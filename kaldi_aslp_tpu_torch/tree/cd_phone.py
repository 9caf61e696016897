"""CD-phone preparation: segment-level tree statistics, question
compilation and alignment conversion for context-dependent-phone (CTC /
low-frame-rate) targets.

A copy of kaldi_aslp_tpu/tree/cd_phone.py (numpy; the port imports
nothing of the JAX package): equivalents of the reference CD-phone tool
family (reference: src/aslp-bin/aslp-acc-tree-stats-cd-phone-kmeans.cc —
per-phone-segment k-means into 3 sub-states, concatenated means as one
Gaussian statistic per triphone context; aslp-acc-tree-stats-cd-phone-
equal.cc — equal thirds; aslp-acc-tree-stats-cd-phone-viterbi.cc —
HMM-state-aligned thirds; aslp-acc-tree-stats-phone-{mean,mean-per-
frame,median}.cc — whole-segment summaries;
aslp-compile-questions-phone.cc; aslp-tree-bind-info.cc; pipeline
aslp_scripts/cd_phone/prepare_cd_phone.sh:29-53).

The CD-phone idea: instead of tying 3-state HMM pdfs, tie WHOLE phones
in context — each (l, c, r) window becomes one modelling unit whose
acoustics are summarized from the aligned segment; the decision tree
then clusters the windows into ``num_leaves`` CD-phone classes used as
CTC/LFR targets."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_aslp_tpu_torch.hmm.convert_ali import phone_segments
from kaldi_aslp_tpu_torch.tree.build_tree import (
    ContextDependency,
    build_tree,
    cluster_phones_into_questions,
)
from kaldi_aslp_tpu_torch.tree.cluster import GaussStats

NUM_SUBSTATES = 3  # the reference's num_cluster (…-cd-phone-kmeans.cc)


# ---------------------------------------------------------------------------
# segment summarizers (one 3*dim vector per phone segment)
# ---------------------------------------------------------------------------

def summarize_equal(frames: np.ndarray) -> np.ndarray:
    """Equal thirds, mean each (reference:
    aslp-acc-tree-stats-cd-phone-equal.cc)."""
    n, dim = frames.shape
    if n <= NUM_SUBSTATES:
        rows = [frames[min(k, n - 1)] for k in range(NUM_SUBSTATES)]
        return np.concatenate(rows)
    bounds = np.linspace(0, n, NUM_SUBSTATES + 1).astype(int)
    return np.concatenate([
        frames[bounds[k]:bounds[k + 1]].mean(axis=0)
        for k in range(NUM_SUBSTATES)
    ])


def summarize_kmeans(frames: np.ndarray, num_iters: int = 5
                     ) -> np.ndarray:
    """Sequential-init k-means into 3 clusters, concatenated means
    (reference: ClusterKMeansForCDPhone — contiguous stride init, then
    refinement; aslp-acc-tree-stats-cd-phone-kmeans.cc:30-70)."""
    n, dim = frames.shape
    if n <= NUM_SUBSTATES:
        return summarize_equal(frames)
    stride = n // NUM_SUBSTATES
    assign = np.minimum(np.arange(n) // stride, NUM_SUBSTATES - 1)
    for _ in range(num_iters):
        means = np.stack([frames[assign == k].mean(axis=0)
                          for k in range(NUM_SUBSTATES)])
        d = ((frames[:, None, :] - means[None]) ** 2).sum(axis=2)
        new = d.argmin(axis=1)
        # keep clusters non-empty (degenerate segments)
        for k in range(NUM_SUBSTATES):
            if not (new == k).any():
                new[d[:, k].argmin()] = k
        if (new == assign).all():
            break
        assign = new
    means = np.stack([frames[assign == k].mean(axis=0)
                      for k in range(NUM_SUBSTATES)])
    return means.reshape(-1)


def summarize_viterbi(frames: np.ndarray,
                      pdf_classes: np.ndarray) -> np.ndarray:
    """Mean per aligned HMM state (reference:
    aslp-acc-tree-stats-cd-phone-viterbi.cc — the segment's own Viterbi
    state boundaries define the thirds)."""
    n, dim = frames.shape
    out = []
    classes = sorted(set(int(c) for c in pdf_classes))
    for k in range(NUM_SUBSTATES):
        cls = classes[min(k, len(classes) - 1)]
        sel = frames[np.asarray(pdf_classes) == cls]
        if len(sel) == 0:
            sel = frames
        out.append(sel.mean(axis=0))
    return np.concatenate(out)


def summarize_mean(frames: np.ndarray) -> np.ndarray:
    """Whole-segment mean (reference:
    aslp-acc-tree-stats-phone-mean.cc)."""
    return frames.mean(axis=0)


def summarize_median(frames: np.ndarray) -> np.ndarray:
    """Per-dimension median (reference:
    aslp-acc-tree-stats-phone-median.cc)."""
    return np.median(frames, axis=0)


# ---------------------------------------------------------------------------
# accumulation (reference: AccumulateTreeStatsCDPhone)
# ---------------------------------------------------------------------------

def acc_tree_stats_cd_phone(
    feats: np.ndarray,
    ali: np.ndarray,
    trans_model,
    method: str = "kmeans",
    context_width: int = 3,
    central_position: int = 1,
    ci_phones: Sequence[int] = (),
    stats: Optional[Dict] = None,
) -> Dict[Tuple[Tuple[int, ...], int], GaussStats]:
    """Accumulate one Gaussian statistic per phone segment keyed by its
    phone window (pdf-class always 0 — CD phones are single units)."""
    summarize = {
        "kmeans": summarize_kmeans,
        "equal": summarize_equal,
        "viterbi": None,  # handled below (needs the state sequence)
        "mean": summarize_mean,
        "mean-per-frame": None,  # handled below (per-frame stats)
        "median": summarize_median,
    }
    if method not in summarize:
        raise ValueError(f"unknown cd-phone stats method {method!r}")
    stats = stats if stats is not None else {}
    segs = phone_segments(trans_model, ali)  # (phone, start, length)
    ci = set(ci_phones)
    phones = [p for p, _, _ in segs]
    N, P = context_width, central_position
    for idx, (phone, start, length) in enumerate(segs):
        end = start + length
        window = []
        for j in range(N):
            k = idx + j - P
            window.append(phones[k] if 0 <= k < len(segs) else 0)
        if phone in ci:
            window = [0] * P + [phone] + [0] * (N - P - 1)
        window = tuple(window)
        frames = np.asarray(feats[start:end], np.float64)
        if len(frames) == 0:
            continue
        if method == "mean-per-frame":
            # every frame is a point (reference:
            # aslp-acc-tree-stats-phone-mean-per-frame.cc)
            key = (window, 0)
            s = stats.get(key)
            seg_stats = GaussStats.from_frames(frames)
            stats[key] = s.add(seg_stats) if s else seg_stats
            continue
        if method == "viterbi":
            pcs = np.array([
                trans_model.topo.entry(phone).states[
                    trans_model.states[
                        trans_model.tid_to_state(int(t))].hmm_state
                ].pdf_class
                for t in ali[start:end]
            ])
            vec = summarize_viterbi(frames, pcs)
        else:
            vec = summarize[method](frames)
        key = (window, 0)
        s = stats.get(key)
        seg_stats = GaussStats.from_frames(vec[None, :])
        stats[key] = s.add(seg_stats) if s else seg_stats
    return stats


def compile_questions_phone(
    stats: Dict, phones: Sequence[int]
) -> List[List[int]]:
    """Questions = phone clusters from the CD-phone stats (reference:
    aslp-compile-questions-phone.cc — cluster phones by their summed
    stats, emit nested question sets)."""
    return cluster_phones_into_questions(stats, list(phones))


def build_cd_phone_tree(
    stats: Dict,
    phones: Sequence[int],
    num_leaves: int,
    questions: Optional[List[List[int]]] = None,
    min_gain: float = 20.0,
) -> ContextDependency:
    """(reference: cluster_cd_phone.sh → build-tree over the segment
    stats; every phone has a single pdf-class)."""
    return build_tree(
        stats, list(phones), {p: 1 for p in phones},
        questions=questions, max_leaves=num_leaves, min_gain=min_gain,
    )


def tree_bind_info(tree: ContextDependency, stats: Dict) -> str:
    """Text dump 'l c r → cd-phone id' for every seen context
    (reference: aslp-tree-bind-info.cc)."""
    lines = []
    for (window, pc) in sorted(stats):
        pdf = tree.compute(window, pc)
        lines.append(" ".join(str(p) for p in window) + f" {pdf}")
    return "\n".join(lines) + "\n"


def convert_ali_to_cd_phone(
    trans_model,
    tree: ContextDependency,
    ali: np.ndarray,
    per_frame: bool = False,
    context_width: int = 3,
    central_position: int = 1,
) -> np.ndarray:
    """Triphone-window alignment → CD-phone label sequence (reference:
    aslp-convert-ali in the cd_phone pipeline — one label per segment,
    or per frame when training frame-level targets)."""
    segs = phone_segments(trans_model, ali)
    phones = [p for p, _, _ in segs]
    N, P = context_width, central_position
    labels = []
    for idx, (phone, start, length) in enumerate(segs):
        window = tuple(
            phones[idx + j - P] if 0 <= idx + j - P < len(segs) else 0
            for j in range(N)
        )
        cd = tree.compute(window, 0)
        if per_frame:
            labels.extend([cd] * length)
        else:
            labels.append(cd)
    return np.asarray(labels, np.int32)
