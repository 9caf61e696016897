"""Lattice type, dense lattice generation, best path and the LMWT sweep.

Port of kaldi_aslp_tpu/decoder/lattice.py (``_eps_closure``,
``epsfree_arcs``, ``LatticeArc``, ``Lattice``, ``generate_lattice``,
``lattice_best_path``, ``score_lmwt_sweep``; reference:
src/decoder/lattice-faster-decoder.h:96 GetRawLattice,
src/lat/kaldi-lattice.h, src/latbin/lattice-best-path.cc,
aslp_scripts/score_basic.sh:49-80).

``generate_lattice`` keeps the arcs of a full forward-backward pass over
the dense Viterbi DP: an arc at frame t survives if
alpha[t-1, src] + score(arc, t) + beta[t, dst] is within ``beam`` of
the best path.  The two recursions run on a device as one
``scatter_reduce(..., "amax")`` a frame into a table filled with
NEG_INF (JAX's ``segment_max`` followed by ``maximum(., NEG_INF)``: an
empty segment stays NEG_INF); the pruning and the arcs are numpy.

Where the JAX module catches every ``RuntimeError`` of a path-less
lattice, the port raises and catches ``LatticeError`` (a
``DecodeError``), so a fault of the card is never scored as an empty
hypothesis."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.decoder.viterbi import (
    NEG_INF,
    DecodeError,
    PackedGraph,
)
from kaldi_aslp_tpu_torch.ops.edit_distance import (
    ErrorStats,
    score_utterances,
)
from kaldi_aslp_tpu_torch.utils.device import resolve_device
from kaldi_aslp_tpu_torch.utils.log import get_logger


class LatticeError(DecodeError):
    """A lattice holds no complete path (or no arc at all)."""


# ---------------------------------------------------------------------------
# eps-free expansion: fold eps prefixes into emitting arcs
# ---------------------------------------------------------------------------

def _eps_closure(graph: PackedGraph):
    """Per-state dict of reachable state -> (weight, words) via eps arcs
    (bounded by the eps diameter; the graphs are acyclic in eps)."""
    n = graph.num_states
    closure: List[Dict[int, Tuple[float, Tuple[int, ...]]]] = [
        {s: (0.0, ())} for s in range(n)]
    eps_arcs = [[] for _ in range(n)]
    for a in range(len(graph.src)):
        if graph.ilabel[a] == 0:
            eps_arcs[graph.src[a]].append(a)
    for _ in range(max(graph.eps_diameter, 1)):
        changed = False
        for s in range(n):
            for dst0, (w0, words0) in list(closure[s].items()):
                for a in eps_arcs[dst0]:
                    d = int(graph.dst[a])
                    w = w0 + float(graph.weight[a])
                    words = words0 + (
                        (int(graph.olabel[a]),)
                        if graph.olabel[a] > 0 else ())
                    cur = closure[s].get(d)
                    if cur is None or w < cur[0]:
                        closure[s][d] = (w, words)
                        changed = True
        if not changed:
            break
    return closure


@dataclass
class EpsFreeArc:
    src: int
    dst: int
    tid: int
    words: Tuple[int, ...]
    graph_cost: float   # eps prefix + emitting arc weight


def epsfree_arcs(graph: PackedGraph) -> List[EpsFreeArc]:
    closure = _eps_closure(graph)
    out: List[EpsFreeArc] = []
    for a in range(len(graph.src)):
        if graph.ilabel[a] == 0:
            continue
        src = int(graph.src[a])
        # any eps path u -> src can precede this arc
        for u in range(graph.num_states):
            hit = closure[u].get(src)
            if hit is None:
                continue
            w0, words = hit
            if graph.olabel[a] > 0:  # word on the emitting arc itself
                words = words + (int(graph.olabel[a]),)
            out.append(EpsFreeArc(
                u, int(graph.dst[a]), int(graph.ilabel[a]), words,
                w0 + float(graph.weight[a])))
    return out


# ---------------------------------------------------------------------------
# lattice type
# ---------------------------------------------------------------------------

@dataclass
class LatticeArc:
    t: int                   # frame consumed (arc goes t-1 -> t)
    src: int                 # graph state at t-1
    dst: int                 # graph state at t
    tid: int
    words: Tuple[int, ...]
    graph_cost: float
    acoustic_cost: float     # -loglike, unscaled


@dataclass
class Lattice:
    num_frames: int
    arcs: List[LatticeArc]
    start: int
    final_costs: Dict[int, float]   # graph final costs at t = T

    def num_arcs(self) -> int:
        return len(self.arcs)


def _segment_max(cand: torch.Tensor, seg: torch.Tensor,
                 num_states: int) -> torch.Tensor:
    """max(segment_max(cand, seg), NEG_INF) over ``num_states``
    segments."""
    out = torch.full((num_states,), NEG_INF, dtype=cand.dtype,
                     device=cand.device)
    return out.scatter_reduce(0, seg, cand, reduce="amax",
                              include_self=True)


def generate_lattice(
    graph: PackedGraph,
    loglikes: np.ndarray,
    tid_to_pdf: np.ndarray,
    acoustic_scale: float = 1.0,
    beam: float = 10.0,
    device: Union[str, torch.device, None] = None,
) -> Lattice:
    """Forward-backward pruned lattice, exact at ``beam`` (reference:
    GetRawLattice + determinization role).  The recursions run on
    ``device`` (default the card).  Raises ``DecodeError`` when no path
    completes."""
    dev = resolve_device("cuda" if device is None else device)
    T = len(loglikes)
    ef = epsfree_arcs(graph)
    S = graph.num_states
    src = np.asarray([a.src for a in ef], np.int64)
    dst = np.asarray([a.dst for a in ef], np.int64)
    tid = np.asarray([a.tid for a in ef], np.int64)
    gw = np.asarray([a.graph_cost for a in ef], np.float32)
    pdf = np.asarray(tid_to_pdf)[tid]

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    src_d, dst_d, pdf_d, gw_d = (on_dev(src), on_dev(dst),
                                 on_dev(pdf.astype(np.int64)), on_dev(gw))
    ll = on_dev(np.asarray(loglikes, np.float32))
    scale = float(acoustic_scale)

    # alpha: forward best scores BEFORE each frame (alphas[0] = init)
    init = np.full(S, NEG_INF, np.float32)
    init[graph.start] = 0.0
    alpha = on_dev(init)
    alphas = []
    for t in range(T):
        alphas.append(alpha)
        acoustic = scale * ll[t][pdf_d]
        alpha = _segment_max(alpha[src_d] - gw_d + acoustic, dst_d, S)
    final_scores = np.full(S, NEG_INF, np.float32)
    for s, c in enumerate(graph.final):
        if np.isfinite(c):
            final_scores[s] = -c
    # betas[t] = beta before frame t
    beta = on_dev(final_scores)
    betas = [None] * T
    for t in range(T - 1, -1, -1):
        acoustic = scale * ll[t][pdf_d]
        beta = _segment_max(beta[dst_d] - gw_d + acoustic, src_d, S)
        betas[t] = beta
    alpha_T = alpha.cpu().numpy()
    alphas = (torch.stack(alphas).cpu().numpy() if T
              else np.zeros((0, S), np.float32))
    betas = (torch.stack(betas).cpu().numpy() if T
             else np.zeros((0, S), np.float32))
    best = float((alpha_T + final_scores).max())
    if not np.isfinite(best) or best <= NEG_INF / 2:
        raise DecodeError("no complete path; cannot build lattice")

    arcs: List[LatticeArc] = []
    ll_np = np.asarray(loglikes)
    for t in range(T):
        a_t = alphas[t]
        beta_next = betas[t + 1] if t + 1 < T else final_scores
        score = (a_t[src] - gw
                 + acoustic_scale * ll_np[t, pdf] + beta_next[dst])
        keep = score >= best - beam
        for i in np.where(keep)[0]:
            arcs.append(LatticeArc(
                t + 1, int(src[i]), int(dst[i]), int(tid[i]),
                ef[i].words, float(gw[i]), float(-ll_np[t, pdf[i]])))
    finals = {s: float(c) for s, c in enumerate(graph.final)
              if np.isfinite(c)}
    return Lattice(T, arcs, graph.start, finals)


def _arc_arrays(lat: Lattice):
    """The lattice's arcs as numpy columns (frame, source, destination,
    graph cost, acoustic cost), their frame-major order (list order
    within a frame) and each frame's bounds in it, and the node count."""
    arcs = lat.arcs
    m = len(arcs)
    t_ = np.fromiter((a.t for a in arcs), np.int64, m)
    src = np.fromiter((a.src for a in arcs), np.int64, m)
    dst = np.fromiter((a.dst for a in arcs), np.int64, m)
    g = np.fromiter((a.graph_cost for a in arcs), np.float64, m)
    ac = np.fromiter((a.acoustic_cost for a in arcs), np.float64, m)
    n = 1 + max([lat.start, *lat.final_costs,
                 int(src.max()) if m else 0, int(dst.max()) if m else 0])
    order = np.argsort(t_, kind="stable")
    bounds = np.searchsorted(t_[order], np.arange(lat.num_frames + 2))
    return src, dst, g, ac, order, bounds, n


def lattice_best_path(
    lat: Lattice, acoustic_scale: float = 1.0, lm_scale: float = 1.0
) -> Tuple[List[int], float]:
    """(reference: lattice-best-path.cc) DP over the lattice with
    rescaled costs; returns (words, total cost).  Raises
    ``LatticeError`` when no path completes."""
    return _best_path(lat, _arc_arrays(lat), acoustic_scale, lm_scale)


def _best_path(lat: Lattice, arrays, acoustic_scale: float,
               lm_scale: float) -> Tuple[List[int], float]:
    """``lattice_best_path`` over the lattice's ``_arc_arrays``.

    The JAX function relaxes one arc at a time over (frame, state)
    dicts; here a frame's arcs relax together in numpy, with the same
    float64 sums, keeping at each node the first arc (in list order)
    that reaches the node's largest score above -1e30, which is the arc
    the one-at-a-time strict ``>`` keeps."""
    NEG = -1e30
    T = lat.num_frames
    src, dst, g, ac, order, bounds, n = arrays
    score = np.full(n, NEG)
    has = np.zeros(n, bool)
    score[lat.start], has[lat.start] = 0.0, True
    back = [None] * (T + 1)     # per frame: (sorted dst, winning arc)
    for t in range(1, T + 1):
        idx = order[bounds[t]:bounds[t + 1]]
        idx = idx[has[src[idx]]]
        s = score[src[idx]] - lm_scale * g[idx] - acoustic_scale * ac[idx]
        idx, s = idx[s > NEG], s[s > NEG]
        o = np.lexsort((idx, -s, dst[idx]))
        d = dst[idx[o]]
        first = np.ones(len(o), bool)
        first[1:] = d[1:] != d[:-1]
        win = o[first]
        score = np.full(n, NEG)
        has = np.zeros(n, bool)
        score[d[first]] = s[win]
        has[d[first]] = True
        back[t] = (d[first], idx[win])
    best_state, best_val = None, NEG
    for st, c in lat.final_costs.items():
        v = (float(score[st]) if has[st] else NEG) - lm_scale * c
        if v > best_val:
            best_state, best_val = st, v
    if best_state is None:
        raise LatticeError("lattice has no complete path")
    words_rev: List[int] = []
    st = best_state
    for t in range(T, 0, -1):
        dsts, won = back[t]
        a = lat.arcs[int(won[np.searchsorted(dsts, st)])]
        words_rev.extend(reversed(a.words))
        st = a.src
    return list(reversed(words_rev)), -best_val


def score_lmwt_sweep(
    lattices: Dict[str, Lattice],
    refs: Dict[str, List[int]],
    lmwt_range=range(5, 16),
    acoustic_scale_base: float = 1.0,
) -> Dict[int, ErrorStats]:
    """(reference: score_basic.sh) best path per LMWT, WER each.  A
    path-less lattice scores an empty hypothesis (the reference's
    lattice-best-path warns "No output for utterance" and scoring counts
    every reference word as a deletion)."""
    out: Dict[int, ErrorStats] = {}
    warned: set = set()
    arrays = {utt: _arc_arrays(lat) for utt, lat in lattices.items()}
    for lmwt in lmwt_range:
        hyps = {}
        for utt, lat in lattices.items():
            try:
                words, _ = _best_path(lat, arrays[utt],
                                      acoustic_scale_base / lmwt, 1.0)
            except DecodeError:
                words = []
                if utt not in warned:
                    warned.add(utt)
                    get_logger("lattice").warning(
                        "no complete path in lattice for %s; "
                        "scoring empty hypothesis", utt)
            hyps[utt] = words
        out[lmwt] = score_utterances(refs, hyps)
    return out
