"""Minimum-Bayes-risk (confusion network / sausage) decoding.

Copy of the numpy module kaldi_aslp_tpu/decoder/mbr.py (reference:
src/lat/sausages.{h,cc} MinimumBayesRisk): exact arc posteriors by
log-domain forward-backward over the lattice's (frame, state) nodes,
then word instances clustered into slots by their word position; each
slot emits its posterior-max word, or nothing when the epsilon mass
wins.  A lattice with no complete path raises ``LatticeError`` (a
``DecodeError``) where the JAX module raises a plain ``RuntimeError``."""

from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from kaldi_aslp_tpu_torch.decoder.lattice import (
    Lattice,
    LatticeArc,
    LatticeError,
)


def _logsumexp(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def lattice_arc_posteriors(
    lat: Lattice,
    acoustic_scale: float = 1.0,
    lm_scale: float = 1.0,
    return_positions: bool = False,
):
    """Per-arc posterior probability (sum over paths through the arc).

    With return_positions, also returns each arc's expected number of
    words emitted BEFORE it (posterior-weighted) — the slot index used
    by the confusion-network construction."""
    NEG = -math.inf
    arcs_by_t: Dict[int, List[Tuple[int, LatticeArc]]] = defaultdict(list)
    for i, a in enumerate(lat.arcs):
        arcs_by_t[a.t].append((i, a))

    alpha: Dict[Tuple[int, int], float] = {(0, lat.start): 0.0}
    # word count along the BEST (Viterbi) path into each node — used as
    # the confusion-network slot index (crisper than the expectation
    # when G-loop states mix word counts)
    wc: Dict[Tuple[int, int], int] = {(0, lat.start): 0}
    best_in: Dict[Tuple[int, int], float] = {(0, lat.start): 0.0}
    for t in range(1, lat.num_frames + 1):
        for i, a in arcs_by_t.get(t, ()):  # arcs arriving at time t
            prev = alpha.get((t - 1, a.src))
            if prev is None:
                continue
            w = prev - lm_scale * a.graph_cost \
                - acoustic_scale * a.acoustic_cost
            key = (t, a.dst)
            alpha[key] = _logsumexp(alpha.get(key, NEG), w)
            if w > best_in.get(key, NEG):
                best_in[key] = w
                wc[key] = wc.get((t - 1, a.src), 0) + len(a.words)

    beta: Dict[Tuple[int, int], float] = {}
    total = NEG
    for s, c in lat.final_costs.items():
        key = (lat.num_frames, s)
        if key in alpha:
            beta[key] = -lm_scale * c
            total = _logsumexp(total, alpha[key] + beta[key])
    if total == NEG:
        raise LatticeError("lattice has no complete path")
    for t in range(lat.num_frames, 0, -1):
        for i, a in arcs_by_t.get(t, ()):
            b_next = beta.get((t, a.dst))
            if b_next is None:
                continue
            w = b_next - lm_scale * a.graph_cost \
                - acoustic_scale * a.acoustic_cost
            key = (t - 1, a.src)
            beta[key] = _logsumexp(beta.get(key, NEG), w)

    post = []
    positions = []
    for a in lat.arcs:
        al = alpha.get((a.t - 1, a.src))
        be = beta.get((a.t, a.dst))
        if al is None or be is None:
            post.append(0.0)
            positions.append(0.0)
            continue
        lp = al + be - lm_scale * a.graph_cost \
            - acoustic_scale * a.acoustic_cost - total
        post.append(math.exp(min(lp, 0.0)))
        positions.append(wc.get((a.t - 1, a.src), 0.0))
    if return_positions:
        return post, positions
    return post


@dataclass
class SausageSlot:
    start: int
    end: int
    word_posteriors: Dict[int, float]

    @property
    def best(self) -> Tuple[Optional[int], float]:
        eps_mass = max(0.0, 1.0 - sum(self.word_posteriors.values()))
        word, p = max(self.word_posteriors.items(), key=lambda kv: kv[1])
        if p > eps_mass:
            return word, p
        return None, eps_mass


def minimum_bayes_risk(
    lat: Lattice,
    acoustic_scale: float = 1.0,
    lm_scale: float = 1.0,
) -> Tuple[List[int], List[float], List[SausageSlot]]:
    """Returns (mbr words, per-word confidences, all slots)
    (reference: sausages.h MinimumBayesRisk::GetOneBest/GetConfidences).

    Slots are indexed by each word instance's expected word POSITION
    along its paths (not wall time), so overlapping alternatives like
    "YES NO" vs "YES YES" land in the right columns."""
    post, positions = lattice_arc_posteriors(
        lat, acoustic_scale, lm_scale, return_positions=True
    )
    by_slot: Dict[int, SausageSlot] = {}
    for a, p, pos in zip(lat.arcs, post, positions):
        if p <= 1e-8 or not a.words:
            continue
        for k, w in enumerate(a.words):
            slot_id = int(round(pos)) + k
            slot = by_slot.setdefault(
                slot_id, SausageSlot(a.t, a.t, {})
            )
            slot.word_posteriors[w] = \
                slot.word_posteriors.get(w, 0.0) + p
            slot.start = min(slot.start, a.t)
            slot.end = max(slot.end, a.t)
    slots = [by_slot[k] for k in sorted(by_slot)]
    words, confs = [], []
    for slot in slots:
        w, p = slot.best
        if w is not None:
            words.append(w)
            confs.append(min(p, 1.0))
    return words, confs, slots
