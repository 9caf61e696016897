"""Transition model: (phone, hmm-state, pdf) ↔ transition-ids.

Equivalent of the reference TransitionModel (reference:
src/hmm/transition-model.{h,cc}).  The numbering scheme mirrors Kaldi:
transition-states are tuples (phone, hmm-state, pdf) numbered from 1 in
order of phone then state; each transition-state owns a contiguous block
of transition-ids (one per outgoing arc of that topology state, self-loop
included), also numbered from 1.  Alignments are vectors of
transition-ids, so reference-produced ali arks convert with identical
pdf/phone mappings.

Probabilities are MLE-trained from transition counts
(reference: transition-model.cc MleUpdate).

A copy of kaldi_aslp_tpu/hmm/transition_model.py (numpy; the port
imports nothing of the JAX package)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from kaldi_aslp_tpu_torch.hmm.topology import HmmTopology


@dataclass
class TransitionState:
    phone: int
    hmm_state: int
    pdf: int


class TransitionModel:
    def __init__(self, topo: HmmTopology,
                 pdf_map: Optional[Callable[[int, int], int]] = None,
                 triples: Optional[List[Tuple[int, int, int]]] = None):
        """Build from either pdf_map(phone, pdf_class) → pdf (monophone
        path, reference: gmm-init-mono) or an explicit sorted list of
        (phone, hmm_state, pdf) triples (context-dependent path,
        reference: transition-model.cc ComputeTriples via the tree)."""
        self.topo = topo
        self.states: List[TransitionState] = [None]  # 1-based
        self._state_index: Dict[Tuple[int, int, int], int] = {}
        # per transition-state: start transition-id and arc list
        self._tid_start: List[int] = [0]
        self._arcs: List[List[Tuple[int, float]]] = [[]]
        if triples is None:
            if pdf_map is None:
                raise ValueError("need pdf_map or triples")
            triples = []
            for phone in topo.phones:
                entry = topo.entry(phone)
                for hmm_state, st in enumerate(entry.states):
                    if st.pdf_class < 0:
                        continue
                    triples.append(
                        (phone, hmm_state, pdf_map(phone, st.pdf_class))
                    )
        tid = 1
        for (phone, hmm_state, pdf) in sorted(set(triples)):
            st = topo.entry(phone).states[hmm_state]
            self.states.append(TransitionState(phone, hmm_state, pdf))
            self._state_index[(phone, hmm_state, pdf)] = \
                len(self.states) - 1
            self._tid_start.append(tid)
            self._arcs.append(list(st.transitions))
            tid += len(st.transitions)
        self.num_transition_ids = tid - 1
        self.num_pdfs = 1 + max(
            (s.pdf for s in self.states[1:]), default=-1
        )
        self._pair_index: Dict[Tuple[int, int], List[int]] = {}
        for (phone, hmm_state, _pdf), i in self._state_index.items():
            self._pair_index.setdefault((phone, hmm_state), []).append(i)
        # log transition probabilities, initialized from topology priors
        self.log_probs = np.zeros(self.num_transition_ids + 1, np.float32)
        for ts in range(1, len(self.states)):
            for i, (_, p) in enumerate(self._arcs[ts]):
                self.log_probs[self._tid_start[ts] + i] = np.log(
                    max(p, 1e-10)
                )

    def copy_log_probs_from(self, other: "TransitionModel") -> None:
        """Transfer trained transition probabilities from ``other`` for
        every (phone, hmm_state, pdf) triple both models share.

        The CD decode-graph transition model is re-enumerated over the
        union of training + decode context windows, so it is a FRESH
        object — without this transfer its arc costs silently revert
        to topology priors while the monophone decode graph keeps its
        MLE probs (the round-5 tri-inversion diagnosis).  The reference
        never hits this because one TransitionModel object serves both
        training and decode (src/hmm/transition-model.cc)."""
        for key, ts in self._state_index.items():
            ots = other._state_index.get(key)
            if ots is None:
                continue
            n = len(self._arcs[ts])
            self.log_probs[self._tid_start[ts]:self._tid_start[ts] + n] \
                = other.log_probs[other._tid_start[ots]:
                                  other._tid_start[ots] + n]

    # -- lookups (reference: transition-model.h accessors) ------------------
    def transition_state(self, phone: int, hmm_state: int,
                         pdf: int) -> int:
        """(reference: TripleToTransitionState)."""
        return self._state_index[(phone, hmm_state, pdf)]

    def transition_state_of(self, phone: int, hmm_state: int) -> int:
        """Monophone convenience: unique pdf per (phone, hmm_state)."""
        matches = self._pair_index[(phone, hmm_state)]
        if len(matches) != 1:
            raise KeyError(
                f"({phone},{hmm_state}) maps to {len(matches)} "
                "transition states; use transition_state(phone, state, pdf)"
            )
        return matches[0]

    def pair_to_tid(self, trans_state: int, arc_index: int) -> int:
        return self._tid_start[trans_state] + arc_index

    def tid_to_state(self, tid: int) -> int:
        # binary search over start offsets
        lo, hi = 1, len(self.states) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self._tid_start[mid] <= tid:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def tid_to_pdf(self, tid: int) -> int:
        return self.states[self.tid_to_state(tid)].pdf

    def tid_to_phone(self, tid: int) -> int:
        return self.states[self.tid_to_state(tid)].phone

    def tid_to_arc(self, tid: int) -> Tuple[int, int]:
        """Returns (trans_state, arc_index)."""
        ts = self.tid_to_state(tid)
        return ts, tid - self._tid_start[ts]

    def is_self_loop(self, tid: int) -> bool:
        ts, ai = self.tid_to_arc(tid)
        dest, _ = self._arcs[ts][ai]
        return dest == self.states[ts].hmm_state

    def arcs_of(self, trans_state: int) -> List[Tuple[int, float]]:
        return self._arcs[trans_state]

    # -- vectorized alignment converters (ali-to-pdf / ali-to-phones) -------
    def _tid_lut(self, mapper) -> np.ndarray:
        lut = np.zeros(self.num_transition_ids + 1, np.int32)
        for tid in range(1, self.num_transition_ids + 1):
            lut[tid] = mapper(tid)
        return lut

    def alignment_to_pdfs(self, ali: np.ndarray) -> np.ndarray:
        """(reference: bin/ali-to-pdf.cc)."""
        if not hasattr(self, "_pdf_lut"):
            self._pdf_lut = self._tid_lut(self.tid_to_pdf)
        return self._pdf_lut[np.asarray(ali)]

    def alignment_to_phones(self, ali: np.ndarray,
                            collapse: bool = True) -> np.ndarray:
        """(reference: bin/ali-to-phones.cc) — per-segment phone sequence."""
        if not hasattr(self, "_phone_lut"):
            self._phone_lut = self._tid_lut(self.tid_to_phone)
        phones = self._phone_lut[np.asarray(ali)]
        if not collapse:
            return phones
        # one phone per contiguous segment that starts at hmm-state 0
        # non-self-loop entry; approximate by collapsing repeats at
        # phone-initial transition-ids
        out = []
        prev_start = -1
        for i, tid in enumerate(np.asarray(ali)):
            ts = self.tid_to_state(int(tid))
            st = self.states[ts]
            if st.hmm_state == 0 and not self.is_self_loop(int(tid)):
                out.append(st.phone)
        return np.asarray(out, np.int32)

    def alignment_to_phone_pdfclass(self, ali: np.ndarray):
        """Per-frame (phone, pdf_class) arrays (tree-stats input,
        reference: acc-tree-stats.cc)."""
        phones = np.zeros(len(ali), np.int32)
        pdf_classes = np.zeros(len(ali), np.int32)
        for i, tid in enumerate(np.asarray(ali)):
            ts = self.states[self.tid_to_state(int(tid))]
            phones[i] = ts.phone
            pdf_classes[i] = self.topo.entry(ts.phone).states[
                ts.hmm_state].pdf_class
        return phones, pdf_classes

    # -- MLE update ---------------------------------------------------------
    def accumulate(self, ali: np.ndarray,
                   counts: np.ndarray | None = None) -> np.ndarray:
        if counts is None:
            counts = np.zeros(self.num_transition_ids + 1, np.float64)
        np.add.at(counts, np.asarray(ali), 1.0)
        return counts

    def mle_update(self, counts: np.ndarray, floor: float = 0.01) -> None:
        """(reference: transition-model.cc MleUpdate)."""
        for ts in range(1, len(self.states)):
            start = self._tid_start[ts]
            n = len(self._arcs[ts])
            c = counts[start:start + n].astype(np.float64)
            tot = c.sum()
            if tot == 0:
                continue
            p = np.maximum(c / tot, floor)
            p /= p.sum()
            self.log_probs[start:start + n] = np.log(p).astype(np.float32)
