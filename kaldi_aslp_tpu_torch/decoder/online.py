"""Incremental (online) Viterbi decoding.

Port of kaldi_aslp_tpu/decoder/online.py:OnlineViterbiDecoder
(reference: src/aslp-online/online-nnet-decoder.h:66 with
AdvanceDecoding/FinalizeDecoding/GetBestPath/ResetDecoder).  The dense
scan advances chunk by chunk on the decoder's device: the state scores
are the carry, per-chunk backpointers accumulate on the host, and
partial results backtrace from the current best state without
finalizing.  The JAX decoder buckets chunk lengths for XLA; the port
does not."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from kaldi_aslp_tpu_torch.decoder.viterbi import NEG_INF, ViterbiDecoder


class OnlineViterbiDecoder(ViterbiDecoder):
    """advance_decoding(chunk) / partial / finalize / reset."""

    def __init__(self, graph, tid_to_pdf, acoustic_scale=1.0,
                 device="cuda"):
        super().__init__(graph, tid_to_pdf, acoustic_scale, device=device)
        self.reset()

    def reset(self) -> None:
        """(reference: ResetDecoder — next utterance)."""
        self._scores, self._init_bp = self._init()
        self._bps: List[np.ndarray] = []
        self.num_frames_decoded = 0

    def advance_decoding(self, loglikes: np.ndarray) -> None:
        """Consume [T_chunk, P] acoustic scores."""
        T = len(loglikes)
        if T == 0:
            return
        self._scores, bps = self._scan(loglikes, self._scores)
        self._bps.extend(bps)
        self.num_frames_decoded += T

    def _backtrace(self, end_state: int) -> Tuple[List[int], np.ndarray]:
        g = self.graph
        T = self.num_frames_decoded
        ali = np.zeros(T, np.int32)
        words_rev: List[int] = []
        s = end_state
        t = T - 1
        while t >= 0:
            a = int(self._bps[t][s])
            if a < 0:
                break
            if g.olabel[a] > 0:
                words_rev.append(int(g.olabel[a]))
            if g.ilabel[a] > 0:
                ali[t] = g.ilabel[a]
                t -= 1
            s = int(g.src[a])
        while s != g.start:
            a = int(self._init_bp[s])
            if a < 0:
                break
            if g.olabel[a] > 0:
                words_rev.append(int(g.olabel[a]))
            s = int(g.src[a])
        return list(reversed(words_rev)), ali

    def get_partial_path(self) -> List[int]:
        """Best words so far, from the currently-best state (may change
        as more audio arrives — the reference's partial result)."""
        if self.num_frames_decoded == 0:
            return []
        return self._backtrace(int(np.argmax(self._scores)))[0]

    def finalize_decoding(self) -> Tuple[List[int], np.ndarray, float]:
        """Require a final state (reference: FinalizeDecoding +
        GetBestPath with final costs)."""
        total = self._scores - self.graph.final
        end = int(np.argmax(total))
        if not np.isfinite(total[end]) or total[end] <= NEG_INF:
            # no reachable final state: fall back to best partial
            end = int(np.argmax(self._scores))
            words, ali = self._backtrace(end)
            return words, ali, float(self._scores[end])
        words, ali = self._backtrace(end)
        return words, ali, float(total[end])

    def final_relative_cost(self) -> float:
        """Relative cost of final states: 0 when a final state has the
        best score this frame, +inf when no final state is reachable
        (reference: lattice-faster-online-decoder FinalRelativeCost,
        consumed by online-endpoint.cc EndpointDetected)."""
        if self.num_frames_decoded == 0:
            return float("inf")
        with np.errstate(invalid="ignore"):
            total = self._scores - self.graph.final
        best_final = float(np.max(np.nan_to_num(total, nan=-np.inf)))
        best_any = float(np.max(self._scores))
        if not np.isfinite(best_final) or best_final <= NEG_INF:
            return float("inf")
        return max(0.0, best_any - best_final)

    def trailing_silence_frames(self, sil_tids: np.ndarray) -> int:
        """Frames of silence at the end of the current best path
        (endpointing input, reference: online-endpoint.cc
        TrailingSilenceLength)."""
        if self.num_frames_decoded == 0:
            return 0
        _, ali = self._backtrace(int(np.argmax(self._scores)))
        sil = set(int(t) for t in np.asarray(sil_tids).reshape(-1))
        count = 0
        for tid in ali[::-1]:
            if int(tid) in sil or int(tid) == 0:
                count += 1
            else:
                break
        return count
