"""Batched dense decoding: many utterances through one Viterbi loop.

Port of kaldi_aslp_tpu/decoder/batched.py (``BatchedViterbiDecoder``;
reference: run.pl JOB=1:nj ark-sharded latgen-faster-mapped processes +
latgen-faster-mapped-parallel --num-threads, decode.sh:93-134).  The
parallel axis is the batch: one frame loop advances a [B, states] score
table for the whole batch, each utterance's frames past its length held
by a valid mask, so every op of a frame serves B utterances; the
backtrace runs on the host per utterance, from its own last frame.
Ties resolve as in the single decoder (``_seg_max_arg``: the largest arc
id within 1e-6 of the best), so each utterance's words, alignment and
score are those of :meth:`ViterbiDecoder.decode`.

JAX pads the frames to a ``bucket`` multiple and vmaps its scan, which
bounds XLA's compiles; the port runs eagerly, so ``bucket`` is accepted
and unused."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from kaldi_aslp_tpu_torch.decoder.viterbi import (  # noqa: F401 (NEG_INF)
    NEG_INF,
    ViterbiDecoder,
)


class BatchedViterbiDecoder(ViterbiDecoder):
    """decode_batch: list of [T_b, P] -> per-utterance (words, ali,
    score)."""

    def decode_batch(
        self,
        loglikes: Sequence[np.ndarray],
        bucket: int = 128,
    ) -> List[Tuple[List[int], np.ndarray, float]]:
        """Raises DecodeError for the first utterance without a complete
        path."""
        del bucket
        B = len(loglikes)
        if B == 0:
            return []
        lens = [len(x) for x in loglikes]
        T_max = max(lens)
        P = np.shape(loglikes[0])[1]
        init, init_bp = self._init()
        if T_max == 0:
            return [self._finish(init, np.zeros((0, len(init)), np.int64),
                                 0, init_bp) for _ in loglikes]
        ll = np.zeros((B, T_max, P), np.float32)
        valid = np.zeros((B, T_max), bool)
        for i, x in enumerate(loglikes):
            ll[i, :len(x)] = x
            valid[i, :len(x)] = True
        final, bps = self._scan_batch(
            torch.from_numpy(ll).to(self.device),
            torch.from_numpy(init).to(self.device),
            torch.from_numpy(valid).to(self.device))
        final, bps = final.cpu().numpy(), bps.cpu().numpy()
        return [self._finish(final[i], bps[:T, i], T, init_bp)
                for i, T in enumerate(lens)]
