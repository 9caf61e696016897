"""Frame-level shuffling randomizer.

Equivalent of the reference randomizer family (reference:
src/aslp-nnet/nnet-randomizer.h:34-143 — MatrixRandomizer /
VectorRandomizer / PosteriorRandomizer pooling ~32k frames, shuffling by a
shared mask, emitting fixed-size minibatches; defaults
randomizer_size=32768 minibatch=256 seed=777 at :39-41).

One generic FrameRandomizer shuffles any number of parallel per-frame
arrays with one permutation (the reference needs one class per type).
Host-side numpy; the trainer moves minibatches to the device.

A copy of kaldi_aslp_tpu/data/randomizer.py:24-89, with the same
``RandomState(randomizer_seed)`` draws, so both packages emit the same
minibatches."""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

from kaldi_aslp_tpu_torch.utils.config import Config


@dataclasses.dataclass
class RandomizerOptions(Config):
    randomizer_size: int = 32768
    minibatch_size: int = 256
    randomizer_seed: int = 777
    randomize: bool = True


class FrameRandomizer:
    """Pool frames from utterances, shuffle, emit minibatches.

    feed(feats, targets, weights) per utterance; iterate_minibatches()
    drains full minibatches; flush() at epoch end emits the remainder."""

    def __init__(self, opts: Optional[RandomizerOptions] = None):
        self.opts = opts or RandomizerOptions()
        self._rng = np.random.RandomState(self.opts.randomizer_seed)
        self._pools: List[List[np.ndarray]] = []
        self._num_arrays: Optional[int] = None

    def feed(self, *arrays: np.ndarray) -> None:
        """Add one utterance's parallel per-frame arrays (same length)."""
        if self._num_arrays is None:
            self._num_arrays = len(arrays)
            self._pools = [[] for _ in range(len(arrays))]
        if len(arrays) != self._num_arrays:
            raise ValueError("inconsistent number of parallel arrays")
        n = len(arrays[0])
        for a in arrays:
            if len(a) != n:
                raise ValueError("parallel arrays must share frame count")
        for pool, a in zip(self._pools, arrays):
            pool.append(np.asarray(a))

    def pooled_frames(self) -> int:
        return sum(len(a) for a in self._pools[0]) if self._pools else 0

    def full(self) -> bool:
        return self.pooled_frames() >= self.opts.randomizer_size

    def _drain(self, min_batch: int) -> Iterator[Tuple[np.ndarray, ...]]:
        if not self._pools or not self._pools[0]:
            return
        stacked = [np.concatenate(pool, axis=0) for pool in self._pools]
        n = len(stacked[0])
        order = (self._rng.permutation(n) if self.opts.randomize
                 else np.arange(n))
        bs = self.opts.minibatch_size
        emitted = 0
        for start in range(0, n - min_batch + 1, bs):
            idx = order[start:start + bs]
            if len(idx) < min_batch:
                break
            yield tuple(a[idx] for a in stacked)
            emitted += len(idx)
        leftover = order[emitted:]
        self._pools = [[a[leftover]] if len(leftover) else []
                       for a in stacked]

    def iterate_minibatches(self) -> Iterator[Tuple[np.ndarray, ...]]:
        """Drain full minibatches, keep the remainder pooled."""
        yield from self._drain(self.opts.minibatch_size)

    def flush(self) -> Iterator[Tuple[np.ndarray, ...]]:
        """Epoch end: emit remaining frames (last batch may be short)."""
        yield from self._drain(1)
        self._pools = []
