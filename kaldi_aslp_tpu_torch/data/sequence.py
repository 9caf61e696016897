"""Whole-utterance CTC stream batches.

Port of ``CtcBatcherOptions``, ``CtcBatch`` and ``CtcBatcher`` from
kaldi_aslp_tpu/data/sequence.py:146-233 (reference: the stream filling
loop of aslp-nnetbin/aslp-nnet-train-ctc-streams.cc:118-204).  The same
dropping rule (fewer than 2U+1 frames, or no labels), the same sort by
length, and the same padding of T to a multiple of ``bucket_time`` and
U to a multiple of ``bucket_labels``, so a batch here equals the JAX
package's batch array for array.  Padding uses numpy (the JAX package's
optional native packer gives the same bytes)."""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

from kaldi_aslp_tpu_torch.utils.config import Config


@dataclasses.dataclass
class CtcBatcherOptions(Config):
    num_streams: int = 16
    frame_limit: int = 25000    # max total frames per batch
    drop_len: int = 0
    skip_width: int = 1
    bucket_time: int = 64       # pad T to a multiple
    bucket_labels: int = 16     # pad U to a multiple
    sort_by_length: bool = True


@dataclasses.dataclass
class CtcBatch:
    keys: List[str]
    feats: np.ndarray          # [S, T_max, D] float32
    labels: np.ndarray         # [S, U_max] int32
    input_lengths: np.ndarray  # [S] int32
    label_lengths: np.ndarray  # [S] int32
    frame_mask: np.ndarray     # [S, T_max] float32


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _make_batch(items, opts: CtcBatcherOptions) -> CtcBatch:
    if opts.sort_by_length:
        items = sorted(items, key=lambda kv: -len(kv[1]))
    S = len(items)
    T = _round_up(max(len(f) for _, f, _ in items), opts.bucket_time)
    U = _round_up(max(max(len(l) for _, _, l in items), 1),
                  opts.bucket_labels)
    D = items[0][1].shape[1]
    feats = np.zeros((S, T, D), np.float32)
    labels = np.zeros((S, U), np.int32)
    in_lens = np.zeros((S,), np.int32)
    lab_lens = np.zeros((S,), np.int32)
    mask = np.zeros((S, T), np.float32)
    keys = []
    for i, (k, f, l) in enumerate(items):
        keys.append(k)
        feats[i, :len(f)] = f
        labels[i, :len(l)] = l
        in_lens[i] = len(f)
        lab_lens[i] = len(l)
        mask[i, :len(f)] = 1.0
    return CtcBatch(keys, feats, labels, in_lens, lab_lens, mask)


class CtcBatcher:
    """Whole-utterance batches for CTC training.

    source: iterator of (key, feats [T, D], labels [U]) tuples."""

    def __init__(self, source, opts: Optional[CtcBatcherOptions] = None):
        self.opts = opts or CtcBatcherOptions()
        self._source = iter(source)
        self.num_dropped = 0

    def __iter__(self) -> Iterator[CtcBatch]:
        opts = self.opts
        pending: List[Tuple[str, np.ndarray, np.ndarray]] = []
        frames = 0
        for key, f, l in self._source:
            if opts.drop_len > 0 and len(f) > opts.drop_len:
                self.num_dropped += 1
                continue
            if opts.skip_width > 1:
                # frame skipping (reference: data-reader.cc:240-250)
                f = f[np.arange(0, len(f), opts.skip_width)]
            if len(f) < 2 * len(l) + 1 or len(l) == 0:
                self.num_dropped += 1  # unalignable (too few frames)
                continue
            pending.append((key, f, np.asarray(l, np.int32)))
            frames += len(f)
            if len(pending) >= opts.num_streams or frames >= opts.frame_limit:
                yield _make_batch(pending, opts)
                pending, frames = [], 0
        if pending:
            yield _make_batch(pending, opts)
