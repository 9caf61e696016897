"""Sequence data readers: multi-stream truncated-BPTT chunks and
whole-utterance CTC stream batches.

Port of kaldi_aslp_tpu/data/sequence.py:
  - ``SequenceReaderOptions``, ``SequenceChunk``, ``_apply_skip``,
    ``_apply_delay`` and ``SequenceDataReader`` (:26-142; reference:
    src/aslp-nnet/data-reader.{h,cc} SequenceDataReader, defaults
    batch_size=20 num_stream=100 targets_delay=5 at data-reader.h:58-60):
    N parallel utterance streams cut into chunks of batch_size frames,
    with per-stream cursors, new_utt_flags for the state reset, target
    delay, frame skipping and drop_len;
  - ``CtcBatcherOptions``, ``CtcBatch`` and ``CtcBatcher`` (:146-233;
    reference: the stream filling loop of
    aslp-nnetbin/aslp-nnet-train-ctc-streams.cc:118-204): the same
    dropping rule (fewer than 2U+1 frames, or no labels), the same sort
    by length, and the same padding of T to a multiple of ``bucket_time``
    and U to a multiple of ``bucket_labels``.
Both give the JAX package's arrays byte for byte.  Padding uses numpy
(the JAX package's optional native packer gives the same bytes)."""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

from kaldi_aslp_tpu_torch.utils.config import Config


@dataclasses.dataclass
class SequenceReaderOptions(Config):
    batch_size: int = 20        # BPTT chunk length
    num_streams: int = 100
    targets_delay: int = 5
    skip_width: int = 1         # take every k-th frame (1 = none)
    skip_offset: int = 0
    drop_len: int = 0           # drop utts longer than this (0 = off)


@dataclasses.dataclass
class SequenceChunk:
    feats: np.ndarray          # [S, T, D] float32
    targets: np.ndarray        # [S, T] int32
    frame_mask: np.ndarray     # [S, T] float32
    new_utt_flags: np.ndarray  # [S] int32, 1 = stream restarted


class _Stream:
    def __init__(self):
        self.feats: Optional[np.ndarray] = None
        self.targets: Optional[np.ndarray] = None
        self.pos = 0
        self.fresh = False

    @property
    def remaining(self) -> int:
        return 0 if self.feats is None else len(self.feats) - self.pos


def _apply_skip(feats, targets, width, offset):
    """Frame skipping (reference: data-reader.cc:240-250)."""
    if width <= 1:
        return feats, targets
    idx = np.arange(offset, len(feats), width)
    return feats[idx], (targets[idx] if targets is not None else None)


def _apply_delay(feats, targets, delay):
    """Target delay: the output at frame t is trained on the label of
    frame t - delay (reference: data-reader.cc target_delay).  The
    utterance is extended by ``delay`` copies of its last frame and the
    labels shifted right, padded with the first label."""
    if delay <= 0:
        return feats, targets
    ext = np.concatenate([feats, np.repeat(feats[-1:], delay, axis=0)])
    tgt = np.concatenate([np.full(delay, targets[0], targets.dtype),
                          targets])
    return ext, tgt


class SequenceDataReader:
    """Truncated-BPTT chunk iterator over an utterance source.

    source: iterator of (key, feats [T, D], targets [T]) tuples.  Every
    chunk has ``num_streams`` rows; a stream with no utterance left is all
    padding (mask 0)."""

    def __init__(self, source: Iterator[Tuple[str, np.ndarray, np.ndarray]],
                 opts: Optional[SequenceReaderOptions] = None):
        self.opts = opts or SequenceReaderOptions()
        self._source = iter(source)
        self._streams = [_Stream() for _ in range(self.opts.num_streams)]
        self._exhausted = False
        self.num_dropped = 0

    def _refill(self) -> None:
        """AddNewUtt (reference: data-reader.cc:200)."""
        opts = self.opts
        for s in self._streams:
            while s.remaining == 0 and not self._exhausted:
                try:
                    _, feats, targets = next(self._source)
                except StopIteration:
                    self._exhausted = True
                    break
                if opts.drop_len > 0 and len(feats) > opts.drop_len:
                    self.num_dropped += 1
                    continue
                n = min(len(feats), len(targets))
                if n == 0:
                    continue
                feats, targets = _apply_skip(feats[:n], targets[:n],
                                             opts.skip_width,
                                             opts.skip_offset)
                feats, targets = _apply_delay(feats, targets,
                                              opts.targets_delay)
                s.feats, s.targets, s.pos, s.fresh = feats, targets, 0, True

    def __iter__(self) -> Iterator[SequenceChunk]:
        T = self.opts.batch_size
        while True:
            self._refill()
            active = [s for s in self._streams if s.remaining > 0]
            if not active:
                return
            S = len(self._streams)
            dim = active[0].feats.shape[1]
            feats = np.zeros((S, T, dim), np.float32)
            targets = np.zeros((S, T), np.int32)
            mask = np.zeros((S, T), np.float32)
            flags = np.zeros((S,), np.int32)
            for i, s in enumerate(self._streams):
                if s.remaining == 0:
                    continue
                if s.fresh:
                    flags[i] = 1
                    s.fresh = False
                n = min(T, s.remaining)
                feats[i, :n] = s.feats[s.pos:s.pos + n]
                targets[i, :n] = s.targets[s.pos:s.pos + n]
                mask[i, :n] = 1.0
                s.pos += n
            yield SequenceChunk(feats, targets, mask, flags)


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
