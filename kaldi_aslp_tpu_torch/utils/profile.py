"""Profiling utilities.

Port of kaldi_aslp_tpu/utils/profile.py (reference: CuDevice::AccuProfile
/ PrintProfile, src/aslp-cudamatrix/cu-device.h:87-88, per-op cumulative
timers printed at exit; per-component Propagate timing,
nnet-nnet.cc:97-100; the frames/s logs of aslp-nnet-train-simple.cc:
245-250).  What carries over: named wall-time regions that wait for the
card when handed a CUDA tensor (``AccuProfiler``), the audio-seconds/s
counter (``ThroughputMeter``) and a ``torch.profiler`` trace over the
CPU and CUDA that writes a Chrome trace (``trace``)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def _sync(obj) -> None:
    """Wait for the card if ``obj`` is (or holds) a CUDA tensor; a CPU
    tensor needs no wait."""
    if torch.is_tensor(obj):
        if obj.is_cuda:
            torch.cuda.synchronize(obj.device)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _sync(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            _sync(o)


class AccuProfiler:
    """Cumulative wall time a named region (AccuProfile's counterpart).

    ``with prof.region("ctc-loss", sync=loss): ...``: a CUDA tensor (or a
    list, tuple or dict of tensors) as ``sync`` makes the region wait for
    the card before it stops the clock."""

    def __init__(self):
        self._acc: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def region(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            self._acc[name] += time.perf_counter() - t0
            self._count[name] += 1

    def report(self) -> str:
        """(reference: PrintProfile output shape)."""
        lines = ["-----\n[profile]"]
        total = sum(self._acc.values())
        for name, t in sorted(self._acc.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name}\t{t:.3f}s\t{self._count[name]} calls"
                f"\t{100 * t / max(total, 1e-9):.1f}%"
            )
        lines.append(f"total\t{total:.3f}s\n-----")
        return "\n".join(lines)


class ThroughputMeter:
    """frames/s and audio-seconds/s (the reference's fps log)."""

    def __init__(self, frame_shift_s: float = 0.01):
        self.frame_shift_s = frame_shift_s
        self.frames = 0
        self._start = time.monotonic()

    def add_frames(self, n: int) -> None:
        self.frames += int(n)

    @property
    def frames_per_sec(self) -> float:
        return self.frames / max(time.monotonic() - self._start, 1e-9)

    @property
    def audio_seconds_per_sec(self) -> float:
        return self.frames_per_sec * self.frame_shift_s

    def report(self) -> str:
        return (f"throughput: {self.frames_per_sec:.0f} frames/s "
                f"({self.audio_seconds_per_sec:.1f} audio-s/s)")


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace over the CPU and (when there is one)
    the card; on exit it writes ``trace.json``, a Chrome trace, into
    ``log_dir`` and yields the profiler for ``key_averages()``."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
