"""Profiling utilities.

Port of kaldi_aslp_tpu/utils/profile.py (reference: CuDevice::AccuProfile
/ PrintProfile, src/aslp-cudamatrix/cu-device.h:87-88, per-op cumulative
timers printed at exit; per-component Propagate timing,
nnet-nnet.cc:97-100; the frames/s logs of aslp-nnet-train-simple.cc:
245-250).  What carries over: named wall-time regions that wait for the
card when handed a CUDA tensor (``AccuProfiler``), the audio-seconds/s
counter (``ThroughputMeter``) and a ``torch.profiler`` trace over the
CPU and CUDA that writes a Chrome trace (``trace``).

The port's own spans and counters live here too.  A span site is
``with span("aslp.<layer>.<part>"): ...`` at a layer boundary of the
program, and a counter site ``count(name, value)``.  While no record is
on (the default) a site costs one check of ``_RECORD`` and returns a
shared no-op context: no object, no CUDA event, no profiler range, no
wait for the device.  ``record_spans()`` turns a record on: each span
then notes its name, its parent (the innermost span open: a backward's
spans, opened on the autograd engine's thread while the caller waits in
``backward()``, nest under the caller's), the id of its outermost span (shared by every span of one step
or call) and its start and end on ``time.perf_counter_ns``; a span
handed a CUDA device also records a CUDA event at each end, read only
once the record is closed.  While a ``torch.profiler`` profile runs,
each span is also a ``record_function`` range of its name, so the
device trace's own clock places it.  ``trace`` turns a record on, so an
operator's Chrome trace carries the spans."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

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
        """The region is also a span of ``name`` while a record is on."""
        with span(name):
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
    the card, with a span record on, so the program's spans are ranges
    of the trace; on exit it writes ``trace.json``, a Chrome trace, into
    ``log_dir`` and yields the profiler for ``key_averages()``."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with record_spans(), \
            torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# -- spans and counters ------------------------------------------------------

class _NoSpan:
    """The context every span site gets while no record is on."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()

# the record that span and counter sites write to; None: the record is off
_RECORD: Optional["SpanRecord"] = None


class Span:
    """One span of a record: ``name``, ``parent`` (a Span or None),
    ``step`` (the id of its outermost span), ``start_ns`` / ``end_ns``
    (``time.perf_counter_ns``), ``child_ns`` (what its children cover)
    and ``events`` (a CUDA event pair, or None)."""

    __slots__ = ("record", "name", "device", "parent", "step", "start_ns",
                 "end_ns", "child_ns", "events", "_range")

    def __init__(self, record: "SpanRecord", name: str,
                 device: Optional[torch.device]):
        self.record, self.name, self.device = record, name, device
        self.parent: Optional[Span] = None
        self.step = -1
        self.start_ns = self.end_ns = self.child_ns = 0
        self.events = None
        self._range = None

    def __enter__(self) -> "Span":
        rec = self.record
        stack = rec._open
        if stack:
            self.parent = stack[-1]
            self.step = self.parent.step
        else:
            self.step = rec._new_step()
        stack.append(self)
        rec.spans.append(self)
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.record._open.pop()
        if self.parent is not None:
            self.parent.child_ns += self.end_ns - self.start_ns
        return False

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def self_ms(self) -> float:
        """The span's duration less what its children cover."""
        return (self.end_ns - self.start_ns - self.child_ns) / 1e6

    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's CUDA events (None without
        them); waits for the second, so read it once the record is
        closed."""
        if self.events is None:
            return None
        if not self.record.closed:
            raise RuntimeError("a span's CUDA events are read once its "
                               "record is closed")
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


class SpanRecord:
    """The spans (in the order they opened) and counters of one
    ``record_spans()``; read them once it is closed."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = defaultdict(float)
        self.closed = False
        self._steps = 0
        self._open: List[Span] = []

    def _new_step(self) -> int:
        self._steps += 1
        return self._steps - 1

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def summary(self) -> Dict[str, dict]:
        """For each span name: count, total_ms, mean_ms and self_ms (mean
        host milliseconds) and, for spans with CUDA events, device_ms
        (mean milliseconds between them)."""
        out: Dict[str, dict] = {}
        for s in self.spans:
            row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                          "self_total_ms": 0.0,
                                          "device_total_ms": None})
            row["count"] += 1
            row["total_ms"] += s.ms
            row["self_total_ms"] += s.self_ms
            dev = s.device_ms()
            if dev is not None:
                row["device_total_ms"] = (row["device_total_ms"] or 0.0) + dev
        for row in out.values():
            n = row["count"]
            row["mean_ms"] = row["total_ms"] / n
            row["self_ms"] = row.pop("self_total_ms") / n
            dev = row.pop("device_total_ms")
            if dev is not None:
                row["device_ms"] = dev / n
        return out


def span(name: str, device: Optional[torch.device] = None):
    """A span of ``name`` while a record is on (CUDA events around it
    when ``device`` is a CUDA device), else the shared no-op context."""
    rec = _RECORD
    if rec is None:
        return _NO_SPAN
    return Span(rec, name, device)


def recording() -> bool:
    """Whether a record is on: a site that computes what it counts asks
    first."""
    return _RECORD is not None


def count(name: str, value: float) -> None:
    """Add ``value`` to the counter ``name`` of the record that is on."""
    rec = _RECORD
    if rec is not None:
        rec.counters[name] += value


@contextlib.contextmanager
def record_spans() -> Iterator[SpanRecord]:
    """Turn a span record on for the block and yield it; the record that
    was on before (or none) is on again after."""
    global _RECORD
    outer, rec = _RECORD, SpanRecord()
    _RECORD = rec
    try:
        yield rec
    finally:
        _RECORD = outer
        rec.closed = True
