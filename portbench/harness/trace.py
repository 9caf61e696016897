"""The traced run's instruments, all in the benchmark's own code:

- ``PartTimer``: CUDA events between the parts of every step of the
  traced window (forward, loss, backward, update), read once the window
  has closed;
- ``Entries``: for the profiled sub-window, each named C-entry wrapper
  of the port (``module:function``) is replaced by one that opens a
  ``portbench.entry#<i>`` range and notes its arguments' shapes and the
  step's inputs; the wrappers' launch counters are carried over and back;
- ``profiled``: ``torch.profiler`` over a short sub-window that
  ``portbench.window`` marks, reduced to the records the metric readers
  take: kernels, copies, busy time and each entry call's device time.

A kernel belongs to an entry call when the runtime call that launched it
(the same correlation id) ran directly inside that call's range, not
inside a torch operator the wrapper called: those are the kernels that
the entry's C code launched."""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

COUNTERS = ("launches", "per_step", "wide")
ENTRY = "portbench.entry#"
WINDOW = "portbench.window"
PART = "portbench.part."


class _HostEvent:
    """The host clock in ``torch.cuda.Event``'s place, off the card."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, other: "_HostEvent") -> float:
        return 1e3 * (other.t - self.t)


class PartTimer:
    """CUDA events at the boundaries of each step's parts (the host clock
    on a CPU device)."""

    def __init__(self, parts: Tuple[str, ...], device: torch.device):
        self.parts = parts
        self._steps: List[List[Any]] = []
        self._event = ((lambda: torch.cuda.Event(enable_timing=True))
                       if device.type == "cuda" else _HostEvent)

    @contextlib.contextmanager
    def step(self) -> Iterator[Callable[[str], Any]]:
        """A step: ``mark(part)`` opens ``part``, ending the one before;
        the step's last part ends with the step."""
        events: List[Any] = []
        ranges: List[Any] = []

        def mark(part: str):
            if ranges:
                ranges.pop().__exit__(None, None, None)
            ev = self._event()
            ev.record()
            events.append((part, ev))
            r = torch.profiler.record_function(PART + part)
            r.__enter__()
            ranges.append(r)

        yield mark
        if ranges:
            ranges.pop().__exit__(None, None, None)
        end = self._event()
        end.record()
        events.append((None, end))
        self._steps.append(events)

    def mean_ms(self) -> Dict[str, float]:
        """Each part's mean milliseconds a step (call after a
        synchronize)."""
        sums = {p: 0.0 for p in self.parts}
        for events in self._steps:
            for (part, a), (_, b) in zip(events, events[1:]):
                sums[part] += a.elapsed_time(b)
        n = max(len(self._steps), 1)
        return {p: s / n for p, s in sums.items()}


def _place(spec: str):
    module, attr = spec.split(":")
    return importlib.import_module(module), attr


class Entries:
    """Within the context, every place in ``places`` ({entry name:
    ["module:function", ...]}, the first place holding the original)
    calls a wrapper that records the call in ``calls`` under an
    ``portbench.entry#<i>`` range; ``context`` (set by the driver before
    each step) is noted with every call."""

    def __init__(self, places: Dict[str, List[str]]):
        self.places = places
        self.calls: List[dict] = []
        self.context: dict = {}
        self._saved: List[Tuple[Any, str, Any]] = []

    def _wrap(self, name: str, orig):
        calls = self.calls

        def wrapper(*args, **kwargs):
            i = len(calls)
            calls.append({"entry": name, "context": self.context,
                          "shapes": [tuple(a.shape) if isinstance(
                              a, torch.Tensor) else None for a in args],
                          "itemsize": [a.element_size() if isinstance(
                              a, torch.Tensor) else None for a in args]})
            with torch.profiler.record_function(f"{ENTRY}{i}"):
                return orig(*args, **kwargs)

        for c in COUNTERS:
            if hasattr(orig, c):
                setattr(wrapper, c, getattr(orig, c))
        return wrapper

    def __enter__(self):
        for name, specs in self.places.items():
            module, attr = _place(specs[0])
            orig = getattr(module, attr)
            wrapper = self._wrap(name, orig)
            for spec in specs:
                module, attr = _place(spec)
                self._saved.append((module, attr, getattr(module, attr)))
                setattr(module, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for module, attr, orig in reversed(self._saved):
            wrapper = getattr(module, attr)
            for c in COUNTERS:
                if hasattr(orig, c) and wrapper is not orig:
                    setattr(orig, c, getattr(wrapper, c))
            setattr(module, attr, orig)
        self._saved.clear()
        return False


def _is_device(e) -> bool:
    return (str(getattr(e, "device_type", "")).endswith("CUDA")
            and not e.name.startswith(("portbench.", "ProfilerStep"))
            and not getattr(e, "is_user_annotation", False))


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce_profile(events, calls: List[dict]) -> dict:
    """The profiled sub-window's records from the profiler's events:
    window_us, kernels (name, start_us, dur_us), copies, busy_us, the
    entry calls with their device_us, and the host's view of each idle
    gap (``gaps``: [name, us])."""
    window = [e for e in events if e.name == WINDOW]
    if not window:
        raise RuntimeError("the profiled sub-window left no record")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    device = [e for e in events if _is_device(e)
              and w0 <= e.time_range.start < w1]
    kernels, copies = [], []
    for e in device:
        rec = (e.name, e.time_range.start, e.time_range.end - e.time_range.start)
        (copies if e.name.startswith(("Memcpy", "Memset")) else kernels
         ).append(rec)
    busy = _union([(s, min(s + d, w1)) for _, s, d in kernels + copies])
    busy_us = sum(b - a for a, b in busy)

    # kernels of each entry call: launched by a runtime call whose
    # innermost enclosing range is the call's own
    cpu = [e for e in events if not _is_device(e)]
    launch_parent = {}
    for e in cpu:
        if e.name.startswith("cu") and getattr(e, "cpu_parent", None):
            launch_parent[e.id] = e.cpu_parent.name
    entry_us = [0.0] * len(calls)
    attributed = 0
    for e in device:
        parent = launch_parent.get(e.id, "")
        if parent.startswith(ENTRY):
            i = int(parent[len(ENTRY):])
            if i < len(calls):
                entry_us[i] += e.time_range.end - e.time_range.start
                attributed += 1
    # only the calls made inside the window count: their kernels are the
    # ones timed
    inside = {int(e.name[len(ENTRY):]) for e in cpu
              if e.name.startswith(ENTRY) and w0 <= e.time_range.start < w1}
    entries = [dict(call, device_us=us) for i, (call, us)
               in enumerate(zip(calls, entry_us)) if i in inside]
    return {"window_us": w1 - w0, "kernels": kernels, "copies": copies,
            "busy_us": busy_us, "entries": entries,
            "attributed_kernels": attributed,
            "gaps": _gap_names(busy, w0, w1, cpu)}


def _gap_names(busy, w0, w1, cpu) -> List[Tuple[str, float]]:
    """Idle time of the device in the window, summed by what the host
    was doing at each gap's middle: the step part and the innermost host
    range there."""
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    # the window's thread: its ranges nest, so a stack holds those open
    thread = next(e.thread for e in cpu if e.name == WINDOW)
    spans = sorted((e.time_range.start, -e.time_range.end, e.name)
                   for e in cpu if e.thread == thread and e.name != WINDOW)
    out: Dict[str, float] = {}
    stack: List[Tuple[float, str]] = []
    j = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while j < len(spans) and spans[j][0] <= mid:
            start, neg_end, name = spans[j]
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((-neg_end, name))
            j += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        part = next((n[len(PART):] for _, n in reversed(stack)
                     if n.startswith(PART)), "between steps")
        inner = stack[-1][1] if stack else "host idle"
        key = part if inner.startswith(PART) else f"{part}: {inner}"
        out[key] = out.get(key, 0.0) + (b - a)
    return sorted(out.items(), key=lambda kv: -kv[1])


def profiled(run: Callable[[], None], warm: Callable[[], None],
             sync: Callable[[], None], on_card: bool = True) -> Any:
    """The profiler's events over ``run`` inside a ``portbench.window``
    range that ends on ``sync``; ``warm`` runs first inside the profile,
    outside the range, so that the tracer is running when the window
    opens."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        warm()
        sync()
        with torch.profiler.record_function(WINDOW):
            run()
            sync()
    return prof.events()


def breakdown(profile: dict) -> dict:
    """The ten device operations that took most time, and the ten
    longest idle-time causes, in seconds."""
    ops: Dict[str, float] = {}
    for name, _, dur in profile["kernels"] + profile["copies"]:
        ops[name] = ops.get(name, 0.0) + dur
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, us / 1e6] for n, us in top],
            "idle_gaps": [[n, us / 1e6] for n, us in profile["gaps"][:10]]}
