"""The spans pass of a traced run: the program's own spans and counters
(``kaldi_aslp_tpu_torch/utils/profile.py``), for the metrics whose source
is ``program_span``.

The traced window and its profiled sub-window run with the record off.
After them the pass drives the calls the untraced window makes
(``train_epoch`` through the driver's ``epoch``, or
``nnet_forward_batched`` call after call): one warm step; right behind
it, the cell's ``profile_steps`` steps under ``record_spans()`` with no
profiler, which give each span's host and CUDA-event durations; as many
steps again, one at a time with the device drained before each, which
give the host's time to issue a step while no full command buffer holds
it back; then ``profile_steps`` steps under ``record_spans()`` inside
``trace.profiled``, which puts the spans on the device trace's clock
beside the device's busy intervals.  The first reader that asks runs the
pass, keeps its result under ``records["spans"]`` and prints one line,
``{"program_spans": ...}``.

``trace.profiled`` opens its window on a drained device, so until its
first kernel there the device waits for the host's first feed or
upload, a wait an epoch pays once.  Idle time inside a span counts from
that kernel on; the wait before it is reported apart
(``startup_idle_pct``).

The runner hands a reader the records alone, so the pass takes the
run's driver from the frame of ``runner.run`` that called the reader.
A program without spans (no ``record_spans``) gives no result and no
line, and its readers read nothing."""

from __future__ import annotations

import importlib
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from portbench.harness import runner, trace
from portbench.harness.training import StepReporter, sync

Interval = Tuple[float, float]


def _record_spans():
    profile = importlib.import_module("kaldi_aslp_tpu_torch.utils.profile")
    return getattr(profile, "record_spans", None)


def _steps(driver) -> Callable[[int], None]:
    """``steps(n)``: n more steps of the window's own program calls."""
    if hasattr(driver, "epoch"):
        def steps(n: int) -> None:
            driver.epoch(driver._cycle([], count=n),
                         StepReporter(driver.reporter_name))
        return steps
    return lambda n: driver._calls(count=n)


def _host_ranges(events, name: str, w0: float, w1: float) -> List[Interval]:
    return [(max(e.time_range.start, w0), min(e.time_range.end, w1))
            for e in events if e.name == name
            and str(getattr(e, "device_type", "")).endswith("CPU")
            and e.time_range.end > w0 and e.time_range.start < w1]


def idle_inside(ranges: List[Interval], busy: List[Interval]) -> float:
    """Time within ``ranges`` that no interval of ``busy`` (a union)
    covers."""
    idle = 0.0
    for a, b in trace._union(ranges):
        covered = sum(max(0.0, min(b, y) - max(a, x)) for x, y in busy)
        idle += (b - a) - covered
    return idle


def device_busy(events, w0: float, w1: float
                ) -> Tuple[List[Interval], float]:
    """The union of the device's kernels, copies and fills that start in
    [w0, w1), and the start of the first kernel there (w0 if none)."""
    device = [e for e in events if trace._is_device(e)
              and w0 <= e.time_range.start < w1]
    busy = trace._union([(e.time_range.start, min(e.time_range.end, w1))
                         for e in device])
    first = min((e.time_range.start for e in device
                 if not e.name.startswith(("Memcpy", "Memset"))), default=w0)
    return busy, first


def run_pass(driver, steps: int, on_card: bool) -> Optional[dict]:
    """The pass over ``driver`` (set up, its window run); None where the
    program has no spans."""
    record_spans = _record_spans()
    if record_spans is None:
        return None
    t0 = time.perf_counter()
    dev = driver.device
    step = _steps(driver)
    # the timed steps queue behind the warm one, so no part of theirs
    # waits for the host to issue it
    step(1)
    with record_spans() as timed:
        step(steps)
        sync(dev)
    with record_spans() as issued:
        for _ in range(steps):
            sync(dev)
            step(1)
        sync(dev)
    summary = timed.summary()

    def recorded() -> None:
        with record_spans():
            step(steps)

    events = trace.profiled(recorded, lambda: step(1), lambda: sync(dev),
                            on_card)
    window = next(e for e in events if e.name == trace.WINDOW)
    w0, w1 = window.time_range.start, window.time_range.end
    busy, first = device_busy(events, w0, w1)
    idle_us = {name: idle_inside(_host_ranges(events, name, first, w1), busy)
               for name in summary}
    return {"steps": steps, "on_card": on_card, "spans": summary,
            "issue": issued.summary(), "counters": dict(timed.counters),
            "window_us": w1 - w0, "busy_us": sum(b - a for a, b in busy),
            "startup_us": idle_inside([(w0, first)], busy),
            "idle_us": idle_us, "pass_s": time.perf_counter() - t0}


def _line(result: dict) -> dict:
    window = result["window_us"]
    rows = {}
    for name, row in result["spans"].items():
        rows[name] = {k: row[k] for k in ("count", "mean_ms", "self_ms",
                                          "device_ms") if k in row}
        rows[name]["idle_pct"] = 100.0 * result["idle_us"][name] / window
    return {"program_spans": rows, "span_counters": result["counters"],
            "issue_ms": {k: v["mean_ms"] for k, v in result["issue"].items()},
            "spans_window_idle_pct":
                100.0 * (1.0 - result["busy_us"] / window),
            "startup_idle_pct": 100.0 * result["startup_us"] / window,
            "spans_pass_s": result["pass_s"]}


def _from_runner() -> Optional[dict]:
    frame = sys._getframe(1)
    while frame is not None and frame.f_code is not runner.run.__code__:
        frame = frame.f_back
    if frame is None:
        return None
    local = frame.f_locals
    result = run_pass(local["driver"], local["cell"]["profile_steps"],
                      local["on_card"])
    if result is not None:
        print(json.dumps(_line(result)), flush=True)
    return result


def of(records: dict) -> Optional[dict]:
    """The pass's result for this run, run at the first request."""
    if "spans" not in records:
        records["spans"] = _from_runner()
    return records["spans"]


def _row(records: dict, name: str) -> Optional[Dict[str, float]]:
    result = of(records)
    return None if result is None else result["spans"].get(name)


def issue_ms(records: dict, name: str) -> Optional[float]:
    """Mean host milliseconds of one span ``name`` in the steps issued
    to a drained device."""
    result = of(records)
    row = None if result is None else result["issue"].get(name)
    return None if row is None else row["mean_ms"]


def part_ms(records: dict, name: str) -> Optional[float]:
    """Mean milliseconds of ``name`` between its CUDA events; on a CPU
    device, which runs each operation as it is issued, its host time."""
    row = _row(records, name)
    if row is None:
        return None
    return row.get("device_ms",
                   None if of(records)["on_card"] else row["mean_ms"])


def per_step_ms(records: dict, name: str) -> Optional[float]:
    """Host milliseconds in ``name`` a step (or call) of the pass."""
    row = _row(records, name)
    return None if row is None else row["total_ms"] / of(records)["steps"]


def idle_pct(records: dict, name: str) -> Optional[float]:
    """Share of the pass's profiled window in which the host was inside
    ``name`` and the device, once it had run its first kernel there, ran
    no kernel, copy or fill."""
    result = of(records)
    if result is None or name not in result["idle_us"] \
            or result["window_us"] <= 0:
        return None
    return 100.0 * result["idle_us"][name] / result["window_us"]
