"""The spans pass (harness/spans.py) and the metrics that read it, on
cells cut to the CPU's size: a traced run reports every metric whose
source is the program's spans or counters, the record stays off in the
traced window and in the existing profiled sub-window, and a program
without spans gives those metrics nothing and fails nothing."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

import kaldi_aslp_tpu_torch.utils.profile as P
from kaldi_aslp_tpu_torch.ops import build
from portbench.harness import cells, runner, spans, trace
from portbench.harness.training import TrainDriver
from portbench.tests import tiny

BENCH = cells.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NEW = {m["name"] for m in BENCH["per_layer"]
       if m["source"] in ("program_span", "program_counter")
       and m["name"].startswith(("span_", "dispatch_", "feed_", "to_host_",
                                 "library_"))}
SEED = 2 ** 31 + 11


def _new_in(cell: str):
    return {m["name"] for m in cells.per_layer(BENCH, cell)} & NEW


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reports_every_new_metric(cell, capsys):
    result = runner.run(tiny.found(cell, profile_steps=2), SEED, 0.2, True,
                        "cpu")
    assert _new_in(cell) <= set(result["metrics"])
    for name in _new_in(cell):
        value = result["metrics"][name]["value"]
        assert value >= 0, (name, value)
        if name != "library_s.setup":  # no library is loaded on the CPU
            assert value > 0 or name.endswith("idle_pct"), (name, value)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith('{"program_spans"')]
    assert len(lines) == 1
    rows = lines[0]["program_spans"]
    step = "aslp.train.step" if "train" in cell.split(".")[1] \
        else "aslp.infer.call"
    assert rows[step]["count"] == 2
    assert lines[0]["spans_pass_s"] > 0


def test_the_record_is_off_in_the_traced_window_and_sub_window(monkeypatch):
    """A span opened in the traced window or the existing profiled
    sub-window fails the run; the pass's own profiled window records."""
    phase = {"now": None}
    opened = []
    init = P.Span.__init__

    def noting(self, *args):
        if phase["now"] is not None:
            raise AssertionError(f"a span recorded in {phase['now']}")
        opened.append(args[1])
        init(self, *args)

    def during(name, fn):
        def wrapped(*args, **kwargs):
            phase["now"] = name
            try:
                return fn(*args, **kwargs)
            finally:
                phase["now"] = None
        return wrapped

    profiled = trace.profiled
    calls = []

    def first_profiled_only(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            return during("the profiled sub-window", profiled)(*args,
                                                               **kwargs)
        return profiled(*args, **kwargs)

    monkeypatch.setattr(P.Span, "__init__", noting)
    monkeypatch.setattr(TrainDriver, "traced_window",
                        during("the traced window",
                               TrainDriver.traced_window))
    monkeypatch.setattr(trace, "profiled", first_profiled_only)
    result = runner.run(tiny.found("blstm_ctc.train", profile_steps=2),
                        SEED, 0.2, True, "cpu")
    assert len(calls) == 2
    assert "aslp.train.step" in opened and "aslp.train.feed" in opened
    assert "dispatch_ms.train" in result["metrics"]


def test_a_program_without_spans_gives_the_new_metrics_nothing(
        monkeypatch):
    monkeypatch.delattr(P, "record_spans")
    monkeypatch.delattr(build.load_library, "seconds")
    result = runner.run(tiny.found("blstm_ctc.posteriors", profile_steps=2),
                        SEED, 0.2, True, "cpu")
    assert not set(result["metrics"]) & NEW
    assert "copy_ms.infer" in result["metrics"] or \
        "step_mfu.infer" in result["metrics"]
    assert result["correct"]


def test_a_reader_outside_a_run_reads_nothing():
    records = {}
    assert spans.issue_ms(records, "aslp.train.step") is None
    assert records == {"spans": None}


def test_idle_inside_counts_what_no_busy_interval_covers():
    busy = [(0.0, 10.0), (20.0, 30.0)]
    assert spans.idle_inside([(5.0, 25.0)], busy) == 10.0
    assert spans.idle_inside([(5.0, 8.0), (6.0, 12.0)], busy) == 2.0
    assert spans.idle_inside([], busy) == 0.0


def _event(name, start, end, device="CUDA"):
    return SimpleNamespace(name=name, device_type=f"DeviceType.{device}",
                           time_range=SimpleNamespace(start=start, end=end))


def test_the_device_starts_at_its_first_kernel():
    """A copy before the first kernel is busy time but not the start; a
    host range and what lies outside the window are neither."""
    events = [_event("Memcpy HtoD (Pinned -> Device)", 12.0, 14.0),
              _event("fwd_sweep_kernel", 20.0, 50.0),
              _event("Memset (Device)", 45.0, 60.0),
              _event("aslp.train.feed", 0.0, 18.0, device="CPU"),
              _event("late_kernel", 95.0, 120.0),
              _event("outside_kernel", 110.0, 130.0)]
    busy, first = spans.device_busy(events, 10.0, 100.0)
    assert busy == [(12.0, 14.0), (20.0, 60.0), (95.0, 100.0)]
    assert first == 20.0
    assert spans.device_busy(events[:1], 10.0, 100.0) == ([(12.0, 14.0)],
                                                          10.0)
