"""The port's spans and counters (kaldi_aslp_tpu_torch/utils/profile.py)
and their sites: nesting, parents, step ids and self time; the record
off (every site runs through the shared no-op, nothing is recorded, no
CUDA event or profiler range is made); a small ``CtcTrainer`` epoch and
``nnet_forward_batched`` with the record on; the spans in an operator's
Chrome trace; ``load_library``'s counters.  The test marked ``cuda``
runs the training and posteriors sites on the card, where the C entries'
``aslp.op.*`` spans and the parts' CUDA events exist."""

from __future__ import annotations

import json
import os
import stat
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kaldi_aslp_tpu_torch.utils.profile as P
from kaldi_aslp_tpu_torch.data.sequence import CtcBatch
from kaldi_aslp_tpu_torch.decoder.decodable import (
    PdfPrior,
    nnet_forward_batched,
)
from kaldi_aslp_tpu_torch.models import (
    AffineTransform,
    BLstmProjectedStreams,
    Nnet,
)
from kaldi_aslp_tpu_torch.ops import build
from kaldi_aslp_tpu_torch.train import CtcTrainer, init_velocity
from kaldi_aslp_tpu_torch.train.sgd import NnetTrainOptions

PARTS = ["aslp.train.forward", "aslp.train.loss", "aslp.train.backward",
         "aslp.train.update"]
INFER = ["aslp.infer.upload", "aslp.infer.forward", "aslp.infer.scores",
         "aslp.infer.wait", "aslp.infer.to_host"]
D, TARGETS = 16, 5


def _net(device, bf16=False, cell=8, proj=4, layers=1) -> Nnet:
    net = Nnet()
    dim = D
    for _ in range(layers):
        net.add(BLstmProjectedStreams(dim, 2 * proj, cell_dim=cell,
                                      bf16=bf16))
        dim = 2 * proj
    net.add(AffineTransform(dim, TARGETS, param_stddev=0.5))
    net.reset_parameters(torch.Generator().manual_seed(3))
    return net.to(device)


def _batches(n, streams=3, frames=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lens = rng.integers(frames // 2, frames + 1, streams).astype(np.int32)
        mask = (np.arange(frames)[None] < lens[:, None]).astype(np.float32)
        lab_lens = np.maximum(lens // 4, 1).astype(np.int32)
        labels = rng.integers(1, TARGETS, (streams, 4)).astype(np.int32)
        feats = rng.standard_normal((streams, frames, D)).astype(np.float32)
        out.append(CtcBatch([], feats * mask[..., None], labels, lens,
                            lab_lens, mask))
    return out


def _epoch(net, batches):
    trainer = CtcTrainer(net, NnetTrainOptions(learn_rate=1e-3,
                                               momentum=0.9))
    return trainer.train_epoch(init_velocity(net), iter(batches), 1e-3)


def _posteriors(net, seed=1):
    b = _batches(1, seed=seed)[0]
    prior = PdfPrior(np.arange(1, TARGETS + 1))
    return nnet_forward_batched(net, b.feats, b.frame_mask, prior=prior)


def test_nested_spans_have_parent_step_and_self_time(monkeypatch):
    ticks = iter(t * 1_000_000 for t in
                 (0, 10, 30, 40, 50, 60, 90, 100, 200, 210))
    monkeypatch.setattr(P.time, "perf_counter_ns", lambda: next(ticks))
    with P.record_spans() as rec:
        with P.span("outer"):
            with P.span("a"):
                pass
            with P.span("b"):
                with P.span("c"):
                    P.count("c.bytes", 7)
        with P.span("second"):
            P.count("c.bytes", 5)
    by = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["outer", "a", "b", "c", "second"]
    assert by["outer"].parent is None and by["second"].parent is None
    assert by["a"].parent is by["outer"] and by["b"].parent is by["outer"]
    assert by["c"].parent is by["b"]
    assert {by[n].step for n in ("outer", "a", "b", "c")} == {0}
    assert by["second"].step == 1
    assert [by[n].ms for n in ("outer", "a", "b", "c", "second")] == \
        [100, 20, 50, 10, 10]
    assert by["outer"].self_ms == 30 and by["b"].self_ms == 40
    assert by["c"].self_ms == 10
    summary = rec.summary()
    assert summary["outer"] == {"count": 1, "total_ms": 100, "mean_ms": 100,
                                "self_ms": 30}
    assert rec.counters == {"c.bytes": 12}
    assert not P.recording()


class _Counted:
    """Stands in for ``torch.cuda.Event`` and ``record_function``,
    counting constructions."""

    made = 0

    def __init__(self, *args, **kwargs):
        type(self).made += 1

    def record(self, *args):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 2.5

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_with_the_record_off_the_sites_make_nothing(monkeypatch):
    """The sites run through the shared no-op as often as they record
    spans with the record on; off, no Span, CUDA event or profiler range
    is made, even while a profiler runs."""
    net = _net("cpu")
    with P.record_spans() as rec:
        _epoch(net, _batches(2))
        _posteriors(net)
    sites = len(rec.spans)

    class Event(_Counted):
        made = 0

    class Range(_Counted):
        made = 0

    entered = []
    spans_made = []
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.profiler, "record_function", Range)
    monkeypatch.setattr(P._NoSpan, "__enter__",
                        lambda self: entered.append(1))
    init = P.Span.__init__
    monkeypatch.setattr(P.Span, "__init__", lambda self, *a: (
        spans_made.append(1), init(self, *a))[1])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _epoch(net, _batches(2))
        _posteriors(net)
        with P.AccuProfiler().region("region"):
            pass
        with P.span("aslp.test.device", torch.device("cuda")):
            pass
    assert len(entered) == sites + 2
    assert spans_made == [] and Event.made == 0 and Range.made == 0

    # the same stand-ins count what a record makes
    with P.record_spans() as on, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with P.span("aslp.test.device", torch.device("cuda")):
            pass
    assert Event.made == 2 and Range.made == 1 and len(spans_made) == 1
    assert on.summary()["aslp.test.device"]["device_ms"] == 2.5


def test_a_device_span_is_read_once_its_record_is_closed(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Counted)
    with P.record_spans() as rec:
        with P.span("aslp.test.device", torch.device("cuda")):
            pass
        with pytest.raises(RuntimeError, match="closed"):
            rec.spans[0].device_ms()
    assert rec.spans[0].device_ms() == 2.5


def test_a_training_epoch_records_each_step_and_feed():
    net = _net("cpu")
    batches = _batches(3)
    with P.record_spans() as rec:
        _epoch(net, batches)
    steps = rec.named("aslp.train.step")
    assert len(steps) == 3 and all(s.parent is None for s in steps)
    assert len({s.step for s in steps}) == 3
    for s in steps:
        children = [c for c in rec.spans if c.parent is s]
        assert [c.name for c in children] == PARTS
        assert all(c.step == s.step for c in children)
        assert s.self_ms >= 0
    feeds = rec.named("aslp.train.feed")
    assert len(feeds) == 3 and all(f.parent is None for f in feeds)
    # each batch's five arrays, as the trainer sends them
    assert rec.counters["aslp.train.feed.bytes"] == sum(
        a.nbytes for b in batches for a in (b.feats, b.labels,
                                            b.input_lengths,
                                            b.label_lengths, b.frame_mask))
    # the record's own spans only: the CPU nets' parts have no CUDA events
    assert all(s.events is None for s in rec.spans)
    assert set(rec.summary()) == {"aslp.train.step", "aslp.train.feed",
                                  *PARTS}


def test_a_posteriors_call_records_its_parts_and_scores_alike():
    net = _net("cpu")
    off = _posteriors(net)
    with P.record_spans() as rec:
        on = _posteriors(net)
    assert np.array_equal(off, on) and off.dtype == on.dtype
    calls = rec.named("aslp.infer.call")
    assert len(calls) == 1 and calls[0].parent is None
    assert [s.name for s in rec.spans if s.parent is calls[0]] == INFER
    b = _batches(1, seed=1)[0]
    assert rec.counters["aslp.infer.upload.bytes"] == \
        b.feats.nbytes + b.frame_mask.nbytes
    assert rec.counters["aslp.infer.to_host.bytes"] == on.nbytes


def test_the_chrome_trace_holds_the_spans(tmp_path):
    log_dir = str(tmp_path / "prof")
    net = _net("cpu")
    with P.trace(log_dir):
        _epoch(net, _batches(1))
        _posteriors(net)
        with P.AccuProfiler().region("aslp.test.region"):
            torch.ones(4) + 1
    with open(os.path.join(log_dir, "trace.json")) as f:
        names = {str(e.get("name", "")) for e in json.load(f)["traceEvents"]}
    want = {"aslp.train.step", "aslp.train.feed", "aslp.infer.call",
            "aslp.infer.to_host", "aslp.test.region", *PARTS}
    assert want <= names, want - names
    assert not P.recording()


def _fake_library(monkeypatch, tmp_path, name):
    """``library_path(name)`` in ``tmp_path``, and ``name`` not loaded."""
    so = tmp_path / f"lib{name}.so"
    monkeypatch.setattr(build, "library_path", lambda source: so)
    monkeypatch.setattr(build, "_LOADED", {})
    return so


def _torch_library() -> Path:
    return next(Path(torch.__file__).parent.joinpath("lib").glob(
        "libc10.so*"))


def test_a_cached_load_counts_a_load_and_its_seconds(monkeypatch, tmp_path):
    so = _fake_library(monkeypatch, tmp_path, "spans_test_cached.cu")
    so.write_bytes(_torch_library().read_bytes())
    before = (build.load_library.builds, build.load_library.loads,
              build.load_library.seconds)
    lib = build.load_library("spans_test_cached.cu")
    assert build.load_library("spans_test_cached.cu") is lib
    assert build.load_library.builds == before[0]
    assert build.load_library.loads == before[1] + 1
    assert build.load_library.seconds > before[2]


def test_a_build_counts_a_build_and_a_load(monkeypatch, tmp_path):
    """``nvcc`` stood in for by a script that writes the library to the
    path after ``-o``."""
    so = _fake_library(monkeypatch, tmp_path, "spans_test_built.cu")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import shutil, sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        f"shutil.copyfile({str(_torch_library())!r}, out)\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    before = (build.load_library.builds, build.load_library.loads)
    build.load_library("spans_test_built.cu")
    assert so.exists()
    assert (build.load_library.builds, build.load_library.loads) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_the_sites_on_the_card():
    """A bf16 BLSTMP-CTC epoch and a posteriors call on the card: one
    ``aslp.op.*`` span a C entry's launch under the part that calls it,
    each part's CUDA events read after the record closes, and the scores
    alike with the record off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from kaldi_aslp_tpu_torch.ops import bilstmp_train, ctc_recursions, lstmp

    dev = torch.device("cuda")
    net = _net(dev, bf16=True, cell=64, proj=32, layers=2)
    counters = {"aslp.op.bilstmp_train_fwd": bilstmp_train.bilstmp_train_fwd,
                "aslp.op.bilstmp_train_bwd": bilstmp_train.bilstmp_train_bwd,
                "aslp.op.ctc_alpha_beta": ctc_recursions.ctc_alpha_beta,
                "aslp.op.blstmp_forward": lstmp.blstmp_forward}
    before = {n: f.launches for n, f in counters.items()}
    with P.record_spans() as rec:
        _epoch(net, _batches(2))
        on = _posteriors(net)
    torch.cuda.synchronize()
    parents = {"aslp.op.bilstmp_train_fwd": "aslp.train.forward",
               "aslp.op.bilstmp_train_bwd": "aslp.train.backward",
               "aslp.op.ctc_alpha_beta": "aslp.train.loss",
               "aslp.op.blstmp_forward": "aslp.infer.forward"}
    for name, f in counters.items():
        assert len(rec.named(name)) == f.launches - before[name] > 0, name
        # the backward's entries run on the autograd engine's thread
        assert {s.parent.name for s in rec.named(name)} == {parents[name]}
    summary = rec.summary()
    for part in PARTS:
        assert summary[part]["count"] == 2 and summary[part]["device_ms"] > 0
    assert summary["aslp.infer.call"]["count"] == 1
    assert np.array_equal(_posteriors(net), on)
    assert build.load_library.loads >= 3 and build.load_library.seconds > 0
