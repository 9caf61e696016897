"""VAD scoring, TextGrid, boundary accuracy, segmentation and the
profiling helpers of the port (kaldi_aslp_tpu_torch/vad/roc.py,
textgrid.py, boundary.py, ops/segment.py, utils/profile.py) against the
JAX package: ``roc_curve``, ``auc`` and ``eer`` within 1e-12 (both host
float64; ties included), ``BoundaryTool`` reports and the TextGrid bytes
equal, ``ForwardMaxMatch`` equal; ``AccuProfiler`` and
``ThroughputMeter`` by their reports, ``trace`` by its Chrome trace."""

import json
import os
import time

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.ops.segment import ForwardMaxMatch as JFmm
from kaldi_aslp_tpu.vad import roc as jroc
from kaldi_aslp_tpu.vad import textgrid as jtg
from kaldi_aslp_tpu.vad.boundary import BoundaryTool as JBoundary
from kaldi_aslp_tpu_torch.ops import ForwardMaxMatch
from kaldi_aslp_tpu_torch.utils.profile import (
    AccuProfiler,
    ThroughputMeter,
    trace,
)
from kaldi_aslp_tpu_torch.vad import (
    auc,
    eer,
    intervals_to_textgrid,
    parse_interval_file,
    roc_curve,
)
from kaldi_aslp_tpu_torch.vad.boundary import BoundaryTool

torch.set_num_threads(1)

TOL = 1e-12


def _scores(kind, seed):
    rs = np.random.RandomState(seed)
    labels = rs.rand(300) < 0.4
    scores = rs.randn(300) + 1.5 * labels
    if kind == "ties":          # a coarse grid: many tied ranks
        scores = np.round(scores * 2) / 2
    elif kind == "constant":    # every score tied
        scores = np.zeros(300)
    elif kind == "float32":
        scores = scores.astype(np.float32)
    return scores, labels.astype(np.int32)


@pytest.mark.parametrize("kind", ["plain", "ties", "constant", "float32"])
@pytest.mark.parametrize("seed", range(2))
def test_auc_eer_roc_match_jax(kind, seed):
    s, y = _scores(kind, seed)
    assert abs(auc(s, y) - jroc.auc(s, y)) <= TOL
    assert abs(eer(s, y) - jroc.eer(s, y)) <= TOL
    for n in (5, 100, 400):
        got, want = roc_curve(s, y, n), jroc.roc_curve(s, y, n)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            assert abs(g.threshold - w.threshold) <= TOL
            assert abs(g.tpr - w.tpr) <= TOL and abs(g.fpr - w.fpr) <= TOL


def test_auc_of_ties_is_the_average_rank():
    # two positives tied with one negative at 1.0: each tie scores 1/2
    s = np.array([0.0, 1.0, 1.0, 1.0, 2.0])
    y = np.array([0, 1, 1, 0, 1])
    assert auc(s, y) == jroc.auc(s, y)
    assert abs(auc(s, y) - (1 + 1 + 1 + 0.5 + 0.5 + 1) / 6) <= TOL


def test_one_class_raises_like_jax():
    s, y = np.arange(4.0), np.ones(4, np.int32)
    for fn in (auc, eer, roc_curve, jroc.auc, jroc.eer, jroc.roc_curve):
        with pytest.raises(ValueError):
            fn(s, y)


@pytest.mark.parametrize("intervals", [
    [(10, 50)],
    [(5, 30), (40, 60), (100, 180), (170, 200)],
    [(0, 12), (13, 20), (90, 91)],
])
def test_textgrid_bytes_match_jax(intervals):
    assert intervals_to_textgrid(intervals, "u0") == \
        jtg.intervals_to_textgrid(intervals, "u0")
    text = "".join("[%d, %d]\n" % iv for iv in intervals) + "\n7 9\nx\n"
    assert parse_interval_file(text) == jtg.parse_interval_file(text)
    with pytest.raises(ValueError):
        intervals_to_textgrid([])


def _masks(seed):
    """Label / hypothesis pairs: sil -> speech -> sil with a shifted and
    noisy hypothesis, plus the shapes the tool rejects."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(12):
        n = rs.randint(40, 120)
        a = rs.randint(1, n // 2)
        b = rs.randint(a + 2, n - 1)
        lab = np.zeros(n, np.int32)
        lab[a:b] = 1
        hyp = np.roll(lab, rs.randint(-6, 7))
        hyp[rs.rand(n) < 0.05] ^= 1
        out.append((lab, hyp))
    out.append((np.ones(20, np.int32), np.ones(20, np.int32)))
    out.append((np.zeros(20, np.int32), np.zeros(20, np.int32)))
    lab = np.zeros(20, np.int32)
    lab[5:] = 1
    out.append((lab, lab))
    return out


@pytest.mark.parametrize("context", [1, 3, 10])
def test_boundary_tool_matches_jax(context):
    tool, jtool = BoundaryTool(context), JBoundary(context)
    for lab, hyp in _masks(context):
        assert tool.add_data(lab, hyp) == jtool.add_data(lab, hyp)
    assert tool.report() == jtool.report()
    assert abs(tool.start_acc - jtool.start_acc) <= TOL
    assert abs(tool.end_acc - jtool.end_acc) <= TOL
    assert tool.num_sentence == jtool.num_sentence > 0


def test_boundary_tool_errors_match_jax():
    for cls in (BoundaryTool, JBoundary):
        with pytest.raises(ValueError):
            cls(0)
        with pytest.raises(ValueError, match="mismatch"):
            cls().add_data(np.zeros(3), np.zeros(4))


@pytest.mark.parametrize("text,max_len", [
    ("我们是中国人民的朋友", 0), ("我们是中国人民的朋友", 2),
    ("abcabcx", 0), ("", 0)])
def test_forward_max_match_matches_jax(text, max_len):
    vocab = ["我们", "中国", "中国人", "人民", "朋友", "ab", "abc", "c"]
    assert ForwardMaxMatch(vocab, max_len).segment(text) == \
        JFmm(vocab, max_len).segment(text)
    assert ForwardMaxMatch([]).segment("xy") == JFmm([]).segment("xy")


def test_accu_profiler_regions_and_report():
    prof = AccuProfiler()
    for _ in range(3):
        with prof.region("a", sync=torch.ones(2)):
            time.sleep(0.002)
    with prof.region("b", sync=[torch.zeros(1), {"k": torch.zeros(1)}]):
        pass
    rep = prof.report().splitlines()
    assert rep[:2] == ["-----", "[profile]"]
    assert rep[2].startswith("a\t") and rep[2].split("\t")[2] == "3 calls"
    assert rep[3].startswith("b\t") and "1 calls" in rep[3]
    assert rep[-2].startswith("total\t") and rep[-1] == "-----"
    assert prof._acc["a"] >= 0.006


def test_throughput_meter(monkeypatch):
    import kaldi_aslp_tpu_torch.utils.profile as P

    now = [100.0]
    monkeypatch.setattr(P.time, "monotonic", lambda: now[0])
    meter = ThroughputMeter(frame_shift_s=0.01)
    now[0] = 110.0
    meter.add_frames(300)
    meter.add_frames(200.0)
    assert meter.frames == 500
    assert meter.frames_per_sec == 50.0
    assert meter.audio_seconds_per_sec == 0.5
    assert meter.report() == "throughput: 50 frames/s (0.5 audio-s/s)"


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "prof")
    with trace(log_dir) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()
