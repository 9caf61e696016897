"""Distributed training on the card: two ranks sharing one card over
gloo (parallel/mesh.py's backend rule: NCCL refuses two ranks on one
card).

The bf16 flagship (3 x BLSTMP, C=512, P=320, 40 inputs, 72 targets;
chip_smoke.py's model, numpy-seeded weights) under BSP at 8 streams a
rank: both ranks' parameters equal bit for bit after the step, each
rank's step launching ``bilstmp_train_fwd`` and ``_bwd`` 3 times and the
CTC pair once (never its wide kernel), and the loss and gradients within
PERF.md section 2's CTC bf16 bounds (1e-3; 5e-2 of each parameter's
largest gradient) of one rank on all 16 streams.  The full-width LSTM
hybrid (2 x LSTMP, C=800, P=512, 3019 pdfs) through
``aslp-nnet-train-lstm-stream-worker`` run in each rank: exit 0,
``lstmp_train_fwd`` / ``_bwd`` launches with ``per_step`` 0, and a model
that reloads.  A BN net with ``axis_name="data"`` under BSP against one
rank on the whole batch (1e-4 of each tensor's largest value).

These tests skip where there is no CUDA card.  This file imports no JAX;
run it on the card with ``python -m pytest --noconftest
tests/test_torch_parallel_cuda.py -q``."""

import numpy as np
import pytest
import torch

import chip_smoke
from kaldi_aslp_tpu_torch.parallel.launch import RankContext, spawn
from kaldi_aslp_tpu_torch.parallel.mesh import choose_backend
from kaldi_aslp_tpu_torch.parallel.steps import train_rank, train_ranks

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _one(job):
    return train_rank(RankContext(0, 1, torch.device("cuda"), "none"), job)


def test_two_ranks_on_one_card_take_gloo():
    _card()
    assert choose_backend("cuda", 2, 1) == "gloo"
    assert choose_backend("cuda", torch.cuda.device_count(),
                          torch.cuda.device_count()) == "nccl"


def test_bsp_flagship_two_ranks_against_one(tmp_path):
    _card()
    model, _, _ = chip_smoke.write_train_files(str(tmp_path))
    rs = np.random.RandomState(5)
    S, T, U = 16, 60, 12
    job = dict(model=model, strategy="bsp", steps=1, learn_rate=0.008,
               momentum=0.9, batch={
                   "feats": rs.randn(S, T, 40).astype(np.float32),
                   "labels": rs.randint(1, 72, (S, U)).astype(np.int64),
                   "in_lens": np.full(S, T, np.int64),
                   "lab_lens": np.full(S, U, np.int64),
                   "mask": np.ones((S, T), np.float32)})
    ranks = [r[0] for r in spawn(train_ranks, 2, args=([job],),
                                 device_type="cuda", run_timeout_s=300)]
    for k, v in ranks[0]["params"][0].items():
        assert np.array_equal(ranks[1]["params"][0][k], v), k
    for r in ranks:
        got = {n: r["launches"][n]["launches"] for n in
               ("bilstmp_train_fwd", "bilstmp_train_bwd", "ctc_alpha_beta")}
        assert got == {"bilstmp_train_fwd": 3, "bilstmp_train_bwd": 3,
                       "ctc_alpha_beta": 1}, r["launches"]
        assert r["launches"]["ctc_alpha_beta"]["wide"] == 0
    one = _one(job)
    loss_err = abs(ranks[0]["losses"][0] - one["losses"][0]) / abs(
        one["losses"][0])
    assert loss_err <= 1e-3
    for k, g in one["grads"].items():
        assert chip_smoke.rel_max(ranks[0]["grads"][k], g) <= 5e-2, k


def test_lstm_stream_worker_on_the_hybrid(tmp_path):
    _card()
    from kaldi_aslp_tpu_torch.models import Nnet

    model, feats, targets = chip_smoke.write_bptt_files(str(tmp_path))
    out = str(tmp_path / "out.zip")
    argv = ["aslp-nnet-train-lstm-stream-worker", "--worker-type=bmuf",
            "--device=cuda", "--minibatch-size=256", "--sync-period=512",
            "--learn-rate=0.02", feats, targets, model, out]
    ranks = spawn(train_ranks, 2, args=([{"cli": [argv]}],),
                  device_type="cuda", run_timeout_s=300)
    for r in ranks:
        run = r[0]["cli"][0]
        lc = run["launches"]
        assert run["rc"] == 0
        assert lc["lstmp_train_fwd"]["launches"] > 0
        assert lc["lstmp_train_fwd"]["launches"] == \
            lc["lstmp_train_bwd"]["launches"]
        assert lc["lstmp_train_fwd"]["per_step"] == 0
        assert lc["lstmp_train_bwd"]["per_step"] == 0
    assert "AvgLoss" in ranks[0][0]["cli"][0]["stdout"]
    net, _ = Nnet.load(out, "cuda")
    assert all(torch.isfinite(p).all() for p in net.parameters())


def test_bn_axis_name_two_ranks_against_one(tmp_path):
    _card()
    rs = np.random.RandomState(6)
    job = dict(model=chip_smoke.write_bn_model(str(tmp_path)),
               strategy="bsp", steps=1, learn_rate=0.1, momentum=0.9,
               batch={"x": rs.randn(128, 40).astype(np.float32),
                      "y": rs.randint(0, 8, 128).astype(np.int64)})
    ranks = [r[0] for r in spawn(train_ranks, 2, args=([job],),
                                 device_type="cuda", run_timeout_s=300)]
    one = _one(job)
    got = np.concatenate([r["outputs"] for r in ranks])
    assert chip_smoke.rel_max(got, one["outputs"]) <= 1e-4
    for r in ranks:
        for k, g in one["grads"].items():
            assert chip_smoke.rel_max(r["grads"][k], g) <= 1e-4, k
