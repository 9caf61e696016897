"""The nnet zoo on the card against the CPU.

The latency-controlled BLSTMP at the flagship's widths (C=512, P=320,
40 inputs, chunk 64) with ragged masks and a carried state: eval through
two ``lstmp_forward`` launches (the backward direction at S * n streams
of 64 frames), training through two ``lstmp_train_fwd`` and two
``lstmp_train_bwd`` launches, every launch on a persistent sweep; values
within 1e-4 and gradients within 1e-3 of each tensor's largest magnitude
(the BPTT bounds of PERF.md section 2), TF32 off.  A DAG net of every
other new component (CNN, max-pooling, BN, cFSMN, RowConvolution, CIFG,
GRU, Splice, Pnorm, Maxout, BlockSoftmax, LengthNorm, ...) forward and
backward on the card against the CPU (1e-4; ``chip_smoke.zoo_net``), and
the MIMO frame trainer and the LC CLI chain with ``--device=cuda``
against ``--device=cpu``.

These tests skip where there is no CUDA card.  This file imports no
JAX; run it on the card with ``python -m pytest --noconftest
tests/test_torch_zoo_cuda.py -q``."""

import numpy as np
import pytest
import torch

import kaldi_aslp_tpu_torch.models as M
from kaldi_aslp_tpu_torch.models import simple as port_simple
from kaldi_aslp_tpu_torch.ops import lstmp, lstmp_train

VALUE_TOL, GRAD_TOL = 1e-4, 1e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                1e-6))


def _reset_counts():
    for fn in (lstmp.lstmp_forward, lstmp.blstmp_forward,
               lstmp_train.lstmp_train_fwd, lstmp_train.lstmp_train_bwd):
        fn.launches = fn.per_step = 0


def _counts():
    return {f.__name__: (f.launches, f.per_step) for f in (
        lstmp.lstmp_forward, lstmp.blstmp_forward,
        lstmp_train.lstmp_train_fwd, lstmp_train.lstmp_train_bwd)}


def _lc(rs, D=40, C=512, P=320, chunk=64, bf16=False):
    comp = M.BLstmProjectedStreamsLC(D, 2 * P, cell_dim=C, chunk_size=chunk,
                                     **({"bf16": True} if bf16 else {}))
    with torch.no_grad():
        for p in comp.parameters():
            p.copy_(torch.from_numpy(
                (0.1 * (2 * rs.rand(*p.shape) - 1)).astype(np.float32)))
    return comp


def _inputs(rs, S, T, D, C, P):
    lens = rs.randint(T // 3, T + 1, S)
    lens[0] = T
    return {"x": rs.randn(S, T, D).astype(np.float32),
            "mask": (np.arange(T)[None] < lens[:, None]).astype(np.float32),
            "c": 0.5 * rs.randn(S, C).astype(np.float32),
            "r": 0.5 * rs.randn(S, P).astype(np.float32),
            "w": rs.randn(S, T, 2 * P).astype(np.float32)}


def _run_lc(comp, arrays, device, train):
    comp.to(device).train(train)
    comp.zero_grad()
    t = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    state = {"fwd": {"c": t["c"].requires_grad_(train),
                     "r": t["r"].requires_grad_(train)}}
    x = t["x"].requires_grad_(train)
    ys, new = comp(x, state, mask=t["mask"])
    grads = {}
    if train:
        ((ys * t["w"]).sum() + new["fwd"]["c"].sum()).backward()
        grads = {n: p.grad.cpu() for n, p in comp.named_parameters()}
        grads.update(x=x.grad.cpu(), c0=state["fwd"]["c"].grad.cpu(),
                     r0=state["fwd"]["r"].grad.cpu())
    return ys.detach().cpu(), {k: v.detach().cpu()
                               for k, v in new["fwd"].items()}, grads


@pytest.mark.cuda
@pytest.mark.parametrize("S,T", [(4, 150), (100, 20), (2, 64)],
                         ids=["T150", "bptt-chunk", "T64"])
def test_lc_eval_on_the_card_against_the_cpu(S, T):
    dev = _card()
    rs = np.random.RandomState(S + T)
    comp = _lc(rs)
    arrays = _inputs(rs, S, T, 40, 512, 320)
    _reset_counts()
    ys, st, _ = _run_lc(comp, arrays, dev, train=False)
    counts = _counts()
    assert counts["lstmp_forward"] == (2, 0), counts
    assert counts["blstmp_forward"] == (0, 0)
    want, st_cpu, _ = _run_lc(comp, arrays, "cpu", train=False)
    assert torch.isfinite(ys).all()
    assert _rel(ys, want) <= VALUE_TOL
    for k in st:
        assert _rel(st[k], st_cpu[k]) <= VALUE_TOL, k


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_lc_training_on_the_card_against_the_cpu(bf16):
    dev = _card()
    rs = np.random.RandomState(3)
    S, T = 100, 20      # the sequence reader's default chunk
    comp = _lc(rs, bf16=bf16)
    arrays = _inputs(rs, S, T, 40, 512, 320)
    _reset_counts()
    ys, st, grads = _run_lc(comp, arrays, dev, train=True)
    counts = _counts()
    assert counts["lstmp_train_fwd"] == (2, 0), counts
    assert counts["lstmp_train_bwd"] == (2, 0), counts
    want, _, grads_cpu = _run_lc(comp, arrays, "cpu", train=True)
    tol_v, tol_g = (VALUE_TOL, GRAD_TOL) if not bf16 else (2e-2, 5e-2)
    assert _rel(ys, want) <= tol_v
    errs = {k: _rel(g, grads_cpu[k]) for k, g in grads.items()}
    assert max(errs.values()) <= tol_g, errs


def _zoo_run(net, device, xs, mask, cots, train):
    """In training its Dropout keeps one mask, drawn on the host, on both
    devices: the card's generator draws other masks than the CPU's."""
    net.to(device).train(train)
    net.zero_grad()
    t = [torch.from_numpy(x).to(device).requires_grad_(True) for x in xs]
    keep = torch.from_numpy(np.random.RandomState(8).rand(
        *xs[0].shape[:2], 48) < 0.8)
    draw = port_simple.dropout_keep
    port_simple.dropout_keep = lambda shape, ret, gen, dev: keep.to(dev)
    try:
        ys, states = net(t, mask=torch.from_numpy(mask).to(device),
                         generator=torch.Generator(device))
    finally:
        port_simple.dropout_keep = draw
    sum((y * torch.from_numpy(c).to(device)).sum()
        for y, c in zip(ys, cots)).backward()
    grads = {n: p.grad.cpu() for n, p in net.named_parameters()
             if p.grad is not None}
    grads.update({f"x{i}": x.grad.cpu() for i, x in enumerate(t)})
    return [y.detach().cpu() for y in ys], grads, states


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_zoo_net_on_the_card_against_the_cpu(train):
    dev = _card()
    rs = np.random.RandomState(7)
    S, T = 6, 50
    xs = [rs.randn(S, T, 40).astype(np.float32),
          rs.randn(S, T, 3).astype(np.float32)]
    lens = rs.randint(10, T + 1, S)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    cots = [rs.randn(S, T, 10).astype(np.float32),
            rs.randn(S, T, 7).astype(np.float32)]
    import chip_smoke

    net = chip_smoke.zoo_net()
    ys, grads, states = _zoo_run(net, dev, xs, mask, cots, train)
    want, grads_cpu, states_cpu = _zoo_run(net, "cpu", xs, mask, cots,
                                           train)
    for y, w in zip(ys, want):
        assert torch.isfinite(y).all() and _rel(y, w) <= VALUE_TOL
    assert sorted(grads) == sorted(grads_cpu)
    errs = {k: _rel(g, grads_cpu[k]) for k, g in grads.items()}
    assert max(errs.values()) <= VALUE_TOL, errs
    if train:
        for k in ("sum", "sumsq", "count"):
            assert _rel(states["0"][k], states_cpu["0"][k]) <= VALUE_TOL


@pytest.mark.cuda
def test_dropout_draws_on_the_card():
    dev = _card()
    comp = M.Dropout(64, 64, dropout_retention=0.7).train()
    x = torch.randn(32, 50, 64, device=dev)
    g = torch.Generator(dev).manual_seed(3)
    y, _ = comp(x, generator=g)
    kept = y != 0
    assert y.device.type == "cuda"
    assert abs(float(kept.float().mean()) - 0.7) < 0.02
    assert torch.allclose(y[kept], x[kept] / 0.7)
    again, _ = comp(x, generator=torch.Generator(dev).manual_seed(3))
    assert torch.equal(again, y)
    with pytest.raises(ValueError, match="generator"):
        comp(x)
    assert torch.equal(comp.eval()(x)[0], x)


@pytest.mark.cuda
def test_mimo_trainer_and_lc_cli_on_the_card(tmp_path, capsys):
    import chip_smoke
    from kaldi_aslp_tpu_torch.cli.__main__ import main
    from kaldi_aslp_tpu_torch.io import (
        int_vector_writer,
        matrix_writer,
        sequential_matrix_reader,
    )

    _card()
    rs = np.random.RandomState(11)
    f1, f2, t1, t2 = (str(tmp_path / n) for n in ("f1", "f2", "t1", "t2"))
    with matrix_writer(f"ark:{f1}") as w1, matrix_writer(f"ark:{f2}") as w2, \
            int_vector_writer(f"ark:{t1}") as wt1, \
            int_vector_writer(f"ark:{t2}") as wt2:
        for u in range(6):
            n = rs.randint(30, 90)
            w1[f"u{u}"] = rs.randn(n, 40).astype(np.float32)
            w2[f"u{u}"] = rs.randn(n, 3).astype(np.float32)
            wt1[f"u{u}"] = rs.randint(0, 10, n).astype(np.int32)
            wt2[f"u{u}"] = rs.randint(0, 7, n).astype(np.int32)
    # no dropout: the trainer's generator draws other masks on the card
    # than on the CPU
    model = str(tmp_path / "zoo.zip")
    chip_smoke.xent_heads(chip_smoke.zoo_net(retention=1.0)).save(model)
    outs = {}
    for device in ("cuda", "cpu"):
        out = str(tmp_path / f"{device}.zip")
        assert main(["aslp-nnet-train-frame-mimo", f"--device={device}",
                     "--objective-function=xent:xent", "--minibatch-size=64",
                     "--randomizer-size=512", "--learn-rate=0.01",
                     f"ark:{f1}", f"ark:{f2}", f"ark:{t1}", f"ark:{t2}",
                     model, out]) == 0
        assert capsys.readouterr().out.count("AvgLoss") == 2
        outs[device] = M.Nnet.load(out, "cpu")[0].state_dict()
    for k, v in outs["cpu"].items():
        assert torch.isfinite(outs["cuda"][k]).all()
        assert _rel(outs["cuda"][k], v) <= GRAD_TOL, k

    # the LC hybrid: init, BPTT steps and the forward, card against CPU
    proto = tmp_path / "lc.proto"
    proto.write_text(
        "<BLstmProjectedStreamsLC> <InputDim> 40 <OutputDim> 64 "
        "<CellDim> 48 <ChunkSize> 16\n<AffineTransform> <InputDim> 64 "
        "<OutputDim> 10\n")
    lc = str(tmp_path / "lc.zip")
    assert main(["aslp-nnet-init", "--device=cuda", str(proto), lc]) == 0
    lls = {}
    for device in ("cuda", "cpu"):
        out = str(tmp_path / f"lc_{device}.zip")
        _reset_counts()
        assert main(["aslp-nnet-train-blstm-streams-lc",
                     f"--device={device}", "--num-streams=4",
                     "--batch-size=20", f"ark:{f1}", f"ark:{t1}", lc,
                     out]) == 0
        if device == "cuda":
            c = _counts()
            assert c["lstmp_train_fwd"][0] > 0 and c["lstmp_train_fwd"][1] == 0
            assert c["lstmp_train_fwd"][0] == c["lstmp_train_bwd"][0]
        ll = str(tmp_path / f"ll_{device}.ark")
        assert main(["aslp-nnet-forward-blstm-lc", f"--device={device}",
                     out, f"ark:{f1}", f"ark:{ll}"]) == 0
        lls[device] = dict(sequential_matrix_reader(f"ark:{ll}"))
    for utt, want in lls["cpu"].items():
        got = torch.from_numpy(lls["cuda"][utt])
        assert _rel(got, torch.from_numpy(want)) <= GRAD_TOL, utt
