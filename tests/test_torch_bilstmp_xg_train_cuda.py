"""The xg-fed bidirectional LSTMP training CUDA kernels (kaldi_aslp_tpu_torch/
csrc/bilstmp_xg_train.cu) and the per-direction x-fused backward
(csrc/bilstmp_train.cu's bilstmp_train_bwd_dir) against their plain
PyTorch versions on the card, with ragged masks, a nonzero initial state
and nonzero final-state cotangents, in both product modes, on the planned persistent sweeps and on
the per-step kernels, each twice for the same bits; and the two autograd
paths on the card against the CPU.

The kernels have no CPU mode, so these tests skip where there is no CUDA
card.  This file imports no JAX; run it on the card with
``python -m pytest --noconftest tests/test_torch_bilstmp_xg_train_cuda.py``.
Tolerance, max |kernel - plain| / max |plain| per output and gradient:
  - bf16 products: 1e-2.  Both round to bf16 at the same places but sum
    in another order, so a bf16 operand or stored value may land one
    step (2^-8 of itself) away, and the recurrence carries it;
  - float32 products: only the storage rounds, and no rounded value
    feeds the recurrence, so a stored bf16 value differs only where the
    float32 sums put it on a rounding boundary: 4e-3 (one bf16 step of
    the largest value) and at most 1% of the values differ at all, 1e-4
    for the kernel's float32 outputs (final state, initial-state
    cotangents, dbias, dpeep) and 1e-3 for the dW_r / dW_rm reductions
    fed those bf16 streams;
  - the per-direction backward against the fused one: equal (they share
    their device code)."""

import os

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.ops import bilstmp_train as bt
from kaldi_aslp_tpu_torch.ops import bilstmp_xg_train as xt
from kaldi_aslp_tpu_torch.ops.bilstmp_xg_train import (
    BiLstmpXgTrainCore,
    bilstmp_xg_train_bwd,
    bilstmp_xg_train_bwd_reference,
    bilstmp_xg_train_fwd,
    bilstmp_xg_train_fwd_reference,
)
from kaldi_aslp_tpu_torch.ops.sweep_plan import bilstmp_xg_per_step

BF16_PRODUCTS_TOL = 1e-2
F32_PRODUCTS_TOL = {"bf16": 4e-3, "kernel_f32": 1e-4, "reduction": 1e-3}
BF16_SHARE = 1e-2
BF16 = torch.bfloat16
FWD_NAMES = ("ys", "gates", "cs", "rprev", "c_T", "r_T")
BWD_NAMES = ("dxg", "d_init_c", "d_init_r", "dwr", "dwrm", "dbias", "dpeep")


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-6))


def _hold(name, got, want, mxu_bf16):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.isfinite(got.float()).all(), name
    if mxu_bf16:
        assert _rel(got, want) <= BF16_PRODUCTS_TOL, (name, _rel(got, want))
        return
    if got.dtype == BF16:
        share = float((got != want).float().mean())
        assert share <= BF16_SHARE, (name, share)
        tol = F32_PRODUCTS_TOL["bf16"]
    elif name in ("dwr", "dwrm"):
        tol = F32_PRODUCTS_TOL["reduction"]
    else:
        tol = F32_PRODUCTS_TOL["kernel_f32"]
    assert _rel(got, want) <= tol, (name, _rel(got, want))


def _xg_inputs(S, T, C, P, dev, seed):
    rs = np.random.RandomState(seed)

    def u(*shape, scale=0.1):
        return torch.from_numpy(
            (scale * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32)
        ).to(dev)
    lens = rs.randint(1, T + 1, S)
    lens[0] = T
    mask = torch.from_numpy(
        (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)).to(dev)
    xg = [torch.from_numpy(rs.randn(S, T, 4 * C).astype(np.float32))
          .to(dev).to(BF16) for _ in range(2)]
    fwd = (*xg, mask, u(2, 4 * C, P), u(2, P, C), u(2, 3, C), u(2, 4 * C),
           u(S, C, scale=0.5), u(S, P, scale=0.5))
    cots = (torch.from_numpy(rs.randn(S, T, 2 * P).astype(np.float32))
            .to(dev).to(BF16), u(S, C, scale=1.0), u(S, P, scale=1.0))
    return fwd, cots


# (S, T, C, P): small widths, odd widths (no 16-byte xg groups: the
# element-wise prefetch), the flagship at the CLI's and the bench's stream
# counts, and widths that are no multiple of 8
XG_SHAPES = [(5, 7, 32, 16), (33, 9, 36, 20), (16, 20, 512, 320),
             (128, 24, 512, 320), (33, 9, 600, 37)]


def _run_pair(S, T, C, P, mxu_bf16):
    """The kernels' forward and backward and their plain versions on the
    same inputs; the backward fed the plain forward's streams."""
    fwd_args, (dy, dc, dr) = _xg_inputs(S, T, C, P, torch.device("cuda"),
                                        seed=S * T + C)
    _, _, mask, wr, wrm, peep, _, init_c, _ = fwd_args
    got_f = bilstmp_xg_train_fwd(*fwd_args, 50.0, mxu_bf16)
    want_f = bilstmp_xg_train_fwd_reference(*fwd_args, 50.0, mxu_bf16)
    _, gates, cs, rprev, _, _ = want_f
    bwd_args = (dy, mask, gates, cs, rprev, wr, wrm, peep, init_c, dc, dr,
                50.0, mxu_bf16)
    got_b = bilstmp_xg_train_bwd(*bwd_args)
    want_b = bilstmp_xg_train_bwd_reference(*bwd_args)
    torch.cuda.synchronize()
    return got_f, want_f, got_b, want_b


def _counts():
    return (bilstmp_xg_train_fwd.launches, bilstmp_xg_train_fwd.per_step,
            bilstmp_xg_train_bwd.launches, bilstmp_xg_train_bwd.per_step)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [True, False],
                         ids=["bf16-products", "f32-products"])
@pytest.mark.parametrize("S,T,C,P", XG_SHAPES)
def test_xg_kernels_match_plain_versions(S, T, C, P, mxu_bf16):
    """The planned path: at these widths a persistent sweep each way (the
    counters say so), held to the plain versions."""
    _needs_card()
    plan = xt.plan_for(S, C, P, mxu_bf16, torch.device("cuda"))
    assert plan.persistent, plan.reason
    before = _counts()
    got_f, want_f, got_b, want_b = _run_pair(S, T, C, P, mxu_bf16)
    assert _counts() == (before[0] + 1, before[1], before[2] + 1, before[3])
    for name, g, w in zip(FWD_NAMES, got_f, want_f):
        _hold(name, g, w, mxu_bf16)
    for name, g, w in zip(BWD_NAMES, got_b, want_b):
        _hold(name, g, w, mxu_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [True, False],
                         ids=["bf16-products", "f32-products"])
@pytest.mark.parametrize("S,T,C,P", [(5, 7, 32, 16), (33, 9, 36, 20),
                                     (16, 20, 512, 320)])
def test_forced_per_step_plan_matches_plain_versions(S, T, C, P, mxu_bf16,
                                                     monkeypatch):
    """The per-step kernels, which the plan takes past the sweeps'
    capacity, still hold the plain versions; each call counts once in
    ``per_step``."""
    _needs_card()
    monkeypatch.setattr(xt, "plan_for", lambda S_, C_, P_, mxu, device:
                        bilstmp_xg_per_step(S_, C_, P_, mxu, "forced"))
    before = _counts()
    got_f, want_f, got_b, want_b = _run_pair(S, T, C, P, mxu_bf16)
    assert _counts() == (before[0] + 1, before[1] + 1, before[2] + 1,
                         before[3] + 1)
    for name, g, w in zip(FWD_NAMES, got_f, want_f):
        _hold(name, g, w, mxu_bf16)
    for name, g, w in zip(BWD_NAMES, got_b, want_b):
        _hold(name, g, w, mxu_bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [True, False],
                         ids=["bf16-products", "f32-products"])
@pytest.mark.parametrize("S,T,C,P", [(33, 9, 36, 20), (128, 24, 512, 320)])
def test_xg_kernels_give_the_same_bits_twice(S, T, C, P, mxu_bf16):
    """Every sum has one owner and a fixed order."""
    _needs_card()
    fwd_args, (dy, dc, dr) = _xg_inputs(S, T, C, P, torch.device("cuda"),
                                        seed=7 * S + C)
    _, _, mask, wr, wrm, peep, _, init_c, _ = fwd_args
    runs = []
    for _ in range(2):
        f = bilstmp_xg_train_fwd(*fwd_args, 50.0, mxu_bf16)
        _, gates, cs, rprev, _, _ = f
        b = bilstmp_xg_train_bwd(dy, mask, gates, cs, rprev, wr, wrm, peep,
                                 init_c, dc, dr, 50.0, mxu_bf16)
        runs.append((*f, *b))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a, b), i


def _xf_inputs(S, T, D, C, P, dev, seed):
    rs = np.random.RandomState(seed)

    def u(*shape, scale=0.1):
        return torch.from_numpy(
            (scale * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32)
        ).to(dev)
    lens = rs.randint(1, T + 1, S)
    lens[0] = T
    mask = torch.from_numpy(
        (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)).to(dev)
    x = torch.from_numpy(rs.randn(S, T, D).astype(np.float32)).to(dev)
    fwd = (x.to(BF16), mask, u(2, 4 * C, D).to(BF16),
           u(2, 4 * C, P).to(BF16), u(2, P, C).to(BF16), u(2, 3, C),
           u(2, 4 * C), u(S, C, scale=0.5), u(S, P, scale=0.5))
    cots = (torch.from_numpy(rs.randn(S, T, 2 * P).astype(np.float32))
            .to(dev).to(BF16), u(S, C, scale=1.0), u(S, P, scale=1.0))
    return fwd, cots


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,D,C,P", [(5, 7, 40, 32, 16),
                                       (16, 20, 640, 512, 320),
                                       (33, 9, 40, 512, 320)])
def test_bwd_dir_matches_its_plain_version_and_the_fused_kernel(S, T, D, C,
                                                                P):
    _needs_card()
    (x, mask, wx, wr, wrm, peep, bias, init_c, init_r), (dy, dc, dr) = \
        _xf_inputs(S, T, D, C, P, torch.device("cuda"), seed=S * T + D)
    _, gates, cs, rprev, _, _ = bt.bilstmp_train_fwd(
        x, mask, wx, wr, wrm, peep, bias, init_c, init_r)
    fused = bt.bilstmp_train_bwd(dy, mask, x, gates, cs, rprev, wx, wr, wrm,
                                 peep, init_c, dc, dr)
    zc, zr = torch.zeros_like(dc), torch.zeros_like(dr)
    halves = []
    before = bt.bilstmp_train_bwd_dir.launches
    for d in range(2):
        args = (d, dy, mask, x, gates[d], cs[d], rprev[d], wx[d], wr[d],
                wrm[d], peep[d], init_c if d == 0 else zc,
                dc if d == 0 else zc, dr if d == 0 else zr)
        got = bt.bilstmp_train_bwd_dir(*args)
        want = bt.bilstmp_train_bwd_dir_reference(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(("dx", "d_init_c", "d_init_r", "dwx", "dwr",
                               "dwrm", "dbias", "dpeep"), got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert _rel(g, w) <= BF16_PRODUCTS_TOL, (d, name, _rel(g, w))
        halves.append(got)
    assert bt.bilstmp_train_bwd_dir.launches == before + 2
    dx = (halves[0][0].float() + halves[1][0].float()).to(BF16)
    split = [dx, halves[0][1], halves[0][2],
             *(torch.stack([h[k] for h in halves]) for k in range(3, 8))]
    for g, w in zip(split, fused):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_bf16", [True, False],
                         ids=["bf16-products", "f32-products"])
def test_xg_core_on_the_card_matches_the_cpu(mxu_bf16):
    _needs_card()
    S, T, C, P = 6, 11, 64, 32
    rs = np.random.RandomState(10)
    shapes = [(4 * C, P), (P, C), (3, C), (4 * C, P), (P, C), (3, C),
              (4 * C,), (4 * C,)]
    params = [(0.1 * (2 * rs.rand(*s) - 1)).astype(np.float32)
              for s in shapes]
    xg = [rs.randn(S, T, 4 * C).astype(np.float32) for _ in range(2)]
    mask = np.ones((S, T), np.float32)
    mask[3, 5:] = 0
    c0, r0 = rs.randn(S, C).astype(np.float32), rs.randn(S, P).astype(
        np.float32)
    w_out = rs.randn(S, T, 2 * P).astype(np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        xgs = [torch.tensor(a, device=dev).to(BF16).requires_grad_()
               for a in xg]
        leaves = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in [*params, c0, r0]]
        ys, fc, fr = BiLstmpXgTrainCore.apply(
            *xgs, torch.tensor(mask, device=dev), *leaves, 50.0, mxu_bf16)
        loss = (ys.float() * torch.tensor(w_out, device=dev)).sum() \
            + fc.sum() + fr.sum()
        loss.backward()
        grads[dev] = [t.grad.cpu() for t in xgs + leaves]
    tol = BF16_PRODUCTS_TOL if mxu_bf16 else F32_PRODUCTS_TOL["bf16"]
    for i, (g, w) in enumerate(zip(grads["cuda"], grads["cpu"])):
        assert g.dtype == w.dtype, i
        assert _rel(g, w) <= tol, (i, _rel(g, w))


@pytest.mark.cuda
def test_split_backward_core_on_the_card_matches_the_cpu(monkeypatch):
    _needs_card()
    monkeypatch.setitem(os.environ, "KALDI_ASLP_LSTM_SPLIT_BWD", "1")
    S, T, D, C, P = 6, 11, 40, 64, 32
    rs = np.random.RandomState(11)
    shapes = [(4 * C, D), (4 * C, D), (4 * C, P), (P, C), (3, C),
              (4 * C, P), (P, C), (3, C), (4 * C,), (4 * C,)]
    params = [(0.1 * (2 * rs.rand(*s) - 1)).astype(np.float32)
              for s in shapes]
    x = rs.randn(S, T, D).astype(np.float32)
    mask = np.ones((S, T), np.float32)
    mask[2, 4:] = 0
    c0, r0 = rs.randn(S, C).astype(np.float32), rs.randn(S, P).astype(
        np.float32)
    w_out = rs.randn(S, T, 2 * P).astype(np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        before = bt.bilstmp_train_bwd_dir.launches
        leaves = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in [x, *params, c0, r0]]
        ys, fc, fr = bt.BiLstmpTrainCore.apply(
            leaves[0], torch.tensor(mask, device=dev), *leaves[1:], 50.0)
        ((ys.float() * torch.tensor(w_out, device=dev)).sum() + fc.sum()
         + fr.sum()).backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
        assert bt.bilstmp_train_bwd_dir.launches == before + (
            2 if dev == "cuda" else 0)
    for i, (g, w) in enumerate(zip(grads["cuda"], grads["cpu"])):
        assert _rel(g, w) <= BF16_PRODUCTS_TOL, (i, _rel(g, w))
