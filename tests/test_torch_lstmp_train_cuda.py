"""The unidirectional LSTMP training CUDA kernels (kaldi_aslp_tpu_torch/
csrc/lstmp_train.cu) against their plain PyTorch versions on the card, in
float32, in bf16 (bf16 storage and bf16 products) and in bf16 storage
with float32 products (KALDI_ASLP_LSTM_MXU_FP32), with ragged masks, a
nonzero initial state and nonzero final-state cotangents; and
``LstmpTrainCore``'s gradients on the card against the CPU; the
persistent sweeps at one stream, at widths that are no multiple of 4 and
over two passes of streams (S > 128); two runs bit for bit; and a width
past the persistent plan's capacity, which the plan sends to the per-step
kernels and which trains through ``LstmpTrainCore``.

The kernels have no CPU mode, so these tests skip where there is no CUDA
card.  This file imports no JAX; run it on the card with
``python -m pytest --noconftest tests/test_torch_lstmp_train_cuda.py``.
Tolerance: max |kernel - plain| / max |plain| per output and gradient,
1e-4 in float32 (TF32 off; the sums run in another order) and 2e-2 in
bf16 (one bf16 step is 2^-8 of a value): where the two sides' float32
sums differ in the last bit a bf16 product operand rounds the other way,
and over many frames the recurrence spreads that.  On one frame nothing
spreads, so the bf16 rounding check holds the kernel's float32 outputs
(d_init_c, d_init_r) to 1e-4 and lets no more than 1% of a bf16 output's
values differ at all; the weight reductions, the same torch code on both
sides fed the stored bf16 dxg, move by a bf16 step of one term where one
value flips, and keep 2e-2.  A kernel that skipped the bf16 rounding of
its product operands would miss that check: on one frame at the LSTM
hybrid's widths (C=800, P=512; 16 and 100 streams) the plain version
with that fault lands 1.7e-3 or more away in d_init_c and d_init_r and
changes 9-27% of the stored values (on the CPU).  With float32 products
only the storage rounds and no rounding feeds the recurrence, so that
check holds over every frame."""

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.ops.lstmp_train import (
    LstmpTrainCore,
    lstmp_train_bwd,
    lstmp_train_bwd_reference,
    lstmp_train_fwd,
    lstmp_train_fwd_reference,
    plan_for,
)

F32_TOL, BF16_TOL, BF16_SHARE = 1e-4, 2e-2, 1e-2
REDUCTIONS = ("d_w_gifo_r", "d_w_r_m", "dpeep")
MODES = [False, True]
MODE_IDS = ["f32", "bf16"]


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-6))


def _hold(name, got, want, tol, share_of_bf16=False):
    """``got`` within ``tol`` of ``want``; with ``share_of_bf16``, also at
    most BF16_SHARE of a bf16 output's values differ."""
    assert _rel(got, want) <= tol, (name, _rel(got, want))
    if share_of_bf16 and got.dtype == torch.bfloat16:
        share = float((got != want).float().mean())
        assert share <= BF16_SHARE, (name, share)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _inputs(S, T, C, P, dev, seed, store_bf16):
    rs = np.random.RandomState(seed)

    def u(*shape, scale=0.1):
        return torch.from_numpy(
            (scale * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32)
        ).to(dev)
    lens = rs.randint(1, T + 1, S)
    lens[0] = T
    mask = torch.from_numpy(
        (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)).to(dev)
    st = torch.bfloat16 if store_bf16 else torch.float32
    xg = torch.from_numpy(rs.randn(S, T, 4 * C).astype(np.float32)).to(dev)
    fwd = (xg.to(st), mask, u(4 * C, P), u(P, C), u(3, C),
           u(S, C, scale=0.5), u(S, P, scale=0.5))
    cots = (torch.from_numpy(rs.randn(S, T, P).astype(np.float32)).to(dev)
            .to(st), u(S, C, scale=1.0), u(S, P, scale=1.0))
    return fwd, cots


# one stream; C = 13, P = 7 no multiple of 4; 130 streams take two passes
SHAPES = [(5, 7, 32, 16), (33, 9, 800, 512), (17, 6, 37, 600),
          (1, 5, 800, 512), (6, 4, 13, 7), (130, 3, 64, 40)]
SHAPE_IDS = ["small", "hybrid-width", "ragged-width", "one-stream",
             "odd-width", "two-passes"]
MODE_ARGS = [(False, None), (True, None), (True, False)]
MODE_ARG_IDS = ["f32", "bf16", "bf16-f32-products"]


def _kernels_vs_plain(S, T, C, P, store_bf16, strict, mxu_bf16=None):
    """The kernels against their plain versions; ``strict`` holds the
    kernel's float32 outputs to F32_TOL and the share of differing bf16
    values to BF16_SHARE in bf16 storage (module docstring)."""
    _needs_card()
    fwd_args, (dy, dc, dr) = _inputs(S, T, C, P, torch.device("cuda"),
                                     S * T + C, store_bf16)
    xg, mask, w_r, w_rm, peep, c0, r0 = fwd_args
    # the kernel's float32 outputs in bf16 storage to F32_TOL only if strict
    tol = BF16_TOL if store_bf16 and not strict else F32_TOL
    before = (lstmp_train_fwd.launches, lstmp_train_bwd.launches)
    per_step = (lstmp_train_fwd.per_step, lstmp_train_bwd.per_step)
    persistent = plan_for(S, C, P, xg.device).persistent
    got = lstmp_train_fwd(*fwd_args, 50.0, mxu_bf16)
    want = lstmp_train_fwd_reference(*fwd_args, 50.0, mxu_bf16)
    torch.cuda.synchronize()
    for name, g, w in zip(("gates", "cs", "rs"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _hold(name, g, w, BF16_TOL if store_bf16 else F32_TOL, strict)
    gates, cs, rs = want
    bwd_args = (dy, mask, gates, cs, rs, w_r, w_rm, peep, c0, r0, dc, dr,
                50.0, mxu_bf16)
    got = lstmp_train_bwd(*bwd_args)
    want = lstmp_train_bwd_reference(*bwd_args)
    torch.cuda.synchronize()
    assert (lstmp_train_fwd.launches, lstmp_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert (lstmp_train_fwd.per_step, lstmp_train_bwd.per_step) == tuple(
        n + (not persistent) for n in per_step)
    for name, g, w in zip(("dxg", "d_init_c", "d_init_r", "d_w_gifo_r",
                           "d_w_r_m", "dpeep"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        bf16_tol = g.dtype == torch.bfloat16 or (store_bf16
                                                 and name in REDUCTIONS)
        _hold(name, g, w, BF16_TOL if bf16_tol else tol, strict)


@pytest.mark.cuda
@pytest.mark.parametrize("store_bf16", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("S,T,C,P", SHAPES, ids=SHAPE_IDS)
def test_kernels_match_plain_versions(S, T, C, P, store_bf16):
    _kernels_vs_plain(S, T, C, P, store_bf16, strict=False)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,C,P", SHAPES, ids=SHAPE_IDS)
def test_float32_products_with_bf16_storage(S, T, C, P):
    """KALDI_ASLP_LSTM_MXU_FP32's mode, held strictly over every frame."""
    _kernels_vs_plain(S, T, C, P, True, strict=True, mxu_bf16=False)


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,P", [(S, C, P) for S, _, C, P in SHAPES],
                         ids=SHAPE_IDS)
def test_bf16_rounding_on_one_frame(S, C, P):
    """The bf16 rounding check (module docstring), one frame."""
    _kernels_vs_plain(S, 1, C, P, True, strict=True)


@pytest.mark.cuda
@pytest.mark.parametrize("store_bf16", MODES, ids=MODE_IDS)
def test_core_gradients_on_the_card_match_the_cpu(store_bf16):
    _needs_card()
    S, T, C, P = 6, 11, 64, 32
    rs = np.random.RandomState(9)
    shapes = [(S, T, 4 * C), (4 * C, P), (P, C), (3, C), (S, C), (S, P)]
    arrays = [rs.randn(*shapes[0]).astype(np.float32)] + [
        (0.1 * (2 * rs.rand(*s) - 1)).astype(np.float32) for s in shapes[1:4]
    ] + [rs.randn(*s).astype(np.float32) for s in shapes[4:]]
    mask = np.ones((S, T), np.float32)
    mask[3, 5:] = 0
    mask[5, 1:] = 0
    w_out = rs.randn(S, T, P).astype(np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in arrays]
        xg, w_r, w_rm, peep, c0, r0 = leaves
        ys, fc, fr = LstmpTrainCore.apply(
            xg, torch.tensor(mask, device=dev), w_r, w_rm, peep, c0, r0,
            50.0, store_bf16, store_bf16)
        ((ys.float() * torch.tensor(w_out, device=dev)).sum()
         + fc.sum() + fr.sum()).backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    for name, g, w in zip(["xg", "w_gifo_r", "w_r_m", "peep", "init_c",
                           "init_r"], grads["cuda"], grads["cpu"]):
        assert g.dtype == torch.float32, name
        _hold(name, g, w, BF16_TOL if store_bf16 else F32_TOL)


def _run_pair(fwd_args, cots, mxu_bf16):
    xg, mask, w_r, w_rm, peep, c0, r0 = fwd_args
    dy, dc, dr = cots
    fwd = lstmp_train_fwd(*fwd_args, 50.0, mxu_bf16)
    bwd = lstmp_train_bwd(dy, mask, *fwd, w_r, w_rm, peep, c0, r0, dc, dr,
                          50.0, mxu_bf16)
    torch.cuda.synchronize()
    return (*fwd, *bwd)


@pytest.mark.cuda
@pytest.mark.parametrize("store_bf16,mxu_bf16", MODE_ARGS, ids=MODE_ARG_IDS)
def test_two_runs_give_the_same_bits(store_bf16, mxu_bf16):
    _needs_card()
    S, T, C, P = 33, 9, 800, 512
    fwd_args, cots = _inputs(S, T, C, P, torch.device("cuda"), 5, store_bf16)
    assert plan_for(S, C, P, fwd_args[0].device).persistent
    first = _run_pair(fwd_args, cots, mxu_bf16)
    second = _run_pair(fwd_args, cots, mxu_bf16)
    for g, w in zip(first, second):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_past_the_persistent_capacity_the_per_step_kernels_train():
    """C = 2048, P = 512 in float32 at 100 streams: the plan picks the
    per-step kernels from the shapes, counts them, and LstmpTrainCore
    trains through them as it trains at any width."""
    _needs_card()
    S, T, C, P = 100, 3, 2048, 512
    dev = torch.device("cuda")
    plan = plan_for(S, C, P, dev)
    assert not plan.persistent and "shared memory" in plan.reason
    _kernels_vs_plain(S, T, C, P, False, strict=False)
    fwd_args, cots = _inputs(S, T, C, P, dev, 17, False)
    xg, mask, w_r, w_rm, peep, c0, r0 = fwd_args
    leaves = [t.clone().requires_grad_() for t in (xg, w_r, w_rm, peep)]
    before = (lstmp_train_fwd.per_step, lstmp_train_bwd.per_step)
    ys, fc, fr = LstmpTrainCore.apply(leaves[0], mask, *leaves[1:], c0, r0,
                                      50.0, False, False)
    (ys * cots[0]).sum().backward()
    torch.cuda.synchronize()
    assert (lstmp_train_fwd.per_step, lstmp_train_bwd.per_step) == (
        before[0] + 1, before[1] + 1)
    for t in leaves:
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
