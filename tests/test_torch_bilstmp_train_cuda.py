"""The bidirectional LSTMP training CUDA kernels (kaldi_aslp_tpu_torch/
csrc/bilstmp_train.cu) against their plain PyTorch versions, on the
card, with ragged masks, a nonzero initial state and nonzero final-state
cotangents; the persistent sweeps at stream counts that are no multiple
of the 16-row tile, widths that are no multiple of 16 and the flagship's
widths at S = 128; two runs bit for bit; the per-direction backward
against the fused one bit for bit; the capacity; the hoisted GEMM alone
in both layouts of each operand.

The kernels have no CPU mode, so these tests skip where there is no CUDA
card.  This file imports no JAX; run it on the card with
``python -m pytest --noconftest tests/test_torch_bilstmp_train_cuda.py``.
Tolerance: max |kernel - plain| / max |plain| <= 1e-2 for every stream
and gradient.  Both round to bf16 at the same places but sum in another
order, so a stored bf16 value may differ by one step (2^-8 of itself)."""

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.ops.bilstmp_train import (
    BiLstmpTrainCore,
    bilstmp_gemm_bf16,
    bilstmp_gemm_bf16_reference,
    bilstmp_train_bwd,
    bilstmp_train_bwd_dir,
    bilstmp_train_bwd_reference,
    bilstmp_train_fwd,
    bilstmp_train_fwd_reference,
)

REL_TOL = 1e-2
# the GEMM: exact bf16 products, float32 sums in another order
GEMM_REL_TOL = 1e-5
BF16 = torch.bfloat16


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")


def _rel(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-6))


def _inputs(S, T, D, C, P, dev, seed):
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


# S = 1 and 33 leave the 16-row tile part empty; C = 36, P = 20 are no
# multiple of 16 (and D = 13 no multiple of 8: the GEMM's element-wise
# staging); the flagship's widths at S = 128 with T = 32 split the weight
# gradients' K in two
@pytest.mark.cuda
@pytest.mark.parametrize("S,T,D,C,P", [(5, 7, 40, 32, 16),
                                       (16, 20, 640, 512, 320),
                                       (33, 9, 40, 512, 320),
                                       (1, 6, 40, 512, 320),
                                       (6, 7, 24, 36, 20),
                                       (4, 5, 13, 36, 20),
                                       (128, 32, 640, 512, 320),
                                       (128, 8, 40, 800, 512)])
def test_kernels_match_plain_versions(S, T, D, C, P):
    _needs_card()
    fwd_args, (dy, dc, dr) = _inputs(S, T, D, C, P, torch.device("cuda"),
                                     seed=S * T)
    x, mask, wx, wr, wrm, peep, bias, init_c, init_r = fwd_args
    before = (bilstmp_train_fwd.launches, bilstmp_train_bwd.launches)
    got = bilstmp_train_fwd(*fwd_args)
    want = bilstmp_train_fwd_reference(*fwd_args)
    torch.cuda.synchronize()
    for name, g, w in zip(("ys", "gates", "cs", "rprev", "c_T", "r_T"),
                          got, want):
        assert _rel(g, w) <= REL_TOL, (name, _rel(g, w))
    _, gates, cs, rprev, _, _ = want
    bwd_args = (dy, mask, x, gates, cs, rprev, wx, wr, wrm, peep, init_c,
                dc, dr)
    got = bilstmp_train_bwd(*bwd_args)
    want = bilstmp_train_bwd_reference(*bwd_args)
    torch.cuda.synchronize()
    assert (bilstmp_train_fwd.launches, bilstmp_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for name, g, w in zip(("dx", "d_init_c", "d_init_r", "dwx", "dwr",
                           "dwrm", "dbias", "dpeep"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel(g, w) <= REL_TOL, (name, _rel(g, w))


def _fwd_then_bwd(fwd_args, cots):
    x, mask, wx, wr, wrm, peep, bias, init_c, init_r = fwd_args
    dy, dc, dr = cots
    fwd = bilstmp_train_fwd(*fwd_args)
    _, gates, cs, rprev, _, _ = fwd
    bwd = bilstmp_train_bwd(dy, mask, x, gates, cs, rprev, wx, wr, wrm, peep,
                            init_c, dc, dr)
    torch.cuda.synchronize()
    return fwd, bwd


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,D,C,P", [(33, 9, 40, 512, 320),
                                       (6, 7, 24, 36, 20)])
def test_two_runs_give_the_same_bits(S, T, D, C, P):
    _needs_card()
    fwd_args, cots = _inputs(S, T, D, C, P, torch.device("cuda"), seed=7)
    first = _fwd_then_bwd(fwd_args, cots)
    second = _fwd_then_bwd(fwd_args, cots)
    for a, b in zip(first, second):
        for g, w in zip(a, b):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,D,C,P", [(6, 7, 24, 36, 20),
                                       (128, 32, 640, 512, 320),
                                       (128, 8, 40, 800, 512)])
def test_split_backward_halves_equal_the_fused_backward(S, T, D, C, P):
    _needs_card()
    fwd_args, (dy, dc, dr) = _inputs(S, T, D, C, P, torch.device("cuda"),
                                     seed=S + T)
    x, mask, wx, wr, wrm, peep, bias, init_c, init_r = fwd_args
    _, gates, cs, rprev, _, _ = bilstmp_train_fwd(*fwd_args)
    fused = bilstmp_train_bwd(dy, mask, x, gates, cs, rprev, wx, wr, wrm,
                              peep, init_c, dc, dr)
    zc, zr = torch.zeros_like(dc), torch.zeros_like(dr)
    halves = [bilstmp_train_bwd_dir(
        d, dy, mask, x, gates[d], cs[d], rprev[d], wx[d], wr[d], wrm[d],
        peep[d], init_c if d == 0 else zc, dc if d == 0 else zc,
        dr if d == 0 else zr) for d in range(2)]
    torch.cuda.synchronize()
    dx = (halves[0][0].float() + halves[1][0].float()).to(BF16)
    assert torch.equal(dx, fused[0])
    assert torch.equal(halves[0][1], fused[1])
    assert torch.equal(halves[0][2], fused[2])
    for k in range(3, 8):
        for d in range(2):
            assert torch.equal(halves[d][k], fused[k][d]), (k, d)


# C past 16 cells in each of 66 blocks; P = 1024 at C = 1024 past the
# shared memory at S = 128 (it fits at a few streams)
@pytest.mark.cuda
@pytest.mark.parametrize("S,C,P", [(2, 1057, 16), (128, 1024, 1024)])
def test_past_the_capacity_the_wrappers_raise(S, C, P):
    _needs_card()
    T, D = 3, 8
    fwd_args, (dy, dc, dr) = _inputs(S, T, D, C, P, torch.device("cuda"),
                                     seed=3)
    x, mask, wx, wr, wrm, peep, bias, init_c, init_r = fwd_args
    before = bilstmp_train_fwd.launches
    with pytest.raises(ValueError, match="capacity"):
        bilstmp_train_fwd(*fwd_args)
    gates = torch.zeros((2, S, T, 4 * C), dtype=BF16, device="cuda")
    cs = torch.zeros((2, S, T, C), dtype=BF16, device="cuda")
    rprev = torch.zeros((2, S, T, P), dtype=BF16, device="cuda")
    with pytest.raises(ValueError, match="capacity"):
        bilstmp_train_bwd(dy, mask, x, gates, cs, rprev, wx, wr, wrm, peep,
                          init_c, dc, dr)
    with pytest.raises(ValueError, match="capacity"):
        bilstmp_train_bwd_dir(1, dy, mask, x, gates[1], cs[1], rprev[1],
                              wx[1], wr[1], wrm[1], peep[1], init_c, dc, dr)
    assert bilstmp_train_fwd.launches == before


def _operand(rs, batch, rows, cols, unit_stride_last, dev):
    """A [batch, rows, cols] bf16 operand, stored with unit stride along
    its last dimension or (a transposed view) along its middle one."""
    a = torch.from_numpy(rs.randn(batch, rows, cols).astype(np.float32))
    if not unit_stride_last:
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
    return a.to(dev).to(BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("a_k", [True, False], ids=["A_K", "A_M"])
@pytest.mark.parametrize("b_k", [True, False], ids=["B_K", "B_N"])
# a K of 4096 is cut in two (gemm_splits); 37 x 45 x 29 takes the
# element-wise staging (no 16-byte rows), and so does 64 x 45 x 64 with B
# stored along N (A's rows aligned, B's not)
@pytest.mark.parametrize("M,N,K", [(200, 136, 72), (136, 264, 4096),
                                   (37, 45, 29), (64, 45, 64)])
def test_gemm_matches_its_plain_version(a_k, b_k, M, N, K):
    _needs_card()
    rs = np.random.RandomState(M + N + K)
    dev = torch.device("cuda")
    a = _operand(rs, 2, M, K, a_k, dev)
    b = _operand(rs, 2, K, N, not b_k, dev)
    assert (a.stride(2) == 1) == a_k and (b.stride(1) == 1) == b_k
    before = bilstmp_gemm_bf16.launches
    got = bilstmp_gemm_bf16(a, b)
    want = bilstmp_gemm_bf16_reference(a, b)
    torch.cuda.synchronize()
    assert bilstmp_gemm_bf16.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (2, M, N)
    assert _rel(got, want) <= GEMM_REL_TOL, _rel(got, want)
    # the split-K second pass and the batch do not change a matrix's bits
    alone = bilstmp_gemm_bf16(a[1:], b[1:])
    assert torch.equal(alone[0], got[1])


@pytest.mark.cuda
def test_autograd_core_on_the_card_matches_the_cpu():
    _needs_card()
    S, T, D, C, P = 6, 11, 40, 64, 32
    rs = np.random.RandomState(9)
    names = ["wf_gifo_x", "wb_gifo_x", "wf_gifo_r", "wf_r_m", "peep_f",
             "wb_gifo_r", "wb_r_m", "peep_b", "bias_f", "bias_b"]
    shapes = [(4 * C, D), (4 * C, D), (4 * C, P), (P, C), (3, C),
              (4 * C, P), (P, C), (3, C), (4 * C,), (4 * C,)]
    params = [(0.1 * (2 * rs.rand(*s) - 1)).astype(np.float32)
              for s in shapes]
    x = rs.randn(S, T, D).astype(np.float32)
    mask = np.ones((S, T), np.float32)
    mask[3, 5:] = 0
    c0, r0 = rs.randn(S, C).astype(np.float32), rs.randn(S, P).astype(
        np.float32)
    w_out = rs.randn(S, T, 2 * P).astype(np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in [x, *params, c0, r0]]
        ys, fc, fr = BiLstmpTrainCore.apply(
            leaves[0], torch.tensor(mask, device=dev), *leaves[1:], 50.0)
        loss = (ys.float() * torch.tensor(w_out, device=dev)).sum() \
            + fc.sum() + fr.sum()
        loss.backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    for name, g, w in zip(["x", *names, "init_c", "init_r"], grads["cuda"],
                          grads["cpu"]):
        assert g.dtype == torch.float32, name
        assert _rel(g, w) <= REL_TOL, (name, _rel(g, w))
