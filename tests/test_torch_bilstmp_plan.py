"""The launch plan of the x-fused BLSTMP sweeps (kaldi_aslp_tpu_torch/ops/
sweep_plan.py:sweep_plan) and the hoisted GEMM's plain version
(ops/bilstmp_train.py), on the CPU.

The persistent sweep kernels (csrc/bilstmp_sweep.cuh) take their plan as
arguments and check that it gives the byte count of the shared-memory
layout they use; what the plan promises is tested here: each block's
cells and projection columns, each owned once per direction; its shared
memory within a block's 232,448 bytes; a plan for every width inside the
stated capacity (C <= 1024, P <= 512 at every S <= 128); the
per-direction backward summing every column over K in the fused
backward's order; a ValueError past the capacity; the plan's limits equal
to the kernel source's.  The GEMM's
plain version is held to the products ``bilstmp_train_bwd_dir_reference``
computes."""

import re

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.ops import bilstmp_train as bt
from kaldi_aslp_tpu_torch.ops import build
from kaldi_aslp_tpu_torch.ops import sweep_plan as sp

H100_SMS = 132
# (S, C, P): the flagship at the bench's and the CLI's stream counts,
# widths that are no multiple of 16, one stream, the widths of the card
# tests, and the capacity edge
SHAPES = [(128, 512, 320), (16, 512, 320), (33, 36, 20), (1, 36, 20),
          (5, 32, 16), (6, 64, 32), (128, 1024, 512), (128, 1056, 512)]


@pytest.mark.parametrize("S,C,P", SHAPES)
@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_every_gate_row_and_column_is_owned_once(S, C, P, sms):
    if C > sp.MAX_CELLS * (sms // 2):
        pytest.skip("past this card's capacity (tested below)")
    plan = sp.sweep_plan(S, C, P, sms)
    assert 2 * plan.blocks_per_dir <= sms
    cells = [j for b in range(plan.blocks_per_dir) for j in plan.cells(b)]
    cols = [p for b in range(plan.blocks_per_dir) for p in plan.cols(b)]
    assert sorted(cells) == list(range(C))
    assert sorted(cols) == list(range(P))
    # a block's gate rows are its cells' rows of each gate
    rows = [g * C + j for b in range(plan.blocks_per_dir)
            for j in plan.cells(b) for g in range(4)]
    assert sorted(rows) == list(range(4 * C))
    for b in range(plan.blocks_per_dir):
        assert len(plan.cells(b)) <= sp.MAX_CELLS
        assert len(plan.cols(b)) <= sp.MAX_COLS
    # columns in whole groups of 8: the 16-byte loads of dy
    assert plan.cols_per_block % 8 == 0

@pytest.mark.parametrize("S,C,P", SHAPES)
def test_shared_memory_fits_a_block(S, C, P):
    plan = sp.sweep_plan(S, C, P, H100_SMS)
    for backward, stages, smem in ((False, plan.stages_fwd, plan.smem_fwd),
                                   (True, plan.stages_bwd, plan.smem_bwd)):
        assert 2 <= stages <= sp.MAX_STAGES
        assert smem == sp._sweep_smem(S, C, P, plan.cells_per_block,
                                      plan.cols_per_block, stages, backward)
        assert 0 < smem <= 232_448
        assert smem % 16 == 0
        assert plan.kernel_args(backward)[-2:] == (stages, smem)
        # the deepest ring that fits
        if stages < sp.MAX_STAGES:
            assert sp._sweep_smem(S, C, P, plan.cells_per_block,
                                  plan.cols_per_block, stages + 1,
                                  backward) > 232_448


@pytest.mark.parametrize("S,C,P", [(128, 512, 320), (33, 36, 20),
                                   (128, 1024, 512)])
@pytest.mark.parametrize("T,D", [(400, 640), (7, 13)])
def test_split_backward_sums_each_column_in_the_fused_order(S, C, P, T, D):
    """A launch of direction d alone takes the fused launch's plan and
    split-K counts, so each output element is summed over the same K
    chunks (the sweep) and the same K slices (the hoisted GEMM); only the
    workspace halves."""
    fused_args, fused_splits, fused_words = bt.bwd_launch(
        2, S, T, D, C, P, H100_SMS)
    alone_args, alone_splits, alone_words = bt.bwd_launch(
        1, S, T, D, C, P, H100_SMS)
    assert alone_args == fused_args
    assert alone_splits == fused_splits
    assert fused_words == 2 * alone_words
    plan = sp.sweep_plan(S, C, P, H100_SMS)
    assert fused_args == plan.kernel_args(backward=True)
    # the sweep's chunks tile K, padded to 16, once and in increasing order
    for product, k in (("gates", P), ("proj", C), ("dm", P), ("dr", 4 * C)):
        chunks = plan.k_chunks(product)
        ends = [0] + [k0 + w for k0, w in chunks]
        assert [k0 for k0, _ in chunks] == ends[:-1]
        k_pad = 4 * sp._round_up(C, 16) if product == "dr" else \
            sp._round_up(k, 16)
        assert ends[-1] == k_pad
        assert all(0 < w <= sp.K_CHUNK and w % 16 == 0 for _, w in chunks)
    # the weight gradients' split-K workspace fits the largest split product
    G = 4 * C
    for k, (M, N) in zip(fused_splits, ((G, D), (G, P), (P, C))):
        assert k == bt.gemm_splits(M, N, S * T, H100_SMS)
        if k > 1:
            assert k * 2 * M * N <= fused_words


def test_plan_limits_match_the_kernel_source():
    """The sweep kernels' own limits are the plan's."""
    source = "".join((build.CSRC_DIR / name).read_text() for name in (
        bt.SOURCE, "bilstmp_sweep.cuh", "sweep.cuh"))

    def constant(name):
        found = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);",
                          source)
        assert found, name
        return int(found.group(1))
    assert constant("kSmemLimit") == sp.SMEM_LIMIT
    assert constant("kRowsMax") == sp.ROWS_PER_PASS
    assert constant("kKC") == sp.K_CHUNK
    assert constant("kMaxCells") == sp.MAX_CELLS
    assert constant("kMaxCols") == sp.MAX_COLS
    assert constant("kMaxStages") == sp.MAX_STAGES


@pytest.mark.parametrize("S,C,P,what", [
    (128, 1057, 512, "C <= 1056 on 132 SMs"),
    (128, 1024, 1024, "232448"),
    (512, 1024, 512, "232448"),
    (4, 32, 64 * 66 + 1, "P <= 4224"),
])
def test_past_the_capacity_the_plan_raises(S, C, P, what):
    with pytest.raises(ValueError, match="capacity") as err:
        sp.sweep_plan(S, C, P, H100_SMS)
    assert what in str(err.value)


def test_the_capacity_covers_c1024_p512():
    plan = sp.sweep_plan(128, 1024, 512, H100_SMS)
    assert plan.cells_per_block <= sp.MAX_CELLS
    assert max(plan.smem_fwd, plan.smem_bwd) <= sp.SMEM_LIMIT


GRID = [(C, P) for C in range(64, 1025, 16) for P in range(64, 513, 16)]


@pytest.mark.parametrize("S", [16, 64, 97, 128])
def test_every_width_inside_the_stated_capacity_has_a_plan(S):
    """C = 64..1024 and P = 64..512 by 16: each point plans, owns each cell
    and column once, and fits (at S = 97 and 128, (800, 512) raised before
    the columns were spread over as many blocks as their groups need)."""
    for C, P in GRID:
        plan = sp.sweep_plan(S, C, P, H100_SMS)
        n = plan.blocks_per_dir
        assert n <= H100_SMS // 2
        assert [j for b in range(n) for j in plan.cells(b)] == list(range(C))
        assert [p for b in range(n) for p in plan.cols(b)] == list(range(P))
        assert plan.cols_per_block == 8
        assert max(plan.smem_fwd, plan.smem_bwd) <= sp.SMEM_LIMIT


def test_the_flagship_plan_is_unchanged():
    """(128, 512, 320): 64 blocks a direction of 8 cells and 8 columns,
    4-deep rings, 146,560 / 170,240 bytes, as the sweeps were timed."""
    plan = sp.sweep_plan(128, 512, 320, H100_SMS)
    assert plan.kernel_args(False) == (64, 8, 8, 4, 146_560)
    assert plan.kernel_args(True) == (64, 8, 8, 4, 170_240)


def test_past_128_streams_the_error_names_the_streams_that_fit():
    with pytest.raises(ValueError, match="capacity") as err:
        sp.sweep_plan(256, 1024, 512, H100_SMS)
    s_max = int(str(err.value).split("at most S=")[1].split()[0])
    assert 128 <= s_max < 256
    sp.sweep_plan(s_max, 1024, 512, H100_SMS)
    with pytest.raises(ValueError, match="capacity"):
        sp.sweep_plan(s_max + 1, 1024, 512, H100_SMS)


def test_gemm_splits_depend_on_the_shape_alone():
    # the flagship's weight gradients at S = 128, T = 400
    K = 128 * 400
    assert [bt.gemm_splits(M, N, K, H100_SMS)
            for M, N in ((2048, 640), (2048, 320), (320, 512))] == [2, 3, 11]
    # short K is never split; a full card of tiles is not split either
    assert bt.gemm_splits(320, 512, 2047, H100_SMS) == 1
    assert bt.gemm_splits(51200, 2048, 640, H100_SMS) == 1


def _dir_inputs(S, T, C, P, seed):
    """Inputs to the per-direction backward whose products can be read
    back: x the identity (D = S * T), so dW_x is dgates^T; W_r zero and an
    all-ones mask, so dr_new is bf16(dy (+ d_r_T at the first frame))."""
    rs = np.random.RandomState(seed)
    D, G = S * T, 4 * C

    def u(*shape, scale=0.1):
        return torch.from_numpy(
            (scale * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32))
    x = torch.eye(D).reshape(S, T, D).to(torch.bfloat16)
    mask = torch.ones(S, T)
    # activated gates in (0, 1) for i, f, o and (-1, 1) for g
    gates = torch.cat([u(S, T, C, scale=0.9), 0.5 + u(S, T, 3 * C, scale=4)],
                      dim=-1).to(torch.bfloat16)
    cs = u(S, T, C, scale=2.0).to(torch.bfloat16)
    rprev = u(S, T, P, scale=1.0).to(torch.bfloat16)
    dy = torch.from_numpy(rs.randn(S, T, 2 * P).astype(np.float32)).to(
        torch.bfloat16)
    bf16 = torch.bfloat16
    return (dy, mask, x, gates, cs, rprev, u(G, D).to(bf16),
            torch.zeros(G, P, dtype=bf16), u(P, C).to(bf16), u(3, C),
            u(S, C, scale=0.5), u(S, C), u(S, P))


@pytest.mark.parametrize("d", [0, 1])
def test_gemm_plain_version_gives_the_backward_products(d):
    S, T, C, P = 3, 4, 12, 8
    args = _dir_inputs(S, T, C, P, seed=11 + d)
    dy, mask, x, gates, cs, rprev, wx, wr, wrm, peep, init_c, dc, dr = args
    if d == 1:
        init_c, dc, dr = (torch.zeros_like(init_c), torch.zeros_like(dc),
                          torch.zeros_like(dr))
    dx, _, _, dwx, dwr, dwrm, _, _ = bt.bilstmp_train_bwd_dir_reference(
        d, dy, mask, x, gates, cs, rprev, wx, wr, wrm, peep, init_c, dc, dr)
    # exact: x is the identity
    dgates = dwx.t().contiguous().to(torch.bfloat16)
    assert torch.equal(dgates.float(), dwx.t())
    # dx = bf16(dgates . W_x): A unit-stride along K, B along N
    got = bt.bilstmp_gemm_bf16(dgates, wx)
    assert got.dtype == torch.float32 and got.shape == (S * T, S * T)
    assert torch.equal(got.to(torch.bfloat16).reshape(S, T, S * T), dx)
    # dW_r = dgates^T . r_prev: A unit-stride along M (a transposed view)
    got = bt.bilstmp_gemm_bf16(dgates.t(), rprev.reshape(S * T, P))
    torch.testing.assert_close(got, dwr, rtol=1e-6, atol=1e-6)
    # dW_rm = dr_new^T . m: dr_new = bf16(dy + d_r_T at the first frame)
    dyd = dy[:, :, d * P:(d + 1) * P].float()
    t0 = T - 1 if d == 0 else 0
    dyd[:, t0] += dr
    drn = dyd.to(torch.bfloat16).reshape(S * T, P)
    g, i, f, o = gates.float().split(C, dim=-1)
    cp = torch.cat([init_c[:, None], cs[:, :-1].float()], 1) if d == 0 \
        else torch.cat([cs[:, 1:].float(), torch.zeros(S, 1, C)], 1)
    m = (o * torch.tanh(torch.clamp(f * cp + i * g, -50.0, 50.0))).to(
        torch.bfloat16).reshape(S * T, C)
    got = bt.bilstmp_gemm_bf16(drn.t(), m)
    torch.testing.assert_close(got, dwrm, rtol=1e-6, atol=1e-6)


def test_gemm_batches_share_an_operand_through_a_zero_stride():
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(10, 6).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy(rs.randn(2, 7, 6).astype(np.float32)).to(
        torch.bfloat16)
    # xg[d] = x . W_x[d]^T, as the forward computes it
    got = bt.bilstmp_gemm_bf16(x.expand(2, -1, -1), w.transpose(1, 2))
    for d in range(2):
        torch.testing.assert_close(got[d], x.float() @ w[d].float().t(),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="chain"):
        bt.bilstmp_gemm_bf16(x, w[0])
