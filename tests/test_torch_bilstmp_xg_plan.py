"""The launch plan of the xg-fed BLSTMP training pair (kaldi_aslp_tpu_torch/
ops/sweep_plan.py:bilstmp_xg_plan), on the CPU.

With bf16 products the pair runs the x-fused pair's tensor-core sweeps
(csrc/bilstmp_sweep.cuh) with a bf16 xg prefetch; with float32 products
the FMA sweeps of csrc/bilstmp_xg_train.cu on lstmp_sweep.cuh's layout
plus the backward's float32 dbias / dpeep sums; past either capacity the
per-step kernels.  The kernels check that a plan gives their layout's byte
count; what the plan promises is tested here: each gate row (and, on the
tensor-core sweeps, each projection column) owned once per direction, the
shared memory within a block's 232,448 bytes, the deepest ring that fits,
a plan (never an error) for every width the JAX core takes, the sweep
wherever the stated capacity says so, and the plan's limits equal to the
kernel sources'."""

import re

import pytest

from kaldi_aslp_tpu_torch.ops import bilstmp_xg_train as xt
from kaldi_aslp_tpu_torch.ops import build
from kaldi_aslp_tpu_torch.ops import sweep_plan as sp

H100_SMS = 132
SMS = [H100_SMS, 114]
MODES = [True, False]
MODE_IDS = ["bf16-products", "f32-products"]
# (S, C, P): the flagship at the bench's and the CLI's stream counts, odd
# widths, one stream, the card tests' widths, and the capacity edges
SHAPES = [(128, 512, 320), (16, 512, 320), (33, 36, 20), (1, 36, 20),
          (5, 32, 16), (6, 64, 32), (24, 512, 320), (128, 656, 512),
          (128, 1024, 224), (48, 1024, 512)]
# the capacity edges on 132 SMs, which 114 SMs take to the per-step kernels
EDGES_PAST_FEWER_SMS = [(128, 656, 512), (128, 1024, 224), (48, 1024, 512)]


def _sweep_bytes(plan, backward):
    """What the plan's layout takes, from the layout functions."""
    cpb = plan.cells_per_block
    stages = plan.stages_bwd if backward else plan.stages_fwd
    if plan.path == sp.TENSOR_CORE:
        return sp._sweep_smem(plan.S, plan.C, plan.P, cpb,
                              plan.cols_per_block, stages, backward,
                              xg_bf16=True)
    return sp._xg_fma_smem(plan.S, plan.C, plan.P, cpb, stages, backward)


@pytest.mark.parametrize("mxu_bf16", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("S,C,P", SHAPES)
def test_every_gate_row_and_column_is_owned_once(S, C, P, sms, mxu_bf16):
    plan = sp.bilstmp_xg_plan(S, C, P, sms, mxu_bf16)
    past = sms < H100_SMS and (S, C, P) in EDGES_PAST_FEWER_SMS
    assert plan.persistent != past, plan.reason
    if past:
        return
    n = plan.blocks_per_dir
    assert 2 * n <= sms
    rows = [g * C + j for b in range(n) for j in plan.cells(b)
            for g in range(4)]
    assert sorted(rows) == list(range(4 * C))
    limit = sp.MAX_CELLS if mxu_bf16 else sp.UNI_MAX_CELLS
    assert all(0 < len(plan.cells(b)) <= limit for b in range(n))
    if plan.path == sp.TENSOR_CORE:
        cols = [p for b in range(n) for p in plan.cols(b)]
        assert sorted(cols) == list(range(P))
        assert plan.cols_per_block % 8 == 0
    else:
        # no column owners: a column of r (dr_prev) sums every block's slab
        assert plan.path == sp.FMA and plan.cols_per_block == 0
        assert plan.cells_per_block >= min(sp.UNI_MIN_CELLS, C)


@pytest.mark.parametrize("mxu_bf16", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("S,C,P", SHAPES)
def test_shared_memory_fits_a_block(S, C, P, mxu_bf16):
    plan = sp.bilstmp_xg_plan(S, C, P, H100_SMS, mxu_bf16)
    assert plan.persistent, plan.reason
    deepest = sp.MAX_STAGES if mxu_bf16 else min(
        sp.UNI_MAX_STAGES, max(2, -(-sp._round_up(P, 4) // sp.UNI_K_CHUNK)))
    for backward in (False, True):
        nbd, cpb, ppb, stages, smem = plan.kernel_args(backward)
        assert (nbd, cpb, ppb) == (plan.blocks_per_dir, plan.cells_per_block,
                                   plan.cols_per_block)
        assert 2 <= stages <= deepest
        assert smem == _sweep_bytes(plan, backward)
        assert 0 < smem <= sp.SMEM_LIMIT and smem % 16 == 0
        if stages < deepest:
            # the deepest ring that fits
            deeper = plan.__class__(**{
                **plan.__dict__,
                ("stages_bwd" if backward else "stages_fwd"): stages + 1})
            assert _sweep_bytes(deeper, backward) > sp.SMEM_LIMIT


def test_the_bf16_prefetch_is_the_x_fused_layout_with_bf16_xg():
    """With bf16 products the plan is sweep_plan's, its forward smaller by
    the float32 xg it does not prefetch: mg * 4 * cells * 2 bytes."""
    for S, C, P in SHAPES:
        xf = sp.sweep_plan(S, C, P, H100_SMS)
        xg = sp.bilstmp_xg_plan(S, C, P, H100_SMS, True)
        assert xg.kernel_args(True) == xf.kernel_args(True)
        assert xg.kernel_args(False)[:3] == xf.kernel_args(False)[:3]
        assert xg.smem_fwd <= xf.smem_fwd


def test_the_flagship_plans_are_pinned():
    """(128, 512, 320): 64 blocks a direction of 8 cells both ways; bf16
    products 8 columns a block, 4-deep rings, 138,368 / 170,240 bytes;
    float32 products a 5-deep ring forward in 229,376 bytes and a 3-deep
    one backward in 200,704 (of which the float32 weight slices 51,200,
    the dgates operand 16,384 and the dbias / dpeep sums 28,672)."""
    tc = sp.bilstmp_xg_plan(128, 512, 320, H100_SMS, True)
    assert tc.path == sp.TENSOR_CORE
    assert tc.kernel_args(False) == (64, 8, 8, 4, 138_368)
    assert tc.kernel_args(True) == (64, 8, 8, 4, 170_240)
    fma = sp.bilstmp_xg_plan(128, 512, 320, H100_SMS, False)
    assert fma.path == sp.FMA
    assert fma.kernel_args(False) == (64, 8, 0, 5, 229_376)
    assert fma.kernel_args(True) == (64, 8, 0, 3, 200_704)
    assert 4 * 7 * 128 * 8 == 28_672
    assert sp._xg_fma_smem(128, 512, 320, 8, 3, True) - \
        sp._uni_smem(128, 512, 320, 8, 3, True) == 28_672


def test_plan_limits_match_the_kernel_sources():
    source = "".join((build.CSRC_DIR / name).read_text() for name in (
        xt.SOURCE, "bilstmp_sweep.cuh", "lstmp_sweep.cuh", "sweep.cuh"))

    def constant(name):
        found = re.search(rf"constexpr (?:int|size_t) {name} = (\d+)[;,]",
                          source)
        assert found, name
        return int(found.group(1))
    assert constant("kSmemLimit") == sp.SMEM_LIMIT
    assert constant("kRowsMax") == sp.ROWS_PER_PASS
    assert constant("kKC") == sp.K_CHUNK
    assert constant("kMaxCells") == sp.MAX_CELLS
    assert constant("kMaxCols") == sp.MAX_COLS
    assert constant("kMaxStages") == sp.MAX_STAGES
    assert constant("kUniRows") == sp.UNI_ROWS_PER_PASS
    assert constant("kUniKC") == sp.UNI_K_CHUNK
    assert constant("kUniMaxCells") == sp.UNI_MAX_CELLS
    assert constant("kUniMaxStages") == sp.UNI_MAX_STAGES
    words = re.search(r"kBarStride = (\d+), kBarWords = (\d+);", source)
    assert int(words.group(2)) == sp.BAR_WORDS
    # both directions' counters fit the words the wrapper allocates
    assert 2 * int(words.group(1)) <= sp.BAR_WORDS


GRID = [(C, P) for C in range(64, 1025, 16) for P in range(64, 513, 16)] + [
    (C, P) for C in (1, 7, 36, 129, 657, 1023) for P in (1, 20, 37, 511)]


def _fma_capacity(S, C, P):
    """The float32 sweep's capacity as the kernel's note states it."""
    return S <= 48 or C <= 656 or P <= 224


@pytest.mark.parametrize("mxu_bf16", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("S", [16, 97, 128])
def test_every_width_has_a_plan(S, mxu_bf16):
    """C <= 1024, P <= 512: a sweep wherever the stated capacity says so,
    else the per-step kernels with the reason; never an error."""
    for C, P in GRID:
        plan = sp.bilstmp_xg_plan(S, C, P, H100_SMS, mxu_bf16)
        if mxu_bf16 or _fma_capacity(S, C, P):
            assert plan.persistent, (C, P, plan.reason)
        if plan.persistent:
            n = plan.blocks_per_dir
            assert [j for b in range(n) for j in plan.cells(b)] == \
                list(range(C))
            assert max(plan.smem_fwd, plan.smem_bwd) <= sp.SMEM_LIMIT
        else:
            assert plan.path == sp.PER_STEP and "232448" in plan.reason
            assert plan.kernel_args(False) == (0, 0, 0, 0, 0)


@pytest.mark.parametrize("S,C,P,mxu_bf16,what", [
    (128, 1057, 512, True, "C <= 1056 on 132 SMs"),
    (128, 1057, 512, False, "more than 16"),
    (128, 1024, 1024, True, "232448"),
    (512, 1024, 512, True, "232448"),
    (128, 1024, 512, False, "232448"),
    (4, 32, 64 * 66 + 1, True, "P <= 4224"),
])
def test_past_the_capacity_the_per_step_plan_is_chosen(S, C, P, mxu_bf16,
                                                       what):
    """From the shapes alone: the plan says why and costs no error."""
    plan = sp.bilstmp_xg_plan(S, C, P, H100_SMS, mxu_bf16)
    assert plan.path == sp.PER_STEP and not plan.persistent
    assert what in plan.reason
    assert plan == sp.bilstmp_xg_plan(S, C, P, H100_SMS, mxu_bf16)


def test_fewer_sms_take_more_cells_a_block():
    """On 114 SMs (57 blocks a direction) C = 512 takes 9 cells a block."""
    for mxu_bf16 in MODES:
        plan = sp.bilstmp_xg_plan(128, 512, 320, 114, mxu_bf16)
        assert (plan.blocks_per_dir, plan.cells_per_block) == (57, 9)


@pytest.mark.parametrize("mxu_bf16", MODES, ids=MODE_IDS)
def test_a_hand_made_per_step_plan_takes_the_per_step_kernels(mxu_bf16):
    """bilstmp_xg_per_step, which the card tests and chip_smoke.py put in
    place of plan_for to time and hold the per-step kernels, is the plan
    bilstmp_xg_plan gives past the capacity, for any shapes."""
    plan = sp.bilstmp_xg_per_step(16, 512, 320, mxu_bf16, "forced")
    assert plan.path == sp.PER_STEP and not plan.persistent
    assert (plan.S, plan.C, plan.P, plan.mxu_bf16) == (16, 512, 320,
                                                       mxu_bf16)
    assert plan.kernel_args(False) == plan.kernel_args(True) == (0,) * 5
    past = sp.bilstmp_xg_plan(128, 1057, 512, H100_SMS, mxu_bf16)
    assert past == sp.bilstmp_xg_per_step(128, 1057, 512, mxu_bf16,
                                          past.reason)
