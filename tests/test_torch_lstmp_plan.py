"""The launch plans of the unidirectional LSTMP training sweeps
(kaldi_aslp_tpu_torch/ops/sweep_plan.py:lstmp_sweep_plan) and of the LSTMP
inference sweeps (lstmp_infer_plan, at the end), on the CPU.

The persistent sweep kernels (csrc/lstmp_train.cu) take their plan as
arguments and check that it gives the byte count of the shared-memory
layout they use; what the plan promises is tested here: each cell (and so
each of its four gate rows of W_r and its column of W_rm) owned by one
block, at most one block an SM; the shared memory within a block's
232,448 bytes and the deepest ring that fits; the plan's limits equal to
the kernel source's; and the capacity rule: past it the plan selects the
per-step kernels, from the shapes alone, and says why."""

import re

import pytest

from kaldi_aslp_tpu_torch.ops import build
from kaldi_aslp_tpu_torch.ops import lstmp_train as lt
from kaldi_aslp_tpu_torch.ops import sweep_plan as sp

H100_SMS = 132
# (S, C, P): the LSTM hybrid at the CLI's, the reference's default and
# the bench's stream counts; widths that are no multiple of 4; one
# stream; two passes of streams; C = 2048 at few streams
SHAPES = [(16, 800, 512), (100, 800, 512), (128, 800, 512), (5, 13, 7),
          (1, 37, 600), (130, 64, 40), (16, 2048, 512), (3, 1, 1)]


@pytest.mark.parametrize("S,C,P", SHAPES)
@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_every_cell_is_owned_once(S, C, P, sms):
    plan = sp.lstmp_sweep_plan(S, C, P, sms)
    if C > sp.UNI_MAX_CELLS * sms:
        # C = 2048 needs 18 cells a block on 114 SMs
        assert not plan.persistent and "cells a block" in plan.reason
        return
    assert plan.persistent, plan.reason
    assert 0 < plan.blocks <= sms
    cells = [j for b in range(plan.blocks) for j in plan.cells(b)]
    assert cells == list(range(C))
    # every block owns at least one cell: none waits at the barriers idle
    assert all(len(plan.cells(b)) > 0 for b in range(plan.blocks))
    assert plan.cells_per_block <= sp.UNI_MAX_CELLS
    # a block's gate rows are its cells' rows of each gate
    rows = sorted(g * C + j for b in range(plan.blocks)
                  for j in plan.cells(b) for g in range(4))
    assert rows == list(range(4 * C))


@pytest.mark.parametrize("S,C,P", SHAPES)
def test_shared_memory_fits_a_block(S, C, P):
    plan = sp.lstmp_sweep_plan(S, C, P, H100_SMS)
    cpb, stages = plan.cells_per_block, plan.stages
    chunks = -(-sp._round_up(P, 4) // sp.UNI_K_CHUNK)
    assert 2 <= stages <= min(sp.UNI_MAX_STAGES, max(2, chunks))
    for backward, smem in ((False, plan.smem_fwd), (True, plan.smem_bwd)):
        assert smem == sp._uni_smem(S, C, P, cpb, stages, backward)
        assert 0 < smem <= sp.SMEM_LIMIT and smem % 16 == 0
        assert plan.kernel_args(backward) == (plan.blocks, cpb, stages, smem)
    # the deepest ring that fits, up to a stage a chunk
    if stages < min(sp.UNI_MAX_STAGES, chunks):
        assert max(sp._uni_smem(S, C, P, cpb, stages + 1, bw)
                   for bw in (False, True)) > sp.SMEM_LIMIT
    # the scratch: one partial [S, pp] a block and the state row
    assert plan.scratch_words() == (plan.blocks + 1) * S * sp._round_up(P, 4)


def test_plan_limits_match_the_kernel_source():
    """The sweep kernels' own limits are the plan's."""
    source = "".join((build.CSRC_DIR / name).read_text() for name in
                     (lt.SOURCE, "lstmp_sweep.cuh", "sweep.cuh"))

    def constant(name):
        found = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);",
                          source)
        assert found, name
        return int(found.group(1))
    assert constant("kSmemLimit") == sp.SMEM_LIMIT
    assert constant("kUniRows") == sp.UNI_ROWS_PER_PASS
    assert constant("kUniKC") == sp.UNI_K_CHUNK
    assert constant("kUniMaxCells") == sp.UNI_MAX_CELLS
    assert constant("kUniMaxStages") == sp.UNI_MAX_STAGES


@pytest.mark.parametrize("S,c_max", [(16, 2112), (64, 2112), (100, 1848),
                                     (128, 1584)])
def test_the_stated_capacity_at_p512(S, c_max):
    """The capacity the kernel note, README and SKILL.md state: at P = 512
    every C <= 2112 at S <= 64, C <= 1848 at S = 100, C <= 1584 at
    S = 128; the next width takes the per-step kernels."""
    assert all(sp.lstmp_sweep_plan(S, C, 512, H100_SMS).persistent
               for C in range(4, c_max + 1, 4))
    beyond = sp.lstmp_sweep_plan(S, c_max + 4, 512, H100_SMS)
    assert not beyond.persistent


@pytest.mark.parametrize("S,C,P,why", [
    (100, 2048, 512, "shared memory"),
    (128, 2048, 512, "shared memory"),
    (4, 2113, 16, "cells a block"),
])
def test_past_the_capacity_the_plan_selects_the_per_step_kernels(S, C, P,
                                                                 why):
    plan = sp.lstmp_sweep_plan(S, C, P, H100_SMS)
    assert not plan.persistent and plan.path == "per_step"
    assert why in plan.reason
    # the C entries' signal for the per-step kernels, and no scratch
    assert plan.kernel_args(False) == plan.kernel_args(True) == (0, 0, 0, 0)
    assert plan.scratch_words() == 0


def test_the_plan_depends_on_the_shapes_alone():
    first = sp.lstmp_sweep_plan(100, 800, 512, H100_SMS)
    assert first == sp.lstmp_sweep_plan(100, 800, 512, H100_SMS)
    assert (first.blocks, first.cells_per_block, first.path) == (
        115, 7, "persistent")
    with pytest.raises(ValueError, match="positive"):
        sp.lstmp_sweep_plan(0, 800, 512, H100_SMS)


# -- the inference sweeps -----------------------------------------------------
#
# csrc/lstmp_forward.cu takes lstmp_infer_plan's plan as arguments and
# checks it against its own layouts; what the plan promises is tested here.

# (S, C, P): the flagship's served chunk, a small batch and a training-size
# batch; the LSTM hybrid's cross-validation chunk
INFER_SHAPES = [(1, 512, 320), (8, 512, 320), (128, 512, 320),
                (100, 800, 512)]


def _check_infer_plan(plan, S, C, P, directions, sms):
    """What every persistent inference plan promises."""
    assert plan.persistent and plan.regime in (sp.FEW, sp.MANY)
    nbd, cpb = plan.blocks_per_dir, plan.cells_per_block
    # all directions' blocks resident at once, one an SM
    assert 0 < directions * nbd <= sms
    assert [j for b in range(nbd) for j in plan.cells(b)] == list(range(C))
    assert all(len(plan.cells(b)) > 0 for b in range(nbd))
    assert cpb <= sp.FWD_MAX_CELLS
    assert 0 < plan.smem <= sp.SMEM_LIMIT and plan.smem % 16 == 0
    if plan.regime == sp.FEW:
        assert S <= sp.FEW_MAX_STREAMS
        assert plan.exchange == (sp.TAGS if S <= sp.FEW_TAG_STREAMS
                                 else sp.BARRIER)
        assert [p for b in range(nbd) for p in plan.cols(b)] == list(range(P))
        assert plan.smem == sp._few_smem(S, C, P, cpb, plan.cols_per_block)
        assert plan.kernel_args() == (
            3 if plan.exchange == sp.TAGS else 1, nbd, cpb,
            plan.cols_per_block, 0, plan.smem)
    else:
        assert plan.exchange == "" and 2 <= plan.stages <= sp.UNI_MAX_STAGES
        assert plan.smem == sp._uni_smem(S, C, P, cpb, plan.stages, False)
        assert plan.kernel_args() == (2, nbd, cpb, 0, plan.stages, plan.smem)
    assert plan.scratch_words() > sp.BAR_WORDS


@pytest.mark.parametrize("S,C,P", INFER_SHAPES)
@pytest.mark.parametrize("directions", [1, 2])
def test_infer_plan_at_the_models_shapes(S, C, P, directions):
    plan = sp.lstmp_infer_plan(S, C, P, directions, H100_SMS)
    _check_infer_plan(plan, S, C, P, directions, H100_SMS)
    assert plan.regime == (sp.FEW if S <= 16 else sp.MANY)
    if C == 512:
        # the flagship: 8 cells on 64 blocks a direction, one direction or
        # two, so a BLSTMP call sums as two LSTMP calls do
        assert (plan.blocks_per_dir, plan.cells_per_block) == (64, 8)
        if plan.regime == sp.FEW:
            assert plan.cols_per_block == 5
            # the resident weights: 8 cells' gate rows and 5 columns' rows
            assert 4 * (4 * 8 * 320 + 5 * 512) == 51200 < plan.smem
    elif directions == 1:
        assert (plan.blocks_per_dir, plan.cells_per_block) == (100, 8)
    else:
        assert (plan.blocks_per_dir, plan.cells_per_block) == (62, 13)


@pytest.mark.parametrize("S", [1, 16, 100, 128])
@pytest.mark.parametrize("directions", [1, 2])
def test_infer_plan_over_the_grid(S, directions):
    """C = 64 .. 2112, P = 64 .. 512 by 16 on 132 SMs: every persistent plan
    keeps its promises, and past the capacity the plan says why."""
    per_dir = H100_SMS // directions
    seen = set()
    for C in range(64, 2113, 16):
        for P in range(64, 513, 16):
            plan = sp.lstmp_infer_plan(S, C, P, directions, H100_SMS)
            seen.add(plan.regime)
            if plan.persistent:
                _check_infer_plan(plan, S, C, P, directions, H100_SMS)
                continue
            assert plan.kernel_args() == (0, 0, 0, 0, 0, 0)
            if C > sp.FWD_MAX_CELLS * per_dir:
                assert "cells a block" in plan.reason
            else:
                assert "shared memory" in plan.reason
                cpb = max(sp.FWD_MIN_CELLS, -(-C // per_dir))
                assert sp._uni_smem(S, C, P, cpb, 2, False) > sp.SMEM_LIMIT
    assert sp.PER_STEP in seen or (directions == 1 and S <= 100)
    assert (sp.FEW in seen) == (S <= 16)


@pytest.mark.parametrize("S,C,P,directions,why", [
    (128, 2048, 512, 1, "shared memory"),
    (100, 2048, 512, 2, "cells a block"),
    (4, 2113, 16, 1, "cells a block"),
])
def test_past_the_capacity_the_infer_plan_selects_the_per_step_kernels(
        S, C, P, directions, why):
    plan = sp.lstmp_infer_plan(S, C, P, directions, H100_SMS)
    assert not plan.persistent and plan.regime == sp.PER_STEP
    assert why in plan.reason
    assert plan == sp.lstmp_infer_per_step(S, C, P, directions, plan.reason)
    # m [S, C], and direction b's state
    sc, spp = sp._round_up(S * C, 4), sp._round_up(S * P, 4)
    assert plan.scratch_words() == sc + (directions - 1) * (sc + spp)


def test_the_stated_inference_capacity_at_p512():
    """What the kernel note, README and SKILL.md state: at P = 512 one
    direction of every C <= 2112 runs persistently at S <= 100 (C = 2048
    at S = 100 on a ring of 2 chunks), at S = 128 every C <= 1848."""
    for S in (1, 16, 64, 100):
        assert all(sp.lstmp_infer_plan(S, C, 512, 1, H100_SMS).persistent
                   for C in range(8, 2113, 8))
    assert sp.lstmp_infer_plan(100, 2048, 512, 1, H100_SMS).stages == 2
    assert all(sp.lstmp_infer_plan(128, C, 512, 1, H100_SMS).persistent
               for C in range(8, 1849, 8))
    assert not sp.lstmp_infer_plan(128, 1856, 512, 1, H100_SMS).persistent
    # two directions: 16 cells on 66 blocks each
    assert sp.lstmp_infer_plan(1, 1056, 512, 2, H100_SMS).persistent
    assert not sp.lstmp_infer_plan(1, 1057, 512, 2, H100_SMS).persistent


def test_infer_plan_limits_match_the_kernel_source():
    source = "".join((build.CSRC_DIR / name).read_text() for name in
                     ("lstmp_forward.cu", "lstmp_sweep.cuh", "sweep.cuh"))

    def constant(name):
        found = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);",
                          source)
        assert found, name
        return int(found.group(1))
    assert constant("kSmemLimit") == sp.SMEM_LIMIT
    assert constant("kFwdThreads") == sp.FWD_THREADS
    assert constant("kFewMaxStreams") == sp.FEW_MAX_STREAMS
    assert constant("kFewTagStreams") == sp.FEW_TAG_STREAMS
    assert constant("kFwdMaxCells") == sp.FWD_MAX_CELLS == sp.UNI_MAX_CELLS
    assert constant("kBarWords") == sp.BAR_WORDS
    assert constant("kUniMaxStages") == sp.UNI_MAX_STAGES
    # a warp a cell: the plan's least cells a block is the block's warps
    assert sp.FWD_MIN_CELLS == sp.FWD_THREADS // 32


def test_the_infer_plan_depends_on_the_shapes_alone():
    first = sp.lstmp_infer_plan(1, 512, 320, 2, H100_SMS)
    assert first == sp.lstmp_infer_plan(1, 512, 320, 2, H100_SMS)
    with pytest.raises(ValueError, match="positive"):
        sp.lstmp_infer_plan(0, 512, 320, 1, H100_SMS)
    with pytest.raises(ValueError, match="directions"):
        sp.lstmp_infer_plan(1, 512, 320, 3, H100_SMS)
    # a card too small for two directions' blocks takes the per-step kernels
    assert not sp.lstmp_infer_plan(1, 512, 320, 2, 1).persistent
