"""The launch plan of the unidirectional LSTMP training sweeps
(kaldi_aslp_tpu_torch/ops/sweep_plan.py:lstmp_sweep_plan), on the CPU.

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
    source = (build.CSRC_DIR / lt.SOURCE).read_text() + \
        (build.CSRC_DIR / "sweep.cuh").read_text()

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
