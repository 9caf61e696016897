"""The CTC alpha/beta kernel's launch plan
(kaldi_aslp_tpu_torch/ops/ctc_recursions.py:plan_for), on the CPU.

csrc/ctc_alpha_beta.cu takes the plan as arguments and refuses one that
is not its kernels' layout; what the plan promises is tested here: the
warp kernel with the smallest compiled K (states a lane, 32 K >= U') up
to the source's kRegMaxK, the wide kernel exactly past it, its threads
within the source's limits, ValueError past the wide kernel's capacity,
and the plan's limits equal to the source's constants.  The recursions
themselves against the JAX package are tests/test_torch_ctc.py's."""

import re

import pytest
import torch

from kaldi_aslp_tpu_torch.ops import build
from kaldi_aslp_tpu_torch.ops import ctc_recursions as cab


def _source() -> str:
    return (build.CSRC_DIR / cab.SOURCE).read_text()


def test_plan_limits_match_the_kernel_source():
    source = _source()

    def constant(name):
        found = re.search(rf"constexpr int {name} = (\d+);", source)
        assert found, name
        return int(found.group(1))
    assert constant("kRegMaxK") == cab.REG_MAX_K
    assert constant("kWideMaxThreads") == cab.WIDE_MAX_THREADS
    assert constant("kWidePerThread") == cab.WIDE_PER_THREAD
    # the C entry's switch compiles every K from 1 to kRegMaxK
    compiled = sorted(int(k) for k in re.findall(r"CTC_CASE\((\d+)\)",
                                                 source))
    assert compiled == list(range(1, cab.REG_MAX_K + 1))


def test_register_plan_takes_the_smallest_k_up_to_the_maximum():
    for Up in range(1, 1025):
        plan = cab.plan_for(Up)
        if Up <= 32 * cab.REG_MAX_K:
            k = plan.states_per_lane
            assert not plan.wide and plan.wide_threads == 0, Up
            assert 32 * k >= Up and 32 * (k - 1) < Up, Up
            assert 1 <= k <= cab.REG_MAX_K
        else:
            assert plan.wide and plan.states_per_lane == 0, Up


def test_wide_plan_fits_its_kernel():
    for Up in list(range(1, 1025)) + [4096, 6143, 6144]:
        plan = cab.wide_plan(Up)
        n = plan.wide_threads
        assert n % 32 == 0 and 32 <= n <= cab.WIDE_MAX_THREADS, Up
        assert n * cab.WIDE_PER_THREAD >= Up, Up
        # no warp of the block is idle
        assert n - 32 < Up, Up
        if Up > 32 * cab.REG_MAX_K:
            assert cab.plan_for(Up).wide_threads == n, Up


@pytest.mark.parametrize("Up", [0, 6145, 10_000])
def test_past_the_capacity_the_plan_raises(Up):
    with pytest.raises(ValueError):
        cab.plan_for(Up)


def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    torch.manual_seed(0)
    T, S, Up = 6, 3, 7
    lp = torch.randn(T, S, Up) - 3.0
    skip = (torch.rand(S, Up) > 0.5).float()
    in_lens = torch.tensor([6, 4, 0], dtype=torch.int32)
    exp_lens = torch.tensor([7, 3, 1], dtype=torch.int32)
    before = (cab.ctc_alpha_beta.launches, cab.ctc_alpha_beta.wide)
    alphas, betas = cab.ctc_alpha_beta(lp, skip, in_lens, exp_lens)
    assert (cab.ctc_alpha_beta.launches, cab.ctc_alpha_beta.wide) == before
    assert torch.equal(alphas, cab.ctc_alpha_reference(lp, skip, in_lens,
                                                       exp_lens))
    assert torch.equal(betas, cab.ctc_beta_reference(lp, skip, in_lens,
                                                     exp_lens))
    with pytest.raises(ValueError):
        cab.ctc_alpha_beta(lp, skip[:, :-1], in_lens, exp_lens)
    with pytest.raises(ValueError):
        cab.ctc_alpha_beta(lp, skip, in_lens.long(), exp_lens)
