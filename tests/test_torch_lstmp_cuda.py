"""The LSTMP inference kernel (kaldi_aslp_tpu_torch/csrc/lstmp_forward.cu)
against its plain PyTorch version, on the card: one direction
(``lstmp_forward``) and both directions of a BLSTMP layer in one launch
(``blstmp_forward``), in the few-stream sweep (both exchanges), the
many-stream sweep and the per-step kernels.

The kernel has no CPU mode, so these tests skip where there is no CUDA
card.  This file imports no JAX (the machine with the card has none);
run it there with ``python -m pytest --noconftest
tests/test_torch_lstmp_cuda.py -q``, since tests/conftest.py loads JAX.
Tolerance rtol=atol=1e-4: float32 on both sides, the kernel sums the
recurrent products in another order, and the cell is contractive at the
model's init scale."""

import dataclasses

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.ops import lstmp as lstmp_ops
from kaldi_aslp_tpu_torch.ops import sweep_plan as sp
from kaldi_aslp_tpu_torch.ops.lstmp import (
    blstmp_forward,
    blstmp_forward_reference,
    lstmp_forward,
    lstmp_forward_reference,
)

TOL = dict(rtol=1e-4, atol=1e-4)
FLAGSHIP, HYBRID, ODD = (512, 320), (800, 512), (36, 20)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(dev, S, T, C, P, seed=0):
    """(xg_f, xg_b, mask, weights_f, weights_b, c0, r0) on the card: ragged
    masks, the model's init scale, a nonzero initial state."""
    rs = np.random.RandomState(seed + 1000 * S + T + C)

    def u(*shape, scale=0.1):
        return torch.from_numpy(
            (scale * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32)).to(dev)
    xgs = [torch.from_numpy(rs.randn(S, T, 4 * C).astype(np.float32)).to(dev)
           for _ in range(2)]
    lens = np.full(S, T)
    if S > 1:
        lens = rs.randint(max(T // 4, 1), T + 1, size=S)
        lens[0] = T
    mask = torch.from_numpy(
        (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)).to(dev)
    weights = [(u(4 * C, P), u(P, C), u(3, C)) for _ in range(2)]
    return (*xgs, mask, *weights, u(S, C, scale=0.5), u(S, P, scale=0.5))


def _one(args):
    xg_f, _, mask, w_f, _, c0, r0 = args
    return (xg_f, mask, *w_f, c0, r0)


def _run(directions, args):
    """(kernel outputs, plain outputs, the wrapper) for a direction count."""
    if directions == 1:
        return (lstmp_forward(*_one(args)),
                lstmp_forward_reference(*_one(args)), lstmp_forward)
    return (blstmp_forward(*args), blstmp_forward_reference(*args),
            blstmp_forward)


def _hold(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("directions", [1, 2])
@pytest.mark.parametrize("S,T,widths", [
    (1, 1, FLAGSHIP), (1, 16, FLAGSHIP), (1, 400, FLAGSHIP),
    (2, 16, FLAGSHIP), (8, 16, FLAGSHIP), (8, 400, FLAGSHIP),
    (16, 20, HYBRID), (4, 16, HYBRID), (3, 16, ODD), (13, 1, ODD),
    (33, 16, FLAGSHIP), (100, 20, HYBRID), (128, 1, FLAGSHIP),
    (128, 400, FLAGSHIP), (130, 16, ODD), (33, 16, ODD), (130, 16, FLAGSHIP)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_cuda_kernel_matches_plain_version(S, T, widths, directions):
    dev = _card()
    C, P = widths
    args = _args(dev, S, T, C, P)
    plan = lstmp_ops.plan_for(S, C, P, directions, dev)
    # these shapes are within the sweeps' capacity, on the regime the
    # stream count picks
    assert plan.regime == (sp.FEW if S <= sp.FEW_MAX_STREAMS else sp.MANY)
    wrapper = lstmp_forward if directions == 1 else blstmp_forward
    before = (wrapper.launches, wrapper.per_step)
    got, want, _ = _run(directions, args)
    _hold(got, want)
    assert (wrapper.launches, wrapper.per_step) == (before[0] + 1, before[1])
    # a second run gives the same bits
    again, _, _ = _run(directions, args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,widths", [
    (1, 16, FLAGSHIP), (1, 400, FLAGSHIP), (8, 200, FLAGSHIP),
    (16, 20, HYBRID), (3, 16, ODD), (128, 400, FLAGSHIP), (130, 16, ODD)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_two_directions_equal_two_one_direction_calls_bit_for_bit(S, T,
                                                                  widths):
    """Few streams: every sum's order is the plan's business nowhere.  Many
    streams: where one direction and two take the same cells a block (as at
    these widths), the slabs add in the same order."""
    dev = _card()
    C, P = widths
    args = _args(dev, S, T, C, P, seed=3)
    xg_f, xg_b, mask, w_f, w_b, c0, r0 = args
    one, two = (lstmp_ops.plan_for(S, C, P, n, dev) for n in (1, 2))
    assert one.regime == sp.FEW or one.cells_per_block == two.cells_per_block
    ys, c, r = blstmp_forward(*args)
    y_f, c_f, r_f = lstmp_forward(xg_f, mask, *w_f, c0, r0)
    y_b, _, _ = lstmp_forward(
        torch.flip(xg_b, (1,)).contiguous(),
        torch.flip(mask, (1,)).contiguous(), *w_b, torch.zeros_like(c0),
        torch.zeros_like(r0))
    torch.cuda.synchronize()
    assert torch.equal(ys[..., :P], y_f)
    assert torch.equal(ys[..., P:], torch.flip(y_b, (1,)))
    assert torch.equal(c, c_f) and torch.equal(r, r_f)


@pytest.mark.cuda
@pytest.mark.parametrize("directions", [1, 2])
@pytest.mark.parametrize("S", [1, 4])
def test_the_two_exchanges_of_the_few_stream_sweep_agree(S, directions):
    """Up to 4 streams the plan hands the state off by tagged values; the
    barrier exchange under the same plan gives the same bits."""
    dev = _card()
    C, P = FLAGSHIP
    args = _args(dev, S, 40, C, P, seed=5)
    plan = lstmp_ops.plan_for(S, C, P, directions, dev)
    assert (plan.regime, plan.exchange) == (sp.FEW, sp.TAGS)
    xgs, ws = list(args[:directions]), list(args[3:3 + directions])
    tags = lstmp_ops._launch(plan, xgs, args[2], ws, args[5], args[6], 50.0)
    barrier = lstmp_ops._launch(
        dataclasses.replace(plan, exchange=sp.BARRIER), xgs, args[2], ws,
        args[5], args[6], 50.0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(tags, barrier))


@pytest.mark.cuda
@pytest.mark.parametrize("S,C,P,directions,why", [
    (128, 2048, 512, 1, "shared memory"),
    (100, 2048, 512, 2, "cells a block"),
    (1, 2048, 512, 2, "cells a block")])
def test_past_the_capacity_the_call_takes_the_per_step_kernels(
        S, C, P, directions, why):
    dev = _card()
    args = _args(dev, S, 6, C, P)
    plan = lstmp_ops.plan_for(S, C, P, directions, dev)
    assert not plan.persistent and why in plan.reason
    wrapper = lstmp_forward if directions == 1 else blstmp_forward
    before = (wrapper.launches, wrapper.per_step)
    got, want, _ = _run(directions, args)
    _hold(got, want)
    assert (wrapper.launches, wrapper.per_step) == (before[0] + 1,
                                                    before[1] + 1)


@pytest.mark.cuda
def test_c2048_at_100_streams_runs_persistently_in_one_direction():
    """The forward-only layout holds what the training pair's cannot: 16
    cells a block on a ring of 2 chunks."""
    dev = _card()
    args = _args(dev, 100, 6, 2048, 512)
    plan = lstmp_ops.plan_for(100, 2048, 512, 1, dev)
    assert (plan.regime, plan.cells_per_block, plan.stages) == (sp.MANY, 16, 2)
    got, want, _ = _run(1, args)
    _hold(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 8])
def test_25_chunks_of_16_frames_against_one_call_of_400(S):
    """A served utterance: direction f carries its state over the chunks
    and gives the bits of one long call; direction b restarts per chunk."""
    dev = _card()
    C, P = FLAGSHIP
    xg_f, xg_b, mask, w_f, w_b, c0, r0 = _args(dev, S, 400, C, P, seed=7)
    whole, c_w, r_w = blstmp_forward(xg_f, xg_b, mask, w_f, w_b, c0, r0)
    c, r, parts = c0, r0, []
    for t0 in range(0, 400, 16):
        sl = slice(t0, t0 + 16)
        ys, c, r = blstmp_forward(
            xg_f[:, sl].contiguous(), xg_b[:, sl].contiguous(),
            mask[:, sl].contiguous(), w_f, w_b, c, r)
        parts.append(ys)
    chunked = torch.cat(parts, dim=1)
    want, c_p, r_p = lstmp_forward_reference(xg_f, mask, *w_f, c0, r0)
    torch.cuda.synchronize()
    assert torch.equal(chunked[..., :P], whole[..., :P])
    assert torch.equal(c, c_w) and torch.equal(r, r_w)
    _hold((chunked[..., :P], c, r), (want, c_p, r_p))


@pytest.mark.cuda
def test_the_call_reads_the_state_where_it_lies_and_refuses_autograd():
    dev = _card()
    C, P = ODD
    args = _args(dev, 2, 5, C, P)
    c0, r0 = args[5].clone(), args[6].clone()
    blstmp_forward(*args)
    torch.cuda.synchronize()
    assert torch.equal(args[5], c0) and torch.equal(args[6], r0)
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        blstmp_forward(*args)
    with pytest.raises(RuntimeError, match="no backward"):
        lstmp_forward(*_one(args))
    with torch.no_grad():
        blstmp_forward(*args)


@pytest.mark.cuda
def test_a_plan_that_is_not_the_kernels_layout_is_refused():
    dev = _card()
    C, P = FLAGSHIP
    args = _args(dev, 1, 4, C, P)
    plan = lstmp_ops.plan_for(1, C, P, 1, dev)
    for wrong in (dataclasses.replace(plan, smem=plan.smem + 16),
                  dataclasses.replace(plan, cells_per_block=7),
                  dataclasses.replace(plan, blocks_per_dir=63)):
        with pytest.raises(RuntimeError, match="CUDA error 1 "):
            lstmp_ops._launch(wrong, [args[0]], args[2], [args[3]], args[5],
                              args[6], 50.0)
