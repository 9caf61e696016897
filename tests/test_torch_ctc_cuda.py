"""The CTC alpha/beta kernel (kaldi_aslp_tpu_torch/csrc/ctc_alpha_beta.cu,
both recursions in one launch) against its plain PyTorch versions, on the
card, and the CTC loss with its gradient on the card against the CPU.

The kernels have no CPU mode, so these tests skip where there is no CUDA
card.  This file imports no JAX; run it on the card with
``python -m pytest --noconftest tests/test_torch_ctc_cuda.py -q``.
Tolerance rtol=atol=1e-4: float32 on both sides; expf and logf on the
card may differ from the CPU's in the last bit, and the kernel sums the
maximum's term (exactly 1) first."""

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.ops import ctc_recursions as cab
from kaldi_aslp_tpu_torch.ops.ctc import ctc_emissions, ctc_loss

TOL = dict(rtol=1e-4, atol=1e-4)
NEG_INF = cab.NEG_INF


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


def _batch(S, T, V, U, seed):
    rs = np.random.RandomState(seed)
    logits = torch.from_numpy(rs.randn(S, T, V).astype(np.float32))
    labels = torch.from_numpy(rs.randint(1, V, (S, U)).astype(np.int32))
    lab_lens = torch.from_numpy(rs.randint(1, U + 1, S).astype(np.int32))
    in_lens = torch.from_numpy(
        rs.randint(T // 2, T + 1, S).astype(np.int32))
    in_lens[0] = T
    lab_lens[0] = U
    in_lens = torch.maximum(in_lens, 2 * lab_lens + 1)
    return logits, labels, in_lens, lab_lens


def _label_args(S, T, V, U, seed, dev):
    """The recursions' inputs from labels, as the loss makes them; with a
    small V, labels repeat and their skips are refused."""
    logits, labels, in_lens, lab_lens = _batch(S, T, V, U, seed)
    if S > 1:
        in_lens[1] = 2 * lab_lens[1] + 1      # input_length == exp_len
    lp_t, skip_ok, _, _, exp_lens = ctc_emissions(
        torch.log_softmax(logits, -1), labels, lab_lens)
    return [a.to(dev) for a in (lp_t, skip_ok, in_lens, exp_lens)]


def _direct_args(S, T, Up, seed, dev):
    """Inputs at any U' (even ones too, which no label sequence gives):
    ragged expanded lengths down to 1 and input lengths from 0 to T, one
    equal to its stream's expanded length."""
    rs = np.random.RandomState(seed)
    exp_lens = rs.randint(1, Up + 1, S).astype(np.int32)
    exp_lens[0], exp_lens[-1] = Up, 1
    in_lens = rs.randint(0, T + 1, S).astype(np.int32)
    in_lens[0] = T
    if S > 1:
        in_lens[1] = min(T, exp_lens[1])
    u = np.arange(Up)
    valid = u[None, :] < exp_lens[:, None]
    lp = np.where(valid[None], rs.randn(T, S, Up) - 3.0, NEG_INF)
    skip = (rs.rand(S, Up) > 0.3) & valid
    return [torch.from_numpy(a).to(dev) for a in (
        lp.astype(np.float32), skip.astype(np.float32), in_lens, exp_lens)]


def _hold_one_launch(args, wide):
    """One call is one launch (on the wide kernel iff ``wide``), matches
    the plain versions and gives the same bits twice."""
    before = (cab.ctc_alpha_beta.launches, cab.ctc_alpha_beta.wide)
    alphas, betas = cab.ctc_alpha_beta(*args)
    torch.cuda.synchronize()
    assert (cab.ctc_alpha_beta.launches, cab.ctc_alpha_beta.wide) == (
        before[0] + 1, before[1] + int(wide))
    assert alphas.shape == betas.shape == args[0].shape
    torch.testing.assert_close(alphas, cab.ctc_alpha_reference(*args), **TOL)
    torch.testing.assert_close(betas, cab.ctc_beta_reference(*args), **TOL)
    again = cab.ctc_alpha_beta(*args)
    torch.cuda.synchronize()
    assert torch.equal(again[0], alphas) and torch.equal(again[1], betas)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,V,U", [(4, 18, 9, 5), (16, 200, 72, 40)])
def test_kernels_match_plain_versions(S, T, V, U):
    dev = _card()
    _hold_one_launch(_label_args(S, T, V, U, S + T, dev), wide=False)


@pytest.mark.cuda
@pytest.mark.parametrize("Up", [1, 3, 31, 32, 33, 81, 129, 161, 255, 256,
                                257])
def test_every_width_matches_plain_versions(Up):
    """One to eight states a lane, partial last groups (129 and 161 are
    five and six states a lane, the CTC recipe's widths), the largest U'
    of the register path (256) and one past it (the wide kernel)."""
    dev = _card()
    _hold_one_launch(_direct_args(5, 37, Up, Up, dev),
                     wide=Up > 32 * cab.REG_MAX_K)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,V,U", [(1, 100, 72, 40), (128, 400, 72, 40),
                                     (12, 60, 3, 20)])
def test_bench_shape_one_stream_and_repeated_labels(S, T, V, U):
    """S = 1, the bench's S = 128 at T = 400, and V = 3 (two labels, so
    most neighbours repeat and their skips are refused)."""
    dev = _card()
    _hold_one_launch(_label_args(S, T, V, U, 11 + S, dev), wide=False)


@pytest.mark.cuda
@pytest.mark.parametrize("Up", [3, 81])
def test_forced_wide_kernel_matches_plain_versions(Up, monkeypatch):
    """The block-per-stream kernel at widths the plan gives the warps, by
    its plan put in place of plan_for."""
    dev = _card()
    monkeypatch.setattr(cab, "plan_for", cab.wide_plan)
    _hold_one_launch(_direct_args(6, 45, Up, 3 + Up, dev), wide=True)


@pytest.mark.cuda
def test_loss_and_grad_on_the_card_match_the_cpu():
    _card()
    logits, labels, in_lens, lab_lens = _batch(8, 60, 12, 10, seed=5)
    out = {}
    for dev in ("cpu", "cuda"):
        lg = logits.to(dev).detach().requires_grad_(True)
        nll = ctc_loss(lg, labels.to(dev), in_lens.to(dev),
                       lab_lens.to(dev))
        nll.sum().backward()
        out[dev] = (nll.detach().cpu(), lg.grad.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], **TOL)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=0,
                               atol=1e-4)
