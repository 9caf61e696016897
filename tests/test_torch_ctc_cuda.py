"""The CTC alpha/beta CUDA kernels (kaldi_aslp_tpu_torch/csrc/
ctc_alpha_beta.cu) against their plain PyTorch versions, on the card,
and the CTC loss with its gradient on the card against the CPU.

The kernels have no CPU mode, so these tests skip where there is no CUDA
card.  This file imports no JAX; run it on the card with
``python -m pytest --noconftest tests/test_torch_ctc_cuda.py -q``.
Tolerance rtol=atol=1e-4: float32 on both sides; expf and logf on the
card may differ from the CPU's in the last bit."""

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.ops.ctc import ctc_emissions, ctc_loss
from kaldi_aslp_tpu_torch.ops.ctc_alpha_beta import (
    ctc_alpha,
    ctc_alpha_reference,
    ctc_beta,
    ctc_beta_reference,
)

TOL = dict(rtol=1e-4, atol=1e-4)


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


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,V,U", [(4, 18, 9, 5), (16, 200, 72, 40)])
def test_kernels_match_plain_versions(S, T, V, U):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    dev = torch.device("cuda")
    logits, labels, in_lens, lab_lens = _batch(S, T, V, U, seed=S + T)
    lp_t, skip_ok, _, _, exp_lens = ctc_emissions(
        torch.log_softmax(logits, -1), labels, lab_lens)
    args = [a.to(dev) for a in (lp_t, skip_ok, in_lens, exp_lens)]
    launches = (ctc_alpha.launches, ctc_beta.launches)
    alphas, betas = ctc_alpha(*args), ctc_beta(*args)
    torch.cuda.synchronize()
    assert (ctc_alpha.launches, ctc_beta.launches) == (launches[0] + 1,
                                                      launches[1] + 1)
    torch.testing.assert_close(alphas, ctc_alpha_reference(*args), **TOL)
    torch.testing.assert_close(betas, ctc_beta_reference(*args), **TOL)


@pytest.mark.cuda
def test_loss_and_grad_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
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
