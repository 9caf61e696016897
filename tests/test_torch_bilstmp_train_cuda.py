"""The bidirectional LSTMP training CUDA kernels (kaldi_aslp_tpu_torch/
csrc/bilstmp_train.cu) against their plain PyTorch versions, on the
card, with ragged masks, a nonzero initial state and nonzero final-state
cotangents.

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
    bilstmp_train_bwd,
    bilstmp_train_bwd_reference,
    bilstmp_train_fwd,
    bilstmp_train_fwd_reference,
)

REL_TOL = 1e-2
BF16 = torch.bfloat16


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


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,D,C,P", [(5, 7, 40, 32, 16),
                                       (16, 20, 640, 512, 320),
                                       (33, 9, 40, 512, 320)])
def test_kernels_match_plain_versions(S, T, D, C, P):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
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


@pytest.mark.cuda
def test_autograd_core_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
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
