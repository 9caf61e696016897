"""The LSTMP CUDA kernel (kaldi_aslp_tpu_torch/csrc/lstmp_forward.cu)
against its plain PyTorch version, on the card.

The kernel has no CPU mode, so these tests skip where there is no CUDA
card.  This file imports no JAX (the machine with the card has none);
run it there with ``python -m pytest --noconftest
tests/test_torch_lstmp_cuda.py -q``, since tests/conftest.py loads JAX.
Tolerance rtol=atol=1e-4: float32 on both sides, the kernel sums the
recurrent products in another order, and the cell is contractive at the
model's init scale."""

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.ops import lstmp as lstmp_ops
from kaldi_aslp_tpu_torch.ops.lstmp import (
    lstmp_forward,
    lstmp_forward_reference,
)


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,Cf,Pf", [
    (1, 16, 512, 320), (8, 40, 512, 320),      # the flagship's server
    (16, 20, 800, 512), (100, 20, 800, 512)],  # the LSTM hybrid's CV
    ids=["flagship-1x16", "flagship-8x40", "hybrid-16x20", "hybrid-100x20"])
def test_cuda_kernel_matches_plain_version(S, T, Cf, Pf):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(S * T)
    dev = torch.device("cuda")

    def u(*shape):
        return torch.from_numpy(
            (0.1 * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32)).to(dev)
    xg = torch.from_numpy(rs.randn(S, T, 4 * Cf).astype(np.float32)).to(dev)
    mask = torch.ones(S, T, device=dev)
    mask[S // 2:, T // 2:] = 0
    args = (xg, mask, u(4 * Cf, Pf), u(Pf, Cf), u(3, Cf),
            u(S, Cf), u(S, Pf))
    before = lstmp_ops.lstmp_forward.launches
    got = lstmp_forward(*args)
    want = lstmp_forward_reference(*args)
    torch.cuda.synchronize()
    assert lstmp_ops.lstmp_forward.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
