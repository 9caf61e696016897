"""CTC alpha and beta recursions: the hand-written CUDA kernels and their
plain PyTorch versions.

Port of kaldi_aslp_tpu/ops/ctc_pallas.py (``_alpha_kernel``,
``_beta_kernel`` and their wrapper ``ctc_alpha_beta_pallas``).  The
kernels are ``csrc/ctc_alpha_beta.cu``, built for ``sm_90a`` and bound
with ``ctypes``: one block per stream keeps the [U'] state in shared
memory and loops over T, so each recursion is one launch.  Why CUDA and
not Triton: every step exchanges neighbouring states (u-1, u-2) within
the block, which is a shared-memory shift between two ``__syncthreads``.

The layout is the JAX wrapper's: ``lp_t [T, S, U']`` emission scores
(``NEG_INF`` past each stream's expanded length), ``skip_ok [S, U']``
(already masked to the valid states), ``input_lengths`` and
``exp_lens`` [S].  The TPU padding of U' to 128 and S to 8 is not
ported.  On the TPU these kernels were opt-in because of Mosaic compile
time (kaldi_aslp_tpu/ops/ctc.py:174-186); here they are the default on
CUDA tensors."""

from __future__ import annotations

import ctypes

import torch

from kaldi_aslp_tpu_torch.ops.build import (
    check_tensors,
    current_stream,
    load_library,
)

SOURCE = "ctc_alpha_beta.cu"
NEG_INF = -1e30


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    for name in ("ctc_alpha_f32", "ctc_beta_f32"):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _library()


def _check(lp_t, skip_ok, input_lengths, exp_lens) -> None:
    if lp_t.dim() != 3:
        raise ValueError(f"lp_t must be [T, S, U'], got {tuple(lp_t.shape)}")
    T, S, U = lp_t.shape
    if T == 0:
        raise ValueError("lp_t has no frames")
    if lp_t.dtype != torch.float32 or not lp_t.is_contiguous():
        raise TypeError("lp_t must be contiguous float32")
    check_tensors(lp_t.device, {
        "skip_ok": (skip_ok, (S, U), torch.float32),
        "input_lengths": (input_lengths, (S,), torch.int32),
        "exp_lens": (exp_lens, (S,), torch.int32)})


def _launch(name: str, lp_t, skip_ok, input_lengths, exp_lens):
    if lp_t.device.type != "cuda":
        raise ValueError(f"no CTC kernel for device {lp_t.device}")
    T, S, U = lp_t.shape
    out = torch.empty_like(lp_t)
    lib = _library()
    with torch.cuda.device(lp_t.device):
        err = getattr(lib, name)(
            lp_t.data_ptr(), skip_ok.data_ptr(), input_lengths.data_ptr(),
            exp_lens.data_ptr(), out.data_ptr(), T, S, U,
            current_stream(lp_t.device))
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    return out


def ctc_alpha(lp_t: torch.Tensor, skip_ok: torch.Tensor,
              input_lengths: torch.Tensor,
              exp_lens: torch.Tensor) -> torch.Tensor:
    """alphas [T, S, U'].  On a CUDA tensor this launches the kernel or
    raises; a CPU tensor takes :func:`ctc_alpha_reference`.
    ``ctc_alpha.launches`` counts calls into the kernel's C entry."""
    _check(lp_t, skip_ok, input_lengths, exp_lens)
    if lp_t.device.type == "cpu":
        return ctc_alpha_reference(lp_t, skip_ok, input_lengths, exp_lens)
    out = _launch("ctc_alpha_f32", lp_t, skip_ok, input_lengths, exp_lens)
    ctc_alpha.launches += 1
    return out


ctc_alpha.launches = 0


def ctc_beta(lp_t: torch.Tensor, skip_ok: torch.Tensor,
             input_lengths: torch.Tensor,
             exp_lens: torch.Tensor) -> torch.Tensor:
    """betas [T, S, U'].  On a CUDA tensor this launches the kernel or
    raises; a CPU tensor takes :func:`ctc_beta_reference`.
    ``ctc_beta.launches`` counts calls into the kernel's C entry."""
    _check(lp_t, skip_ok, input_lengths, exp_lens)
    if lp_t.device.type == "cpu":
        return ctc_beta_reference(lp_t, skip_ok, input_lengths, exp_lens)
    out = _launch("ctc_beta_f32", lp_t, skip_ok, input_lengths, exp_lens)
    ctc_beta.launches += 1
    return out


ctc_beta.launches = 0


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c).clamp(min=NEG_INF)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[..., u - k], NEG_INF where u < k."""
    return torch.nn.functional.pad(x[..., :-k], (k, 0), value=NEG_INF)


def _shift_left(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[..., u + k], NEG_INF where u + k is past the end."""
    return torch.nn.functional.pad(x[..., k:], (0, k), value=NEG_INF)


def ctc_alpha_reference(lp_t, skip_ok, input_lengths, exp_lens):
    """Plain PyTorch version of the alpha kernel: a loop over T with the
    equations of ctc_pallas.py:_alpha_kernel (and the scan step of
    kaldi_aslp_tpu/ops/ctc.py:ctc_alpha_beta)."""
    T, S, U = lp_t.shape
    u = torch.arange(U, device=lp_t.device)[None, :]
    prev = torch.where(u < 2, lp_t[0], NEG_INF)
    prev = torch.where((u == 1) & (exp_lens[:, None] < 2), NEG_INF, prev)
    alphas = [prev]
    skip_prev2 = skip_ok > 0
    for t in range(1, T):
        cand = _lse3(prev, _shift_right(prev, 1),
                     torch.where(skip_prev2, _shift_right(prev, 2),
                                 NEG_INF)) + lp_t[t]
        prev = torch.where((t < input_lengths)[:, None], cand, prev)
        alphas.append(prev)
    return torch.stack(alphas)


def ctc_beta_reference(lp_t, skip_ok, input_lengths, exp_lens):
    """Plain PyTorch version of the beta kernel (ctc_pallas.py:_beta_kernel):
    seeded at each stream's last frame on its final two states."""
    T, S, U = lp_t.shape
    u = torch.arange(U, device=lp_t.device)[None, :]
    end = (u == exp_lens[:, None] - 1) | (u == exp_lens[:, None] - 2)
    skip_next2 = _shift_left(skip_ok, 2) > 0
    nxt = torch.full((S, U), NEG_INF, device=lp_t.device)
    betas = [None] * T
    for t in range(T - 1, -1, -1):
        cand = _lse3(nxt, _shift_left(nxt, 1),
                     torch.where(skip_next2, _shift_left(nxt, 2),
                                 NEG_INF)) + lp_t[t]
        init = torch.where(end, lp_t[t], NEG_INF)
        nxt = torch.where((t == input_lengths - 1)[:, None], init,
                          torch.where((t < input_lengths - 1)[:, None],
                                      cand, nxt))
        betas[t] = nxt
    return torch.stack(betas)
