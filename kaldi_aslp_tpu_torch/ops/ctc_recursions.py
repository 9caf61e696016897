"""CTC alpha and beta recursions: the hand-written CUDA kernel, its launch
plan and the plain PyTorch versions.

Port of kaldi_aslp_tpu/ops/ctc_pallas.py (``_alpha_kernel``,
``_beta_kernel`` and their wrapper ``ctc_alpha_beta_pallas``).  The kernel
is ``csrc/ctc_alpha_beta.cu``, built for ``sm_90a`` and bound with
``ctypes``: :func:`ctc_alpha_beta` runs both recursions in one launch.
What bounds them is the T-long chain of dependent steps, so one warp walks
one stream's recursion with its U' states in registers, K = ceil(U'/32)
consecutive states a lane, the neighbouring states by warp shuffles and
the emission scores loaded frames ahead of the chain; no barrier in the
frame loop.  Past ``REG_MAX_K * 32`` states the block-per-stream kernel
takes over (its state in shared memory), counted in
``ctc_alpha_beta.wide``.  :func:`plan_for` picks the kernel from U' alone.
Why CUDA and not Triton: each step exchanges neighbouring states (u-1,
u-2 or u+1, u+2) between lanes, which is a warp shuffle on state held in
registers for the whole loop; Triton's block model offers neither.

The layout is the JAX wrapper's: ``lp_t [T, S, U']`` emission scores
(``NEG_INF`` past each stream's expanded length), ``skip_ok [S, U']``
(already masked to the valid states), ``input_lengths`` and
``exp_lens`` [S].  The TPU padding of U' to 128 and S to 8 is not
ported.  On the TPU these kernels were opt-in because of Mosaic compile
time (kaldi_aslp_tpu/ops/ctc.py:174-186); here they are the default on
CUDA tensors.

The module is ``ops.ctc_recursions``: in the package, ``ops.ctc_alpha_beta``
is JAX's function of that name (ops/ctc.py), which calls this module's
wrapper after gathering the emission scores."""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from kaldi_aslp_tpu_torch.ops.build import (
    check_tensors,
    current_stream,
    load_library,
)
from kaldi_aslp_tpu_torch.utils.profile import span

SOURCE = "ctc_alpha_beta.cu"
NEG_INF = -1e30
# the .cu file's limits (kRegMaxK, kWideMaxThreads, kWidePerThread): a
# lane holds up to 8 states (U' <= 256: character and BPE label sequences
# up to 127); the wide kernel up to 6 states a thread over 1024 threads
# (U' <= 6144, 48 KB of state a block)
REG_MAX_K = 8
WIDE_MAX_THREADS = 1024
WIDE_PER_THREAD = 6


@dataclass(frozen=True)
class CtcPlan:
    """Which kernel runs the pair: ``states_per_lane`` K of the warp
    kernel (0 on the wide path), ``wide_threads`` a block of the wide
    kernel (0 on the warp path)."""
    states_per_lane: int
    wide_threads: int

    @property
    def wide(self) -> bool:
        return self.states_per_lane == 0


def wide_plan(U: int) -> CtcPlan:
    """The block-per-stream kernel's plan at U' = ``U`` (the card tests and
    ``chip_smoke.py`` put it in place of :func:`plan_for` to run it at any
    U'); raises ``ValueError`` past its capacity."""
    threads = min(WIDE_MAX_THREADS, -(-U // 32) * 32)
    if -(-U // threads) > WIDE_PER_THREAD:
        raise ValueError(
            f"U' = {U} expanded states exceed the CTC kernels' capacity of "
            f"{WIDE_MAX_THREADS * WIDE_PER_THREAD}")
    return CtcPlan(0, threads)


def plan_for(U: int) -> CtcPlan:
    """The plan at U' = ``U`` expanded states: the warp kernel with the
    smallest K, 32 K >= U', up to ``REG_MAX_K``; past it the wide
    kernel."""
    if U < 1:
        raise ValueError(f"U' must be positive, got {U}")
    k = -(-U // 32)
    return CtcPlan(k, 0) if k <= REG_MAX_K else wide_plan(U)


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.ctc_alpha_beta_f32
    if fn.argtypes is None:
        # 6 arrays, T S U, the plan's K and wide threads, the stream
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
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


def ctc_alpha_beta(lp_t: torch.Tensor, skip_ok: torch.Tensor,
                   input_lengths: torch.Tensor, exp_lens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(alphas, betas), each [T, S, U'].  On a CUDA tensor this launches the
    kernel once for both recursions or raises; a CPU tensor takes
    :func:`ctc_alpha_beta_reference`.  ``ctc_alpha_beta.launches`` counts
    calls into the kernel's C entry (each in the span
    ``aslp.op.ctc_alpha_beta``), ``ctc_alpha_beta.wide`` those on the wide
    kernel."""
    _check(lp_t, skip_ok, input_lengths, exp_lens)
    if lp_t.device.type == "cpu":
        return ctc_alpha_beta_reference(lp_t, skip_ok, input_lengths,
                                        exp_lens)
    if lp_t.device.type != "cuda":
        raise ValueError(f"no CTC kernel for device {lp_t.device}")
    T, S, U = lp_t.shape
    plan = plan_for(U)
    out = torch.empty((2, T, S, U), dtype=torch.float32, device=lp_t.device)
    alphas = out.data_ptr()
    with span("aslp.op.ctc_alpha_beta"), torch.cuda.device(lp_t.device):
        err = _library().ctc_alpha_beta_f32(
            lp_t.data_ptr(), skip_ok.data_ptr(), input_lengths.data_ptr(),
            exp_lens.data_ptr(), alphas, alphas + 4 * T * S * U, T, S, U,
            plan.states_per_lane, plan.wide_threads,
            current_stream(lp_t.device))
    if err != 0:
        raise RuntimeError(f"ctc_alpha_beta_f32 failed: CUDA error {err}")
    ctc_alpha_beta.launches += 1
    ctc_alpha_beta.wide += plan.wide
    return out.unbind(0)


ctc_alpha_beta.launches = 0
ctc_alpha_beta.wide = 0


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c).clamp(min=NEG_INF)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[..., u - k], NEG_INF where u < k."""
    k = min(k, x.shape[-1])
    return torch.nn.functional.pad(x[..., :x.shape[-1] - k], (k, 0),
                                   value=NEG_INF)


def _shift_left(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[..., u + k], NEG_INF where u + k is past the end."""
    k = min(k, x.shape[-1])
    return torch.nn.functional.pad(x[..., k:], (0, k), value=NEG_INF)


def ctc_alpha_reference(lp_t, skip_ok, input_lengths, exp_lens):
    """Plain PyTorch version of the alpha recursion: a loop over T with the
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
    """Plain PyTorch version of the beta recursion
    (ctc_pallas.py:_beta_kernel): seeded at each stream's last frame on its
    final two states."""
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


def ctc_alpha_beta_reference(lp_t, skip_ok, input_lengths, exp_lens):
    """Plain PyTorch version of the kernel: (alphas, betas)."""
    return (ctc_alpha_reference(lp_t, skip_ok, input_lengths, exp_lens),
            ctc_beta_reference(lp_t, skip_ok, input_lengths, exp_lens))
