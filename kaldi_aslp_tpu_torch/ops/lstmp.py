"""LSTMP inference recurrence: the hand-written CUDA kernel and its plain
PyTorch version.

Port of kaldi_aslp_tpu/ops/lstm_pallas.py (``_lstmp_kernel`` and its
wrappers ``lstmp_forward_pallas`` / ``lstmp_forward_pallas_from_params``).
The kernel is ``csrc/lstmp_forward.cu``, built for ``sm_90a`` and bound
with ``ctypes``; it computes both recurrent products (``r_prev . W_r^T``
and ``m . W_rm^T``), the gates, the clip, the mask blend and the output
store.  Only the input projection ``x . W_x^T + b`` stays a
``torch.matmul``, as the JAX package leaves it to XLA outside the kernel
(lstm_pallas.py:163-164).

What bounds the kernel on the H100: at S=1 (the server's one stream) a
step reads 3.3 MB of f32 weights for 1.6 MFLOP, so it is bound by weight
reads from L2.  The TPU kernel kept the weights in one core's VMEM; one
SM's 227 KB of shared memory cannot, so each step is two launches that
spread the weight rows over many SMs (see the note at the top of the
CUDA source).

The public layout is the JAX package's: ``mask [S, T]``,
``w_gifo_r [4C, P]``, ``w_r_m [P, C]``, ``peep [3, C]`` (i, f, o).  The
TPU wrapper's lane-replicated mask and transposed weights exist for the
TPU's tiling and are not ported."""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from kaldi_aslp_tpu_torch.ops.build import current_stream, load_library

SOURCE = "lstmp_forward.cu"

_Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.lstmp_forward_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _library()


def _check(xg, mask, w_gifo_r, w_r_m, peep, c0, r0) -> None:
    if xg.dim() != 3 or xg.shape[2] % 4:
        raise ValueError(f"xg must be [S, T, 4C], got {tuple(xg.shape)}")
    S, T, G = xg.shape
    C = G // 4
    P = w_r_m.shape[0]
    want = {"mask": (mask, (S, T)), "w_gifo_r": (w_gifo_r, (G, P)),
            "w_r_m": (w_r_m, (P, C)), "peep": (peep, (3, C)),
            "c0": (c0, (S, C)), "r0": (r0, (S, P))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in [("xg", xg)] + [(n, v[0]) for n, v in want.items()]:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != xg.device:
            raise ValueError(
                f"{name} is on {t.device}, xg on {xg.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def refuse_autograd(*tensors: torch.Tensor) -> None:
    """Raise if autograd would record a graph through ``tensors``.

    The inference kernel has no backward: its outputs would carry no
    gradient on the card while the plain version's carry one on the CPU.
    Call it under ``torch.no_grad()`` (as the eval path does), or train
    through the training kernels."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "lstmp_forward's CUDA kernel has no backward; call it under "
            "torch.no_grad() or train through the training kernels")


def lstmp_forward(xg: torch.Tensor, mask: torch.Tensor,
                  w_gifo_r: torch.Tensor, w_r_m: torch.Tensor,
                  peep: torch.Tensor, c0: torch.Tensor, r0: torch.Tensor,
                  cell_clip: float = 50.0) -> _Outputs:
    """(ys [S, T, P], c_T [S, C], r_T [S, P]) from the precomputed input
    projection ``xg [S, T, 4C]`` (bias included).

    On a CUDA tensor this launches the kernel or raises (also when
    autograd would need its backward, see :func:`refuse_autograd`); a
    CPU tensor takes :func:`lstmp_forward_reference`.
    ``lstmp_forward.launches`` counts calls into the kernel's C entry."""
    _check(xg, mask, w_gifo_r, w_r_m, peep, c0, r0)
    if xg.device.type == "cpu":
        return lstmp_forward_reference(xg, mask, w_gifo_r, w_r_m, peep,
                                       c0, r0, cell_clip)
    if xg.device.type != "cuda":
        raise ValueError(f"no LSTMP kernel for device {xg.device}")
    refuse_autograd(xg, mask, w_gifo_r, w_r_m, peep, c0, r0)
    S, T, G = xg.shape
    C, P = G // 4, w_r_m.shape[0]
    # the kernel carries the state in place in c and r
    c = c0.clone()
    r = r0.clone()
    ys = torch.empty((S, T, P), dtype=torch.float32, device=xg.device)
    if T == 0:
        return ys, c, r
    m = torch.empty((S, C), dtype=torch.float32, device=xg.device)
    lib = _library()
    with torch.cuda.device(xg.device):
        err = lib.lstmp_forward_f32(
            xg.data_ptr(), mask.data_ptr(), w_gifo_r.data_ptr(),
            w_r_m.data_ptr(), peep.data_ptr(), c.data_ptr(), r.data_ptr(),
            m.data_ptr(), ys.data_ptr(), S, T, C, P, float(cell_clip),
            current_stream(xg.device))
        lstmp_forward.launches += 1
    if err != 0:
        raise RuntimeError(f"lstmp_forward_f32 failed: CUDA error {err}")
    return ys, c, r


lstmp_forward.launches = 0


def lstmp_forward_reference(xg: torch.Tensor, mask: torch.Tensor,
                            w_gifo_r: torch.Tensor, w_r_m: torch.Tensor,
                            peep: torch.Tensor, c0: torch.Tensor,
                            r0: torch.Tensor,
                            cell_clip: float = 50.0) -> _Outputs:
    """Plain PyTorch version of the kernel: a loop over T with the
    equations of lstm_pallas.py:_lstmp_kernel (and the scan step of
    kaldi_aslp_tpu/models/recurrent.py:LstmProjectedStreams.apply)."""
    S, T, G = xg.shape
    C, P = G // 4, w_r_m.shape[0]
    c, r = c0, r0
    w_r_t, w_rm_t = w_gifo_r.t(), w_r_m.t()
    ys = []
    for t in range(T):
        gates = xg[:, t] + r @ w_r_t
        g = torch.tanh(gates[:, :C])
        i = torch.sigmoid(gates[:, C:2 * C] + peep[0] * c)
        f = torch.sigmoid(gates[:, 2 * C:3 * C] + peep[1] * c)
        c_new = f * c + i * g
        if cell_clip > 0:
            c_new = torch.clamp(c_new, -cell_clip, cell_clip)
        o = torch.sigmoid(gates[:, 3 * C:] + peep[2] * c_new)
        r_new = (o * torch.tanh(c_new)) @ w_rm_t
        mt = mask[:, t:t + 1]
        c = mt * c_new + (1.0 - mt) * c
        r = mt * r_new + (1.0 - mt) * r
        ys.append(r * mt)
    if not ys:
        return xg.new_zeros((S, 0, P)), c.clone(), r.clone()
    return torch.stack(ys, dim=1), c, r
