"""LSTMP inference recurrence: the hand-written CUDA kernel and its plain
PyTorch version, for one direction (:func:`lstmp_forward`) and for both
directions of a BLSTMP layer in one launch (:func:`blstmp_forward`).

Port of kaldi_aslp_tpu/ops/lstm_pallas.py (``_lstmp_kernel`` and its
wrappers ``lstmp_forward_pallas`` / ``lstmp_forward_pallas_from_params``).
The kernel is ``csrc/lstmp_forward.cu``, built for ``sm_90a`` and bound
with ``ctypes``; it computes both recurrent products (``r_prev . W_r^T``
and ``m . W_rm^T``), the gates, the clip, the mask blend and the output
store.  Only the input projection ``x . W_x^T + b`` stays a
``torch.matmul``, as the JAX package leaves it to XLA outside the kernel
(lstm_pallas.py:163-164).

What bounds the kernel on the H100 is the step's latency, neither FLOPs
nor bytes: at S=1 (the server's one stream) a step is 1.6 MFLOP.  The TPU
kernel kept the weights in one core's VMEM; one SM's 227 KB of shared
memory cannot, so a call is one cooperative, persistent launch over all
frames whose blocks (64 a direction at the flagship's widths) each keep
their cells' slice of the float32 weights in shared memory and hand the
step's state to each other through L2 at a barrier of their direction's
own (the note at the top of the CUDA source).  :func:`plan_for` picks the
launch plan from the shapes (ops/sweep_plan.py:lstmp_infer_plan): the
few-stream sweep up to 16 streams, the many-stream sweep past that, and
past the sweeps' capacity two per-step kernels a frame.

The public layout is the JAX package's: ``mask [S, T]``,
``w_gifo_r [4C, P]``, ``w_r_m [P, C]``, ``peep [3, C]`` (i, f, o).  The
TPU wrapper's lane-replicated mask and transposed weights exist for the
TPU's tiling and are not ported."""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from kaldi_aslp_tpu_torch.ops.build import current_stream, load_library
from kaldi_aslp_tpu_torch.ops.sweep_plan import (
    LstmpInferPlan,
    lstmp_infer_plan,
)
from kaldi_aslp_tpu_torch.utils.profile import span

SOURCE = "lstmp_forward.cu"
F32 = torch.float32

_Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# one direction's weights: w_gifo_r [4C, P], w_r_m [P, C], peep [3, C]
_Weights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    fn = lib.lstmp_forward_f32
    if fn.argtypes is None:
        # (directions, 15 arrays, the scratch's words, S T C P, cell_clip,
        # the plan's regime nbd cpb ppb nstage smem, the stream)
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 15
                       + [ctypes.c_longlong] + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 5
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _library()


def plan_for(S: int, C: int, P: int, directions: int,
             device: torch.device) -> LstmpInferPlan:
    """The call's launch plan on ``device``'s card: one of the persistent
    sweeps, or past their capacity the per-step kernels
    (ops/sweep_plan.py)."""
    return _plan(S, C, P, directions, _sm_count(device))


# a server asks for the same plan at every chunk
_plan = functools.lru_cache(maxsize=64)(lstmp_infer_plan)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(xgs: Sequence[torch.Tensor], mask, weights: Sequence[_Weights],
           c0, r0) -> None:
    xg = xgs[0]
    if xg.dim() != 3 or xg.shape[2] % 4:
        raise ValueError(f"xg must be [S, T, 4C], got {tuple(xg.shape)}")
    S, T, G = xg.shape
    C = G // 4
    P = weights[0][1].shape[0]
    want = [("mask", mask, (S, T)), ("c0", c0, (S, C)), ("r0", r0, (S, P))]
    for d, (x, (w_gifo_r, w_r_m, peep)) in enumerate(zip(xgs, weights)):
        tag = "" if len(xgs) == 1 else ("_f", "_b")[d]
        want += [("xg" + tag, x, (S, T, G)),
                 ("w_gifo_r" + tag, w_gifo_r, (G, P)),
                 ("w_r_m" + tag, w_r_m, (P, C)), ("peep" + tag, peep, (3, C))]
    dev = xg.device
    for name, t, shape in want:
        # one test on the path every call takes; which part failed, after
        if (t.shape != shape or t.dtype is not F32 or t.device != dev
                or not t.is_contiguous()):
            _refuse(name, t, shape, dev)


def _refuse(name: str, t: torch.Tensor, shape: tuple, dev) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if t.dtype != F32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, xg on {dev}")
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


def _launch(plan: LstmpInferPlan, xgs: Sequence[torch.Tensor], mask,
            weights: Sequence[_Weights], c0, r0, cell_clip: float) -> _Outputs:
    """One call into the C entry under ``plan``: (ys [S, T, directions * P],
    c_T, r_T), all new tensors (the kernel reads c0 and r0 where they
    lie).  The scratch is one ``torch.empty``; the C entry clears its
    barrier counters on the stream."""
    xg = xgs[0]
    dev = xg.device
    S, T, G = xg.shape
    C, P = G // 4, weights[0][1].shape[0]
    ndir = len(xgs)
    ys = torch.empty((S, T, ndir * P), dtype=F32, device=dev)
    c_T = torch.empty((S, C), dtype=F32, device=dev)
    r_T = torch.empty((S, P), dtype=F32, device=dev)
    words = plan.scratch_words()
    scratch = torch.empty((words,), dtype=F32, device=dev)
    back = weights[-1]      # one direction: not read
    lib = _library()

    def call():
        return lib.lstmp_forward_f32(
            ndir, xg.data_ptr(), xgs[-1].data_ptr(), mask.data_ptr(),
            weights[0][0].data_ptr(), weights[0][1].data_ptr(),
            weights[0][2].data_ptr(), back[0].data_ptr(), back[1].data_ptr(),
            back[2].data_ptr(), c0.data_ptr(), r0.data_ptr(),
            c_T.data_ptr(), r_T.data_ptr(), ys.data_ptr(),
            scratch.data_ptr(), words, S, T, C, P, float(cell_clip),
            *plan.kernel_args(), current_stream(dev))
    # a short call: entering a device context costs what the launch does
    if torch.cuda.current_device() == dev.index:
        err = call()
    else:
        with torch.cuda.device(dev):
            err = call()
    if err != 0:
        raise RuntimeError(f"lstmp_forward_f32 failed: CUDA error {err} "
                           f"under {plan}")
    return ys, c_T, r_T


def _forward(counter, xgs, mask, weights, c0, r0, cell_clip) -> _Outputs:
    """The CUDA route of both wrappers; ``counter`` is the wrapper whose
    ``launches`` / ``per_step`` count the call and whose name the call's
    span takes (``aslp.op.lstmp_forward``, ``aslp.op.blstmp_forward``)."""
    xg = xgs[0]
    if xg.device.type != "cuda":
        raise ValueError(f"no LSTMP kernel for device {xg.device}")
    refuse_autograd(*xgs, mask, *(w for ws in weights for w in ws), c0, r0)
    S, T, G = xg.shape
    C, P = G // 4, weights[0][1].shape[0]
    if T == 0:
        return (torch.empty((S, 0, len(xgs) * P), dtype=F32,
                            device=xg.device), c0.clone(), r0.clone())
    plan = plan_for(S, C, P, len(xgs), xg.device)
    with span("aslp.op." + counter.__name__):
        out = _launch(plan, xgs, mask, weights, c0, r0, cell_clip)
    counter.launches += 1
    counter.per_step += not plan.persistent
    return out


def lstmp_forward(xg: torch.Tensor, mask: torch.Tensor,
                  w_gifo_r: torch.Tensor, w_r_m: torch.Tensor,
                  peep: torch.Tensor, c0: torch.Tensor, r0: torch.Tensor,
                  cell_clip: float = 50.0) -> _Outputs:
    """(ys [S, T, P], c_T [S, C], r_T [S, P]) from the precomputed input
    projection ``xg [S, T, 4C]`` (bias included).

    On a CUDA tensor (of the current device) this launches the kernel or
    raises (also when autograd would need its backward, see
    :func:`refuse_autograd`); a CPU tensor takes
    :func:`lstmp_forward_reference`.  ``lstmp_forward.launches`` counts
    calls into the kernel's C entry, and ``lstmp_forward.per_step`` those
    of them that took the per-step kernels (:func:`plan_for` chooses, from
    the shapes)."""
    weights = [(w_gifo_r, w_r_m, peep)]
    _check([xg], mask, weights, c0, r0)
    if xg.device.type == "cpu":
        return lstmp_forward_reference(xg, mask, w_gifo_r, w_r_m, peep,
                                       c0, r0, cell_clip)
    return _forward(lstmp_forward, [xg], mask, weights, c0, r0, cell_clip)


lstmp_forward.launches = 0
lstmp_forward.per_step = 0


def blstmp_forward(xg_f: torch.Tensor, xg_b: torch.Tensor,
                   mask: torch.Tensor, weights_f: _Weights,
                   weights_b: _Weights, c0: torch.Tensor, r0: torch.Tensor,
                   cell_clip: float = 50.0) -> _Outputs:
    """Both directions of a BLSTMP layer in one launch: (ys [S, T, 2P],
    c_T [S, C], r_T [S, P]).

    ``xg_f`` and ``xg_b`` [S, T, 4C] are the two directions' input
    projections of the same, unflipped, frames; ``weights_f`` and
    ``weights_b`` their (w_gifo_r, w_r_m, peep).  Direction f runs from
    (c0, r0) into columns [0, P) of ys and returns its final state;
    direction b runs the frames T-1 .. 0 from a zero state into columns
    [P, 2P), as kaldi_aslp_tpu/models/recurrent.py:_Bidirectional.apply
    does by flipping x, the mask and the backward cell's output.

    Devices, autograd and the counters (``blstmp_forward.launches``,
    ``blstmp_forward.per_step``) as :func:`lstmp_forward`; a CPU tensor
    takes :func:`blstmp_forward_reference`."""
    weights = [tuple(weights_f), tuple(weights_b)]
    _check([xg_f, xg_b], mask, weights, c0, r0)
    if xg_f.device.type == "cpu":
        return blstmp_forward_reference(xg_f, xg_b, mask, weights_f,
                                        weights_b, c0, r0, cell_clip)
    return _forward(blstmp_forward, [xg_f, xg_b], mask, weights, c0, r0,
                    cell_clip)


blstmp_forward.launches = 0
blstmp_forward.per_step = 0


def blstmp_forward_reference(xg_f, xg_b, mask, weights_f: _Weights,
                             weights_b: _Weights, c0, r0,
                             cell_clip: float = 50.0) -> _Outputs:
    """Plain PyTorch version of the two-direction call: two
    :func:`lstmp_forward_reference` runs, the backward one on the
    time-flipped projection and mask from a zero state, its output flipped
    back (the masked carry makes the flipped-to-front padding a no-op)."""
    y_f, c, r = lstmp_forward_reference(xg_f, mask, *weights_f, c0, r0,
                                        cell_clip)
    y_b, _, _ = lstmp_forward_reference(
        torch.flip(xg_b, (1,)), torch.flip(mask, (1,)), *weights_b,
        torch.zeros_like(c0), torch.zeros_like(r0), cell_clip)
    return torch.cat([y_f, torch.flip(y_b, (1,))], dim=-1), c, r


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
