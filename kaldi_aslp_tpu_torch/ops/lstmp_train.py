"""Unidirectional LSTMP training core: the hand-written CUDA kernels, their
plain PyTorch versions, and the ``torch.autograd.Function`` around them.

Port of kaldi_aslp_tpu/ops/lstm_pallas.py:189-541: ``_lstmp_fwd_train_kernel``
and ``_lstmp_bwd_kernel``, their wrappers ``_lstmp_train_fwd`` /
``_lstmp_train_bwd``, the custom VJP ``_get_lstmp_core`` and
``lstmp_train_core``, which the JAX package's ``LstmProjectedStreams``
takes in training (models/recurrent.py:163-190).  The kernels are
``csrc/lstmp_train.cu``, built for ``sm_90a`` and bound with ``ctypes``;
the note at the top of that file says how the TPU design was rethought
for the H100: one cooperative, persistent kernel per sweep, each block
holding its cells' slices of W_r and W_rm in shared memory, launched by
the plan :func:`plan_for` returns (ops/sweep_plan.py), and past that
plan's capacity two per-step kernels a frame each way.  The weight
gradients dW_r, dW_rm and dpeep are reduced outside the kernel over all
frames, as the JAX wrapper does (lstm_pallas.py:426-451), with
``torch.matmul`` and sums.

The storage dtype (the dtype of ``xg``) and ``mxu_bf16`` pick one of
the TPU kernels' three modes (``store_bf16``, ``mxu_bf16``):
  - float32 (F, F): everything is float32 and nothing is rounded;
  - bf16 (T, T), which the ``bf16`` attr selects: xg, the stored gates,
    c and r, the output ys, dxg and dr_new are bf16, and every product
    takes bf16 operands with float32 sums;
  - bf16 storage with float32 products (T, F), which
    ``KALDI_ASLP_LSTM_MXU_FP32`` selects for a bf16 LSTMP
    (models/recurrent.py:175-188): stored as in (T, T), but the state,
    m, dr_new, dgates and the weights enter the products unrounded.
``mxu_bf16=None`` means the storage dtype's own products.  The carried
state and the cell math are float32 in every mode.  The S_BLK = 128
stream padding of ``lstmp_train_core`` is a TPU tiling artefact and is
not ported.

Layouts are the JAX wrapper's: xg [S, T, 4C], mask [S, T]; the stored
streams gates [T, S, 4C], cs [T, S, C], rs [T, S, P] (time-major, post-mask
c and r); dy [S, T, P]; dxg [S, T, 4C]; dr_new [T, S, P].  The weights
are passed in the parameters' own layouts, w_gifo_r [4C, P] and
w_r_m [P, C], float32."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from kaldi_aslp_tpu_torch.ops.build import (
    check_tensors,
    current_stream,
    load_library,
)
from kaldi_aslp_tpu_torch.ops.sweep_plan import (
    LstmpSweepPlan,
    _round_up,
    lstmp_sweep_plan,
)

SOURCE = "lstmp_train.cu"
BF16 = torch.bfloat16
F32 = torch.float32

_Streams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    signatures = {"lstmp_train_fwd": 13, "lstmp_train_bwd": 17}
    for name, n_ptr in signatures.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            # (flags, arrays, S T C P, cell_clip, the plan's nb cpb nstage
            # smem, the persistent sweep's row and slab, the stream)
            fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * n_ptr
                           + [ctypes.c_int] * 4 + [ctypes.c_float]
                           + [ctypes.c_int] * 3 + [ctypes.c_longlong]
                           + [ctypes.c_void_p] * 3)
            fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _library()


def _storage(dtype: torch.dtype) -> torch.dtype:
    if dtype not in (F32, BF16):
        raise ValueError(f"the stored streams are float32 or bf16, not "
                         f"{dtype}")
    return dtype


def _products(st: torch.dtype, mxu_bf16: Optional[bool]) -> torch.dtype:
    """The dtype the products take their operands in: bf16 for bf16
    storage unless ``mxu_bf16`` is False, float32 for float32 storage."""
    if mxu_bf16 is None:
        mxu_bf16 = st == BF16
    if mxu_bf16 and st != BF16:
        raise ValueError("bf16 products need bf16 storage")
    return BF16 if mxu_bf16 else F32


def plan_for(S: int, C: int, P: int, device: torch.device) -> LstmpSweepPlan:
    """The pair's launch plan on ``device``'s card: the persistent sweeps,
    or past their capacity the per-step kernels (ops/sweep_plan.py)."""
    return _plan(S, C, P, torch.cuda.get_device_properties(
        device).multi_processor_count)


# a training step asks for the same few plans again and again
_plan = functools.lru_cache(maxsize=64)(lstmp_sweep_plan)


def _sweep_scratch(plan: LstmpSweepPlan, dev: torch.device):
    """The persistent sweep's state row [S, pp] and partial slabs
    [nb, S, pp], float32 (the kernel fills both); (None, None) for the
    per-step kernels."""
    if not plan.persistent:
        return None, None
    pp = _round_up(plan.P, 4)
    return (torch.empty((plan.S, pp), dtype=F32, device=dev),
            torch.empty((plan.blocks, plan.S, pp), dtype=F32, device=dev))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _operand(t: torch.Tensor, pt: torch.dtype) -> torch.Tensor:
    """A product operand in float32, rounded to the product dtype first
    (bf16 x bf16 is exact in float32, so float32 sums of these are what
    the kernels compute)."""
    return t.to(pt).float()


# -- forward -----------------------------------------------------------------

def lstmp_train_fwd(xg: torch.Tensor, mask: torch.Tensor,
                    w_gifo_r: torch.Tensor, w_r_m: torch.Tensor,
                    peep: torch.Tensor, init_c: torch.Tensor,
                    init_r: torch.Tensor, cell_clip: float = 50.0,
                    mxu_bf16: Optional[bool] = None) -> _Streams:
    """Training forward: (gates [T, S, 4C], cs [T, S, C], rs [T, S, P])
    in the dtype of ``xg`` (float32, or bf16 for ``store_bf16``), the
    products in the mode ``mxu_bf16`` picks (module docstring).

    xg [S, T, 4C] (bias included, already in the storage dtype); mask
    [S, T], w_gifo_r [4C, P], w_r_m [P, C], peep [3, C], init_c [S, C]
    and init_r [S, P] float32.

    On a CUDA tensor this launches the kernel or raises; a CPU tensor
    takes :func:`lstmp_train_fwd_reference`.
    ``lstmp_train_fwd.launches`` counts calls into the C entry, and
    ``lstmp_train_fwd.per_step`` those of them that took the per-step
    kernels (:func:`plan_for` chooses, from the shapes)."""
    S, T, G = xg.shape
    P, C = w_r_m.shape
    st = _storage(xg.dtype)
    pt = _products(st, mxu_bf16)
    check_tensors(xg.device, {
        "xg": (xg, (S, T, 4 * C), st), "mask": (mask, (S, T), F32),
        "w_gifo_r": (w_gifo_r, (4 * C, P), F32),
        "w_r_m": (w_r_m, (P, C), F32), "peep": (peep, (3, C), F32),
        "init_c": (init_c, (S, C), F32), "init_r": (init_r, (S, P), F32)})
    if T == 0:
        raise ValueError("xg has no frames")
    if xg.device.type == "cpu":
        return lstmp_train_fwd_reference(xg, mask, w_gifo_r, w_r_m, peep,
                                         init_c, init_r, cell_clip, mxu_bf16)
    if xg.device.type != "cuda":
        raise ValueError(f"no LSTMP training kernel for device {xg.device}")
    dev = xg.device
    plan = plan_for(S, C, P, dev)
    # the weights in the dtype the products take them in
    w_r, w_rm = w_gifo_r.to(pt).contiguous(), w_r_m.to(pt).contiguous()
    c_state = torch.empty((S, C), dtype=F32, device=dev)
    r_state = torch.empty((S, P), dtype=F32, device=dev)
    row, slab = _sweep_scratch(plan, dev)
    m_buf = (torch.empty((S, C), dtype=F32, device=dev) if row is None
             else None)
    gates = torch.empty((T, S, G), dtype=st, device=dev)
    cs = torch.empty((T, S, C), dtype=st, device=dev)
    rs = torch.empty((T, S, P), dtype=st, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.lstmp_train_fwd(
            int(st == BF16), int(pt == BF16), xg.data_ptr(), mask.data_ptr(),
            w_r.data_ptr(), w_rm.data_ptr(), peep.data_ptr(),
            init_c.data_ptr(), init_r.data_ptr(), c_state.data_ptr(),
            r_state.data_ptr(), _ptr(m_buf),
            gates.data_ptr(), cs.data_ptr(), rs.data_ptr(),
            S, T, C, P, float(cell_clip), *plan.kernel_args(backward=False),
            _ptr(row), _ptr(slab), current_stream(dev))
        lstmp_train_fwd.launches += 1
        lstmp_train_fwd.per_step += not plan.persistent
    if err != 0:
        raise RuntimeError(f"lstmp_train_fwd failed: CUDA error {err}")
    return gates, cs, rs


lstmp_train_fwd.launches = 0
lstmp_train_fwd.per_step = 0


def lstmp_train_fwd_reference(xg, mask, w_gifo_r, w_r_m, peep, init_c,
                              init_r, cell_clip: float = 50.0,
                              mxu_bf16: Optional[bool] = None) -> _Streams:
    """Plain PyTorch version of the forward kernel: a loop over T with the
    equations of lstm_pallas.py:_lstmp_fwd_train_kernel."""
    S, T, G = xg.shape
    P, C = w_r_m.shape
    st = _storage(xg.dtype)
    pt = _products(st, mxu_bf16)
    xgf = xg.float()
    w_r_t = _operand(w_gifo_r, pt).t()
    w_rm_t = _operand(w_r_m, pt).t()
    c, r = init_c, init_r
    gates = xg.new_empty((T, S, G), dtype=st)
    cs = xg.new_empty((T, S, C), dtype=st)
    rs = xg.new_empty((T, S, P), dtype=st)
    for t in range(T):
        lin = xgf[:, t] + _operand(r, pt) @ w_r_t
        g = torch.tanh(lin[:, :C])
        i = torch.sigmoid(lin[:, C:2 * C] + peep[0] * c)
        f = torch.sigmoid(lin[:, 2 * C:3 * C] + peep[1] * c)
        cn = f * c + i * g
        if cell_clip > 0:
            cn = torch.clamp(cn, -cell_clip, cell_clip)
        o = torch.sigmoid(lin[:, 3 * C:] + peep[2] * cn)
        rn = _operand(o * torch.tanh(cn), pt) @ w_rm_t
        mk = mask[:, t:t + 1]
        c = mk * cn + (1.0 - mk) * c
        r = mk * rn + (1.0 - mk) * r
        gates[t] = torch.cat([g, i, f, o], dim=1).to(st)
        cs[t] = c.to(st)
        rs[t] = r.to(st)
    return gates, cs, rs


# -- backward ----------------------------------------------------------------

def lstmp_train_bwd(dys, mask, gates, cs, rs, w_gifo_r, w_r_m, peep,
                    init_c, init_r, d_final_c, d_final_r,
                    cell_clip: float = 50.0,
                    mxu_bf16: Optional[bool] = None):
    """Training backward: the reverse sweep, then the weight-gradient
    reductions.

    dys [S, T, P] in the storage dtype (the dtype of ys); gates, cs, rs as
    :func:`lstmp_train_fwd` returned them; init_c, init_r and the
    final-state cotangents d_final_c [S, C], d_final_r [S, P] float32.
    Returns (dxg [S, T, 4C] in the storage dtype, d_init_c, d_init_r,
    d_w_gifo_r [4C, P], d_w_r_m [P, C], dpeep [3, C]), all but dxg
    float32.

    On a CUDA tensor the sweep launches the kernel or raises; a CPU tensor
    takes :func:`lstmp_train_bwd_reference`.
    ``lstmp_train_bwd.launches`` counts calls into the C entry, and
    ``lstmp_train_bwd.per_step`` those of them that took the per-step
    kernels (:func:`plan_for` chooses, from the shapes)."""
    T, S, G = gates.shape
    P, C = w_r_m.shape
    st = _storage(gates.dtype)
    pt = _products(st, mxu_bf16)
    check_tensors(gates.device, {
        "dys": (dys, (S, T, P), st), "mask": (mask, (S, T), F32),
        "gates": (gates, (T, S, 4 * C), st), "cs": (cs, (T, S, C), st),
        "rs": (rs, (T, S, P), st), "w_gifo_r": (w_gifo_r, (G, P), F32),
        "w_r_m": (w_r_m, (P, C), F32), "peep": (peep, (3, C), F32),
        "init_c": (init_c, (S, C), F32), "init_r": (init_r, (S, P), F32),
        "d_final_c": (d_final_c, (S, C), F32),
        "d_final_r": (d_final_r, (S, P), F32)})
    if gates.device.type == "cpu":
        return lstmp_train_bwd_reference(dys, mask, gates, cs, rs, w_gifo_r,
                                         w_r_m, peep, init_c, init_r,
                                         d_final_c, d_final_r, cell_clip,
                                         mxu_bf16)
    if gates.device.type != "cuda":
        raise ValueError(
            f"no LSTMP training kernel for device {gates.device}")
    dev = gates.device
    plan = plan_for(S, C, P, dev)
    # the weights in the product dtype: the persistent sweep reads their
    # own layouts, the per-step kernels contiguous rows of their transposes
    w_r, w_rm = w_gifo_r.to(pt).contiguous(), w_r_m.to(pt).contiguous()
    w_r_t = w_rm_t = dg_buf = None
    if not plan.persistent:
        w_r_t = w_r.t().contiguous()                # [P, 4C]
        w_rm_t = w_rm.t().contiguous()              # [C, P]
        dg_buf = torch.empty((S, G), dtype=F32, device=dev)
    dc_state = torch.empty((S, C), dtype=F32, device=dev)
    dr_state = torch.empty((S, P), dtype=F32, device=dev)
    row, slab = _sweep_scratch(plan, dev)
    dxg = torch.empty((S, T, G), dtype=st, device=dev)
    drnew = torch.empty((T, S, P), dtype=st, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.lstmp_train_bwd(
            int(st == BF16), int(pt == BF16), dys.data_ptr(), mask.data_ptr(),
            gates.data_ptr(), cs.data_ptr(), init_c.data_ptr(),
            w_r.data_ptr(), w_rm.data_ptr(), _ptr(w_rm_t), _ptr(w_r_t),
            peep.data_ptr(), d_final_c.data_ptr(), d_final_r.data_ptr(),
            dc_state.data_ptr(), dr_state.data_ptr(), _ptr(dg_buf),
            dxg.data_ptr(), drnew.data_ptr(), S, T, C, P, float(cell_clip),
            *plan.kernel_args(backward=True), _ptr(row), _ptr(slab),
            current_stream(dev))
        lstmp_train_bwd.launches += 1
        lstmp_train_bwd.per_step += not plan.persistent
    if err != 0:
        raise RuntimeError(f"lstmp_train_bwd failed: CUDA error {err}")
    return (dxg, dc_state, dr_state,
            *_weight_grads(dxg, drnew, gates, cs, rs, init_c, init_r, pt))


lstmp_train_bwd.launches = 0
lstmp_train_bwd.per_step = 0


def lstmp_train_bwd_reference(dys, mask, gates, cs, rs, w_gifo_r, w_r_m,
                              peep, init_c, init_r, d_final_c, d_final_r,
                              cell_clip: float = 50.0,
                              mxu_bf16: Optional[bool] = None):
    """Plain PyTorch version of the backward kernel: the reverse sweep of
    lstm_pallas.py:_lstmp_bwd_kernel, then :func:`_weight_grads`."""
    T, S, G = gates.shape
    P, C = w_r_m.shape
    st = gates.dtype
    pt = _products(st, mxu_bf16)
    dy = dys.float()
    c_prev = torch.cat([init_c.to(st)[None], cs[:-1]]).float()
    w_r = _operand(w_gifo_r, pt)                      # [4C, P]
    w_rm = _operand(w_r_m, pt)                        # [P, C]
    dc, dr = d_final_c, d_final_r
    dxg = gates.new_empty((S, T, G))
    drnew = gates.new_empty((T, S, P))
    for t in range(T - 1, -1, -1):
        mk = mask[:, t:t + 1]
        acts = gates[t].float()
        g, i = acts[:, :C], acts[:, C:2 * C]
        f, o = acts[:, 2 * C:3 * C], acts[:, 3 * C:]
        cp = c_prev[t]
        cu = f * cp + i * g
        c = torch.clamp(cu, -cell_clip, cell_clip) if cell_clip > 0 else cu
        tc = torch.tanh(c)
        dr_after = dy[:, t] * mk + dr
        dr_new = mk * dr_after
        dm = _operand(dr_new, pt) @ w_rm
        dcv = mk * dc + dm * o * (1.0 - tc * tc)
        do_lin = dm * tc * o * (1.0 - o)
        dcv = dcv + do_lin * peep[2]
        if cell_clip > 0:
            dcv = dcv * (cu.abs() < cell_clip).float()
        di_lin = dcv * g * i * (1.0 - i)
        df_lin = dcv * cp * f * (1.0 - f)
        dg_lin = dcv * i * (1.0 - g * g)
        dc = (dcv * f + di_lin * peep[0] + df_lin * peep[1]
              + (1.0 - mk) * dc)
        dgates = torch.cat([dg_lin, di_lin, df_lin, do_lin], dim=1)
        dxg[:, t] = dgates.to(st)
        drnew[t] = dr_new.to(st)
        dr = (1.0 - mk) * dr_after + _operand(dgates, pt) @ w_r
    return (dxg, dc, dr,
            *_weight_grads(dxg, drnew, gates, cs, rs, init_c, init_r, pt))


def _weight_grads(dxg, drnew, gates, cs, rs, init_c, init_r, pt):
    """(d_w_gifo_r [4C, P], d_w_r_m [P, C], dpeep [3, C]): the reductions
    over all frames and streams of lstm_pallas.py:426-451, from the stored
    (storage-dtype) streams, with the initial state in the storage dtype
    at t = 0 (lstm_pallas.py:496-499); their operands rounded to the
    product dtype ``pt`` as ``mm2`` rounds them."""
    st = gates.dtype
    C = cs.shape[-1]
    r_prev = torch.cat([init_r.to(st)[None], rs[:-1]])    # [T, S, P]
    c_prev = torch.cat([init_c.to(st)[None], cs[:-1]]).float()
    dxg_t = dxg.transpose(0, 1).float()                   # [T, S, 4C]

    def mm2(a, b):      # einsum "tsa,tsb->ab", float32 sums
        a = _operand(a, pt).reshape(-1, a.shape[-1])
        b = _operand(b, pt).reshape(-1, b.shape[-1])
        return a.t() @ b

    c_seq = cs.float()
    m_seq = gates[..., 3 * C:].float() * torch.tanh(c_seq)
    dwr = mm2(r_prev, dxg_t)                              # [P, 4C]
    dwrm = mm2(m_seq, drnew)                              # [C, P]
    dpeep = torch.stack([
        (dxg_t[..., C:2 * C] * c_prev).sum((0, 1)),
        (dxg_t[..., 2 * C:3 * C] * c_prev).sum((0, 1)),
        (dxg_t[..., 3 * C:] * c_seq).sum((0, 1))])
    return dwr.t(), dwrm.t(), dpeep


# -- autograd ----------------------------------------------------------------

class LstmpTrainCore(torch.autograd.Function):
    """Custom-VJP LSTMP core, the counterpart of ``_get_lstmp_core`` /
    ``lstmp_train_core``.

    apply(xg [S, T, 4C], mask [S, T], w_gifo_r [4C, P], w_r_m [P, C],
    peep [3, C], init_c [S, C], init_r [S, P], cell_clip, store_bf16,
    mxu_bf16) -> (ys [S, T, P] in the storage dtype, final_c, final_r
    float32).  ``store_bf16`` and ``mxu_bf16`` are the TPU core's flags
    (bf16 products need bf16 storage).  xg is cast to the storage dtype
    before the sweep (lstm_pallas.py:346); ys = rs * mask and the final state come from
    the stored streams (:473-476).  Gradients flow to everything but the
    mask and the flags, in float32 (xg's in its own dtype)."""

    @staticmethod
    def forward(ctx, xg, mask, w_gifo_r, w_r_m, peep, init_c, init_r,
                cell_clip, store_bf16, mxu_bf16):
        st = BF16 if store_bf16 else F32
        mask = mask.float().contiguous()
        init_c = init_c.float().contiguous()
        init_r = init_r.float().contiguous()
        w_gifo_r, w_r_m = w_gifo_r.contiguous(), w_r_m.contiguous()
        peep = peep.float().contiguous()
        gates, cs, rs = lstmp_train_fwd(
            xg.to(st).contiguous(), mask, w_gifo_r, w_r_m, peep, init_c,
            init_r, cell_clip, mxu_bf16)
        ctx.save_for_backward(mask, gates, cs, rs, w_gifo_r, w_r_m, peep,
                              init_c, init_r)
        ctx.cell_clip, ctx.mxu_bf16 = cell_clip, mxu_bf16
        ctx.xg_dtype = xg.dtype
        ys = rs.transpose(0, 1) * mask[:, :, None].to(st)
        return ys, cs[-1].to(F32, copy=True), rs[-1].to(F32, copy=True)

    @staticmethod
    def backward(ctx, d_ys, d_c, d_r):
        (mask, gates, cs, rs, w_gifo_r, w_r_m, peep, init_c,
         init_r) = ctx.saved_tensors
        dxg, dic, dir_, dwr, dwrm, dpeep = lstmp_train_bwd(
            d_ys.to(gates.dtype).contiguous(), mask, gates, cs, rs,
            w_gifo_r, w_r_m, peep, init_c, init_r, d_c.float().contiguous(),
            d_r.float().contiguous(), ctx.cell_clip, ctx.mxu_bf16)
        return (dxg.to(ctx.xg_dtype), None, dwr, dwrm, dpeep, dic, dir_,
                None, None, None)
