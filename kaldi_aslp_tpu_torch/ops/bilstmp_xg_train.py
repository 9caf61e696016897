"""Bidirectional LSTMP training core fed the input projections (the xg-fed
core): the hand-written CUDA kernels, their plain PyTorch versions, and
the ``torch.autograd.Function`` around them.

Port of the JAX package's xg-fed bidirectional core
(kaldi_aslp_tpu/ops/lstm_pallas.py:544-1005): ``_bilstmp_fwd_kernel``
(:561) and ``_bilstmp_bwd_kernel`` (:618), their wrappers
``_bilstmp_train_fwd`` / ``_bilstmp_train_bwd``, the custom VJP
``_get_bilstmp_core`` and ``bilstmp_train_core``, which the JAX
package's bf16 BLSTMP takes in training under ``KALDI_ASLP_LSTM_NO_XFUSE``
or ``KALDI_ASLP_LSTM_MXU_FP32`` (models/recurrent.py:474-486).  The
kernels are ``csrc/bilstmp_xg_train.cu``, built for ``sm_90a`` and bound
with ``ctypes``; the note at the top of that file says how the TPU design
was rethought for the H100.  Each call is one persistent sweep of both
directions, picked by :func:`plan_for` from the shapes and the product
mode: with bf16 products the x-fused pair's tensor-core sweeps
(csrc/bilstmp_sweep.cuh), with float32 products the FMA sweeps, past
either's capacity the per-step kernels.  The backward's dW_r and dW_rm
run on the hand GEMM :func:`bilstmp_gemm_bf16`.

Rounding follows the TPU kernels (``store_bf16=True``, as the JAX
package calls them):
  - xgf and xgb are bf16 and bias-free; the kernel adds the bias,
    ``gates = (xg + bias) + r_prev . W_r^T``;
  - the product operands (r_prev and W_r, m and W_rm, dr_new and W_rm^T,
    dgates and W_r^T) are rounded to bf16 only with ``mxu_bf16``
    (``_mm_k``); without it they meet in float32;
  - the stored gates, c and r, the output ys, dy, the emitted dxg,
    dr_new and m are bf16 in both modes; the state is float32;
  - dbias and dpeep are summed from the unrounded float32 dgates;
  - dW_r and dW_rm are reduced after the sweep over the stored bf16
    streams with float32 sums (lstm_pallas.py:878-894), r_prev being the
    stored bf16 r with bf16(init_r) at direction f's t = 0 and zero at
    direction b's t = T-1 (:946-951) in both modes.
The S_BLK = 128 stream padding of ``bilstmp_train_core`` is a TPU tiling
artefact and is not ported.

Stream layouts (d = direction, f then b; G = 4C): gates [2, S, T, G],
cs [2, S, T, C], rprev [2, S, T, P] bf16, where rprev[d, :, t] is the r
that frame t of direction d starts from; dxg [2, S, T, G]."""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from kaldi_aslp_tpu_torch.ops.bilstmp_train import (
    bilstmp_gemm_bf16,
    bilstmp_gemm_bf16_reference,
)
from kaldi_aslp_tpu_torch.ops.build import (
    check_tensors,
    current_stream,
    load_library,
)
from kaldi_aslp_tpu_torch.ops.sweep_plan import (
    BAR_WORDS,
    TENSOR_CORE,
    XgSweepPlan,
    _round_up,
    bilstmp_xg_plan,
)

SOURCE = "bilstmp_xg_train.cu"
BF16 = torch.bfloat16
F32 = torch.float32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (pointers after the mode flag, then S, T, C, P, cell_clip and the rest)
_SIGNATURES = {
    "bilstmp_xg_sweep_fwd": (13, [_I] * 4 + [_L, _P, _P, _P]),
    "bilstmp_xg_sweep_bwd": (14, [_I] * 4 + [_L, _P, _P, _P]),
    "bilstmp_xg_train_fwd": (14, []),
    "bilstmp_xg_train_bwd": (16, []),
}


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    for name, (n_ptr, tail) in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([_I] + [_P] * n_ptr + [_I] * 4
                           + [ctypes.c_float] + tail + [_P])
            fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _library()


def plan_for(S: int, C: int, P: int, mxu_bf16: bool,
             device: torch.device) -> XgSweepPlan:
    """The pair's launch plan on ``device``'s card: a persistent sweep for
    the product mode, or past its capacity the per-step kernels
    (ops/sweep_plan.py:bilstmp_xg_plan)."""
    return _plan(S, C, P, torch.cuda.get_device_properties(
        device).multi_processor_count, bool(mxu_bf16))


# a training step asks for the same few plans again and again
_plan = functools.lru_cache(maxsize=64)(bilstmp_xg_plan)


def _sweep_scratch(plan: XgSweepPlan, dev: torch.device, backward: bool):
    """(row, part, bar) of a persistent sweep.  Tensor-core sweeps: the
    step's bf16 state row [2, S, pp] (r_prev forward, dr_new backward) and
    the bf16 m rows [2, S, cp] (forward) or dgates rows [2, S, 4 cp]
    (backward), zero-padded to 16 columns a gate; no barrier words.  FMA
    sweeps: the float32 state row [2, S, pp] and partial slabs
    [2, nbd, S, pp] (the kernel fills both) and the directions' barrier
    counters (the kernel clears them)."""
    S, C = plan.S, plan.C
    pp = plan.row_width()
    if plan.path == TENSOR_CORE:
        cp = _round_up(C, 16)
        row = torch.zeros((2, S, pp), dtype=BF16, device=dev)
        part = torch.zeros((2, S, 4 * cp if backward else cp), dtype=BF16,
                           device=dev)
        return row, part, None
    return (torch.empty((2, S, pp), dtype=F32, device=dev),
            torch.empty((2, plan.blocks_per_dir, S, pp), dtype=F32,
                        device=dev),
            torch.empty(BAR_WORDS, dtype=torch.int32, device=dev))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _operand(t: torch.Tensor, mxu_bf16: bool) -> torch.Tensor:
    """A product operand in float32, rounded to bf16 first with
    ``mxu_bf16`` (bf16 x bf16 is exact in float32, so float32 sums of
    these are what the kernels compute)."""
    return t.to(BF16).float() if mxu_bf16 else t.float()


def _check_device(device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"no BLSTMP xg training kernel for device {device}")


# -- forward -----------------------------------------------------------------

def bilstmp_xg_train_fwd(xgf, xgb, mask, wr, wrm, peep, bias, init_c,
                         init_r, cell_clip: float = 50.0,
                         mxu_bf16: bool = True):
    """Training forward of both directions.

    xgf, xgb [S, T, 4C] bf16, bias-free; mask [S, T]; wr [2, 4C, P],
    wrm [2, P, C], peep [2, 3, C], bias [2, 4C] float32 (the parameters'
    layouts, f then b); init_c [S, C], init_r [S, P] float32 (direction b
    starts from zero).  Returns (ys [S, T, 2P], gates, cs, rprev) in bf16
    and the final state of direction f (c_T [S, C], r_T [S, P]) in
    float32.

    On a CUDA tensor this launches the kernel or raises; a CPU tensor
    takes :func:`bilstmp_xg_train_fwd_reference`.  :func:`plan_for` picks
    the persistent sweep of the product mode or the per-step kernels.
    ``bilstmp_xg_train_fwd.launches`` counts calls into the C entries, and
    ``.per_step`` those that took the per-step kernels."""
    S, T, G = xgf.shape
    P, C = wrm.shape[1], wrm.shape[2]
    check_tensors(xgf.device, {
        "xgf": (xgf, (S, T, 4 * C), BF16), "xgb": (xgb, (S, T, 4 * C), BF16),
        "mask": (mask, (S, T), F32), "wr": (wr, (2, 4 * C, P), F32),
        "wrm": (wrm, (2, P, C), F32), "peep": (peep, (2, 3, C), F32),
        "bias": (bias, (2, 4 * C), F32), "init_c": (init_c, (S, C), F32),
        "init_r": (init_r, (S, P), F32)})
    if T == 0:
        raise ValueError("xg has no frames")
    if xgf.device.type == "cpu":
        return bilstmp_xg_train_fwd_reference(xgf, xgb, mask, wr, wrm, peep,
                                              bias, init_c, init_r,
                                              cell_clip, mxu_bf16)
    _check_device(xgf.device)
    dev = xgf.device
    plan = plan_for(S, C, P, mxu_bf16, dev)
    wt = BF16 if mxu_bf16 else F32
    c_state = torch.stack([init_c, torch.zeros_like(init_c)])
    r_state = torch.stack([init_r, torch.zeros_like(init_r)])
    gates = torch.empty((2, S, T, G), dtype=BF16, device=dev)
    cs = torch.empty((2, S, T, C), dtype=BF16, device=dev)
    rprev = torch.empty((2, S, T, P), dtype=BF16, device=dev)
    rprev[0, :, 0] = init_r.to(BF16)
    rprev[1, :, T - 1] = 0
    ys = torch.empty((S, T, 2 * P), dtype=BF16, device=dev)
    # the weights rounded once to the products' type
    w_r, w_rm = wr.to(wt).contiguous(), wrm.to(wt).contiguous()
    arrays = (xgf.data_ptr(), xgb.data_ptr(), mask.data_ptr(),
              w_r.data_ptr(), w_rm.data_ptr(), peep.data_ptr(),
              bias.data_ptr(), c_state.data_ptr(), r_state.data_ptr())
    streams = (gates.data_ptr(), cs.data_ptr(), rprev.data_ptr(),
               ys.data_ptr(), S, T, C, P, float(cell_clip))
    lib = _library()
    with torch.cuda.device(dev):
        if plan.persistent:
            row, part, bar = _sweep_scratch(plan, dev, backward=False)
            if plan.path == TENSOR_CORE:
                row[0, :, :P] = init_r.to(BF16)
            err = lib.bilstmp_xg_sweep_fwd(
                int(mxu_bf16), *arrays, *streams,
                *plan.kernel_args(backward=False), row.data_ptr(),
                part.data_ptr(), _ptr(bar), current_stream(dev))
        else:
            m_buf = torch.empty((2, S, C), dtype=F32, device=dev)
            err = lib.bilstmp_xg_train_fwd(
                int(mxu_bf16), *arrays, m_buf.data_ptr(), *streams,
                current_stream(dev))
        bilstmp_xg_train_fwd.launches += 1
        bilstmp_xg_train_fwd.per_step += not plan.persistent
    if err != 0:
        raise RuntimeError(f"bilstmp_xg_train_fwd failed: CUDA error {err}")
    return ys, gates, cs, rprev, c_state[0], r_state[0]


bilstmp_xg_train_fwd.launches = 0
bilstmp_xg_train_fwd.per_step = 0


def bilstmp_xg_train_fwd_reference(xgf, xgb, mask, wr, wrm, peep, bias,
                                   init_c, init_r, cell_clip: float = 50.0,
                                   mxu_bf16: bool = True):
    """Plain PyTorch version of the forward kernel: a loop over T with the
    equations of lstm_pallas.py:_bilstmp_fwd_kernel."""
    S, T, G = xgf.shape
    P, C = wrm.shape[1], wrm.shape[2]
    xg = [xgf.float(), xgb.float()]
    wr_t = [_operand(wr[d], mxu_bf16).t() for d in range(2)]     # [P, G]
    wrm_t = [_operand(wrm[d], mxu_bf16).t() for d in range(2)]   # [C, P]
    c = [init_c, torch.zeros_like(init_c)]
    r = [init_r, torch.zeros_like(init_r)]
    gates = xgf.new_empty((2, S, T, G))
    cs = xgf.new_empty((2, S, T, C))
    rprev = xgf.new_empty((2, S, T, P))
    rprev[0, :, 0] = init_r.to(BF16)
    rprev[1, :, T - 1] = 0
    ys = xgf.new_empty((S, T, 2 * P))
    for step in range(T):
        for d in range(2):
            t = step if d == 0 else T - 1 - step
            lin = (xg[d][:, t] + bias[d]) + _operand(r[d], mxu_bf16) @ wr_t[d]
            g = torch.tanh(lin[:, :C])
            i = torch.sigmoid(lin[:, C:2 * C] + peep[d, 0] * c[d])
            f = torch.sigmoid(lin[:, 2 * C:3 * C] + peep[d, 1] * c[d])
            cn = f * c[d] + i * g
            if cell_clip > 0:
                cn = torch.clamp(cn, -cell_clip, cell_clip)
            o = torch.sigmoid(lin[:, 3 * C:] + peep[d, 2] * cn)
            rn = _operand(o * torch.tanh(cn), mxu_bf16) @ wrm_t[d]
            mk = mask[:, t:t + 1]
            c[d] = mk * cn + (1.0 - mk) * c[d]
            r[d] = mk * rn + (1.0 - mk) * r[d]
            gates[d, :, t] = torch.cat([g, i, f, o], dim=1).to(BF16)
            cs[d, :, t] = c[d].to(BF16)
            rb = r[d].to(BF16)
            if d == 0 and t + 1 < T:
                rprev[0, :, t + 1] = rb
            if d == 1 and t >= 1:
                rprev[1, :, t - 1] = rb
            ys[:, t, d * P:(d + 1) * P] = (rb.float() * mk.to(BF16).float()
                                           ).to(BF16)
    return ys, gates, cs, rprev, c[0], r[0]


# -- backward ----------------------------------------------------------------

def bilstmp_xg_train_bwd(dy, mask, gates, cs, rprev, wr, wrm, peep, init_c,
                         d_c_T, d_r_T, cell_clip: float = 50.0,
                         mxu_bf16: bool = True):
    """Training backward of both directions: the reverse sweeps (with the
    dbias and dpeep sums), then the dW_r and dW_rm reductions.

    dy [S, T, 2P] bf16; d_c_T [S, C], d_r_T [S, P] float32 cotangents of
    direction f's final state; the rest as :func:`bilstmp_xg_train_fwd`
    took or returned them.  Returns (dxg [2, S, T, 4C] bf16, the
    cotangents of xgf and xgb; d_init_c, d_init_r, dwr [2, 4C, P],
    dwrm [2, P, C], dbias [2, 4C], dpeep [2, 3, C] float32).

    On a CUDA tensor the sweep launches the kernel or raises, and the two
    reductions run on the hand GEMM (:func:`bilstmp_gemm_bf16`); a CPU
    tensor takes :func:`bilstmp_xg_train_bwd_reference`.  The plan and
    the counters ``bilstmp_xg_train_bwd.launches`` / ``.per_step`` as for
    :func:`bilstmp_xg_train_fwd`."""
    S, T = mask.shape
    P, C = wrm.shape[1], wrm.shape[2]
    G = 4 * C
    check_tensors(mask.device, {
        "dy": (dy, (S, T, 2 * P), BF16), "mask": (mask, (S, T), F32),
        "gates": (gates, (2, S, T, G), BF16), "cs": (cs, (2, S, T, C), BF16),
        "rprev": (rprev, (2, S, T, P), BF16), "wr": (wr, (2, G, P), F32),
        "wrm": (wrm, (2, P, C), F32), "peep": (peep, (2, 3, C), F32),
        "init_c": (init_c, (S, C), F32), "d_c_T": (d_c_T, (S, C), F32),
        "d_r_T": (d_r_T, (S, P), F32)})
    if mask.device.type == "cpu":
        return bilstmp_xg_train_bwd_reference(dy, mask, gates, cs, rprev, wr,
                                              wrm, peep, init_c, d_c_T,
                                              d_r_T, cell_clip, mxu_bf16)
    _check_device(mask.device)
    dev = mask.device
    plan = plan_for(S, C, P, mxu_bf16, dev)
    wt = BF16 if mxu_bf16 else F32
    if plan.persistent and plan.path != TENSOR_CORE:
        # the FMA sweep reads the weights in their own layouts
        w_a, w_b = wr.contiguous(), wrm.contiguous()
    else:
        w_r_t = wr.transpose(1, 2).to(wt).contiguous()     # [2, P, G]
        w_rm_t = wrm.transpose(1, 2).to(wt).contiguous()   # [2, C, P]
        # the tensor-core sweep takes (W_r^T, W_rm^T), the per-step
        # kernels (W_rm^T, W_r^T)
        w_a, w_b = (w_r_t, w_rm_t) if plan.persistent else (w_rm_t, w_r_t)
    dc_state = torch.stack([d_c_T, torch.zeros_like(d_c_T)])
    dr_state = torch.stack([d_r_T, torch.zeros_like(d_r_T)])
    dxg = torch.empty((2, S, T, G), dtype=BF16, device=dev)
    m_s = torch.empty((2, S, T, C), dtype=BF16, device=dev)
    drn = torch.empty((2, S, T, P), dtype=BF16, device=dev)
    dbp = torch.empty((2, 7 * C), dtype=F32, device=dev)
    head = (dy.data_ptr(), mask.data_ptr(), gates.data_ptr(), cs.data_ptr(),
            init_c.data_ptr(), w_a.data_ptr(), w_b.data_ptr(),
            peep.data_ptr(), dc_state.data_ptr(), dr_state.data_ptr())
    tail = (dxg.data_ptr(), m_s.data_ptr(), drn.data_ptr(), dbp.data_ptr(),
            S, T, C, P, float(cell_clip))
    lib = _library()
    with torch.cuda.device(dev):
        if plan.persistent:
            row, part, bar = _sweep_scratch(plan, dev, backward=True)
            err = lib.bilstmp_xg_sweep_bwd(
                int(mxu_bf16), *head, *tail,
                *plan.kernel_args(backward=True), row.data_ptr(),
                part.data_ptr(), _ptr(bar), current_stream(dev))
        else:
            acc = torch.zeros((2, S, 7 * C), dtype=F32, device=dev)
            dg_buf = torch.empty((2, S, G), dtype=F32, device=dev)
            err = lib.bilstmp_xg_train_bwd(
                int(mxu_bf16), *head, acc.data_ptr(), dg_buf.data_ptr(),
                *tail, current_stream(dev))
        bilstmp_xg_train_bwd.launches += 1
        bilstmp_xg_train_bwd.per_step += not plan.persistent
    if err != 0:
        raise RuntimeError(f"bilstmp_xg_train_bwd failed: CUDA error {err}")
    return (dxg, dc_state[0], dr_state[0],
            *_weight_grads(dxg, drn, m_s, rprev, bilstmp_gemm_bf16),
            dbp[:, :G], dbp[:, G:].reshape(2, 3, C))


bilstmp_xg_train_bwd.launches = 0
bilstmp_xg_train_bwd.per_step = 0


def bilstmp_xg_train_bwd_reference(dy, mask, gates, cs, rprev, wr, wrm,
                                   peep, init_c, d_c_T, d_r_T,
                                   cell_clip: float = 50.0,
                                   mxu_bf16: bool = True):
    """Plain PyTorch version of the backward kernel: the reverse sweep of
    lstm_pallas.py:_bilstmp_bwd_kernel, then :func:`_weight_grads`."""
    S, T = mask.shape
    P, C = wrm.shape[1], wrm.shape[2]
    G = 4 * C
    dyf = dy.float()
    wr_o = [_operand(wr[d], mxu_bf16) for d in range(2)]       # [G, P]
    wrm_o = [_operand(wrm[d], mxu_bf16) for d in range(2)]     # [P, C]
    dc = [d_c_T, torch.zeros_like(d_c_T)]
    dr = [d_r_T, torch.zeros_like(d_r_T)]
    dxg = gates.new_empty((2, S, T, G))
    m_s = gates.new_empty((2, S, T, C))
    drn = gates.new_empty((2, S, T, P))
    dbias = torch.zeros((2, G), device=mask.device)
    dpeep = torch.zeros((2, 3, C), device=mask.device)
    zero_c = torch.zeros_like(init_c)
    for step in range(T):
        for d in range(2):
            t = T - 1 - step if d == 0 else step
            mk = mask[:, t:t + 1]
            dr_after = dyf[:, t, d * P:(d + 1) * P] * mk + dr[d]
            dr_new = mk * dr_after
            dm = _operand(dr_new, mxu_bf16) @ wrm_o[d]
            if d == 0:
                cp = cs[0, :, t - 1].float() if t > 0 else init_c
            else:
                cp = cs[1, :, t + 1].float() if t < T - 1 else zero_c
            acts = gates[d, :, t].float()
            g, i = acts[:, :C], acts[:, C:2 * C]
            f, o = acts[:, 2 * C:3 * C], acts[:, 3 * C:]
            cu = f * cp + i * g
            c = torch.clamp(cu, -cell_clip, cell_clip) if cell_clip > 0 \
                else cu
            tc = torch.tanh(c)
            m_s[d, :, t] = (o * tc).to(BF16)
            dcv = mk * dc[d] + dm * o * (1.0 - tc * tc)
            do_lin = dm * tc * o * (1.0 - o)
            dcv = dcv + do_lin * peep[d, 2]
            if cell_clip > 0:
                dcv = torch.where(cu.abs() < cell_clip, dcv, 0.0)
            di_lin = dcv * g * i * (1.0 - i)
            df_lin = dcv * cp * f * (1.0 - f)
            dg_lin = dcv * i * (1.0 - g * g)
            dc[d] = (dcv * f + di_lin * peep[d, 0] + df_lin * peep[d, 1]
                     + (1.0 - mk) * dc[d])
            dgl = torch.cat([dg_lin, di_lin, df_lin, do_lin], dim=1)
            dxg[d, :, t] = dgl.to(BF16)
            dbias[d] += dgl.sum(0)
            dpeep[d, 0] += (di_lin * cp).sum(0)
            dpeep[d, 1] += (df_lin * cp).sum(0)
            dpeep[d, 2] += (do_lin * c).sum(0)
            dr[d] = (1.0 - mk) * dr_after + _operand(dgl, mxu_bf16) @ wr_o[d]
            drn[d, :, t] = dr_new.to(BF16)
    return (dxg, dc[0], dr[0],
            *_weight_grads(dxg, drn, m_s, rprev, bilstmp_gemm_bf16_reference),
            dbias, dpeep)


def _weight_grads(dxg, drn, m_s, rprev, gemm):
    """(dwr [2, 4C, P], dwrm [2, P, C]): lstm_pallas.py:878-894's ``mm2``
    over every frame and stream of the stored bf16 streams, bf16 operands
    and float32 sums (so ``mxu_bf16`` changes nothing), by ``gemm``: the
    hand GEMM or its plain version."""
    def mm2(a, b):      # einsum "dsta,dstb->dab"
        return gemm(a.flatten(1, 2).transpose(1, 2), b.flatten(1, 2))
    return mm2(dxg, rprev), mm2(drn, m_s)


# -- autograd ----------------------------------------------------------------

class BiLstmpXgTrainCore(torch.autograd.Function):
    """Custom-VJP xg-fed bidirectional LSTMP core, the counterpart of
    ``_get_bilstmp_core`` / ``bilstmp_train_core(store_bf16=True)``.

    apply(xgf, xgb [S, T, 4C] (bias-free, used as bf16), mask [S, T],
    wf_gifo_r [4C, P], wf_r_m [P, C], peep_f [3, C], wb_gifo_r, wb_r_m,
    peep_b, bias_f, bias_b [4C], init_c [S, C], init_r [S, P], cell_clip,
    mxu_bf16) -> (ys [S, T, 2P] bf16, c_T [S, C], r_T [S, P] float32).
    The float32 parameters get float32 gradients, unrounded; xgf and xgb
    get the bf16 dxg in their own dtype."""

    @staticmethod
    def forward(ctx, xgf, xgb, mask, wf_gifo_r, wf_r_m, peep_f, wb_gifo_r,
                wb_r_m, peep_b, bias_f, bias_b, init_c, init_r, cell_clip,
                mxu_bf16):
        wr = torch.stack([wf_gifo_r, wb_gifo_r]).float()
        wrm = torch.stack([wf_r_m, wb_r_m]).float()
        peep = torch.stack([peep_f, peep_b]).float()
        bias = torch.stack([bias_f, bias_b]).float()
        mask = mask.float().contiguous()
        init_c = init_c.float().contiguous()
        ys, gates, cs, rprev, c_T, r_T = bilstmp_xg_train_fwd(
            xgf.to(BF16).contiguous(), xgb.to(BF16).contiguous(), mask, wr,
            wrm, peep, bias, init_c, init_r.float().contiguous(), cell_clip,
            mxu_bf16)
        ctx.save_for_backward(mask, gates, cs, rprev, wr, wrm, peep, init_c)
        ctx.cell_clip, ctx.mxu_bf16 = cell_clip, mxu_bf16
        ctx.xg_dtypes = (xgf.dtype, xgb.dtype)
        return ys, c_T, r_T

    @staticmethod
    def backward(ctx, d_ys, d_c, d_r):
        mask, gates, cs, rprev, wr, wrm, peep, init_c = ctx.saved_tensors
        S, T = mask.shape
        P = rprev.shape[-1]
        if d_ys is None:
            d_ys = mask.new_zeros((S, T, 2 * P))
        d_c = init_c.new_zeros(init_c.shape) if d_c is None else d_c
        d_r = init_c.new_zeros((S, P)) if d_r is None else d_r
        dxg, dic, dir_, dwr, dwrm, dbias, dpeep = bilstmp_xg_train_bwd(
            d_ys.to(BF16).contiguous(), mask, gates, cs, rprev, wr, wrm,
            peep, init_c, d_c.float().contiguous(),
            d_r.float().contiguous(), ctx.cell_clip, ctx.mxu_bf16)
        return (dxg[0].to(ctx.xg_dtypes[0]), dxg[1].to(ctx.xg_dtypes[1]),
                None, dwr[0], dwrm[0], dpeep[0], dwr[1], dwrm[1], dpeep[1],
                dbias[0], dbias[1], dic, dir_, None, None)
