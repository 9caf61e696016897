"""Bidirectional LSTMP training core: the hand-written CUDA kernels, their
plain PyTorch versions, and the ``torch.autograd.Function`` around them.

Port of the x-fused bidirectional core of kaldi_aslp_tpu/ops/lstm_pallas.py
(``_bixfused_fwd_kernel``, ``_bixfused_bwd_kernel`` and the per-direction
``_xfused_bwd_kernel``, their wrappers ``_bixfused_train_fwd`` /
``_bixfused_train_bwd`` / ``_xfused_train_bwd_dir``, the custom VJP
``_get_bixfused_core`` and ``bilstmp_xfused_train_core``), which the JAX
package's bf16 BLSTMP takes in training (models/recurrent.py:428-473).
Under ``KALDI_ASLP_LSTM_SPLIT_BWD`` the backward runs one direction at a
time (lstm_pallas.py:1612-1639), through :func:`bilstmp_train_bwd_dir`.
The kernels are ``csrc/bilstmp_train.cu``, built for ``sm_90a`` and bound
with ``ctypes``; the note at the top of that file says how the TPU design
was rethought for the H100: a hoisted bf16 GEMM (:func:`bilstmp_gemm_bf16`
reaches it alone) and one cooperative, persistent kernel per sweep that
keeps each block's slices of the recurrent weights in shared memory.
:func:`sweep_plan` lays that kernel out and says what fits.

Rounding follows the TPU kernels: bf16 operands with float32 sums in
every product, float32 cell math and state, the activated gates, c and
r stored in bf16, the layer output bf16(r) * mask, dy rounded to bf16
before the sweep, and dx emitted in bf16 per direction and summed in
float32 before its last rounding.  The TPU padding of D to 128 lanes and
of S to 128-row blocks is not ported.

Stream layouts (d = direction, f then b; G = 4C):
  gates [2, S, T, G], cs [2, S, T, C], rprev [2, S, T, P] bf16, where
  rprev[d, :, t] is the r that frame t of direction d starts from
  (direction f's t = 0 holds bf16(init_r), direction b's t = T-1 zero)."""

from __future__ import annotations

import ctypes
import math

import torch

from kaldi_aslp_tpu_torch.ops.build import (
    check_tensors,
    current_stream,
    load_library,
)
from kaldi_aslp_tpu_torch.ops.sweep_plan import _round_up, sweep_plan
from kaldi_aslp_tpu_torch.ops.switches import lstm_switches
from kaldi_aslp_tpu_torch.utils.profile import span

SOURCE = "bilstmp_train.cu"
BF16 = torch.bfloat16

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (leading arguments, pointers, trailing arguments before the stream)
_SIGNATURES = {
    "bilstmp_train_fwd": ([], 15, [_I] * 5 + [ctypes.c_float, _P]
                          + [_I] * 4 + [_L]),
    "bilstmp_train_bwd": ([], 23, [_I] * 5 + [ctypes.c_float, _P, _P]
                          + [_I] * 4 + [_L] + [_I] * 3),
    "bilstmp_train_bwd_dir": ([_I], 23, [_I] * 5 + [ctypes.c_float, _P, _P]
                              + [_I] * 4 + [_L] + [_I] * 3),
    "bilstmp_gemm_bf16": ([], 0, [_P, _L, _L, _L, _P, _L, _L, _L, _P, _L,
                                  _L] + [_I] * 5 + [_P]),
}


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    for name, (head, n_ptr, tail) in _SIGNATURES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = head + [_P] * n_ptr + tail + [_P]
            fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _library()


def _bf(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and come back to float32."""
    return t.to(BF16).float()


def _empty(device: torch.device, dtype: torch.dtype, *shape: int):
    return torch.empty(shape, dtype=dtype, device=device)


def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# The launch plan of the persistent sweeps: ops/sweep_plan.py.

# -- the hoisted GEMM --------------------------------------------------------

SPLIT_K_MIN = 2048        # K a split-K slice covers at least


def gemm_splits(M: int, N: int, K: int, num_sms: int) -> int:
    """Slices of K for an [M, N] product: enough for one matrix's tiles
    (128 x 256 for N >= 1024, else 128 x 128, one block a SM) to fill the
    card's SMs once, each slice at least SPLIT_K_MIN deep.  It depends on
    the shape alone, not on the batch, so one direction's product has the
    same bits alone as in a batch of two."""
    tiles = math.ceil(M / 128) * math.ceil(N / (256 if N >= 1024 else 128))
    return max(1, min(math.ceil(num_sms / tiles), K // SPLIT_K_MIN))


def bilstmp_gemm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a[i] . b[i]`` in float32 from bf16 operands: the hoisted GEMM of
    the x-fused kernels (x . W_x^T in the forward; dx, dW_x, dW_r, dW_rm
    in the backward), reached alone.

    a [batch, M, K] and b [batch, K, N] bf16 (or both 2-D), each with unit
    stride along one of its last two dimensions, so a transposed view
    takes the transposed layout; a batch stride of 0 (``expand``) shares
    one matrix.  K is cut into :func:`gemm_splits` slices, summed in order
    by a second pass.  Returns [batch, M, N] (or [M, N]) float32.

    On a CUDA tensor this launches the kernel or raises; a CPU tensor
    takes :func:`bilstmp_gemm_bf16_reference`.
    ``bilstmp_gemm_bf16.launches`` counts calls into the C entry."""
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a.unsqueeze(0), b.unsqueeze(0)
    if a.dim() != 3 or b.dim() != 3 or a.dtype != BF16 or b.dtype != BF16:
        raise ValueError("a and b must be bf16 of 2 or 3 dimensions")
    (batch, M, K), (_, _, N) = a.shape, b.shape
    if tuple(b.shape[:2]) != (batch, K):
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         "chain")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if a.device.type == "cpu":
        out = bilstmp_gemm_bf16_reference(a, b)
        return out[0] if squeeze else out
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM kernel for device {a.device}")
    if not all(t.stride(2) == 1 or t.stride(1) == 1 for t in (a, b)):
        raise ValueError("each operand needs unit stride along one of its "
                         "last two dimensions")
    if min(M, N, K, batch) == 0:
        raise ValueError("empty product")
    dev = a.device
    splits = gemm_splits(M, N, K, _num_sms(dev))
    out = _empty(dev, torch.float32, batch, M, N)
    ws = (_empty(dev, torch.float32, splits * batch * M * N)
          if splits > 1 else None)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.bilstmp_gemm_bf16(
            a.data_ptr(), a.stride(0), a.stride(1), a.stride(2),
            b.data_ptr(), b.stride(0), b.stride(1), b.stride(2),
            out.data_ptr(), M * N, N, M, N, K, batch, splits,
            None if ws is None else ws.data_ptr(), current_stream(dev))
        bilstmp_gemm_bf16.launches += 1
    if err != 0:
        raise RuntimeError(f"bilstmp_gemm_bf16 failed: CUDA error {err}")
    return out[0] if squeeze else out


bilstmp_gemm_bf16.launches = 0


def bilstmp_gemm_bf16_reference(a: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the GEMM: the bf16 operands' float32
    product, as the plain sweeps compute their products."""
    return torch.matmul(a.float(), b.float())


# -- forward -----------------------------------------------------------------

def bilstmp_train_fwd(x, mask, wx, wr, wrm, peep, bias, init_c, init_r,
                      cell_clip: float = 50.0):
    """Training forward of both directions.

    x [S, T, D] bf16; mask [S, T]; wx [2, 4C, D], wr [2, 4C, P],
    wrm [2, P, C] bf16 (the parameters' layouts, f then b); peep [2, 3, C],
    bias [2, 4C], init_c [S, C], init_r [S, P] float32 (direction b
    starts from zero).  Returns (ys [S, T, 2P] bf16, gates, cs, rprev,
    c_T [S, C], r_T [S, P]) with the streams laid out as the module
    docstring says and the final state of direction f in float32.

    On a CUDA tensor this launches the kernel or raises (ValueError past
    the capacity :func:`sweep_plan` states); a CPU tensor takes
    :func:`bilstmp_train_fwd_reference`.
    ``bilstmp_train_fwd.launches`` counts calls into the C entry, each
    in the span ``aslp.op.bilstmp_train_fwd``."""
    S, T, D = x.shape
    G, P = wr.shape[1], wr.shape[2]
    C = G // 4
    check_tensors(x.device, {
        "x": (x, (S, T, D), BF16), "mask": (mask, (S, T), torch.float32),
        "wx": (wx, (2, G, D), BF16), "wr": (wr, (2, G, P), BF16),
        "wrm": (wrm, (2, P, C), BF16),
        "peep": (peep, (2, 3, C), torch.float32),
        "bias": (bias, (2, G), torch.float32),
        "init_c": (init_c, (S, C), torch.float32),
        "init_r": (init_r, (S, P), torch.float32)})
    if T == 0:
        raise ValueError("x has no frames")
    if x.device.type == "cpu":
        return bilstmp_train_fwd_reference(x, mask, wx, wr, wrm, peep, bias,
                                           init_c, init_r, cell_clip)
    if x.device.type != "cuda":
        raise ValueError(f"no BLSTMP kernel for device {x.device}")
    dev, f32 = x.device, torch.float32
    plan = sweep_plan(S, C, P, _num_sms(dev))
    c_state = torch.stack([init_c, torch.zeros_like(init_c)])
    r_state = torch.stack([init_r, torch.zeros_like(init_r)])
    xg = _empty(dev, f32, 2, S, T, G)
    # the sweep's bf16 m and r_prev rows, padded to 16 columns of zeros
    m_buf = torch.zeros((2, S, _round_up(C, 16)), dtype=BF16, device=dev)
    rb = torch.zeros((2, S, _round_up(P, 16)), dtype=BF16, device=dev)
    rb[0, :, :P] = init_r.to(BF16)
    gates = _empty(dev, BF16, 2, S, T, G)
    cs = _empty(dev, BF16, 2, S, T, C)
    rprev = _empty(dev, BF16, 2, S, T, P)
    rprev[0, :, 0] = init_r.to(BF16)
    rprev[1, :, T - 1] = 0
    ys = _empty(dev, BF16, S, T, 2 * P)
    lib = _library()
    with span("aslp.op.bilstmp_train_fwd"), torch.cuda.device(dev):
        err = lib.bilstmp_train_fwd(
            x.data_ptr(), mask.data_ptr(), wx.data_ptr(), wr.data_ptr(),
            wrm.data_ptr(), peep.data_ptr(), bias.data_ptr(), xg.data_ptr(),
            c_state.data_ptr(), r_state.data_ptr(), m_buf.data_ptr(),
            gates.data_ptr(), cs.data_ptr(), rprev.data_ptr(), ys.data_ptr(),
            S, T, D, C, P, float(cell_clip), rb.data_ptr(),
            *plan.kernel_args(backward=False), current_stream(dev))
        bilstmp_train_fwd.launches += 1
    if err != 0:
        raise RuntimeError(f"bilstmp_train_fwd failed: CUDA error {err}")
    return ys, gates, cs, rprev, c_state[0], r_state[0]


bilstmp_train_fwd.launches = 0


def bilstmp_train_fwd_reference(x, mask, wx, wr, wrm, peep, bias, init_c,
                                init_r, cell_clip: float = 50.0):
    """Plain PyTorch version of the forward kernel: a loop over T with the
    equations of lstm_pallas.py:_bixfused_fwd_kernel."""
    S, T, D = x.shape
    G, P = wr.shape[1], wr.shape[2]
    C = G // 4
    xg = [x.float() @ wx[d].float().t() for d in range(2)]   # [S, T, G]
    wr_t = [wr[d].float().t() for d in range(2)]             # [P, G]
    wrm_t = [wrm[d].float().t() for d in range(2)]           # [C, P]
    c = [init_c, torch.zeros_like(init_c)]
    r = [init_r, torch.zeros_like(init_r)]
    gates = x.new_empty((2, S, T, G), dtype=BF16)
    cs = x.new_empty((2, S, T, C), dtype=BF16)
    rprev = x.new_empty((2, S, T, P), dtype=BF16)
    rprev[0, :, 0] = init_r.to(BF16)
    rprev[1, :, T - 1] = 0
    ys = x.new_empty((S, T, 2 * P), dtype=BF16)
    for step in range(T):
        for d in range(2):
            t = step if d == 0 else T - 1 - step
            lin = bias[d] + (xg[d][:, t] + _bf(r[d]) @ wr_t[d])
            g = torch.tanh(lin[:, :C])
            i = torch.sigmoid(lin[:, C:2 * C] + peep[d, 0] * c[d])
            f = torch.sigmoid(lin[:, 2 * C:3 * C] + peep[d, 1] * c[d])
            cn = f * c[d] + i * g
            if cell_clip > 0:
                cn = torch.clamp(cn, -cell_clip, cell_clip)
            o = torch.sigmoid(lin[:, 3 * C:] + peep[d, 2] * cn)
            rn = _bf(o * torch.tanh(cn)) @ wrm_t[d]
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
            ys[:, t, d * P:(d + 1) * P] = (rb.float() * _bf(mk)).to(BF16)
    return ys, gates, cs, rprev, c[0], r[0]


# -- backward ----------------------------------------------------------------

def bwd_launch(ndir: int, S: int, T: int, D: int, C: int, P: int,
               num_sms: int):
    """What a backward C entry over ``ndir`` directions takes beyond its
    arrays and scratch rows: the sweep plan's kernel arguments, the split-K
    counts of dW_x, dW_r and dW_rm, and the float32 words of their
    workspace.  Only the workspace grows with ndir: a direction's plan and
    split counts, and so its bits, are the fused backward's."""
    G, K = 4 * C, S * T
    shapes = ((G, D), (G, P), (P, C))
    splits = tuple(gemm_splits(M, N, K, num_sms) for M, N in shapes)
    words = max([k * ndir * M * N for k, (M, N) in zip(splits, shapes)
                 if k > 1], default=0)
    return (sweep_plan(S, C, P, num_sms).kernel_args(backward=True), splits,
            words)


class _BwdScratch:
    """What a backward C entry takes beyond its arrays: the sweep's bf16
    dr_new and dgates rows (zero-padded to 16 columns a gate), the launch
    plan, the split-K counts of dW_x, dW_r and dW_rm and their float32
    workspace (``ws``, a pointer or None), from :func:`bwd_launch`."""

    def __init__(self, dev, ndir, S, T, D, C, P):
        plan_args, splits, words = bwd_launch(ndir, S, T, D, C, P,
                                              _num_sms(dev))
        cp, pp = _round_up(C, 16), _round_up(P, 16)
        self.dnb = torch.zeros((ndir, S, pp), dtype=BF16, device=dev)
        self.dgb = torch.zeros((ndir, S, 4 * cp), dtype=BF16, device=dev)
        self.workspace = (torch.empty(words, dtype=torch.float32, device=dev)
                          if words else None)
        self.ws = None if self.workspace is None else \
            self.workspace.data_ptr()
        self.args = (self.dnb.data_ptr(), self.dgb.data_ptr(), *plan_args,
                     *splits)


def bilstmp_train_bwd(dy, mask, x, gates, cs, rprev, wx, wr, wrm, peep,
                      init_c, d_c_T, d_r_T, cell_clip: float = 50.0):
    """Training backward of both directions (the reverse sweeps and the
    weight-gradient reductions).

    dy [S, T, 2P] bf16; d_c_T [S, C], d_r_T [S, P] float32 cotangents of
    direction f's final state; the rest as :func:`bilstmp_train_fwd`
    took or returned them.  Returns (dx [S, T, D] bf16, d_init_c, d_init_r,
    dwx [2, 4C, D], dwr [2, 4C, P], dwrm [2, P, C], dbias [2, 4C],
    dpeep [2, 3, C]), all but dx in float32 and unrounded.

    On a CUDA tensor this launches the kernel or raises (ValueError past
    the capacity :func:`sweep_plan` states); a CPU tensor takes
    :func:`bilstmp_train_bwd_reference`.
    ``bilstmp_train_bwd.launches`` counts calls into the C entry, each
    in the span ``aslp.op.bilstmp_train_bwd``."""
    S, T, D = x.shape
    G, P = wr.shape[1], wr.shape[2]
    C = G // 4
    check_tensors(x.device, {
        "dy": (dy, (S, T, 2 * P), BF16), "mask": (mask, (S, T), torch.float32),
        "x": (x, (S, T, D), BF16), "gates": (gates, (2, S, T, G), BF16),
        "cs": (cs, (2, S, T, C), BF16), "rprev": (rprev, (2, S, T, P), BF16),
        "wx": (wx, (2, G, D), BF16), "wr": (wr, (2, G, P), BF16),
        "wrm": (wrm, (2, P, C), BF16),
        "peep": (peep, (2, 3, C), torch.float32),
        "init_c": (init_c, (S, C), torch.float32),
        "d_c_T": (d_c_T, (S, C), torch.float32),
        "d_r_T": (d_r_T, (S, P), torch.float32)})
    if x.device.type == "cpu":
        return bilstmp_train_bwd_reference(dy, mask, x, gates, cs, rprev, wx,
                                           wr, wrm, peep, init_c, d_c_T,
                                           d_r_T, cell_clip)
    if x.device.type != "cuda":
        raise ValueError(f"no BLSTMP kernel for device {x.device}")
    dev, f32 = x.device, torch.float32
    wr_t = wr.transpose(1, 2).contiguous()
    wrm_t = wrm.transpose(1, 2).contiguous()
    dc_state = torch.stack([d_c_T, torch.zeros_like(d_c_T)])
    dr_state = torch.stack([d_r_T, torch.zeros_like(d_r_T)])
    scratch = _BwdScratch(dev, 2, S, T, D, C, P)
    dgates = _empty(dev, BF16, 2, S, T, G)
    m_out = _empty(dev, BF16, 2, S, T, C)
    drn = _empty(dev, BF16, 2, S, T, P)
    dx2, dx = _empty(dev, f32, 2, S, T, D), _empty(dev, BF16, S, T, D)
    dwx, dwr = _empty(dev, f32, 2, G, D), _empty(dev, f32, 2, G, P)
    dwrm, dbp = _empty(dev, f32, 2, P, C), _empty(dev, f32, 2, 7 * C)
    lib = _library()
    with span("aslp.op.bilstmp_train_bwd"), torch.cuda.device(dev):
        err = lib.bilstmp_train_bwd(
            dy.data_ptr(), mask.data_ptr(), x.data_ptr(), gates.data_ptr(),
            cs.data_ptr(), rprev.data_ptr(), wx.data_ptr(), wr_t.data_ptr(),
            wrm_t.data_ptr(), peep.data_ptr(), init_c.data_ptr(),
            dc_state.data_ptr(), dr_state.data_ptr(), scratch.ws,
            dgates.data_ptr(), m_out.data_ptr(), drn.data_ptr(),
            dx2.data_ptr(), dx.data_ptr(), dwx.data_ptr(), dwr.data_ptr(),
            dwrm.data_ptr(), dbp.data_ptr(),
            S, T, D, C, P, float(cell_clip), *scratch.args,
            current_stream(dev))
        bilstmp_train_bwd.launches += 1
    if err != 0:
        raise RuntimeError(f"bilstmp_train_bwd failed: CUDA error {err}")
    return (dx, dc_state[0], dr_state[0], dwx, dwr, dwrm, dbp[:, :G],
            dbp[:, G:].reshape(2, 3, C))


bilstmp_train_bwd.launches = 0


def bilstmp_train_bwd_reference(dy, mask, x, gates, cs, rprev, wx, wr, wrm,
                                peep, init_c, d_c_T, d_r_T,
                                cell_clip: float = 50.0):
    """Plain PyTorch version of the backward kernel: the reverse sweep of
    lstm_pallas.py:_bixfused_bwd_kernel per direction (the two are
    independent), then :func:`_weight_grads`; dx is summed over the
    directions in float32 from each one's bf16 dx and rounded once."""
    zero_c, zero_r = torch.zeros_like(d_c_T), torch.zeros_like(d_r_T)
    halves = [bilstmp_train_bwd_dir_reference(
        d, dy, mask, x, gates[d], cs[d], rprev[d], wx[d], wr[d], wrm[d],
        peep[d], init_c if d == 0 else zero_c, d_c_T if d == 0 else zero_c,
        d_r_T if d == 0 else zero_r, cell_clip) for d in range(2)]
    dx = (halves[0][0].float() + halves[1][0].float()).to(BF16)
    return (dx, halves[0][1], halves[0][2],
            *(torch.stack([h[k] for h in halves]) for k in range(3, 8)))


def bilstmp_train_bwd_dir(d: int, dy, mask, x, gates, cs, rprev, wx, wr,
                          wrm, peep, init_c, d_c_T, d_r_T,
                          cell_clip: float = 50.0):
    """Training backward of direction ``d`` alone (0 = f, 1 = b): the
    counterpart of lstm_pallas.py:_xfused_train_bwd_dir, which the JAX
    package runs once per direction under ``KALDI_ASLP_LSTM_SPLIT_BWD``.

    dy [S, T, 2P] bf16 (the layer's, both directions'), mask, x as for
    :func:`bilstmp_train_bwd`; gates [S, T, 4C], cs [S, T, C], rprev
    [S, T, P], wx [4C, D], wr [4C, P], wrm [P, C] bf16 and peep [3, C]
    float32, direction d's; init_c, d_c_T [S, C] and d_r_T [S, P] float32
    (direction b's are zeros: it starts and ends at zero).  Returns (dx_d
    [S, T, D] bf16, d_init_c, d_init_r, dwx [4C, D], dwr [4C, P],
    dwrm [P, C], dbias [4C], dpeep [3, C]), all but dx_d float32 and
    unrounded.  Its device code is the fused backward's, so a direction's
    outputs equal the fused kernel's for it.

    On a CUDA tensor this launches the kernel or raises (ValueError past
    the capacity :func:`sweep_plan` states); a CPU tensor takes
    :func:`bilstmp_train_bwd_dir_reference`.
    ``bilstmp_train_bwd_dir.launches`` counts calls into the C entry."""
    if d not in (0, 1):
        raise ValueError(f"direction {d} is not 0 (f) or 1 (b)")
    S, T, D = x.shape
    G, P = wr.shape
    C = G // 4
    check_tensors(x.device, {
        "dy": (dy, (S, T, 2 * P), BF16), "mask": (mask, (S, T), torch.float32),
        "x": (x, (S, T, D), BF16), "gates": (gates, (S, T, G), BF16),
        "cs": (cs, (S, T, C), BF16), "rprev": (rprev, (S, T, P), BF16),
        "wx": (wx, (G, D), BF16), "wr": (wr, (G, P), BF16),
        "wrm": (wrm, (P, C), BF16), "peep": (peep, (3, C), torch.float32),
        "init_c": (init_c, (S, C), torch.float32),
        "d_c_T": (d_c_T, (S, C), torch.float32),
        "d_r_T": (d_r_T, (S, P), torch.float32)})
    if x.device.type == "cpu":
        return bilstmp_train_bwd_dir_reference(d, dy, mask, x, gates, cs,
                                               rprev, wx, wr, wrm, peep,
                                               init_c, d_c_T, d_r_T,
                                               cell_clip)
    if x.device.type != "cuda":
        raise ValueError(f"no BLSTMP kernel for device {x.device}")
    dev, f32 = x.device, torch.float32
    wr_t, wrm_t = wr.t().contiguous(), wrm.t().contiguous()
    dc_state, dr_state = d_c_T.clone(), d_r_T.clone()
    scratch = _BwdScratch(dev, 1, S, T, D, C, P)
    dgates = _empty(dev, BF16, S, T, G)
    m_out = _empty(dev, BF16, S, T, C)
    drn = _empty(dev, BF16, S, T, P)
    dx_f32, dx = _empty(dev, f32, S, T, D), _empty(dev, BF16, S, T, D)
    dwx, dwr = _empty(dev, f32, G, D), _empty(dev, f32, G, P)
    dwrm, dbp = _empty(dev, f32, P, C), _empty(dev, f32, 7 * C)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.bilstmp_train_bwd_dir(
            d, dy.data_ptr(), mask.data_ptr(), x.data_ptr(),
            gates.data_ptr(), cs.data_ptr(), rprev.data_ptr(), wx.data_ptr(),
            wr_t.data_ptr(), wrm_t.data_ptr(), peep.data_ptr(),
            init_c.data_ptr(), dc_state.data_ptr(), dr_state.data_ptr(),
            scratch.ws, dgates.data_ptr(), m_out.data_ptr(),
            drn.data_ptr(), dx_f32.data_ptr(), dx.data_ptr(), dwx.data_ptr(),
            dwr.data_ptr(), dwrm.data_ptr(), dbp.data_ptr(),
            S, T, D, C, P, float(cell_clip), *scratch.args,
            current_stream(dev))
        bilstmp_train_bwd_dir.launches += 1
    if err != 0:
        raise RuntimeError(f"bilstmp_train_bwd_dir failed: CUDA error {err}")
    return (dx, dc_state, dr_state, dwx, dwr, dwrm, dbp[:G],
            dbp[G:].reshape(3, C))


bilstmp_train_bwd_dir.launches = 0


def bilstmp_train_bwd_dir_reference(d: int, dy, mask, x, gates, cs, rprev,
                                    wx, wr, wrm, peep, init_c, d_c_T, d_r_T,
                                    cell_clip: float = 50.0):
    """Plain PyTorch version of the per-direction backward: the reverse
    sweep of lstm_pallas.py:_xfused_bwd_kernel for direction ``d``, then
    the weight-gradient sums over all frames as products of the bf16
    streams."""
    S, T, D = x.shape
    G, P = wr.shape
    C = G // 4
    dyf = dy[:, :, d * P:(d + 1) * P].float()
    wr_f, wrm_f = wr.float(), wrm.float()
    dc, dr = d_c_T, d_r_T
    dgates = x.new_empty((S, T, G), dtype=BF16)
    m_s = x.new_empty((S, T, C), dtype=BF16)
    drn = x.new_empty((S, T, P), dtype=BF16)
    dbias = torch.zeros(G, device=x.device)
    dpeep = torch.zeros((3, C), device=x.device)
    for step in range(T):
        t = T - 1 - step if d == 0 else step
        mk = mask[:, t:t + 1]
        dr_after = dyf[:, t] * mk + dr
        dr_new = _bf(mk * dr_after)
        dm = dr_new @ wrm_f
        if d == 0:
            cp = cs[:, t - 1].float() if t > 0 else init_c
        else:
            cp = cs[:, t + 1].float() if t < T - 1 else torch.zeros_like(dc)
        acts = gates[:, t].float()
        g, i = acts[:, :C], acts[:, C:2 * C]
        f, o = acts[:, 2 * C:3 * C], acts[:, 3 * C:]
        cu = f * cp + i * g
        c = torch.clamp(cu, -cell_clip, cell_clip) if cell_clip > 0 else cu
        tc = torch.tanh(c)
        m_s[:, t] = (o * tc).to(BF16)
        dcv = mk * dc + dm * o * (1.0 - tc * tc)
        do_lin = dm * tc * o * (1.0 - o)
        dcv = dcv + do_lin * peep[2]
        if cell_clip > 0:
            dcv = torch.where(cu.abs() < cell_clip, dcv, 0.0)
        di_lin = dcv * g * i * (1.0 - i)
        df_lin = dcv * cp * f * (1.0 - f)
        dg_lin = dcv * i * (1.0 - g * g)
        dc = (dcv * f + di_lin * peep[0] + df_lin * peep[1]
              + (1.0 - mk) * dc)
        dgl = torch.cat([dg_lin, di_lin, df_lin, do_lin], dim=1)
        dgates[:, t] = dgl.to(BF16)
        dbias += dgl.sum(0)
        dpeep[0] += (di_lin * cp).sum(0)
        dpeep[1] += (df_lin * cp).sum(0)
        dpeep[2] += (do_lin * c).sum(0)
        dr = (1.0 - mk) * dr_after + dgates[:, t].float() @ wr_f
        drn[:, t] = dr_new.to(BF16)
    dg = dgates.float().reshape(S * T, G)
    dx = (dg @ wx.float()).to(BF16).reshape(S, T, D)
    dwx = dg.t() @ x.float().reshape(S * T, D)
    dwr = dg.t() @ rprev.float().reshape(S * T, P)
    dwrm = drn.float().reshape(S * T, P).t() @ m_s.float().reshape(S * T, C)
    return dx, dc, dr, dwx, dwr, dwrm, dbias, dpeep


# -- autograd ----------------------------------------------------------------

class BiLstmpTrainCore(torch.autograd.Function):
    """Custom-VJP bidirectional LSTMP core, the counterpart of
    ``_get_bixfused_core`` / ``bilstmp_xfused_train_core``.

    Takes the float32 parameters in the component's own layouts
    (w_gifo_x [4C, D], w_gifo_r [4C, P], w_r_m [P, C], peep [3, C],
    bias [4C] per direction) and casts them to bf16 inside, so their
    gradients come back in float32 unrounded, as JAX returns them
    (torch casts a gradient to its input's dtype).  Returns
    (ys [S, T, 2P] bf16, c_T [S, C], r_T [S, P])."""

    @staticmethod
    def forward(ctx, x, mask, wf_gifo_x, wb_gifo_x, wf_gifo_r, wf_r_m,
                peep_f, wb_gifo_r, wb_r_m, peep_b, bias_f, bias_b, init_c,
                init_r, cell_clip):
        xb = x.to(BF16).contiguous()
        wx = torch.stack([wf_gifo_x, wb_gifo_x]).to(BF16)
        wr = torch.stack([wf_gifo_r, wb_gifo_r]).to(BF16)
        wrm = torch.stack([wf_r_m, wb_r_m]).to(BF16)
        peep = torch.stack([peep_f, peep_b]).float()
        bias = torch.stack([bias_f, bias_b]).float()
        mask = mask.float().contiguous()
        init_c = init_c.float().contiguous()
        ys, gates, cs, rprev, c_T, r_T = bilstmp_train_fwd(
            xb, mask, wx, wr, wrm, peep, bias, init_c,
            init_r.float().contiguous(), cell_clip)
        ctx.save_for_backward(xb, mask, gates, cs, rprev, wx, wr, wrm, peep,
                              init_c)
        ctx.cell_clip = cell_clip
        ctx.x_dtype = x.dtype
        return ys, c_T, r_T

    @staticmethod
    def backward(ctx, d_ys, d_c, d_r):
        xb, mask, gates, cs, rprev, wx, wr, wrm, peep, init_c = \
            ctx.saved_tensors
        S, T, _ = xb.shape
        P = rprev.shape[-1]
        if d_ys is None:
            d_ys = xb.new_zeros((S, T, 2 * P))
        d_c = init_c.new_zeros(init_c.shape) if d_c is None else d_c
        d_r = init_c.new_zeros((S, P)) if d_r is None else d_r
        d_ys = d_ys.to(BF16).contiguous()
        d_c, d_r = d_c.float().contiguous(), d_r.float().contiguous()
        if lstm_switches().split_bwd:
            # one direction at a time, b from zeros; dx summed in float32
            # from each one's bf16 dx (lstm_pallas.py:1619-1639)
            zc, zr = torch.zeros_like(d_c), torch.zeros_like(d_r)
            halves = [bilstmp_train_bwd_dir(
                d, d_ys, mask, xb, gates[d], cs[d], rprev[d], wx[d], wr[d],
                wrm[d], peep[d], init_c if d == 0 else zc,
                d_c if d == 0 else zc, d_r if d == 0 else zr, ctx.cell_clip)
                for d in range(2)]
            dx = (halves[0][0].float() + halves[1][0].float()).to(BF16)
            dic, dir_ = halves[0][1], halves[0][2]
            dwx, dwr, dwrm, dbias, dpeep = (
                torch.stack([h[k] for h in halves]) for k in range(3, 8))
        else:
            dx, dic, dir_, dwx, dwr, dwrm, dbias, dpeep = bilstmp_train_bwd(
                d_ys, mask, xb, gates, cs, rprev, wx, wr, wrm, peep, init_c,
                d_c, d_r, ctx.cell_clip)
        return (dx.to(ctx.x_dtype), None, dwx[0], dwx[1], dwr[0], dwrm[0],
                dpeep[0], dwr[1], dwrm[1], dpeep[1], dbias[0], dbias[1],
                dic, dir_, None)
