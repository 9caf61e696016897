"""Recurrent components: LSTMP, LSTM, CIFG-LSTMP, GRU and the
bidirectional forms, latency-controlled BLSTMP included.

Port of kaldi_aslp_tpu/models/recurrent.py (``LstmProjectedStreams``
:103-225, ``Lstm`` :228-290, ``LstmCifgProjectedStreams`` :292-333,
``GruStreams`` :336-395, ``_Bidirectional`` / ``BLstmProjectedStreams``
/ ``BLstm`` :398-522 and ``BLstmProjectedStreamsLC`` :525-567;
reference: src/aslp-nnet/nnet-lstm-projected-streams.h:46,
nnet-blstm-projected-streams.h, nnet-blstm-projected-streams-lc.h:57,
nnet-recurrent-component.h:28,106, nnet-lstm-couple-if-projected-streams.h,
nnet-gru-streams.h).

Semantics kept from the JAX package:
  - layout [S, T, D]; gate order g, i, f, o; the i and f peepholes act
    on c_prev, the o peephole on the new, clipped c;
  - the mask blends the carry, so right-padding is a no-op, and masked
    frames output 0;
  - the backward direction runs on the time-flipped input and mask from
    a zero state; only the forward direction's state is returned.

PyTorch's train/eval flag (``nn.Module.train()`` / ``.eval()``) takes
the place of JAX's ``train=`` argument:
  - eval: the input projection ``x W_gifo_x^T + b`` is one float32
    matmul and the recurrence runs in ops/lstmp.py (the inference CUDA
    kernel on the card, its plain version on the CPU), as the TPU path
    runs ``_lstmp_kernel``; a BLSTMP runs both directions in one call
    (``blstmp_forward``: the backward direction walks the frames in
    reverse inside the kernel, nothing is flipped).  It runs under
    ``torch.no_grad()`` on every device: the kernel has no backward, so an
    eval forward gives no gradients anywhere rather than only on the CPU;
  - training, bf16 BLSTMP: both directions in one core, routed as
    ``_Bidirectional._apply_fused`` routes them (recurrent.py:441-488):
    ops/bilstmp_train.py:BiLstmpTrainCore (the x-fused core) unless
    ``KALDI_ASLP_LSTM_NO_XFUSE`` or ``KALDI_ASLP_LSTM_MXU_FP32`` is set,
    else ops/bilstmp_xg_train.py:BiLstmpXgTrainCore (the xg-fed core) on
    bf16 input projections, with float32 products under MXU_FP32; the
    CUDA training kernels on the card, their plain versions on the CPU;
  - training, any other LSTMP (unidirectional, or a float32 BLSTMP's
    two directions one after the other): ops/lstmp_train.py:
    LstmpTrainCore, the counterpart of ``lstmp_train_core``, float32
    throughout, or with the ``bf16`` attr a bf16 input projection, bf16
    storage and bf16 products, float32 products under
    ``KALDI_ASLP_LSTM_MXU_FP32`` (recurrent.py:163-190).
The JAX package takes its training cores only on the TPU or with the
``pallas`` attr; the port always does.  The three switches are read at
every training forward (ops/switches.py); ``KALDI_ASLP_LSTM_SPLIT_BWD``
acts in BiLstmpTrainCore's backward.

``BLstmProjectedStreamsLC`` runs its two directions as two
``LstmProjectedStreams`` calls, so on the paths above: the forward
direction over the whole [S, T] with the carried state, the backward one
over the chunks folded into the stream axis ([S * n, chunk_size], each
chunk flipped in time, from a zero state).  In eval that is two
``lstmp_forward`` launches a layer (the two calls have different S, so
``blstmp_forward`` cannot take both), in training two ``LstmpTrainCore``
calls.

``Lstm`` (the CTC recipe's cell: no peepholes, no projection),
``LstmCifgProjectedStreams`` and ``GruStreams`` have no TPU kernel: the
JAX package runs each as a plain ``lax.scan``, and the port as a loop
over the frames of stock torch ops, in training and eval mode alike, on
every device.  ``torch.nn.LSTM`` and ``torch.nn.GRU`` are not the same
functions: neither clips, ``nn.LSTM`` orders its gates i, f, g, o, and
``nn.GRU`` applies the reset gate after the candidate's recurrent
product, where JAX applies it before."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from kaldi_aslp_tpu_torch.models.component import Component, register
from kaldi_aslp_tpu_torch.ops.bilstmp_train import BiLstmpTrainCore
from kaldi_aslp_tpu_torch.ops.bilstmp_xg_train import BiLstmpXgTrainCore
from kaldi_aslp_tpu_torch.ops.lstmp import blstmp_forward, lstmp_forward
from kaldi_aslp_tpu_torch.ops.lstmp_train import LstmpTrainCore
from kaldi_aslp_tpu_torch.ops.switches import lstm_switches

BF16 = torch.bfloat16


class _Bf16Projection(torch.autograd.Function):
    """x . w^T with bf16 operands and float32 sums, forward and backward:
    the counterpart of recurrent.py:_einsum_stg_bf16, whose custom VJP
    rounds the cotangent to bf16 before both transpose products."""

    @staticmethod
    def forward(ctx, x, w):
        xb, wb = x.to(BF16), w.to(BF16)
        ctx.save_for_backward(xb, wb)
        ctx.dtypes = (x.dtype, w.dtype)
        return torch.matmul(xb.float(), wb.float().t())

    @staticmethod
    def backward(ctx, dy):
        xb, wb = ctx.saved_tensors
        dyb = dy.to(BF16).float()
        dx = torch.matmul(dyb, wb.float())
        dw = torch.matmul(dyb.reshape(-1, dyb.shape[-1]).t(),
                          xb.float().reshape(-1, xb.shape[-1]))
        return dx.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1])


def _frames(xg: torch.Tensor, mask: torch.Tensor):
    """Per-frame views of ``xg`` [S, T, G] and of the mask as [S, 1]
    booleans, by unbind, whose backward is one stack: an indexed view's
    backward zero-fills its whole source, [S, T, G] for every frame."""
    return xg.unbind(1), (mask > 0)[:, :, None].unbind(1)


def _clip_bounds(clip: float, device):
    """(-clip, clip) as tensors for jnp.clip's form, min(max(c, -clip),
    clip): a value on the clip passes half its gradient, where
    torch.clamp passes all of it."""
    return (torch.full((), v, device=device) for v in (-clip, clip))


def _clip(c, clip, lo, hi):
    return torch.minimum(torch.maximum(c, lo), hi) if clip > 0 else c


@register
class LstmProjectedStreams(Component):
    """Peephole LSTM with recurrent projection
    (reference: nnet-lstm-projected-streams.h:46).

    Params: w_gifo_x [4C, D], w_gifo_r [4C, P], bias [4C],
    peephole_{i,f,o}_c [C], w_r_m [P, C]."""

    token = "<LstmProjectedStreams>"
    updatable = True
    recurrent = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.cell_dim = int(attrs.get("cell_dim", output_dim))
        self.proj_dim = int(output_dim)
        self.cell_clip = float(attrs.get("cell_clip", 50.0))
        D, C, P = self.input_dim, self.cell_dim, self.proj_dim
        self.w_gifo_x = nn.Parameter(torch.zeros(4 * C, D))
        self.w_gifo_r = nn.Parameter(torch.zeros(4 * C, P))
        self.bias = nn.Parameter(torch.zeros(4 * C))
        self.peephole_i_c = nn.Parameter(torch.zeros(C))
        self.peephole_f_c = nn.Parameter(torch.zeros(C))
        self.peephole_o_c = nn.Parameter(torch.zeros(C))
        self.w_r_m = nn.Parameter(torch.zeros(P, C))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # uniform in [-param_scale, param_scale] (reference:
        # nnet-lstm-projected-streams.h InitData)
        scale = float(self.attrs.get("param_scale", 0.1))
        for p in self.parameters(recurse=False):
            p.copy_(scale * (2.0 * torch.rand(p.shape, generator=generator)
                             - 1.0))

    def init_state(self, num_streams, device):
        return {
            "c": torch.zeros((num_streams, self.cell_dim), device=device),
            "r": torch.zeros((num_streams, self.proj_dim), device=device),
        }

    def forward(self, x, state=None, mask=None):
        """x: [S, T, D]; mask: [S, T] (1 = valid); state: carried {c, r}."""
        S, T, _ = x.shape
        if state is None:
            state = self.init_state(S, x.device)
        if mask is None:
            mask = torch.ones((S, T), device=x.device)
        if self.training:
            return self._forward_train(x, state, mask)
        with torch.no_grad():
            ys, c, r = lstmp_forward(
                self._input_projection(x), mask.contiguous(),
                *self._recurrent_weights(), state["c"].contiguous(),
                state["r"].contiguous(), cell_clip=self.cell_clip)
        return ys, {"c": c, "r": r}

    def _input_projection(self, x):
        return (torch.matmul(x, self.w_gifo_x.t()) + self.bias).contiguous()

    def _recurrent_weights(self):
        """(w_gifo_r, w_r_m, peep [3, C]) as ops/lstmp.py takes them."""
        peep = torch.stack([self.peephole_i_c, self.peephole_f_c,
                            self.peephole_o_c])
        return self.w_gifo_r, self.w_r_m, peep

    def _forward_train(self, x, state, mask):
        """The Pallas training branch of recurrent.py:163-190: the bf16
        attr gives bf16 storage (the TPU core's ``store_bf16``) and bf16
        products (``mxu_bf16``) unless ``KALDI_ASLP_LSTM_MXU_FP32`` is
        set."""
        bf16 = bool(self.attrs.get("bf16", False))
        mxu_bf16 = bf16 and not lstm_switches().mxu_fp32
        if bf16:
            xg = _Bf16Projection.apply(x, self.w_gifo_x) + self.bias
        else:
            xg = torch.matmul(x, self.w_gifo_x.t()) + self.bias
        peep = torch.stack([self.peephole_i_c, self.peephole_f_c,
                            self.peephole_o_c])
        ys, c, r = LstmpTrainCore.apply(
            xg, mask, self.w_gifo_r, self.w_r_m, peep, state["c"],
            state["r"], self.cell_clip, bf16, mxu_bf16)
        return ys, {"c": c, "r": r}


@register
class Lstm(Component):
    """Unprojected LSTM (reference: nnet-recurrent-component.h:28).

    Params: w_gifo_x [4C, D], w_gifo_r [4C, C], bias [4C]; attrs
    ``cell_clip`` (50.0; 0 turns the clip off) and ``param_scale``
    (0.1, the init's range).  Gate order g, i, f, o; the input projection
    and the bias are hoisted out of the frame loop, one recurrent product
    a frame; c is clipped before m = o * tanh(c); on a pad frame the
    state keeps its old value and the output is 0
    (kaldi_aslp_tpu/models/recurrent.py:228-290)."""

    token = "<Lstm>"
    updatable = True
    recurrent = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.cell_dim = int(output_dim)
        self.cell_clip = float(attrs.get("cell_clip", 50.0))
        D, C = self.input_dim, self.cell_dim
        self.w_gifo_x = nn.Parameter(torch.zeros(4 * C, D))
        self.w_gifo_r = nn.Parameter(torch.zeros(4 * C, C))
        self.bias = nn.Parameter(torch.zeros(4 * C))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        scale = float(self.attrs.get("param_scale", 0.1))
        for p in self.parameters(recurse=False):
            p.copy_(scale * (2.0 * torch.rand(p.shape, generator=generator)
                             - 1.0))

    def init_state(self, num_streams, device):
        C = self.cell_dim
        return {"c": torch.zeros((num_streams, C), device=device),
                "r": torch.zeros((num_streams, C), device=device)}

    def forward(self, x, state=None, mask=None):
        """x: [S, T, D]; mask: [S, T] (1 = valid); state: carried {c, r}."""
        S, T, _ = x.shape
        if state is None:
            state = self.init_state(S, x.device)
        if mask is None:
            mask = torch.ones((S, T), device=x.device)
        C, clip = self.cell_dim, self.cell_clip
        xg = torch.matmul(x, self.w_gifo_x.t()) + self.bias
        w_r = self.w_gifo_r.t()
        xg_t, valid = _frames(xg, mask)
        lo, hi = _clip_bounds(clip, x.device)
        c, r = state["c"], state["r"]
        ys = []
        for t in range(T):
            g, ifo = torch.addmm(xg_t[t], r, w_r).split([C, 3 * C], dim=1)
            i, f, o = torch.sigmoid(ifo).chunk(3, dim=1)
            c_new = _clip(f * c + i * torch.tanh(g), clip, lo, hi)
            m_new = o * torch.tanh(c_new)
            c = torch.where(valid[t], c_new, c)
            r = torch.where(valid[t], m_new, r)
            ys.append(r)
        ys = torch.stack(ys, dim=1) * mask[:, :, None]
        return ys, {"c": c, "r": r}


@register
class LstmCifgProjectedStreams(LstmProjectedStreams):
    """Coupled input-forget LSTMP: i = 1 - f (reference:
    nnet-lstm-couple-if-projected-streams.h).

    The parameters are LSTMP's (``peephole_i_c`` is kept and unused, as
    in JAX); the f peephole acts on c_prev, the o peephole on the new,
    clipped c.  A loop of stock torch ops over the frames in every mode
    (kaldi_aslp_tpu/models/recurrent.py:292-333 is a plain scan)."""

    token = "<LstmCifgProjectedStreams>"

    def forward(self, x, state=None, mask=None):
        S, T, _ = x.shape
        if state is None:
            state = self.init_state(S, x.device)
        if mask is None:
            mask = torch.ones((S, T), device=x.device)
        C, clip = self.cell_dim, self.cell_clip
        xg = torch.matmul(x, self.w_gifo_x.t()) + self.bias
        w_r, w_rm = self.w_gifo_r.t(), self.w_r_m.t()
        xg_t, valid = _frames(xg, mask)
        lo, hi = _clip_bounds(clip, x.device)
        c, r = state["c"], state["r"]
        ys = []
        for t in range(T):
            g, _i, f, o = torch.addmm(xg_t[t], r, w_r).split(C, dim=1)
            f = torch.sigmoid(f + self.peephole_f_c * c)
            c_new = _clip(f * c + (1.0 - f) * torch.tanh(g), clip, lo, hi)
            o = torch.sigmoid(o + self.peephole_o_c * c_new)
            r_new = torch.matmul(o * torch.tanh(c_new), w_rm)
            c = torch.where(valid[t], c_new, c)
            r = torch.where(valid[t], r_new, r)
            ys.append(r)
        ys = torch.stack(ys, dim=1) * mask[:, :, None]
        return ys, {"c": c, "r": r}


@register
class GruStreams(Component):
    """GRU (reference: nnet-gru-streams.h).

    Params: w_zrc_x [3H, D], w_zrc_h [3H, H], bias [3H]; gate order z
    (update), r (reset), c (candidate):

        z = sigmoid(x W_z + h W_hz),  r = sigmoid(x W_r + h W_hr)
        cand = tanh(x W_c + (r * h) W_hc),  h' = (1 - z) h + z cand

    the reset gate applied to h before the candidate's product
    (kaldi_aslp_tpu/models/recurrent.py:336-395).  State {"h"}; on a pad
    frame h keeps its value and the output is 0."""

    token = "<GruStreams>"
    updatable = True
    recurrent = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.hidden = int(output_dim)
        D, H = self.input_dim, self.hidden
        self.w_zrc_x = nn.Parameter(torch.zeros(3 * H, D))
        self.w_zrc_h = nn.Parameter(torch.zeros(3 * H, H))
        self.bias = nn.Parameter(torch.zeros(3 * H))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        scale = float(self.attrs.get("param_scale", 0.1))
        for p in self.parameters(recurse=False):
            p.copy_(scale * (2.0 * torch.rand(p.shape, generator=generator)
                             - 1.0))

    def init_state(self, num_streams, device):
        return {"h": torch.zeros((num_streams, self.hidden), device=device)}

    def forward(self, x, state=None, mask=None):
        S, T, _ = x.shape
        H = self.hidden
        if state is None:
            state = self.init_state(S, x.device)
        if mask is None:
            mask = torch.ones((S, T), device=x.device)
        xg = torch.matmul(x, self.w_zrc_x.t()) + self.bias
        w_zr, w_c = self.w_zrc_h[:2 * H].t(), self.w_zrc_h[2 * H:].t()
        xg_t, valid = _frames(xg, mask)
        h = state["h"]
        ys = []
        for t in range(T):
            x_zr, x_c = xg_t[t].split([2 * H, H], dim=1)
            z, r = torch.sigmoid(torch.addmm(x_zr, h, w_zr)).chunk(2, dim=1)
            cand = torch.tanh(torch.addmm(x_c, r * h, w_c))
            h = torch.where(valid[t], (1.0 - z) * h + z * cand, h)
            ys.append(h)
        ys = torch.stack(ys, dim=1) * mask[:, :, None]
        return ys, {"h": h}


class _Bidirectional(Component):
    """Run a cell forward and backward, concatenate the outputs
    (kaldi_aslp_tpu/models/recurrent.py:_Bidirectional).

    The backward pass flips x and the mask in time; the masked carry
    makes the flipped-to-front padding a no-op.  An LSTMP pair in eval mode
    runs both directions in one ops/lstmp.py call, which walks the backward
    direction's frames in reverse instead."""

    updatable = True
    recurrent = True
    cell_cls: type = None  # type: ignore

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        if output_dim % 2:
            raise ValueError("bidirectional output dim must be even")
        self.fwd = self.cell_cls(input_dim, output_dim // 2, **attrs)
        self.bwd = self.cell_cls(input_dim, output_dim // 2, **attrs)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.fwd.reset_parameters(generator)
        self.bwd.reset_parameters(generator)

    def init_state(self, num_streams, device):
        # only the forward direction carries streaming state; the
        # backward direction needs the future and restarts per chunk
        return {"fwd": self.fwd.init_state(num_streams, device)}

    def forward(self, x, state: Optional[Dict] = None, mask=None):
        S, T, _ = x.shape
        if state is None:
            state = self.init_state(S, x.device)
        if mask is None:
            mask = torch.ones((S, T), device=x.device)
        if (self.training and self.attrs.get("bf16", False)
                and self.cell_cls is LstmProjectedStreams):
            return self._forward_fused(x, state, mask)
        if not self.training and self.cell_cls is LstmProjectedStreams:
            f, b = self.fwd, self.bwd
            with torch.no_grad():
                ys, c, r = blstmp_forward(
                    f._input_projection(x), b._input_projection(x),
                    mask.contiguous(), f._recurrent_weights(),
                    b._recurrent_weights(),
                    state["fwd"]["c"].contiguous(),
                    state["fwd"]["r"].contiguous(), cell_clip=f.cell_clip)
            return ys, {"fwd": {"c": c, "r": r}}
        y_f, s_f = self.fwd(x, state["fwd"], mask=mask)
        y_b, _ = self.bwd(torch.flip(x, (1,)), None,
                          mask=torch.flip(mask, (1,)))
        y_b = torch.flip(y_b, (1,))
        return torch.cat([y_f, y_b], dim=-1), {"fwd": s_f}

    def _forward_fused(self, x, state, mask):
        """Both directions in one training core with bf16 storage, routed
        as kaldi_aslp_tpu/models/recurrent.py:_apply_fused (:455-488)
        routes them: the x-fused core with bf16 products unless a switch
        asks for the xg-fed core, which is fed bf16 bias-free input
        projections (the bias is added in the core)."""
        f, b = self.fwd, self.bwd
        peep_f = torch.stack([f.peephole_i_c, f.peephole_f_c,
                              f.peephole_o_c])
        peep_b = torch.stack([b.peephole_i_c, b.peephole_f_c,
                              b.peephole_o_c])
        init_c, init_r = state["fwd"]["c"], state["fwd"]["r"]
        switches = lstm_switches()
        mxu_bf16 = not switches.mxu_fp32
        if mxu_bf16 and not switches.no_xfuse:
            ys, c, r = BiLstmpTrainCore.apply(
                x, mask, f.w_gifo_x, b.w_gifo_x, f.w_gifo_r, f.w_r_m, peep_f,
                b.w_gifo_r, b.w_r_m, peep_b, f.bias, b.bias, init_c, init_r,
                f.cell_clip)
        else:
            xgf = _Bf16Projection.apply(x, f.w_gifo_x).to(BF16)
            xgb = _Bf16Projection.apply(x, b.w_gifo_x).to(BF16)
            ys, c, r = BiLstmpXgTrainCore.apply(
                xgf, xgb, mask, f.w_gifo_r, f.w_r_m, peep_f, b.w_gifo_r,
                b.w_r_m, peep_b, f.bias, b.bias, init_c, init_r, f.cell_clip,
                mxu_bf16)
        return ys, {"fwd": {"c": c, "r": r}}


@register
class BLstmProjectedStreams(_Bidirectional):
    """(reference: nnet-blstm-projected-streams.h)."""

    token = "<BLstmProjectedStreams>"
    cell_cls = LstmProjectedStreams


@register
class BLstm(_Bidirectional):
    """(reference: nnet-recurrent-component.h:106): two ``Lstm`` cells on
    the generic path, the backward one on the time-flipped input."""

    token = "<BLstm>"
    cell_cls = Lstm


@register
class BLstmProjectedStreamsLC(_Bidirectional):
    """Latency-controlled BLSTMP (reference:
    nnet-blstm-projected-streams-lc.h:57; kaldi_aslp_tpu/models/
    recurrent.py:525-567).

    The forward direction runs over the whole input and carries its
    state; the backward direction sees ``chunk_size`` (64) frames at a
    time, from a zero state at every chunk, which bounds the lookahead.
    T is padded with masked frames to a multiple of the chunk and the
    chunks are folded into the stream axis, [S, T, D] -> [S * n, chunk,
    D], so every chunk's backward sweep runs at once.  Only the forward
    direction's state is returned.  The padding is kept where T <
    chunk_size too, as in JAX: at the BPTT reader's T = 20 the backward
    direction sweeps 64 frames a stream."""

    token = "<BLstmProjectedStreamsLC>"
    cell_cls = LstmProjectedStreams

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.chunk_size = int(attrs.get("chunk_size", 64))

    def forward(self, x, state: Optional[Dict] = None, mask=None):
        S, T, D = x.shape
        if state is None:
            state = self.init_state(S, x.device)
        if mask is None:
            mask = torch.ones((S, T), device=x.device)
        y_f, s_f = self.fwd(x, state["fwd"], mask=mask)
        chunk = self.chunk_size
        pad = (-T) % chunk
        n = (T + pad) // chunk
        xc = F.pad(x, (0, 0, 0, pad)).reshape(S * n, chunk, D)
        mc = F.pad(mask, (0, pad)).reshape(S * n, chunk)
        y_b, _ = self.bwd(torch.flip(xc, (1,)), None,
                          mask=torch.flip(mc, (1,)))
        y_b = torch.flip(y_b, (1,)).reshape(S, n * chunk, -1)[:, :T]
        return torch.cat([y_f, y_b], dim=-1), {"fwd": s_f}
