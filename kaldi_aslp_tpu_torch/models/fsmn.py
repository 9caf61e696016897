"""Feedforward sequential memory: cFSMN and row convolution.

Port of kaldi_aslp_tpu/models/fsmn.py (reference:
src/aslp-nnet/nnet-cfsmn-component.h:33 CompactFsmn, past and future
taps with per-dimension learned coefficients;
nnet-row-convolution.{h,cc} RowConvolution).  Both are depthwise 1-D
convolutions along the time axis of [S, T, D] with static offsets: each
tap is the input shifted in time with zeros past the edges.  Both take
the network's mask [S, T] and zero the padded frames before the taps,
as the JAX components do."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kaldi_aslp_tpu_torch.models.component import Component, register


def _shifted(x: torch.Tensor, k: int) -> torch.Tensor:
    """x [S, T, D] moved k frames in time: out[:, t] = x[:, t - k], zero
    where t - k falls outside [0, T)."""
    T = x.shape[1]
    if k >= 0:
        return F.pad(x, (0, 0, k, 0))[:, :T]
    return F.pad(x, (0, 0, 0, -k))[:, -k:-k + T]


@register
class CompactFsmn(Component):
    """y_t = x_t + sum_{i=0..l_order} a_i * x_{t - i l_stride}
    + sum_{j=1..r_order} c_j * x_{t + j r_stride}

    Params: a [l_order + 1, D], c [r_order, D], gaussian of
    ``param_scale`` (0.1); orders 10 and strides 1 by default (attrs
    ``l_order`` / ``lorder`` and so on)."""

    token = "<CompactFsmn>"
    updatable = True
    masked = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        if input_dim != output_dim:
            raise ValueError("CompactFsmn requires input_dim == output_dim")
        self.l_order = int(attrs.get("l_order", attrs.get("lorder", 10)))
        self.r_order = int(attrs.get("r_order", attrs.get("rorder", 10)))
        self.l_stride = int(attrs.get("l_stride", attrs.get("lstride", 1)))
        self.r_stride = int(attrs.get("r_stride", attrs.get("rstride", 1)))
        D = self.input_dim
        self.a = nn.Parameter(torch.zeros(self.l_order + 1, D))
        self.c = nn.Parameter(torch.zeros(self.r_order, D))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        scale = float(self.attrs.get("param_scale", 0.1))
        for p in (self.a, self.c):
            p.copy_(scale * torch.randn(p.shape, generator=generator))

    def forward(self, x, state=None, mask=None):
        if x.dim() < 3:
            raise ValueError("CompactFsmn needs [S, T, D] input")
        if mask is not None:
            x = x * mask[..., None]
        y = x
        for i in range(self.l_order + 1):
            y = y + self.a[i] * _shifted(x, i * self.l_stride)
        for j in range(1, self.r_order + 1):
            y = y + self.c[j - 1] * _shifted(x, -j * self.r_stride)
        return y, state


@register
class RowConvolution(Component):
    """Lookahead depthwise convolution, y_t = sum_{j=0..future_ctx} w_j *
    x_{t+j} (reference: nnet-row-convolution.h, Deep Speech 2).

    Params: w [future_ctx + 1, D], gaussian of ``param_scale`` (0.1);
    ``future_ctx`` 2 by default."""

    token = "<RowConvolution>"
    updatable = True
    masked = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        if input_dim != output_dim:
            raise ValueError("RowConvolution requires input_dim == output_dim")
        self.future_ctx = int(attrs.get("future_ctx", 2))
        self.w = nn.Parameter(torch.zeros(self.future_ctx + 1,
                                          self.input_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        scale = float(self.attrs.get("param_scale", 0.1))
        self.w.copy_(scale * torch.randn(self.w.shape, generator=generator))

    def forward(self, x, state=None, mask=None):
        if x.dim() < 3:
            raise ValueError("RowConvolution needs [S, T, D] input")
        if mask is not None:
            x = x * mask[..., None]
        y = torch.zeros_like(x)
        for j in range(self.future_ctx + 1):
            y = y + self.w[j] * _shifted(x, -j)
        return y, state
