"""Frame-level components.

Port of kaldi_aslp_tpu/models/simple.py: ``AffineTransform`` (:20-55),
the flagship's output layer, and the activations ``Sigmoid`` and
``Softmax`` (:82-113), the VAD net's.  The rest of that module waits
for a later slice."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from kaldi_aslp_tpu_torch.models.component import Component, register


@register
class AffineTransform(Component):
    """y = x W^T + b (reference: nnet-affine-transform.h:34).

    Params: w [out, in], b [out].  Init attrs mirror the proto:
    param_stddev (gaussian weights), bias_mean/bias_range (uniform
    bias); training attrs: learn_rate_coef, bias_learn_rate_coef and
    max_norm (row-norm clipping, train/sgd.py)."""

    token = "<AffineTransform>"
    updatable = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.w = nn.Parameter(torch.zeros(self.output_dim, self.input_dim))
        self.b = nn.Parameter(torch.zeros(self.output_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        stddev = float(self.attrs.get("param_stddev", 0.1))
        bias_mean = float(self.attrs.get("bias_mean", -2.0))
        bias_range = float(self.attrs.get("bias_range", 2.0))
        w = stddev * torch.randn(self.w.shape, generator=generator)
        b = bias_mean + bias_range * (
            torch.rand(self.b.shape, generator=generator) - 0.5)
        self.w.copy_(w)
        self.b.copy_(b)

    def forward(self, x, state=None, mask=None):
        # a bf16 input (a bf16 BLSTMP's output) is widened to float32, as
        # JAX promotes jnp.dot(bf16, f32); torch refuses mixed dtypes
        return torch.matmul(x.to(self.w.dtype), self.w.t()) + self.b, state

    def lr_coefs(self) -> Dict[str, float]:
        return {
            "w": float(self.attrs.get("learn_rate_coef", 1.0)),
            "b": float(self.attrs.get("bias_learn_rate_coef", 1.0)),
        }

    @property
    def max_norm(self) -> float:
        return float(self.attrs.get("max_norm", 0.0))


@register
class Sigmoid(Component):
    token = "<Sigmoid>"

    def forward(self, x, state=None, mask=None):
        return torch.sigmoid(x), state


@register
class Softmax(Component):
    """(reference: nnet-activation.h:35)."""

    token = "<Softmax>"

    def forward(self, x, state=None, mask=None):
        return torch.softmax(x, dim=-1), state
