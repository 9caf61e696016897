"""1-D convolution and max-pooling along the frequency axis.

Port of kaldi_aslp_tpu/models/conv.py (reference:
src/aslp-nnet/nnet-convolutional-component.h:65 ConvolutionalComponent:
the input vector is ``num_splice`` copies of ``patch_stride`` frequency
bins, filters of ``patch_dim`` bins slide by ``patch_step``;
nnet-max-pooling-component.h:39 MaxPoolingComponent).

The patches are one gather by a static index and the filters one matmul
over all patches.  Outputs are patch-major, ``out[..., p * num_filters +
f]``, so the pooling's groups are the JAX package's."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from kaldi_aslp_tpu_torch.models.component import Component, register


@register
class ConvolutionalComponent(Component):
    """Params: filters [num_filters, num_splice * patch_dim] (gaussian of
    ``param_stddev``, 0.1), bias [num_filters] (zeros)."""

    token = "<ConvolutionalComponent>"
    updatable = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.patch_dim = int(attrs["patch_dim"])
        self.patch_step = int(attrs.get("patch_step", 1))
        self.patch_stride = int(attrs.get("patch_stride", input_dim))
        if input_dim % self.patch_stride:
            raise ValueError("input_dim must be a multiple of patch_stride")
        self.num_splice = input_dim // self.patch_stride
        self.num_patches = 1 + (
            self.patch_stride - self.patch_dim) // self.patch_step
        if output_dim % self.num_patches:
            raise ValueError("output_dim must be a multiple of num_patches")
        self.num_filters = output_dim // self.num_patches
        # patch p, splice s covers bins [p*step, p*step + patch_dim) of
        # splice s; a host array (a buffer would be saved as a parameter)
        idx = np.empty((self.num_patches, self.num_splice * self.patch_dim),
                       np.int64)
        for p in range(self.num_patches):
            cols = []
            for s in range(self.num_splice):
                base = s * self.patch_stride + p * self.patch_step
                cols.extend(range(base, base + self.patch_dim))
            idx[p] = cols
        self._patch_idx = idx
        self.filters = nn.Parameter(torch.zeros(
            self.num_filters, self.num_splice * self.patch_dim))
        self.bias = nn.Parameter(torch.zeros(self.num_filters))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        stddev = float(self.attrs.get("param_stddev", 0.1))
        self.filters.copy_(stddev * torch.randn(self.filters.shape,
                                                generator=generator))
        self.bias.zero_()

    def forward(self, x, state=None, mask=None):
        # x [..., input_dim] -> patches [..., num_patches, splice*patch_dim]
        patches = x[..., torch.from_numpy(self._patch_idx).to(x.device)]
        y = torch.matmul(patches, self.filters.t()) + self.bias
        return y.reshape(x.shape[:-1] + (self.output_dim,)), state

    def lr_coefs(self) -> Dict[str, float]:
        return {"filters": float(self.attrs.get("learn_rate_coef", 1.0)),
                "bias": float(self.attrs.get("bias_learn_rate_coef", 1.0))}


@register
class MaxPoolingComponent(Component):
    """The maximum over ``pool_size`` patches, every ``pool_step``
    patches, of each of ``pool_stride`` filters (reference:
    nnet-max-pooling-component.h:39); the input is [num_patches,
    num_filters] patch-major."""

    token = "<MaxPoolingComponent>"

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.pool_size = int(attrs["pool_size"])
        self.pool_step = int(attrs.get("pool_step", self.pool_size))
        self.pool_stride = int(attrs.get("pool_stride", 1))
        self.num_filters = self.pool_stride
        self.num_patches = input_dim // self.num_filters
        self.num_pools = 1 + (
            self.num_patches - self.pool_size) // self.pool_step
        if output_dim != self.num_pools * self.num_filters:
            raise ValueError("max-pooling dims inconsistent")

    def forward(self, x, state=None, mask=None):
        xg = x.reshape(x.shape[:-1] + (self.num_patches, self.num_filters))
        pools = [xg[..., s:s + self.pool_size, :].amax(dim=-2)
                 for s in range(0, self.num_pools * self.pool_step,
                                self.pool_step)]
        y = torch.stack(pools, dim=-2)
        return y.reshape(x.shape[:-1] + (self.output_dim,)), state
