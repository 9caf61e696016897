"""Frame-level components: transforms, activations, utility layers.

Port of kaldi_aslp_tpu/models/simple.py (reference:
src/aslp-nnet/nnet-affine-transform.h:34, nnet-linear-transform.h:33,
nnet-activation.h:35-356, nnet-various.h:43-483).  All are element-wise
or matmul ops on [..., D]; ``Splice`` gathers along the time axis of
[S, T, D].

``Dropout`` draws its keep mask from the ``torch.Generator`` it is
given (``Nnet.forward(generator=)``), where JAX splits a PRNG key; the
draws cannot equal JAX's.  In ``eval()`` mode or at a retention of 1
it is the identity; in training without a generator it raises, where
JAX's is the identity without ``rng``."""

from __future__ import annotations

from typing import Dict, List, Optional

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
class LinearTransform(Component):
    """y = x W^T, no bias (reference: nnet-linear-transform.h:33).

    Params: w [out, in], gaussian of ``param_stddev`` (0.1)."""

    token = "<LinearTransform>"
    updatable = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.w = nn.Parameter(torch.zeros(self.output_dim, self.input_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        stddev = float(self.attrs.get("param_stddev", 0.1))
        self.w.copy_(stddev * torch.randn(self.w.shape, generator=generator))

    def forward(self, x, state=None, mask=None):
        return torch.matmul(x.to(self.w.dtype), self.w.t()), state

    def lr_coefs(self) -> Dict[str, float]:
        return {"w": float(self.attrs.get("learn_rate_coef", 1.0))}


@register
class Sigmoid(Component):
    token = "<Sigmoid>"

    def forward(self, x, state=None, mask=None):
        return torch.sigmoid(x), state


@register
class Tanh(Component):
    token = "<Tanh>"

    def forward(self, x, state=None, mask=None):
        return torch.tanh(x), state


@register
class ReLU(Component):
    token = "<ReLU>"

    def forward(self, x, state=None, mask=None):
        return torch.relu(x), state


@register
class Softmax(Component):
    """(reference: nnet-activation.h:35)."""

    token = "<Softmax>"

    def forward(self, x, state=None, mask=None):
        return torch.softmax(x, dim=-1), state


@register
class BlockSoftmax(Component):
    """A softmax over each block of columns, for multi-task heads
    (reference: nnet-activation.h, ``<BlockDims> "d1:d2:..."``)."""

    token = "<BlockSoftmax>"

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        dims = attrs.get("block_dims", str(output_dim))
        if isinstance(dims, str):
            self.block_dims = [int(d)
                               for d in dims.replace(",", ":").split(":")]
        elif isinstance(dims, int):
            self.block_dims = [dims]
        else:
            self.block_dims = list(dims)
        if sum(self.block_dims) != output_dim:
            raise ValueError("block dims must sum to output dim")

    def forward(self, x, state=None, mask=None):
        blocks = x.split(self.block_dims, dim=-1)
        return torch.cat([torch.softmax(b, dim=-1) for b in blocks],
                         dim=-1), state


def dropout_keep(shape, retention: float, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """The keep mask of a ``Dropout`` in training: True with probability
    ``retention``, drawn from ``generator`` (the one place its draws come
    from)."""
    return torch.rand(shape, generator=generator, device=device) < retention


@register
class Dropout(Component):
    """(reference: nnet-activation.h Dropout, ``dropout_retention``,
    default 0.5): kept values are scaled by 1 / retention.

    In ``eval()`` mode, or at a retention of 1, it is the identity.  In
    training it draws its mask from ``generator`` and raises without one:
    the JAX component is the identity when it gets no key, which would
    train a different model in silence."""

    token = "<Dropout>"
    draws = True

    def forward(self, x, state=None, mask=None,
                generator: Optional[torch.Generator] = None):
        retention = float(self.attrs.get("dropout_retention", 0.5))
        if not self.training or retention >= 1.0:
            return x, state
        if generator is None:
            raise ValueError(
                "Dropout in training needs a generator to draw its mask "
                "from; pass Nnet.forward(generator=) or call eval()")
        keep = dropout_keep(x.shape, retention, generator, x.device)
        return torch.where(keep, x / retention, torch.zeros_like(x)), state


@register
class Pnorm(Component):
    """Group p-norm dimension reduction (reference: nnet-activation.h
    Pnorm): output d is the ``p``-norm (2.0) of input group d."""

    token = "<Pnorm>"

    def forward(self, x, state=None, mask=None):
        p = float(self.attrs.get("p", 2.0))
        group = self.input_dim // self.output_dim
        xg = x.reshape(x.shape[:-1] + (self.output_dim, group)).abs() ** p
        return xg.sum(dim=-1) ** (1.0 / p), state


@register
class Maxout(Component):
    """The maximum of each group of input_dim / output_dim columns."""

    token = "<Maxout>"

    def forward(self, x, state=None, mask=None):
        group = self.input_dim // self.output_dim
        return x.reshape(x.shape[:-1] + (self.output_dim, group)).amax(
            dim=-1), state


@register
class LengthNorm(Component):
    """Each frame scaled to unit L2 length (reference: nnet-various.h)."""

    token = "<LengthNormComponent>"

    def forward(self, x, state=None, mask=None):
        return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True) + 1e-20), \
            state


@register
class AddShift(Component):
    """A learned additive shift b [D], zeros at init (reference:
    nnet-various.h AddShift)."""

    token = "<AddShift>"
    updatable = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.b = nn.Parameter(torch.zeros(self.input_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.b.zero_()

    def forward(self, x, state=None, mask=None):
        return x + self.b, state

    def lr_coefs(self) -> Dict[str, float]:
        return {"b": float(self.attrs.get("learn_rate_coef", 1.0))}


@register
class Rescale(Component):
    """A learned per-dimension scale s [D], ones at init (reference:
    nnet-various.h Rescale)."""

    token = "<Rescale>"
    updatable = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.s = nn.Parameter(torch.ones(self.input_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.s.fill_(1.0)

    def forward(self, x, state=None, mask=None):
        return x * self.s, state

    def lr_coefs(self) -> Dict[str, float]:
        return {"s": float(self.attrs.get("learn_rate_coef", 1.0))}


@register
class CopyComponent(Component):
    """Rearranges or repeats columns by a 0-based index vector
    (``<BuildVector>``; reference: nnet-various.h CopyComponent)."""

    token = "<Copy>"

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        spec = attrs.get("build_vector", "")
        self.indices = (_parse_build_vector(spec) if spec
                        else list(range(output_dim)))
        if len(self.indices) != output_dim:
            raise ValueError("copy indices must match output dim")

    def forward(self, x, state=None, mask=None):
        idx = torch.tensor(self.indices, dtype=torch.long, device=x.device)
        return x.index_select(-1, idx), state


@register
class Transmit(Component):
    """Identity pass-through (reference: nnet-activation.h Transmit)."""

    token = "<Transmit>"

    def forward(self, x, state=None, mask=None):
        return x, state


@register
class Splice(Component):
    """Frame splicing inside the network (reference: nnet-various.h:43,
    ``<BuildVector> "-5:5"``): on [.., T, D], output frame t is the
    concatenation of input frames t + o over the offsets o, clamped to
    the utterance's edges."""

    token = "<Splice>"

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        spec = attrs.get("build_vector", "")
        self.offsets = _parse_build_vector(spec) if spec else [0]
        if input_dim * len(self.offsets) != output_dim:
            raise ValueError(
                f"splice: {input_dim}*{len(self.offsets)} != {output_dim}")

    def forward(self, x, state=None, mask=None):
        if x.dim() < 2:
            raise ValueError("Splice needs a time axis: [.., T, D]")
        T = x.shape[-2]
        t = torch.arange(T, device=x.device)
        cols = [x.index_select(-2, torch.clamp(t + o, 0, T - 1))
                for o in self.offsets]
        return torch.cat(cols, dim=-1), state


def _parse_build_vector(spec) -> List[int]:
    """Parse "-5:5" / "0 1 2" / "-2:2 5" (or a list) into ints
    (reference: nnet-various.h BuildIntegerVector)."""
    if isinstance(spec, (list, tuple)):
        return [int(v) for v in spec]
    out: List[int] = []
    for part in str(spec).replace(",", " ").split():
        if ":" in part:
            lo, hi = part.split(":")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out
