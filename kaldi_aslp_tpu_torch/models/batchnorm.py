"""Batch normalization with accumulated global statistics.

Port of kaldi_aslp_tpu/models/batchnorm.py (reference:
src/aslp-nnet/nnet-batch-normalization.h:32; the statistics are summed
across workers at the end of training, MpiNode::ReduceAccStat
mpi-node.h:77-92).  The running sums (``sum``, ``sumsq``, ``count``)
are the component's *state*, threaded through ``Nnet.forward`` and
saved with the model under ``['states'][node]`` in the JAX zip format,
so a state written by either package loads in the other.

Training normalizes by the (masked) batch statistics and adds them to
the sums; eval normalizes by the sums.  With ``axis_name`` training sums
the batch's ``sum``, ``sumsq`` and ``count`` over the ranks of that mesh
axis (the group ``parallel/mesh.py:make_mesh`` registered under the
name) by a differentiable all-reduce, whose backward is an all-reduce,
as JAX's ``psum`` transposes to a ``psum`` (batchnorm.py:58-61).  A name
no mesh registered raises; eval ignores the attr, as JAX's does."""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from kaldi_aslp_tpu_torch.models.component import Component, register


@register
class BatchNormalization(Component):
    """Params: gamma [D] (ones), beta [D] (zeros); attrs ``epsilon``
    (1e-5), ``learn_rate_coef``, ``axis_name``."""

    token = "<BatchNormalization>"
    updatable = True
    masked = True

    def __init__(self, input_dim, output_dim, **attrs):
        super().__init__(input_dim, output_dim, **attrs)
        self.eps = float(attrs.get("epsilon", 1e-5))
        self.axis_name = attrs.get("axis_name", None)
        self.gamma = nn.Parameter(torch.ones(self.input_dim))
        self.beta = nn.Parameter(torch.zeros(self.input_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.gamma.fill_(1.0)
        self.beta.zero_()

    def init_state(self, num_streams=0, device=None):
        D = self.input_dim
        return {"sum": torch.zeros(D, device=device),
                "sumsq": torch.zeros(D, device=device),
                "count": torch.zeros((), device=device)}

    def forward(self, x, state=None, mask=None):
        if state is None:
            state = self.init_state(0, x.device)
        flat = x.reshape(-1, x.shape[-1])
        if mask is not None:
            m = mask.reshape(-1, 1).to(flat.dtype)
            count = torch.clamp(m.sum(), min=1.0)
            s = (flat * m).sum(dim=0)
            sq = (flat * flat * m).sum(dim=0)
        else:
            count = torch.tensor(float(flat.shape[0]), device=x.device)
            s = flat.sum(dim=0)
            sq = (flat * flat).sum(dim=0)
        if self.training:
            if self.axis_name is not None:
                s, sq, count = _psum((s, sq, count), self.axis_name)
            mean = s / count
            var = sq / count - mean * mean
            new_state = {"sum": state["sum"] + s.detach(),
                         "sumsq": state["sumsq"] + sq.detach(),
                         "count": state["count"] + count.detach()}
        else:
            total = torch.clamp(state["count"], min=1.0)
            mean = state["sum"] / total
            var = state["sumsq"] / total - mean * mean
            new_state = state
        # max(var, 0) as JAX's jnp.maximum: half the gradient at a tie
        inv = torch.rsqrt(torch.maximum(var, torch.zeros_like(var))
                          + self.eps)
        return (x - mean) * inv * self.gamma + self.beta, new_state

    def lr_coefs(self) -> Dict[str, float]:
        coef = float(self.attrs.get("learn_rate_coef", 1.0))
        return {"gamma": coef, "beta": coef}


def _psum(tensors, axis_name: str):
    """Each tensor summed over the ranks of mesh axis ``axis_name``,
    differentiably."""
    from kaldi_aslp_tpu_torch.parallel.mesh import axis_group, group_size

    try:
        group = axis_group(axis_name)
    except KeyError:
        raise ValueError(
            f"BatchNormalization axis_name={axis_name!r}: no mesh axis of "
            "that name (parallel.make_mesh registers one); drop the attr "
            "to train on one rank") from None
    if group_size(group) == 1:
        return tensors
    from torch.distributed.nn.functional import all_reduce

    return tuple(all_reduce(t, group=group) for t in tensors)


def merge_bn_stats(states: List[Any]) -> Any:
    """Sum the accumulated statistics of shards that trained apart (the
    ReduceAccStat equivalent, e.g. BMUF blocks): any nesting of dicts of
    tensors, summed leaf by leaf."""
    first = states[0]
    if isinstance(first, dict):
        return {k: merge_bn_stats([s[k] for s in states]) for k in first}
    return sum(states[1:], first)
