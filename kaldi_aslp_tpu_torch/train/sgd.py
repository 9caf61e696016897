"""Per-component SGD with momentum / L1 / L2 / lr-coefs / max-norm.

Port of kaldi_aslp_tpu/train/sgd.py (reference: src/aslp-nnet/
nnet-trnopts.h NnetTrainOptions; per-component learn_rate_coef /
bias_learn_rate_coef and max_norm inside AffineTransform::Update).  The
update runs in place on the device under ``torch.no_grad()``:

    g += l2 * p + l1 * sign(p)
    v = momentum * v - learn_rate * coef * g;   p += v

then rows of an ``AffineTransform`` weight whose norm exceeds its
``max_norm`` are scaled back to it.  ``torch.optim.SGD`` is not used: its
momentum form (v = momentum * v + g; p -= learn_rate * v) differs."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from kaldi_aslp_tpu_torch.models.nnet import Nnet
from kaldi_aslp_tpu_torch.utils.config import Config


@dataclasses.dataclass
class NnetTrainOptions(Config):
    learn_rate: float = 0.008
    momentum: float = 0.0
    l1_penalty: float = 0.0
    l2_penalty: float = 0.0


def init_velocity(net: Nnet) -> Dict[str, torch.Tensor]:
    """Zero velocity for every parameter, keyed by its state-dict name."""
    return {name: torch.zeros_like(p) for name, p in net.named_parameters()}


def _leaf_coef(net: Nnet, name: str) -> float:
    """lr multiplier of a parameter ``nodes.<id>.<top>[...]``: the
    component's lr_coefs() entry for ``top`` (the parameters of a BLSTM's
    fwd/bwd cells take 1.0, as in the JAX package)."""
    _, cid, top = name.split(".")[:3]
    return float(net.nodes[int(cid)].lr_coefs().get(top, 1.0))


def make_sgd_update(net: Nnet, opts: NnetTrainOptions
                    ) -> Callable[[Dict[str, torch.Tensor], float], None]:
    """Returns update(velocity, learn_rate), which applies the gradients
    in ``p.grad`` (a parameter without one counts as a zero gradient)
    and updates ``velocity`` and the parameters in place."""
    params = dict(net.named_parameters())
    coefs = {name: _leaf_coef(net, name) for name in params}
    clipped = [(comp.w, comp.max_norm) for comp in net.nodes
               if getattr(comp, "max_norm", 0.0)]

    @torch.no_grad()
    def update(velocity: Dict[str, torch.Tensor], learn_rate: float) -> None:
        for name, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if opts.l2_penalty != 0.0:
                g = g + opts.l2_penalty * p
            if opts.l1_penalty != 0.0:
                g = g + opts.l1_penalty * torch.sign(p)
            v = velocity[name]
            v.mul_(opts.momentum).sub_(learn_rate * coefs[name] * g)
            p.add_(v)
        for w, max_norm in clipped:
            norms = torch.sqrt((w * w).sum(dim=1, keepdim=True) + 1e-20)
            w.copy_(torch.where(norms > max_norm, w * (max_norm / norms), w))

    return update
