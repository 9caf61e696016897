"""The server optimizers: SGD, momentum, AdaGrad, RMSprop, AdaDelta, Adam.

Port of kaldi_aslp_tpu/parallel/optimizers.py (reference:
src/aslp-parallel/optimizer.h:21-221), which builds them from optax
0.2.6.  Each is a pair of plain functions on dicts of tensors, in
optax's form and arithmetic:

    opt = make_optimizer(OptimizerOptions(optimizer="adam"))
    state = opt.init(params)
    updates, state = opt.update(grads, state)
    params = apply_updates(params, updates)

``torch.optim`` is not used: its Adagrad starts the accumulator at 0
where optax starts at 0.1, its RMSprop adds eps outside the square root
where optax adds it inside (``eps_in_sqrt``), its Adadelta scales by its
own default lr, and its SGD momentum is v = m·v + g, p -= lr·v where
optax's trace gives the same only with the lr outside (train/sgd.py has
the same gap).  Per optimizer, with lr the learning rate and g the
gradient (optax's defaults where the JAX factory passes none):

    sgd       u = -lr·g
    momentum  t = g + m·t;  u = -lr·t
    adagrad   s = g² + s (s₀ = 0.1);  u = -lr·(s > 0 ? rsqrt(s + eps) : 0)·g
    rmsprop   ν = (1-ρ)·g² + ρ·ν;  u = -lr·rsqrt(ν + eps)·g
    adadelta  E_g = (1-ρ)·g² + ρ·E_g;  d = sqrt(E_x + eps) / sqrt(E_g + eps)·g;
              E_x = (1-ρ)·d² + ρ·E_x;  u = -lr·d
    adam      μ = (1-β₁)·g + β₁·μ;  ν = (1-β₂)·g² + β₂·ν;  n += 1;
              u = -lr·(μ / (1-β₁ⁿ)) / (sqrt(ν / (1-β₂ⁿ)) + eps)"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from kaldi_aslp_tpu_torch.utils.config import Config

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class OptimizerOptions(Config):
    optimizer: str = "sgd"  # sgd|momentum|adagrad|rmsprop|adadelta|adam
    learn_rate: float = 0.008
    momentum: float = 0.9
    rho: float = 0.95      # adadelta / rmsprop decay
    epsilon: float = 1e-8
    beta1: float = 0.9
    beta2: float = 0.999


class Optimizer(NamedTuple):
    """optax's GradientTransformation on dicts of tensors."""
    init: Callable[[Tensors], Dict[str, Tensors]]
    update: Callable[[Tensors, Dict[str, Tensors]],
                     Tuple[Tensors, Dict[str, Tensors]]]


def _full_like(params: Tensors, value: float) -> Tensors:
    return {k: torch.full_like(v, value) for k, v in params.items()}


def _moment(g: torch.Tensor, t: torch.Tensor, decay: float,
            order: int) -> torch.Tensor:
    """optax's update_moment: (1 - decay)·g^order + decay·t."""
    return (1 - decay) * g ** order + decay * t


def _pow_f32(base: float, n: int) -> np.float32:
    """base**n as float32 ``powf``, as optax's jitted bias correction
    computes decay**count (XLA on the CPU)."""
    return np.float32(base) ** np.float32(n)


def make_optimizer(opts: OptimizerOptions) -> Optimizer:
    """Factory (reference: optimizer.h Optimizer::GetInstance)."""
    name = opts.optimizer.lower()
    lr = opts.learn_rate

    if name in ("sgd", "momentum"):
        m = opts.momentum if name == "momentum" else None

        def init(params):
            return {} if m is None else {"trace": _full_like(params, 0.0)}

        def update(grads, state):
            if m is None:
                return {k: g * -lr for k, g in grads.items()}, state
            trace = {k: g + m * state["trace"][k] for k, g in grads.items()}
            return {k: t * -lr for k, t in trace.items()}, {"trace": trace}
        return Optimizer(init, update)

    if name == "adagrad":
        eps = opts.epsilon

        def init(params):
            return {"sum_of_squares": _full_like(params, 0.1)}

        def update(grads, state):
            sos = {k: g * g + state["sum_of_squares"][k]
                   for k, g in grads.items()}
            ups = {}
            for k, g in grads.items():
                s = sos[k]
                inv = torch.where(s > 0, torch.rsqrt(s + eps),
                                  torch.zeros_like(s))
                ups[k] = (inv * g) * -lr
            return ups, {"sum_of_squares": sos}
        return Optimizer(init, update)

    if name == "rmsprop":
        decay, eps = opts.rho, opts.epsilon

        def init(params):
            return {"nu": _full_like(params, 0.0)}

        def update(grads, state):
            nu = {k: _moment(g, state["nu"][k], decay, 2)
                  for k, g in grads.items()}
            return ({k: (torch.rsqrt(nu[k] + eps) * g) * -lr
                     for k, g in grads.items()}, {"nu": nu})
        return Optimizer(init, update)

    if name == "adadelta":
        rho, eps = opts.rho, opts.epsilon

        def init(params):
            return {"e_g": _full_like(params, 0.0),
                    "e_x": _full_like(params, 0.0)}

        def update(grads, state):
            e_g = {k: _moment(g, state["e_g"][k], rho, 2)
                   for k, g in grads.items()}
            d = {k: (torch.sqrt(state["e_x"][k] + eps)
                     / torch.sqrt(e_g[k] + eps)) * g
                 for k, g in grads.items()}
            e_x = {k: _moment(d[k], state["e_x"][k], rho, 2) for k in d}
            return ({k: v * -lr for k, v in d.items()},
                    {"e_g": e_g, "e_x": e_x})
        return Optimizer(init, update)

    if name == "adam":
        b1, b2, eps = opts.beta1, opts.beta2, opts.epsilon

        def init(params):
            return {"count": 0, "mu": _full_like(params, 0.0),
                    "nu": _full_like(params, 0.0)}

        def update(grads, state):
            n = state["count"] + 1
            mu = {k: _moment(g, state["mu"][k], b1, 1)
                  for k, g in grads.items()}
            nu = {k: _moment(g, state["nu"][k], b2, 2)
                  for k, g in grads.items()}
            c1, c2 = 1 - _pow_f32(b1, n), 1 - _pow_f32(b2, n)
            ups = {}
            for k in grads:
                m_hat = mu[k] / float(c1)
                v_hat = nu[k] / float(c2)
                ups[k] = (m_hat / (torch.sqrt(v_hat) + eps)) * -lr
            return ups, {"count": n, "mu": mu, "nu": nu}
        return Optimizer(init, update)

    raise ValueError(f"unknown optimizer {opts.optimizer!r}")


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    """optax.apply_updates: params + updates, in the params' dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}
