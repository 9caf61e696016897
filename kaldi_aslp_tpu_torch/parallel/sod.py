"""SOD (sum of deltas) outer training with a server optimizer.

Port of kaldi_aslp_tpu/parallel/sod.py (reference:
src/aslp-parallel/sod-worker.cc:37 + optimizer.h: workers push
parameter deltas, the server applies them through SGD / Momentum /
AdaGrad / RMSprop / AdaDelta / Adam).  The server is the update on the
averaged delta, the same on every rank: delta = avg(w_local) - w_global
goes through a server optimizer (parallel/optimizers.py) as the
gradient -delta."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from kaldi_aslp_tpu_torch.parallel.optimizers import Optimizer, apply_updates

Tensors = Dict[str, torch.Tensor]


class SodState:
    def __init__(self, params: Tensors, optimizer: Optimizer):
        self.w_global = {k: v.detach().clone() for k, v in params.items()}
        self.optimizer = optimizer
        self.opt_state = optimizer.init(self.w_global)


def sod_sync(state: SodState,
             block_avg_params: Tensors) -> Tuple[Tensors, SodState]:
    """One synchronization, -delta as the gradient (reference:
    sod-worker.cc Synchronize + the server optimizer's update)."""
    neg_delta = {k: w - block_avg_params[k]
                 for k, w in state.w_global.items()}
    updates, state.opt_state = state.optimizer.update(neg_delta,
                                                      state.opt_state)
    state.w_global = apply_updates(state.w_global, updates)
    return state.w_global, state


def model_average_sync(params_list: Sequence[Tensors]) -> Tensors:
    """Plain model averaging over worker copies (reference:
    bsp-worker.cc:33, params / num_workers after an allreduce)."""
    n = len(params_list)
    return {k: sum(p[k] for p in params_list) / n for k in params_list[0]}
