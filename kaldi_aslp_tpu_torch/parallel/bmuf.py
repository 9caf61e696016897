"""BMUF: block-momentum update filtering as an outer optimizer.

Port of kaldi_aslp_tpu/parallel/bmuf.py (reference:
src/aslp-parallel/bmuf-worker.cc:37-68: every sync_period frames each
worker computes delta = w_local - w_prev, allreduces it, filters it with
d(t) = m·d(t-1) + (1-m)·lr_bmuf·G(t), sets w = w_prev + d (+ the
Nesterov shift) and snapshots w_prev).

``bmuf_sync`` is the filter on dicts of tensors.  ``make_bmuf_block_step``
is JAX's one-``shard_map`` block step (bmuf.py:76-165) on ranks laid out
as a (block, data) mesh: ``inner_steps`` of BSP inside the block's
``data`` group, then the parameters' mean over the ``block`` group, then
the filter, the same on every rank.  Each rank keeps its block's own
momenta (the optimizer state the inner steps update), the per-rank
counterpart of JAX's ``stack_block_states``."""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from kaldi_aslp_tpu_torch.parallel.bsp import backward_step, slice_batch
from kaldi_aslp_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean,
    flatten,
    unflatten,
)
from kaldi_aslp_tpu_torch.utils.config import Config

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class BmufOptions(Config):
    bmuf_momentum: float = 0.9
    bmuf_learn_rate: float = 1.0
    nesterov: bool = True  # NBM variant (the reference default scheme)


class BmufState:
    """``w_prev``, the model at the last sync before the Nesterov shift,
    and ``delta``, the filtered block update."""

    def __init__(self, params: Tensors):
        self.w_prev = {k: v.detach().clone() for k, v in params.items()}
        self.delta = {k: torch.zeros_like(v) for k, v in params.items()}


def bmuf_sync(state: BmufState, block_avg_params: Tensors,
              opts: BmufOptions):
    """One BMUF synchronization on the across-block average of the
    locally trained parameters; returns (new_params, state)."""
    m, lr = opts.bmuf_momentum, opts.bmuf_learn_rate
    new_w, new_d, new_prev = {}, {}, {}
    for k, wp in state.w_prev.items():
        g = block_avg_params[k] - wp             # block gradient G(t)
        d = m * state.delta[k] + (1.0 - m) * lr * g
        w = wp + d
        new_prev[k] = w                          # snapshot BEFORE lookahead
        new_w[k] = w + m * d if opts.nesterov else w
        new_d[k] = d
    state.delta, state.w_prev = new_d, new_prev
    return new_w, state


def make_bmuf_block_step(loss_fn: Callable, update_fn: Callable,
                         params: Tensors, mesh: Mesh,
                         opts: Optional[BmufOptions] = None,
                         inner_steps: int = 2, block_axis: str = "block",
                         data_axis: str = "data",
                         scan_batches: bool = False) -> Callable:
    """step(state, opt_state, batch, learn_rate) -> (opt_state, loss).

    ``params`` (name -> the module's parameter) hold the model w on entry
    and the filtered model on return; ``state`` (a ``BmufState``) carries
    w_prev and delta; ``loss_fn`` / ``update_fn`` are the BSP step's
    (parallel/bsp.py).  ``batch`` is this rank's shard; with
    ``scan_batches`` each tensor of it has a leading ``inner_steps`` dim
    and inner step i takes slice i (the worker CLI's fresh minibatches
    between syncs), else every inner step takes the whole shard.  The loss
    is the last inner step's, averaged over the data and block groups."""
    opts = opts or BmufOptions()
    names = list(params)
    tensors = [params[k] for k in names]
    data_group, block_group = mesh.group(data_axis), mesh.group(block_axis)

    def step(state: BmufState, opt_state: Any, batch: Any, learn_rate):
        loss = None
        for i in range(inner_steps):
            b = slice_batch(batch, i) if scan_batches else batch
            opt_state, loss, _ = backward_step(
                tensors, loss_fn, update_fn, opt_state, b, learn_rate,
                data_group)
            loss = all_reduce_mean(loss.clone(), data_group)
        avg = unflatten(all_reduce_mean(flatten(tensors), block_group),
                        tensors)
        new_w, _ = bmuf_sync(state, dict(zip(names, avg)), opts)
        with torch.no_grad():
            for k in names:
                params[k].copy_(new_w[k])
        return opt_state, all_reduce_mean(loss, block_group)

    return step


def stack_block_states(opt_state: Any, num_blocks: int) -> Any:
    """This rank's own copy of its block's optimizer state: JAX stacks a
    row a block (bmuf.py:167-172); a rank holds its block's row."""
    del num_blocks
    return copy.deepcopy(opt_state)
