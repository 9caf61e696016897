"""BSP data parallelism: every rank's gradient averaged every step.

Port of kaldi_aslp_tpu/parallel/bsp.py (reference:
src/aslp-parallel/bsp-worker.cc:33, model averaging over MPI
Allreduce).  JAX differentiates the ``pmean`` of the shards' losses
under ``shard_map``; here each rank runs backward on its own shard's
loss, then every gradient is summed over the ``data`` group and divided
by its size, which is the gradient of that mean (bsp.py:42-51).  The
update that follows is the same on every rank, so the model stays
replicated bit for bit.

The port's training step works on a module's parameters in place, so
the step's parts are:

    loss_fn(batch) -> (loss, aux)       forward on this rank's shard
    update_fn(opt_state, learn_rate)    applies each parameter's .grad
                                        (train/sgd.py:make_sgd_update's
                                        update); returns the new state,
                                        or None when it updates in place"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Tuple

import torch

from kaldi_aslp_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean,
    flatten,
    group_size,
    shard_batch,
    unflatten,
)

__all__ = ["average_gradients", "make_bsp_train_step", "shard_batch"]


def average_gradients(params: Sequence[torch.Tensor], group) -> None:
    """Replace each ``p.grad`` by its mean over ``group``: one all-reduce
    of every gradient in one buffer (a parameter without a gradient
    counts as a zero gradient, as under JAX)."""
    if group_size(group) == 1:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = all_reduce_mean(flatten(grads), group)
    for p, g in zip(params, unflatten(flat, grads)):
        p.grad = g


def average_aux(aux: Any, group) -> Any:
    """Every tensor of ``aux`` (a dict or list of them) averaged over
    ``group``, as JAX ``pmean``s the aux tree."""
    if isinstance(aux, dict):
        return {k: average_aux(v, group) for k, v in aux.items()}
    if isinstance(aux, (list, tuple)):
        return type(aux)(average_aux(v, group) for v in aux)
    return all_reduce_mean(aux.detach().clone(), group)


def slice_batch(batch: Any, i: int) -> Any:
    """Slice ``i`` of the leading dim of every tensor of ``batch``."""
    if isinstance(batch, dict):
        return {k: slice_batch(v, i) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(slice_batch(v, i) for v in batch)
    return batch[i]


def backward_step(params: Sequence[torch.Tensor], loss_fn: Callable,
                  update_fn: Callable, opt_state: Any, batch: Any,
                  learn_rate: float, group) -> Tuple[Any, torch.Tensor, Any]:
    """One BSP step over ``group``: (new opt_state, this rank's loss,
    aux)."""
    for p in params:
        p.grad = None
    loss, aux = loss_fn(batch)
    loss.backward()
    average_gradients(params, group)
    new_state = update_fn(opt_state, learn_rate)
    return (opt_state if new_state is None else new_state), loss.detach(), aux


def make_bsp_train_step(loss_fn: Callable, update_fn: Callable,
                        params: Sequence[torch.Tensor], mesh: Mesh,
                        axis: str = "data") -> Callable:
    """step(opt_state, batch, learn_rate) -> (opt_state, loss, aux) on
    this rank's shard of the batch (``shard_batch``); the loss and aux
    come back averaged over the axis, as JAX's pmean'd ones."""
    params = list(params)
    group = mesh.group(axis)

    def step(opt_state, batch, learn_rate):
        opt_state, loss, aux = backward_step(params, loss_fn, update_fn,
                                             opt_state, batch, learn_rate,
                                             group)
        return (opt_state, all_reduce_mean(loss.clone(), group),
                average_aux(aux, group))

    return step
