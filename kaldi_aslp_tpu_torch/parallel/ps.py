"""EASGD / ASGD / MASGD: the parameter-server strategies under a
deterministic arrival schedule.

Port of kaldi_aslp_tpu/parallel/ps.py (reference:
src/aslp-parallel/easgd-server.cc:63-89 + easgd-worker.cc:37-69,
asgd-server.cc:82-109 + asgd-worker.cc:34-69, masgd-server.cc:109-137).
The reference's asynchrony is an MPI arrival order: the server serves
the workers one at a time (easgd-server.cc:38-61), so given the order the
trajectory is fixed.  JAX keeps that math under an explicit order
(round-robin by default) and so does the port; real asynchrony would be
a feature the JAX package lacks.

  * ``PsState`` holds the server model and the workers' models stacked
    [W, ...], with ASGD/MASGD's ``prev`` (each worker's model at its last
    pull) and MASGD's momentum ``diffs`` ([W, ...] for LMASGD, one buffer
    for GMASGD);
  * ``ps_sync_round`` serves the workers in ``order``, a pure function of
    the stacked tensors (JAX's ``_sync_round_impl``);
  * ``make_ps_round_step`` is a round's local training on one rank: SGD
    on its own model, no collective; ``ps_round_sync`` then gathers every
    rank's model (``mesh.gather_rows``), runs the same server loop on
    every rank (the same bits everywhere) and hands each rank its own row.

Per-mode sync math (the reference's; ps.py:26-38):

  EASGD  x_s <- (1-a)·x_s + a·x_w;  x_w <- (1-a)·x_w + a·x_s_old
  ASGD   D = x_w - x_prev;  x_s <- x_s + a·D;  x_w = x_prev = x_s
  MASGD  d <- m·d + D;  x_s <- x_s + d;  x_w = x_prev = x_s"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from kaldi_aslp_tpu_torch.parallel.bsp import backward_step, slice_batch
from kaldi_aslp_tpu_torch.parallel.mesh import (
    Mesh,
    flatten,
    gather_rows,
    unflatten,
)
from kaldi_aslp_tpu_torch.utils.config import Config

Tensors = Dict[str, torch.Tensor]
PS_MODES = ("easgd", "asgd", "masgd")


@dataclasses.dataclass
class PsOptions(Config):
    mode: str = "easgd"          # easgd | asgd | masgd
    alpha: float = 0.5           # easgd elastic / asgd gain
    masgd_momentum: float = 0.9  # masgd server momentum
    masgd_type: str = "local"    # local (LMASGD) | global (GMASGD)
    # the reference's per-mode alpha defaults differ (easgd 0.5, asgd 1.0:
    # easgd-server.h:23 / asgd-server.h:23); callers pick


def stack_worker_states(tree: Any, num_workers: int) -> Any:
    """Every tensor of ``tree`` (dicts of tensors) repeated on a leading
    worker dim."""
    if isinstance(tree, dict):
        return {k: stack_worker_states(v, num_workers)
                for k, v in tree.items()}
    return tree.unsqueeze(0).expand((num_workers,) + tuple(tree.shape)
                                    ).clone()


class PsState:
    """Server params + stacked per-worker state (see the module's
    docstring)."""

    def __init__(self, params: Tensors, num_workers: int, opts: PsOptions):
        self.opts = opts
        self.num_workers = num_workers
        self.server = {k: v.detach().clone() for k, v in params.items()}
        self.workers = stack_worker_states(self.server, num_workers)
        self.prev = (dict(self.workers) if opts.mode in ("asgd", "masgd")
                     else None)
        if opts.mode == "masgd":
            src = self.workers if opts.masgd_type == "local" else self.server
            self.diffs = {k: torch.zeros_like(v) for k, v in src.items()}
        else:
            self.diffs = None


def easgd_pair_sync(server: Tensors, worker: Tensors, alpha: float):
    """One elastic exchange; each side reads the other's value before the
    exchange (the reference's MPI_Sendrecv is simultaneous)."""
    new_server = {k: (1.0 - alpha) * s + alpha * worker[k]
                  for k, s in server.items()}
    new_worker = {k: (1.0 - alpha) * w + alpha * server[k]
                  for k, w in worker.items()}
    return new_server, new_worker


def asgd_pair_sync(server: Tensors, worker: Tensors, prev: Tensors,
                   alpha: float):
    """Delta push + model pull: (server, worker, prev), the latter two the
    new server model."""
    new_server = {k: s + alpha * (worker[k] - prev[k])
                  for k, s in server.items()}
    return new_server, new_server, new_server


def masgd_pair_sync(server: Tensors, worker: Tensors, prev: Tensors,
                    diff: Tensors, momentum: float):
    """ASGD with a server momentum filter on the pushed delta."""
    new_diff = {k: momentum * d + (worker[k] - prev[k])
                for k, d in diff.items()}
    new_server = {k: s + new_diff[k] for k, s in server.items()}
    return new_server, new_server, new_server, new_diff


def _row(stacked: Tensors, i: int) -> Tensors:
    return {k: v[i] for k, v in stacked.items()}


def ps_sync_round(state: PsState,
                  order: Optional[Sequence[int]] = None) -> PsState:
    """One round of worker -> server syncs in arrival ``order`` (default
    0..W-1, round-robin); a new state, ``state`` left as it was."""
    opts, W = state.opts, state.num_workers
    order = list(range(W)) if order is None else [int(i) for i in order]
    server = state.server
    workers = {k: v.clone() for k, v in state.workers.items()}
    prev = (None if state.prev is None
            else {k: v.clone() for k, v in state.prev.items()})
    local = opts.masgd_type == "local"
    diffs = state.diffs
    if opts.mode == "masgd" and local:
        diffs = {k: v.clone() for k, v in diffs.items()}

    def put(stacked, i, row):
        for k, v in row.items():
            stacked[k][i] = v

    for i in order:
        if opts.mode == "easgd":
            server, w = easgd_pair_sync(server, _row(workers, i), opts.alpha)
            put(workers, i, w)
        elif opts.mode == "asgd":
            server, w, p = asgd_pair_sync(server, _row(workers, i),
                                          _row(prev, i), opts.alpha)
            put(workers, i, w)
            put(prev, i, p)
        elif opts.mode == "masgd":
            diff = _row(diffs, i) if local else diffs
            server, w, p, d = masgd_pair_sync(
                server, _row(workers, i), _row(prev, i), diff,
                opts.masgd_momentum)
            put(workers, i, w)
            put(prev, i, p)
            if local:
                put(diffs, i, d)
            else:
                diffs = d
        else:
            raise ValueError(f"unknown ps mode {opts.mode!r}")
    new = PsState.__new__(PsState)
    new.opts, new.num_workers = opts, W
    new.server, new.workers, new.prev, new.diffs = (server, workers, prev,
                                                    diffs)
    return new


def make_ps_round_step(loss_fn: Callable, update_fn: Callable,
                       params: Tensors, inner_steps: int = 1,
                       scan_batches: bool = False) -> Callable:
    """step(opt_state, batch, learn_rate) -> (opt_state, mean loss): a
    round's ``inner_steps`` of local SGD on this rank's model (the
    module's parameters, in place) and this rank's shard, with no
    collective (reference: easgd-worker.cc:37, train --sync-period frames
    then Synchronize).  ``loss_fn`` / ``update_fn`` are the BSP step's
    (parallel/bsp.py); ``scan_batches`` as in ``make_bmuf_block_step``.
    Then ``ps_round_sync``."""
    tensors = list(params.values())

    def step(opt_state, batch, learn_rate):
        losses = []
        for i in range(inner_steps):
            b = slice_batch(batch, i) if scan_batches else batch
            opt_state, loss, _ = backward_step(
                tensors, loss_fn, update_fn, opt_state, b, learn_rate, None)
            losses.append(loss)
        return opt_state, torch.stack(losses).mean()

    return step


def ps_round_sync(state: PsState, params: Tensors, mesh: Mesh,
                  axis: str = "worker",
                  order: Optional[Sequence[int]] = None) -> PsState:
    """The round's sync on every rank: gather the ranks' models into
    ``state.workers``, serve them in ``order``, and load this rank's row
    of the result into ``params``."""
    names = list(params)
    tensors = [params[k] for k in names]
    rows = [unflatten(r, tensors)
            for r in gather_rows(flatten(tensors), mesh, axis)]
    state.workers = {k: torch.stack([r[j] for r in rows])
                     for j, k in enumerate(names)}
    state = ps_sync_round(state, order)
    me = mesh.coords[axis]
    with torch.no_grad():
        for k in names:
            params[k].copy_(state.workers[k][me])
    return state
