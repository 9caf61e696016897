"""One rank's training under a strategy.

``make_strategy`` is one rank's part of a strategy over the ranks of the
current group; the convergence runs (convergence.py), the worker CLI
(cli/parallel_tools.py) and ``train_rank`` all train through it:

    run = make_strategy("bmuf", loss_fn, update_fn, params, blocks=2)
    opt_state, loss, aux = run.step(opt_state, run.shard(batch), lr)
    run.model()      # the model the strategy stands for

``train_rank`` is the body that ``launch.spawn`` runs on every rank for
``entry.dryrun_steps``, the card smoke run and the tests, and the same
code at one rank without a group:

    results = spawn(train_rank, 4, args=(job,))
    results = spawn(train_ranks, 4, args=([job, ...],))   # one group

``job`` (a dict; numpy arrays, so it crosses to a spawned process):

  - ``model``: a model file (the JAX zip format, ``Nnet.load``);
  - ``batch``: the global batch, numpy arrays with the rows first:
    ``x`` [B, ...] and ``y`` [B, ...] (frame cross-entropy over the last
    axis), or ``feats``, ``labels``, ``in_lens``, ``lab_lens``, ``mask``
    (CTC, ``ctc_batch_loss``); with ``scan_batches`` each has a leading
    ``inner_steps`` dim first;
  - ``strategy``: ``bsp`` (``steps`` BSP steps over a ``data`` mesh),
    ``bmuf`` (``steps`` block steps over a (``blocks``, W / ``blocks``)
    mesh, ``inner_steps`` each) or ``easgd`` / ``asgd`` / ``masgd``
    (``steps`` rounds of ``inner_steps`` local steps and a sync over a
    ``worker`` mesh, ``alpha``, ``masgd_momentum``, ``masgd_type``);
  - ``learn_rate``, ``momentum`` (train/sgd.py's update), ``seed`` (of
    the rank's generator, 777 by default, the frame trainer's).

Each rank returns its parameters, loss and wall time (ms, the device
synchronized) after every step, the gradients it applied at the first
step, its outputs at the first forward (numpy, on the host), and the
launch counts of every hand kernel's wrapper over the job
(``kernel_counts``; 0 on the CPU, where the wrappers run their plain
versions); a BSP job also the time of one all-reduce of its gradients
(``allreduce_ms``), a PS job the server model (``server``).  A job
``{"cli": [argv, ...]}`` instead runs each command line of the port's
CLI in this rank (a worker tool then trains over this group) and returns
each one's exit code, output and launch counts."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from kaldi_aslp_tpu_torch.parallel.bmuf import (
    BmufOptions,
    BmufState,
    make_bmuf_block_step,
)
from kaldi_aslp_tpu_torch.parallel.bsp import (
    average_gradients,
    make_bsp_train_step,
)
from kaldi_aslp_tpu_torch.parallel.launch import RankContext
from kaldi_aslp_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean,
    flatten,
    make_mesh,
    shard_batch,
    unflatten,
    world_size,
)
from kaldi_aslp_tpu_torch.parallel.optimizers import Optimizer
from kaldi_aslp_tpu_torch.parallel.ps import (
    PS_MODES,
    PsOptions,
    PsState,
    make_ps_round_step,
    ps_round_sync,
)
from kaldi_aslp_tpu_torch.parallel.sod import SodState, sod_sync


@dataclasses.dataclass
class Strategy:
    """One rank's part of a strategy: its ``mesh``, the ``axes`` a global
    batch splits over, ``step(opt_state, local_batch, learn_rate) ->
    (opt_state, loss, aux)`` (the loss averaged over every rank; aux
    BSP's averaged aux, else None) and ``model()``, the model the strategy
    stands for after a step."""
    mesh: Mesh
    axes: Tuple[str, ...]
    step: Callable
    model: Callable[[], Dict[str, torch.Tensor]]

    def shard(self, batch: Any, scan: bool = False) -> Any:
        """This rank's rows of a global batch (``scan``: of each
        minibatch of a [inner_steps, B, ...] stack)."""
        return shard_batch(batch, self.mesh, self.axes, dim=int(scan))


def make_strategy(name: str, loss_fn: Callable, update_fn: Callable,
                  params: Dict[str, torch.Tensor], blocks: int = 2,
                  inner_steps: int = 1, scan_batches: bool = False,
                  bmuf: Optional[BmufOptions] = None,
                  ps: Optional[PsOptions] = None,
                  sod_optimizer: Optional[Optimizer] = None) -> Strategy:
    """Strategy ``name`` over every rank of the group, on ``params`` (name
    -> the module's parameter, trained in place); ``loss_fn`` /
    ``update_fn`` are the BSP step's (parallel/bsp.py):

      bsp   a BSP step over a ``data`` mesh; the model is ``params``;
      bmuf  a block step of ``inner_steps`` over a (``blocks``, W /
            ``blocks``) mesh; the model is ``w_prev``, the filtered model
            before the Nesterov shift;
      easgd / asgd / masgd  a round of ``inner_steps`` local steps, then
            the server's sync (``ps``, its mode set to ``name``) over a
            ``worker`` mesh; the model is the server's;
      sod   a round of local steps, then the mean of the ranks' models
            through ``sod_optimizer`` (sod.py), which every rank takes up;
            the model is that global one.

    ``scan_batches``: inner step i takes slice i of a local batch with a
    leading ``inner_steps`` dim."""
    tensors = list(params.values())
    if name == "bsp":
        if inner_steps != 1 or scan_batches:
            raise ValueError("bsp takes one minibatch a step")
        mesh = make_mesh(("data",))
        return Strategy(mesh, ("data",), make_bsp_train_step(
            loss_fn, update_fn, tensors, mesh), lambda: params)
    if name == "bmuf":
        mesh = make_mesh(("block", "data"),
                         shape=(blocks, world_size() // blocks))
        block_step = make_bmuf_block_step(
            loss_fn, update_fn, params, mesh, bmuf, inner_steps=inner_steps,
            scan_batches=scan_batches)
        bmuf_state = BmufState(params)

        def bmuf_step(opt_state, batch, learn_rate):
            opt_state, loss = block_step(bmuf_state, opt_state, batch,
                                         learn_rate)
            return opt_state, loss, None

        return Strategy(mesh, ("block", "data"), bmuf_step,
                        lambda: bmuf_state.w_prev)
    if name not in PS_MODES and name != "sod":
        raise ValueError(f"unknown strategy {name!r}")
    mesh = make_mesh(("worker",))
    group = mesh.group("worker")
    local_round = make_ps_round_step(loss_fn, update_fn, params, inner_steps,
                                     scan_batches)
    if name == "sod":
        if sod_optimizer is None:
            raise ValueError("sod needs a server optimizer")
        sod_state = SodState(params, sod_optimizer)

        def sync():
            avg = unflatten(all_reduce_mean(flatten(tensors), group),
                            tensors)
            w_global, _ = sod_sync(sod_state, dict(zip(params, avg)))
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(w_global[k])

        def model():
            return sod_state.w_global
    else:
        ps_state = PsState(params, world_size(),
                           dataclasses.replace(ps or PsOptions(), mode=name))

        def sync():
            nonlocal ps_state
            ps_state = ps_round_sync(ps_state, params, mesh)

        def model():
            return ps_state.server

    def round_step(opt_state, batch, learn_rate):
        opt_state, loss = local_round(opt_state, batch, learn_rate)
        sync()
        return opt_state, all_reduce_mean(loss, group), None

    return Strategy(mesh, ("worker",), round_step, model)


def train_kernel_wrappers() -> Dict[str, Any]:
    """Every training kernel's wrapper, by name."""
    from kaldi_aslp_tpu_torch.ops import (
        bilstmp_train,
        bilstmp_xg_train,
        ctc_alpha_beta,
        lstmp_train,
    )
    return {"bilstmp_train_fwd": bilstmp_train.bilstmp_train_fwd,
            "bilstmp_train_bwd": bilstmp_train.bilstmp_train_bwd,
            "bilstmp_train_bwd_dir": bilstmp_train.bilstmp_train_bwd_dir,
            "bilstmp_xg_train_fwd": bilstmp_xg_train.bilstmp_xg_train_fwd,
            "bilstmp_xg_train_bwd": bilstmp_xg_train.bilstmp_xg_train_bwd,
            "lstmp_train_fwd": lstmp_train.lstmp_train_fwd,
            "lstmp_train_bwd": lstmp_train.lstmp_train_bwd,
            "ctc_alpha_beta": ctc_alpha_beta.ctc_alpha_beta}


def kernel_wrappers() -> Dict[str, Any]:
    """Every hand kernel's wrapper, by name."""
    from kaldi_aslp_tpu_torch.ops.lstmp import blstmp_forward, lstmp_forward
    return {**train_kernel_wrappers(), "lstmp_forward": lstmp_forward,
            "blstmp_forward": blstmp_forward}


def reset_kernel_counts() -> None:
    for fn in kernel_wrappers().values():
        for attr in ("launches", "per_step", "wide"):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def kernel_counts() -> Dict[str, Dict[str, int]]:
    """{wrapper: {"launches": n[, "per_step": n][, "wide": n]}}."""
    return {name: {attr: getattr(fn, attr)
                   for attr in ("launches", "per_step", "wide")
                   if hasattr(fn, attr)}
            for name, fn in kernel_wrappers().items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batch_loss_fn(net, record: Dict[str, Any], generator: torch.Generator):
    """loss_fn(batch) -> (loss, aux) of ``net`` in training mode: frame
    cross-entropy for a batch with ``x`` / ``y``, CTC for one with
    ``feats``; a ``Dropout`` draws from ``generator``; the first
    forward's outputs go to ``record["outputs"]``."""
    from kaldi_aslp_tpu_torch.models.losses import ctc_batch_loss, xent_loss

    def loss_fn(b):
        net.train()
        if "feats" in b:
            y, _ = net(b["feats"], mask=b["mask"], generator=generator)
            loss, aux = ctc_batch_loss(y, b["labels"], b["in_lens"],
                                       b["lab_lens"])
        else:
            y, _ = net(b["x"], generator=generator)
            loss, aux = xent_loss(y.reshape(-1, y.shape[-1]),
                                  b["y"].reshape(-1))
        record.setdefault("outputs", y.detach().cpu().numpy())
        return loss, aux

    return loss_fn


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def cli_rank(ctx: RankContext, argvs) -> list:
    """Each command line of the port's CLI in this rank: (exit code, what
    it printed, the kernels' launch counts over it)."""
    import contextlib
    import io

    from kaldi_aslp_tpu_torch.cli.__main__ import main

    out = []
    for argv in argvs:
        reset_kernel_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = main(list(argv))
        _sync(ctx.device)
        out.append({"rc": rc, "stdout": buf.getvalue(),
                    "seconds": time.perf_counter() - t0,
                    "launches": kernel_counts()})
    return out


def train_rank(ctx: RankContext, job: Dict[str, Any]) -> Dict[str, Any]:
    if "cli" in job:
        return {"cli": cli_rank(ctx, job["cli"])}
    from kaldi_aslp_tpu_torch.models.nnet import Nnet
    from kaldi_aslp_tpu_torch.train.sgd import (
        NnetTrainOptions,
        init_velocity,
        make_sgd_update,
    )

    net, _ = Nnet.load(job["model"], ctx.device)
    params = dict(net.named_parameters())
    tensors = list(params.values())
    velocity = init_velocity(net)
    sgd = make_sgd_update(net, NnetTrainOptions(
        momentum=job.get("momentum", 0.0)))
    record: Dict[str, Any] = {}
    loss_fn = batch_loss_fn(net, record, ctx.generator(job.get("seed", 777)))
    first = {}

    def update(opt_state, learn_rate):
        # the first step's gradients as applied (averaged where the
        # strategy averages them)
        if not first:
            first.update({k: p.grad.detach().cpu().numpy()
                          for k, p in params.items()})
        sgd(opt_state, learn_rate)

    reset_kernel_counts()
    strategy = job["strategy"]
    scan = job.get("scan_batches", False)
    run = make_strategy(
        strategy, loss_fn, update, params, blocks=job.get("blocks", 2),
        inner_steps=job.get("inner_steps", 1), scan_batches=scan,
        bmuf=BmufOptions(**job.get("bmuf", {})),
        ps=PsOptions(alpha=job.get("alpha", 0.5),
                     masgd_momentum=job.get("masgd_momentum", 0.9),
                     masgd_type=job.get("masgd_type", "local")))
    local = run.shard(to_device(job["batch"], ctx.device), scan)
    losses, snapshots, step_ms = [], [], []
    for _ in range(job.get("steps", 1)):
        _sync(ctx.device)
        t0 = time.perf_counter()
        velocity, loss, _ = run.step(velocity, local, job["learn_rate"])
        _sync(ctx.device)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))
        snapshots.append({k: p.detach().cpu().numpy().copy()
                          for k, p in params.items()})
    extra: Dict[str, Any] = {"launches": kernel_counts()}
    if strategy == "bsp":
        # one more all-reduce of the last step's gradients, timed alone
        t0 = time.perf_counter()
        average_gradients(tensors, run.mesh.group("data"))
        _sync(ctx.device)
        extra["allreduce_ms"] = 1e3 * (time.perf_counter() - t0)
    elif strategy in PS_MODES:
        extra["server"] = {k: v.cpu().numpy()
                           for k, v in run.model().items()}
    return {"losses": losses, "params": snapshots, "grads": first,
            "outputs": record.get("outputs"), "step_ms": step_ms, **extra}


def train_ranks(ctx: RankContext, jobs) -> list:
    """``train_rank`` for each job in turn, in one group."""
    return [train_rank(ctx, job) for job in jobs]

