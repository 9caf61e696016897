"""Data-parallel trainer worker CLIs.

Port of kaldi_aslp_tpu/cli/parallel_tools.py (reference:
src/aslp-parallelbin/aslp-nnet-train-frame-worker.cc,
aslp-nnet-train-lstm-stream-worker.cc:126-189: the worker selected by
--worker-type, parameters synced every --sync-period frames;
aslp-nnet-train-server.cc runs the parameter server):

    aslp-nnet-train-frame-worker [--worker-type=bsp] [--num-workers=N]
        [--device=cuda] feats-rspec targets-rspec model-in [model-out]

(also ``-lstm-stream-worker``, ``-lc-blstm-streams-worker`` and
``aslp-nnet-train-simple-mpi``: one trainer, the architecture lives in
the model file).  The JAX package drives every device of a mesh from one
process; the port runs one process a worker rank, as the reference's
MPI does.  Launched by torchrun (``torchrun --nproc-per-node=N -m
kaldi_aslp_tpu_torch.cli aslp-nnet-train-frame-worker ...``) or inside a
group that is already up, the tool is that rank; otherwise it spawns
``--num-workers`` ranks on this host (0: one a visible card; one on the
CPU) and prints rank 0's report.  The backend rule is
parallel/mesh.py's: nccl when every rank has a card of its own, gloo
when ranks share one or run on the CPU.

Every rank reads the same tables through the same seeded
``FrameRandomizer``, so all see the same global minibatches, and takes
its own rows of each, as JAX's mesh shards them:

  bsp  - the gradient averaged over the ranks every step (bsp-worker.cc
         model averaging, sync_period = minibatch);
  sod  - the same, the averaged gradient through the server optimizer
         (--server-optimizer, parallel/optimizers.py);
  bmuf - local SGD on each rank (a block of one) over --sync-period
         frames of fresh minibatches, then the block-momentum sync
         (bmuf-worker.cc:37-68);
  easgd/asgd/masgd - local SGD over --sync-period frames, then every rank
         gathers the workers' models and runs the server's one-at-a-time
         sync loop in arrival order (parallel/ps.py); the server model is
         what is written.

As in JAX, the PS and BMUF modes drop the minibatches left over after
the last full sync period, and ``--cross-validate`` only skips the write.
A net is trained on the frame cross-entropy with each frame a stream of
one frame (``FrameTrainer``'s rule: an LSTM takes the minibatch as N
streams of one frame).  Losses and frame counts are reported over all
ranks; rank 0 writes the model."""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import List, Optional

import numpy as np

from kaldi_aslp_tpu_torch.utils.config import Config, parse_options
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("parallel-cli")

USAGE = ("aslp-nnet-train-*-worker --worker-type=bsp|bmuf|sod|easgd|asgd|"
         "masgd [--num-workers=N] [--device=cuda] feats-rspec targets-rspec "
         "model-in [model-out]")
WORKER_TYPES = ("bsp", "bmuf", "sod", "easgd", "asgd", "masgd")


@dataclasses.dataclass
class WorkerFlags(Config):
    worker_type: str = "bsp"     # bsp | bmuf | sod | easgd | asgd | masgd
    num_workers: int = 0         # 0 = one rank a visible card (CPU: one)
    sync_period: int = 25600     # frames between syncs (ref default)
    learn_rate: float = 0.008
    momentum: float = 0.0
    bmuf_momentum: float = 0.9
    bmuf_learn_rate: float = 1.0
    server_optimizer: str = "sgd"   # sod server-side optimizer
    alpha: float = -1.0          # easgd/asgd gain; -1 = per-mode ref
    #                              default (easgd 0.5, asgd/masgd 1.0)
    masgd_momentum: float = 0.9  # masgd server momentum
    masgd_type: str = "local"    # local (LMASGD) | global (GMASGD)
    minibatch_size: int = 256
    cross_validate: bool = False
    device: str = "cuda"


def _parse(argv):
    from kaldi_aslp_tpu_torch.data.randomizer import RandomizerOptions

    flags, ropts = WorkerFlags(), RandomizerOptions()
    args = parse_options(argv, [flags, ropts], USAGE, 3, 4)
    ropts.minibatch_size = flags.minibatch_size
    if flags.worker_type not in WORKER_TYPES:
        raise ValueError(f"unknown --worker-type={flags.worker_type}")
    return flags, ropts, args


def pad_to(f: np.ndarray, t: np.ndarray, mult: int):
    """Pad a minibatch to a multiple of ``mult`` rows with its own first
    rows (JAX's pad_to, parallel_tools.py:117-123)."""
    m = len(t)
    if m % mult == 0:
        return f, t
    pad = mult - m % mult
    return np.concatenate([f, f[:pad]]), np.concatenate([t, t[:pad]])


def nnet_train_worker(argv) -> int:
    """Frame-CE data-parallel worker (reference:
    aslp-nnet-train-frame-worker.cc / -lstm-stream-worker.cc)."""
    import torch
    import torch.distributed as dist

    from kaldi_aslp_tpu_torch.parallel.launch import (
        RankContext,
        current_context,
        spawn,
    )
    from kaldi_aslp_tpu_torch.parallel.mesh import (
        initialize_distributed,
        shutdown_distributed,
    )
    from kaldi_aslp_tpu_torch.utils.device import resolve_device

    flags, _, _ = _parse(argv)
    device = resolve_device(flags.device)
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        started = initialize_distributed(device_type=device.type)
        try:
            ctx = current_context(device.type)
            if flags.num_workers not in (0, ctx.world_size):
                raise ValueError(f"--num-workers={flags.num_workers} in a "
                                 f"group of {ctx.world_size} ranks")
            if device.type == "cuda":
                torch.cuda.set_device(ctx.device)
            report = worker_main(ctx, list(argv))
            if started:
                dist.barrier()
        finally:
            if started:     # a group this call started (torchrun's)
                shutdown_distributed()
        if ctx.rank == 0:
            print(report)
        return 0
    n = flags.num_workers or (torch.cuda.device_count()
                              if device.type == "cuda" else 1)
    if n == 1:
        report = worker_main(RankContext(0, 1, device, "none"), list(argv))
    else:
        report = spawn(worker_main, n, args=(list(argv),),
                       device_type=device.type)[0]
    print(report)
    return 0


def worker_main(ctx, argv: List[str]) -> Optional[str]:
    """One rank of the worker CLI; rank 0 returns the report."""
    import torch

    from kaldi_aslp_tpu_torch.cli.train_tools import frame_source
    from kaldi_aslp_tpu_torch.data.randomizer import FrameRandomizer
    from kaldi_aslp_tpu_torch.models import Nnet
    from kaldi_aslp_tpu_torch.models.losses import LossReporter
    from kaldi_aslp_tpu_torch.parallel import (
        BmufOptions,
        OptimizerOptions,
        PsOptions,
        make_optimizer,
    )
    from kaldi_aslp_tpu_torch.parallel.ps import PS_MODES
    from kaldi_aslp_tpu_torch.parallel.steps import make_strategy
    from kaldi_aslp_tpu_torch.train import (
        FrameTrainer,
        NnetTrainOptions,
        init_velocity,
    )
    from kaldi_aslp_tpu_torch.train.sgd import make_sgd_update

    flags, ropts, args = _parse(argv)
    n, dev = ctx.world_size, ctx.device
    net, model_states = Nnet.load(args[2], dev)
    params = dict(net.named_parameters())
    opts = NnetTrainOptions(learn_rate=flags.learn_rate,
                            momentum=flags.momentum)
    trainer = FrameTrainer(net, opts)
    lr = flags.learn_rate
    reporter = LossReporter("xent")

    def loss_fn(b):
        net.train()
        return trainer.loss(trainer.forward(b["feats"]), b["targets"],
                            b["weights"])

    def to_device(f, t):
        return {"feats": torch.from_numpy(
                    np.ascontiguousarray(f, np.float32)).to(dev),
                "targets": torch.from_numpy(t.astype(np.int64)).to(dev),
                "weights": torch.ones(t.shape, device=dev)}

    def batches():
        r = FrameRandomizer(ropts)
        for _, f, t in frame_source(args[0], args[1]):
            r.feed(f, t)
            if r.full():
                yield from r.iterate_minibatches()
        yield from r.flush()

    def synced_periods(inner):
        """[inner, b, ...] stacks of ``inner`` minibatches, each padded
        to a multiple of the ranks and cut to the shortest; a last,
        shorter period is dropped, as in JAX."""
        pend_f, pend_t = [], []
        for f, t in batches():
            f, t = pad_to(f, t, n)
            pend_f.append(f)
            pend_t.append(t)
            if len(pend_f) < inner:
                continue
            b = min(len(x) for x in pend_t)
            yield (np.stack([x[:b] for x in pend_f]),
                   np.stack([x[:b] for x in pend_t]), b)
            pend_f, pend_t = [], []

    inner = max(1, flags.sync_period // max(flags.minibatch_size, 1))
    wt = flags.worker_type
    periodic = wt in ("bmuf", *PS_MODES)
    if wt == "sod":   # BSP, the averaged gradient through the server's
        opt = make_optimizer(OptimizerOptions(
            optimizer=flags.server_optimizer, learn_rate=flags.learn_rate))

        @torch.no_grad()
        def update(opt_state, _lr):
            ups, opt_state = opt.update(
                {k: p.grad for k, p in params.items()}, opt_state)
            for k, p in params.items():
                p.copy_((p + ups[k]).to(p.dtype))
            return opt_state
        opt_state = opt.init({k: p.detach() for k, p in params.items()})
    else:
        update, opt_state = make_sgd_update(net, opts), init_velocity(net)
    alpha = flags.alpha
    if alpha < 0:
        alpha = 0.5 if wt == "easgd" else 1.0
    if wt == "bmuf" and n < 2:
        logger.warning("bmuf with <2 workers degenerates to SGD")
    # BMUF: each rank a block of one
    run = make_strategy(
        "bsp" if wt == "sod" else wt, loss_fn, update, params, blocks=n,
        inner_steps=inner if periodic else 1, scan_batches=periodic,
        bmuf=BmufOptions(bmuf_momentum=flags.bmuf_momentum,
                         bmuf_learn_rate=flags.bmuf_learn_rate),
        ps=PsOptions(alpha=alpha, masgd_momentum=flags.masgd_momentum,
                     masgd_type=flags.masgd_type))
    if periodic:
        for f, t, b in synced_periods(inner):
            local = run.shard({"f": f, "t": t}, scan=True)
            opt_state, loss, _ = run.step(
                opt_state, to_device(local["f"], local["t"]), lr)
            reporter.update({"frames": torch.tensor(float(inner * b)),
                             "loss_sum": loss * (inner * b)})
    else:
        for f, t in batches():
            f, t = pad_to(f, t, n)
            local = run.shard({"f": f, "t": t})
            opt_state, loss, aux = run.step(
                opt_state, to_device(local["f"], local["t"]), lr)
            # aux is averaged over the ranks: scaled back to totals
            reporter.update({"frames": aux["frames"] * n,
                             "loss_sum": aux["loss_sum"] * n,
                             "accuracy": aux["accuracy"]})
    if wt in PS_MODES:
        with torch.no_grad():      # the server model is the product
            for k, p in params.items():
                p.copy_(run.model()[k])

    if ctx.rank == 0 and len(args) > 3 and not flags.cross_validate:
        net.save(args[3], model_states)
    logger.info("worker-type=%s over %d ranks (%s, backend %s) done", wt, n,
                dev.type, ctx.backend)
    return reporter.report() if ctx.rank == 0 else None


def nnet_train_server(argv) -> int:
    """Parameter-server role (reference: aslp-nnet-train-server.cc for
    easgd/asgd/masgd).  The port has no server process: each worker rank
    runs the server's part of its strategy."""
    parse_options(argv, [], "aslp-nnet-train-server", 0, None)
    print(
        "aslp-nnet-train-server: no separate server process in the port - "
        "each worker rank (one process a worker: torchrun, or the worker "
        "CLI's --num-workers) runs the server's part.\n"
        "  bsp/sod          -> the ranks' all-reduce of the gradients is the "
        "server (aslp-nnet-train-*-worker --worker-type=bsp|sod)\n"
        "  bmuf             -> the block sync runs on every worker rank "
        "(--worker-type=bmuf)\n"
        "  easgd/asgd/masgd -> every rank gathers the workers' models and "
        "runs the server's one-at-a-time sync loop in arrival order "
        "(--worker-type=easgd|asgd|masgd; parallel/ps.py)",
        file=sys.stderr,
    )
    return 0
