"""Start a local process group: one spawned process a rank.

The JAX package has no counterpart: its workers are the devices of one
process.  The port's CLI, ``entry.dryrun_multichip`` and the convergence
runs start ``n`` ranks on this host with ``torch.multiprocessing``
(``spawn``) and a ``file://`` rendezvous in a temporary directory, which
cannot clash with another group's port.  Each rank gets an explicit
device (``mesh.rank_device``), torch at ``threads`` threads, and runs
``fn(ctx, *args)``; what rank ``r``'s ``fn`` returns comes back as the
r-th entry of the list.  Once every rank's ``fn`` has returned, each
passes a barrier and tears its groups down (``mesh.shutdown_distributed``)
before it writes its result and exits.  A rank that raises, dies or outlives
``run_timeout_s`` fails the whole run: the others are stopped and the
error is raised here.  ``fn`` must be importable by name (a function of
a module of this package), since a spawned process starts from a fresh
import."""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from kaldi_aslp_tpu_torch.parallel.mesh import (
    DEFAULT_TIMEOUT_S,
    choose_backend,
    initialize_distributed,
    logger,
    rank_device,
    shutdown_distributed,
)
from kaldi_aslp_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class RankContext:
    rank: int
    world_size: int
    device: torch.device
    backend: str

    def generator(self, seed: int) -> torch.Generator:
        """A generator on this rank's device seeded ``seed`` (the same on
        every rank unless the caller adds the rank)."""
        return torch.Generator(self.device).manual_seed(seed)


def current_context(device_type: str) -> RankContext:
    """The context of a process inside a group that is already up (a
    torchrun rank, or a rank of ``spawn``), or of the one process."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = int(os.environ.get("LOCAL_RANK", rank))
    backend = dist.get_backend() if dist.is_initialized() else "none"
    return RankContext(rank, world, rank_device(device_type, local),
                       backend)


def _rank_main(rank: int, world_size: int, init_file: str, backend: str,
               device_type: str, threads: Optional[int], timeout_s: float,
               fn: Callable, args: Sequence[Any], out_dir: str) -> None:
    if threads:
        torch.set_num_threads(threads)
    device = resolve_device(rank_device(device_type, rank))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_distributed(f"file://{init_file}", world_size, rank,
                           device_type, backend, timeout_s)
    try:
        result = fn(RankContext(rank, world_size, device, backend), *args)
        # no rank tears its groups down while another still talks to it
        dist.barrier()
    finally:
        shutdown_distributed()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(fn: Callable, world_size: int, args: Sequence[Any] = (),
          device_type: str = "cuda", threads: Optional[int] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S,
          run_timeout_s: Optional[float] = None) -> List[Any]:
    """Run ``fn(ctx, *args)`` on ``world_size`` spawned ranks in one
    process group on ``device_type`` (the card unless the caller asks for
    ``"cpu"``); returns each rank's result, by rank.  ``timeout_s``
    bounds the rendezvous and every collective, ``run_timeout_s`` (None:
    no bound) the whole run."""
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda" and cards == 0:
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    backend = choose_backend(device_type, world_size, cards)
    logger.info("spawning %d ranks on %s (%d cards): backend %s",
                world_size, device_type, cards, backend)
    tmp = tempfile.mkdtemp(prefix="kaldi_aslp_pg_")
    try:
        ctx = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(world_size, os.path.join(tmp, "rendezvous"), backend,
                  device_type, threads, timeout_s, fn, tuple(args), tmp))
        deadline = (None if run_timeout_s is None
                    else time.monotonic() + run_timeout_s)
        try:
            while not ctx.join(timeout=0.5):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world_size} ranks of {fn.__name__} still running "
                        f"after {run_timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
