"""Process groups: the ranks of ``torch.distributed`` in place of mesh
devices.

Port of kaldi_aslp_tpu/parallel/mesh.py (reference:
src/aslp-parallel/mpi-node.h:18 MpiNode, aslp_scripts/machine.conf).
The JAX package drives every device of a named ``Mesh`` from one
process; the port runs one process per worker, as the reference's MPI
does, and a mesh is a set of process groups, one an axis, over the
ranks laid out row-major in the axes' shape:

    mesh = make_mesh(("block", "data"), shape=(2, 2))
    # rank r is block r // 2, data index r % 2; mesh.group("data") holds
    # the two ranks of r's block, mesh.group("block") the rank of each
    # block with r's data index

``make_mesh`` registers each axis's group under its name, where
``BatchNormalization`` finds it (``axis_group``), as a JAX ``psum``
finds its axis in the surrounding ``shard_map``.  An axis of one rank
has no group (``None``) and its collectives are the identity; with one
rank and no process group at all, every axis is such an axis.

The backend is chosen from the topology before the group starts and is
logged (``choose_backend``): ``nccl`` when every rank has a card of its
own, else ``gloo`` (ranks sharing a card, or on the CPU; NCCL refuses
two ranks on one card).  gloo takes CUDA tensors for ``all_reduce`` and
``broadcast`` only, so the port's collectives use those two alone: a
gather of rows is an ``all_reduce`` of a zeroed buffer in which each rank
fills its own row.  Every group has a finite timeout: a stuck rendezvous
or collective raises."""

from __future__ import annotations

import dataclasses
import datetime
import gc
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("parallel")

# seconds a rendezvous or a collective may wait for the other ranks
DEFAULT_TIMEOUT_S = 60.0

_AXES: Dict[str, Optional[dist.ProcessGroup]] = {}


def choose_backend(device_type: str, world_size: int,
                   num_cards: int) -> str:
    """``nccl`` when the ranks are on CUDA and each has a card of its own
    (``world_size <= num_cards``), else ``gloo``.  Decided before the
    group starts, never after a failure."""
    if device_type == "cuda" and world_size <= num_cards:
        return "nccl"
    return "gloo"


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """A rank's device: card ``local_rank`` modulo the visible cards (ranks
    share cards round-robin), or the CPU."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    if device_type != "cpu":
        raise ValueError(f"unsupported device {device_type!r}")
    return torch.device("cpu")


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           device_type: str = "cuda",
                           backend: Optional[str] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the default process group (replaces MPI_Init); True if this
    call started it.  A no-op when a group is already up or at one rank,
    as JAX's (mesh.py:55-64).  Without arguments it reads torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_WORLD_SIZE`` (``MASTER_ADDR`` /
    ``MASTER_PORT`` through ``env://``)."""
    if dist.is_initialized():
        return False
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        cards = torch.cuda.device_count() if device_type == "cuda" else 0
        backend = choose_backend(device_type, local, cards)
    if rank == 0:
        logger.info("process group: %d ranks on %s, backend %s", world_size,
                    device_type, backend)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def shutdown_distributed() -> None:
    """Tear the process groups down (replaces MPI_Finalize): forget the
    registered axes, so that no reference keeps a sub-group alive past
    this call, destroy every group, and collect them now, while the
    interpreter is whole, rather than at its exit."""
    _AXES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def num_hosts() -> int:
    """The number of nodes: torchrun's ``GROUP_WORLD_SIZE`` (its node
    count), 1 without it (ranks spawned on this host).  JAX's counterpart
    is the process count, one process a host."""
    return int(os.environ.get("GROUP_WORLD_SIZE", 1))


def host_index() -> int:
    """This node's index: torchrun's ``GROUP_RANK``, 0 without it."""
    return int(os.environ.get("GROUP_RANK", 0))


def is_main_host() -> bool:
    """Equivalent of MpiNode::IsMainNode: rank 0 writes models."""
    return global_rank() == 0


@dataclasses.dataclass
class Mesh:
    """This rank's view of a mesh: the axes, their sizes, this rank's
    index along each and each axis's group (None for an axis of one
    rank)."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]

    def size(self, axes: Union[str, Sequence[str]]) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in axes:
            n *= self.shape[self.axis_names.index(a)]
        return n

    def index(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's row-major index over ``axes``: its shard of a batch
        split over them (JAX's ``P(("block", "data"))``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[self.axis_names.index(a)] + self.coords[a]
        return idx

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]


def make_mesh(axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh over every rank of the default group (or the one process
    without a group), default shape (W, 1, ...).  Every rank must call it
    with the same arguments: ``new_group`` is collective."""
    W = world_size()
    axis_names = tuple(axis_names)
    if shape is None:
        shape = (W,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if n != W:
        raise ValueError(f"mesh shape {shape} != {W} ranks")
    rank = global_rank()
    coords, rem = {}, rank
    for name, size in reversed(list(zip(axis_names, shape))):
        coords[name] = rem % size
        rem //= size
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for k, (name, size) in enumerate(zip(axis_names, shape)):
        if size == 1:
            groups[name] = None
        elif size == W:
            groups[name] = dist.group.WORLD
        else:
            groups[name] = _axis_subgroups(shape, k, rank)
    for name in axis_names:
        _AXES[name] = groups[name]
    return Mesh(axis_names, shape, coords, groups)


def _axis_subgroups(shape: Tuple[int, ...], k: int,
                    rank: int) -> dist.ProcessGroup:
    """Create the group along axis ``k`` through every line of the mesh
    (every rank creates every group, in the same order) and return the
    one that holds ``rank``."""
    W = 1
    for s in shape:
        W *= s
    stride = 1
    for s in shape[k + 1:]:
        stride *= s
    mine = None
    seen = set()
    for r in range(W):
        base = r - ((r // stride) % shape[k]) * stride
        if base in seen:
            continue
        seen.add(base)
        members = [base + i * stride for i in range(shape[k])]
        group = dist.new_group(members)
        if rank in members:
            mine = group
    return mine


def axis_group(name: str) -> Optional[dist.ProcessGroup]:
    """The group registered for axis ``name`` by the last ``make_mesh``
    that named it (None: the axis has one rank).  Raises ``KeyError``
    when no mesh named it."""
    if name not in _AXES:
        raise KeyError(name)
    return _AXES[name]


def group_size(group: Optional[dist.ProcessGroup]) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor,
                   group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (the identity at one rank)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_mean(t: torch.Tensor,
                    group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The mean of ``t`` over ``group`` in place: the sum, then divided by
    the group's size (JAX's ``pmean``)."""
    n = group_size(group)
    if n > 1:
        all_reduce_sum(t, group).div_(n)
    return t


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One buffer of every tensor's values, in order, in the dtype they
    all promote to (float32 for a net's parameters: exact)."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.cat([t.detach().reshape(-1).to(dtype) for t in tensors])


def unflatten(flat: torch.Tensor,
              like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Split ``flat`` into tensors shaped and typed as ``like``."""
    out, off = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[off:off + n].view(t.shape).to(t.dtype))
        off += n
    return out


def gather_rows(row: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """[size(axis), *row.shape]: every rank's ``row`` along ``axis``, by
    an all-reduce of a zeroed buffer in which this rank fills its own row
    (gloo has no all-gather of CUDA tensors; adding zeros keeps each row's
    bits)."""
    n = mesh.size(axis)
    buf = torch.zeros((n,) + tuple(row.shape), dtype=row.dtype,
                      device=row.device)
    buf[mesh.coords[axis]] = row
    return all_reduce_sum(buf, mesh.group(axis))


def shard_batch(batch: Any, mesh: Mesh,
                axes: Union[str, Sequence[str]] = "data",
                dim: int = 0) -> Any:
    """This rank's rows [i·B/n, (i+1)·B/n) of every tensor or array of
    ``batch`` (or a dict, list or tuple of them) along ``dim``, ``i`` its
    index over ``axes``, as JAX's ``NamedSharding(P(axes))`` places them
    (``dim=1``: ``P(None, axes)``, a stack of minibatches)."""
    n, i = mesh.size(axes), mesh.index(axes)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        B = x.shape[dim]
        if B % n:
            raise ValueError(f"batch of {B} rows does not split over {n} "
                             "ranks")
        return x[(slice(None),) * dim + (slice(i * B // n,
                                               (i + 1) * B // n),)]

    return take(batch)
