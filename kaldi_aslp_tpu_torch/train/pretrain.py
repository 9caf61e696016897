"""Layer-wise discriminative pretraining.

Port of kaldi_aslp_tpu/train/pretrain.py:26-136 (reference:
aslp_scripts/aslp_nnet/pretrain.sh: grow the net one hidden layer per
epoch via ``aslp-nnet-init hidden.conf - | aslp-nnet-insert``; component
insertion + next-affine re-randomization in
src/aslp-nnetbin/aslp-nnet-insert.cc:14-49 ``InsertComponents`` /
``IndexOfLastUpdatableComponent`` and the ``--randomize-next-component``
block at :125-155, stddev = stddev_factor / sqrt(input_dim)).

The port's components own their parameters, so a net and its
parameters are one object: ``insert_components`` returns a new ``Nnet``
of copied components (its inputs are left as they were), and the draws
come from a ``torch.Generator`` where the JAX module splits a key."""

from __future__ import annotations

import copy
import math
from typing import Callable, Optional

import torch

from kaldi_aslp_tpu_torch.models.nnet import Nnet


def last_updatable_index(net: Nnet) -> int:
    """Index of the last updatable component (reference:
    aslp-nnet-insert.cc:14 IndexOfLastUpdatableComponent)."""
    idx = -1
    for i, comp in enumerate(net.nodes):
        if getattr(comp, "updatable", False):
            idx = i
    return idx


def _require_chain(net: Nnet, what: str) -> None:
    for i, edges in enumerate(net.node_inputs):
        want = [("in:0", 0)] if i == 0 else [(i - 1, 0)]
        if [tuple(e) for e in edges] != want:
            raise ValueError(
                f"{what} is not a simple chain (MIMO/branching graph)")


def insert_components(
    base: Nnet,
    ins: Nnet,
    insert_at: int = -1,
    randomize_next: bool = True,
    stddev_factor: float = 0.1,
    generator: Optional[torch.Generator] = None,
) -> Nnet:
    """Insert ``ins``'s chain into ``base`` before component
    ``insert_at`` (< 0: before the last updatable component, the
    pretrain.sh growth position) and optionally re-randomize the next
    affine from ``generator`` (seeded 0 when None).

    Returns a new net of copies; ``base`` and ``ins`` are not changed."""
    _require_chain(base, "base net")
    _require_chain(ins, "insert net")
    if insert_at < 0:
        insert_at = last_updatable_index(base)
        if insert_at < 0:
            raise ValueError("base net has no updatable component")
    if not 0 <= insert_at <= len(base.nodes):
        raise ValueError(f"bad insert position {insert_at}")

    out = Nnet()
    for comp in (list(base.nodes[:insert_at]) + list(ins.nodes)
                 + list(base.nodes[insert_at:])):
        out.add(copy.deepcopy(comp))

    if randomize_next:
        comp = out.nodes[insert_at + len(ins.nodes)]
        names = dict(comp.named_parameters())
        if not (getattr(comp, "updatable", False)
                and "w" in names and "b" in names):
            raise ValueError(
                "--randomize-next-component: component after the insert "
                f"is not an updatable affine: {type(comp).__name__}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        stddev = stddev_factor / math.sqrt(comp.w.shape[1])
        with torch.no_grad():
            for p in (comp.w, comp.b):
                p.copy_(stddev * torch.randn(p.shape, generator=generator,
                                             dtype=p.dtype))
    return out


def pretrain_layerwise(
    initial_net: Nnet,
    hidden_factory: Callable[[int], Nnet],
    num_hid: int,
    train_fn: Callable[[Nnet, int], Nnet],
    generator: Optional[torch.Generator] = None,
    stddev_factor: float = 0.1,
) -> Nnet:
    """Grow-and-train loop of pretrain.sh:56-86.

    ``initial_net``: the 1-hidden-layer proto net (nnet.proto role),
    drawn here.  ``hidden_factory(depth)``: a fresh hidden block to
    splice in before the output layer when growing to ``depth`` hidden
    layers (the hidden.conf role; called with depth = 2..num_hid).
    ``train_fn(net, depth) -> net``: one pretrain epoch at a fixed learn
    rate (the script's inner ``$train_tool`` loop); it may move the net
    to a device.  Returns the full-depth net."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    net = initial_net
    net.reset_parameters(generator)
    net = train_fn(net, 1)
    for depth in range(2, num_hid + 1):
        hidden = hidden_factory(depth)
        hidden.reset_parameters(generator)
        net = insert_components(net, hidden.to(next(net.parameters()).device),
                                insert_at=-1, randomize_next=True,
                                stddev_factor=stddev_factor,
                                generator=generator)
        net = train_fn(net, depth)
    return net
