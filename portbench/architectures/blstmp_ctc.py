"""The ``blstmp_ctc`` architecture: a stack of the port's
``BLstmProjectedStreams`` layers and an ``AffineTransform`` output layer,
as its builder (models/flagship.py) lays it out, and the model FLOPs of
a frame through it.

A configuration names its architecture; the harness finds this module
by that name (``portbench/architectures/<architecture>.py``), so a new
architecture is a new file here."""

from __future__ import annotations

from typing import Dict

import torch

from kaldi_aslp_tpu_torch.models import (
    AffineTransform,
    BLstmProjectedStreams,
    Nnet,
)

DIRECTIONS = 2


def port_name(cfg: dict, leaf: str) -> str:
    """The port's parameter name of a reference leaf: layer l is node l,
    the output layer the node after the last recurrent one."""
    if leaf.startswith("layers."):
        return "nodes." + leaf[len("layers."):]
    return f"nodes.{cfg['num_layers']}." + leaf[len("out."):]


def build(cfg: dict, weights: Dict[str, torch.Tensor], device) -> Nnet:
    """The configuration's network on ``device`` holding ``weights``
    (reference leaf names)."""
    net = Nnet()
    dim = cfg["input_dim"]
    for _ in range(cfg["num_layers"]):
        net.add(BLstmProjectedStreams(dim, DIRECTIONS * cfg["proj_dim"],
                                      cell_dim=cfg["cell_dim"],
                                      cell_clip=cfg["cell_clip"],
                                      bf16=cfg["dtype"] == "bfloat16"))
        dim = DIRECTIONS * cfg["proj_dim"]
    net.add(AffineTransform(dim, cfg["num_targets"],
                            param_stddev=cfg["out_param_stddev"],
                            bias_mean=0.0, bias_range=0.0))
    net.to(device)
    params = dict(net.named_parameters())
    if set(params) != {port_name(cfg, k) for k in weights}:
        raise ValueError("the port's parameters and the reference's leaves "
                         "differ")
    with torch.no_grad():
        for leaf, w in weights.items():
            params[port_name(cfg, leaf)].copy_(w)
    return net


def forward_flops_per_frame(cfg: dict) -> int:
    """Forward matrix-product FLOPs of one frame (two a multiply-add): per
    layer and direction the input, recurrent and projection products,
    then the output layer's."""
    C, P = cfg["cell_dim"], cfg["proj_dim"]
    total, dim = 0, cfg["input_dim"]
    for _ in range(cfg["num_layers"]):
        total += DIRECTIONS * 2 * (dim * 4 * C + P * 4 * C + C * P)
        dim = DIRECTIONS * P
    return total + 2 * dim * cfg["num_targets"]
