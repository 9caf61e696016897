"""A configuration's weights, drawn on the device from the seed.

Two large draws make every leaf: one uniform draw for the recurrent
layers' parameters (+-param_scale, as kaldi-aslp's LSTMP init draws
them) and one normal draw for the output layer's weights (stddev
out_param_stddev); the output bias is zero.  The leaves and their order
come from the configuration's reference, so the program and the
reference get the same numbers under the same names."""

from __future__ import annotations

import importlib
from typing import Dict

import torch


def reference(cfg: dict):
    """The module ``portbench.reference.<configuration name>``."""
    return importlib.import_module(f"portbench.reference.{cfg['name']}")


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % 2 ** 64)


def draw(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{leaf name: float32 tensor on ``device``} for ``seed``."""
    leaves = reference(cfg).leaves(cfg)
    g = generator(seed, device)
    sizes = {kind: sum(int(torch.Size(s).numel()) for _, s, k in leaves
                       if k == kind) for kind in ("uniform", "normal")}
    scale = cfg["param_scale"]
    flat = {
        "uniform": torch.rand(sizes["uniform"], generator=g, device=device)
        * (2.0 * scale) - scale,
        "normal": torch.randn(sizes["normal"], generator=g, device=device)
        * cfg["out_param_stddev"],
    }
    offset = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, kind in leaves:
        n = int(torch.Size(shape).numel())
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = flat[kind][offset[kind]:offset[kind] + n].view(shape)
            offset[kind] += n
    return out
