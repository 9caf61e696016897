"""The general traffic generator: a cell's ``traffic_params`` turned into
the host arrays that the program and the reference both get.

``kind`` names the shape of the inputs, a module
``portbench/generators/<kind>.py`` found by that name; everything else
in ``traffic_params`` is data that module reads.  Lengths are a fixed
grid over the stated range, the same for every seed: a seed changes what
the frames and labels hold, never how much work a cycle of inputs
holds."""

from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np

from portbench.harness.cells import check_name

Item = Dict[str, np.ndarray]


def length_grid(n: int, lo: int, hi: int) -> np.ndarray:
    """``n`` lengths spread evenly over [lo, hi]: the midpoints of n
    equal slices of the uniform distribution, rounded down."""
    i = np.arange(n)
    return lo + ((hi - lo + 1) * (i + 0.5) / n).astype(np.int64)


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def generate(p: dict, seed: int, feat_dim: int,
             num_targets: int) -> List[Item]:
    """The cell's inputs for ``seed``: the generator ``p["kind"]``
    names, drawn from ``np.random.default_rng(seed)``."""
    module = importlib.import_module(
        f"portbench.generators.{check_name(p['kind'])}")
    return module.generate(p, np.random.default_rng(seed), feat_dim,
                           num_targets)


def valid_frames(item: Item) -> int:
    return int(item["mask"].sum())
