"""The comparison that decides ``correct``: each number the program's
run gives against the reference's, beside the limit the cell's file
sets for it.

Training: each step's loss and the frames it averaged over (the largest
relative gap over the steps; the frames exactly), and by the worst leaf
the gap between the program's and the reference's norm of the first
gradient and of the parameters' change over the steps, each over the
larger of the reference's norm of that leaf and of the median leaf.  A leaf
whose first reference gradient is under a thousandth of the median
leaf's moves by round-off alone and is left out of the change.
Scores: the largest absolute gap over every compared valid frame."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

import torch

# a leaf's first gradient under this share of the median leaf's is
# nought to rounding, and its change is left out
STILL_LEAF = 1e-3

Check = Tuple[str, float, float]


def loss_gap(program: List[float], reference: List[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program, reference))


def norm_gap(program: Dict[str, torch.Tensor],
             reference: Dict[str, torch.Tensor],
             leaves: Optional[List[str]] = None) -> float:
    """max over leaves of | |p| - |r| | / max(|r|, median leaf |r|)."""
    names = leaves if leaves is not None else list(reference)
    ref = {k: float(reference[k].double().norm()) for k in reference}
    median = statistics.median(ref.values())
    worst = 0.0
    for k in names:
        gap = abs(float(program[k].double().norm()) - ref[k])
        worst = max(worst, gap / max(ref[k], median, 1e-30))
    return worst


def moving_leaves(first_grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: float(g.double().norm()) for k, g in first_grads.items()}
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= STILL_LEAF * median]


def training_numbers(program: dict, reference: dict, params0: dict) -> dict:
    """The training numbers of ``program`` against ``reference``, each a
    dict of losses, frames, first_grads and params; ``params0`` the
    weights both started from."""
    change = {k: program["params"][k] - params0[k] for k in params0}
    ref_change = {k: reference["params"][k] - params0[k] for k in params0}
    return {"loss_gap": loss_gap(program["losses"], reference["losses"]),
           "frames_gap": loss_gap(program["frames"], reference["frames"]),
           "grad_norm_gap": norm_gap(program["first_grads"],
                                     reference["first_grads"]),
           "change_norm_gap": norm_gap(change, ref_change,
                                       moving_leaves(
                                           reference["first_grads"]))}


def score_gap(program: torch.Tensor, reference: torch.Tensor,
              mask: torch.Tensor) -> float:
    valid = mask > 0
    return float((program - reference).abs()[valid].max())


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[Check]]:
    """(correct, [(name, number, limit)]): correct when every limited
    number is finite and within its limit, and none is missing."""
    checks = [(name, float(numbers.get(name, math.nan)), float(limit))
              for name, limit in limits.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    return ok, checks
