"""Cells cut to a size the CPU runs in seconds, for the tests: the same
files, drivers and checks, with narrow widths and short inputs."""

from __future__ import annotations

import copy

from portbench.harness import cells

# the flagship's output weights drawn wider: at these widths its scores
# would lie so near uniform that no rounding would show in them
WIDTHS = {"blstm_ctc": {"cell_dim": 32, "proj_dim": 16, "num_targets": 12,
                        "input_dim": 40, "num_layers": 2,
                        "out_param_stddev": 1.0}}
TRAFFIC = {"utterance_batches": {"streams": 4, "length_min": 24,
                                 "length_max": 40, "pad_time_to": 8,
                                 "batches": 3}}


def found(name: str, **cell_changes) -> dict:
    """``cells.resolve(name)`` with the configuration's widths and the
    traffic's sizes cut, and ``cell_changes`` applied to the cell."""
    out = cells.resolve(name)
    cfg = dict(out["config"], **WIDTHS[out["config"]["name"]])
    cell = copy.deepcopy(out["cell"])
    p = cell["traffic_params"]
    p.update(TRAFFIC[p["kind"]])
    if "sample_from" in cell["check"]:
        # answers are checked from the first few calls of a short window
        cell["check"].update(sample_from=6, sample_calls=3)
    cell.update(cell_changes)
    return dict(out, config=cfg, cell=cell)
