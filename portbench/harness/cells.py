"""Find a cell's files by name: its workload file, its configuration,
its driver and the per-layer metrics that ``BENCHMARK.json`` gives it.

A cell, configuration, driver or metric that a later change adds is a
new file and a new entry in ``BENCHMARK.json``; nothing in this module
names one.  ``BENCHMARK.json`` alone says which metrics a cell reports
and each metric's unit: a metric's file holds only its reader."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    """``name`` if it is a benchmark name (letters, digits, _ . -, at
    most 64, not starting with . or -), else ValueError: names become
    file names, so none may climb out of its folder."""
    if not NAME.match(name) or ".." in name:
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_benchmark(root: Optional[Path] = None) -> dict:
    return json.loads(((root or ROOT) / "BENCHMARK.json").read_text())


def load_cell(name: str, bench_dir: Optional[Path] = None) -> dict:
    path = (bench_dir or BENCH_DIR) / "workloads" / f"{check_name(name)}.json"
    cell = json.loads(path.read_text())
    if cell["name"] != name:
        raise ValueError(f"{path} names itself {cell['name']!r}")
    return cell


def load_config(name: str, bench_dir: Optional[Path] = None) -> dict:
    path = (bench_dir or BENCH_DIR) / "configs" / f"{check_name(name)}.json"
    cfg = json.loads(path.read_text())
    if cfg["name"] != name:
        raise ValueError(f"{path} names itself {cfg['name']!r}")
    return cfg


def load_driver(name: str) -> ModuleType:
    return importlib.import_module(f"portbench.drivers.{check_name(name)}")


def load_metric(name: str, bench_dir: Optional[Path] = None) -> ModuleType:
    """The module of ``metrics/<name>.py`` (a metric's name may hold
    dots, so it is loaded from its path)."""
    path = (bench_dir or BENCH_DIR) / "metrics" / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "__").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def end_to_end(bench: dict, cell: str) -> List[dict]:
    """The end-to-end metrics ``cell`` reports: those that list it, and
    those that list no cells."""
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics read in ``cell``'s traced run: those that
    list it, and those without a list that move an end-to-end metric the
    cell reports."""
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in reported)]


def resolve(cell_name: str, root: Optional[Path] = None) -> Dict[str, object]:
    """Everything a run of ``cell_name`` needs, found by name."""
    root = root or ROOT
    bench_dir = root / "portbench"
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == cell_name),
                 None)
    if entry is None:
        raise ValueError(f"BENCHMARK.json has no cell {cell_name!r}")
    cell = load_cell(cell_name, bench_dir)
    if cell["config"] != entry["config"] or cell["chips"] != entry["chips"]:
        raise ValueError(f"{cell_name}: its file and BENCHMARK.json differ")
    metrics = {m["name"]: load_metric(m["name"], bench_dir)
               for m in per_layer(bench, cell_name)}
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    return {"bench": bench, "cell": cell, "units": units,
            "config": load_config(cell["config"], bench_dir),
            "driver": load_driver(cell["driver"]),
            "end_to_end": [m["name"] for m in end_to_end(bench, cell_name)],
            "metrics": metrics}
