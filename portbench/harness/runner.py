"""One run of a cell: set-up, the launch-counter check, the window (or
the traced window and its profiled sub-window), then the check against
the reference, and the result line.

``run`` takes the cell as ``cells.resolve`` finds it and a device, so the
CPU tests drive everything but the card's look-up; ``report`` prints."""

from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from portbench.harness import compare, trace
from portbench.harness.training import sync

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "kaldi_aslp_tpu")


def forbidden_modules() -> List[str]:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def read_counter(spec: str) -> float:
    """``module:function.counter`` read from the function object the
    module holds now."""
    place, counter = spec.rsplit(".", 1)
    module, attr = place.split(":")
    return getattr(getattr(importlib.import_module(module), attr), counter)


def _entries(metrics: Dict[str, object]) -> Dict[str, List[str]]:
    out = {}
    for mod in metrics.values():
        entry = getattr(mod, "ENTRY", None)
        if entry:
            out[entry[0]] = list(entry[1])
    return out


def _power_limit() -> Optional[str]:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() \
        else None


def run(found: dict, seed: int, seconds: float, traced: bool, device: str,
        t_start: Optional[float] = None) -> dict:
    t_start = time.monotonic() if t_start is None else t_start
    cell, cfg = found["cell"], found["config"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t_imports = time.monotonic()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t_context = time.monotonic()
    expected = cell["kernels"]
    before = {k: read_counter(k) for k in expected}
    driver = found["driver"].Driver(cfg, cell, seed, dev)
    driver.setup()
    per_step = {k: (read_counter(k) - before[k]) / driver.warm_steps
                for k in expected}
    parts = dict(imports=t_imports - t_start, context=t_context - t_imports,
                 **driver.setup_parts)
    print(json.dumps({"launch_counters_per_step": per_step,
                      "warm_steps": driver.warm_steps,
                      "setup_parts_s": parts}), flush=True)
    if on_card:
        wrong = {k: v for k, v in per_step.items() if v != expected[k]}
        if wrong:
            raise RuntimeError(f"the cell's hand kernels did not run as "
                               f"stated: {wrong}, expected {expected}")
    setup_s = time.monotonic() - t_start

    units = found["units"]
    result: dict = {"correct": False, "attempted": 0, "failed": 0,
                    "metrics": {}, "device": {}}
    if not traced:
        stats = driver.window(seconds)
        values = dict(driver.end_to_end(stats), setup_s=setup_s)
        missing = set(found["end_to_end"]) - set(values)
        if missing:
            raise RuntimeError(f"the driver gave no {sorted(missing)}")
        values = {k: values[k] for k in found["end_to_end"]}
    else:
        stats = driver.traced_window(seconds)
        entries = trace.Entries(_entries(found["metrics"]))
        warm, run_, out = driver.profile_steps(cell["profile_steps"],
                                               entries)
        with entries:
            events = trace.profiled(run_, warm, lambda: sync(dev), on_card)
        profile = trace.reduce_profile(events, entries.calls)
        profile.update(out)
        records = {"cell": cell, "config": cfg, "window": stats,
                   "profile": profile}
        values = {}
        for name, mod in found["metrics"].items():
            v = mod.read(records)
            if v is not None:
                values[name] = v
        result["breakdown"] = trace.breakdown(profile)
        result["device"].update(busy_s=profile["busy_us"] / 1e6,
                                window_s=profile["window_us"] / 1e6)
        print(json.dumps({"profiled_steps": profile["steps"],
                          "kernels": len(profile["kernels"]),
                          "attributed_kernels":
                              profile["attributed_kernels"],
                          "entry_calls": len(entries.calls)}), flush=True)
    result["metrics"] = {k: {"value": v, "unit": units[k]}
                         for k, v in values.items()}
    result["attempted"], result["failed"] = stats["attempted"], \
        stats["failed"]
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if on_card else 0)}
    result["device"] = dict(device_info, **result["device"])
    if on_card:
        result["device"]["power_limit"] = _power_limit()

    driver.release()
    t_ref = time.monotonic()
    numbers = driver.numbers()
    result["reference_s"] = time.monotonic() - t_ref
    correct, checks = compare.judge(numbers, cell["check"]["limits"])
    result["correct"] = correct
    result["checks"] = {n: {"value": v if math.isfinite(v) else repr(v),
                            "limit": lim} for n, v, lim in checks}
    result["numbers"] = numbers
    return result


def report(result: dict) -> int:
    """Print the result (stdout's last line) and the compared numbers
    (stderr's last lines); 0 unless a forbidden module was loaded."""
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules were loaded: {bad}",
              file=sys.stderr)
        return 3
    numbers = result.pop("numbers")
    reference_s = result.pop("reference_s")
    checks = result.pop("checks")
    result["checks"] = checks
    line = json.dumps(result)
    print(json.dumps({"numbers": numbers, "reference_s": reference_s}),
          flush=True)
    print(line, flush=True)
    for name, c in checks.items():
        ok = isinstance(c["value"], float) and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    return 0
