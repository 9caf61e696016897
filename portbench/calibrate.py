"""Readings that a cell's limits are set from, on the card at the cell's
own size (the benchmark's runs do not run this).

    python3 portbench/calibrate.py --workload <cell> --seeds <n> ... \
        [--control <k>] [--seconds <s>]

For every seed, a sound run of the program: the set-up with the first
steps (or, for answers checked one by one, a short window at the cell's
own load), then its numbers against the float32 reference.  For the
first ``--control`` seeds also the control, the reference computed in
the configuration's control precision and put in the program's place,
and, for a training cell, the planted fault of a step that leaves half
of its batch out and takes the mean over the rest.  One JSON line a
reading on standard output."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def training_readings(driver, control: bool) -> list:
    from portbench.harness import compare

    cfg = driver.cfg
    driver.setup()
    driver.release()
    t0 = time.monotonic()
    ref = driver.reference_run()
    out = [("program", compare.training_numbers(driver.result, ref,
                                                 driver.weights),
            time.monotonic() - t0)]
    if control:
        t0 = time.monotonic()
        ctl = driver.reference_run(precision=cfg["control_precision"])
        out.append(("control", compare.training_numbers(ctl, ref,
                                                        driver.weights),
                    time.monotonic() - t0))
        half = driver.cell["traffic_params"]["streams"] // 2
        t0 = time.monotonic()
        fault = driver.reference_run(keep_streams=half)
        out.append(("half_batch", compare.training_numbers(
            fault, ref, driver.weights), time.monotonic() - t0))
    return out


def answer_readings(driver, control: bool, seconds: float) -> list:
    from portbench.harness import compare

    driver.setup()
    driver.window(seconds)
    driver.release()
    t0 = time.monotonic()
    out = [("program", driver.numbers(), time.monotonic() - t0)]
    if control:
        t0 = time.monotonic()
        gaps = []
        for k in sorted({i % len(driver.items) for i in driver.kept}):
            item = driver.items[k]
            ref = driver.reference_scores(item)
            ctl = driver.reference_scores(item,
                                          driver.cfg["control_precision"])
            mask = ref.new_tensor(item["mask"])
            gaps.append(compare.score_gap(ctl, ref, mask))
        out.append(("control", {"score_gap": max(gaps)},
                    time.monotonic() - t0))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from portbench.harness import cells

    found = cells.resolve(args.workload)
    device = torch.device(args.device)
    for n, seed in enumerate(args.seeds):
        driver = found["driver"].Driver(found["config"], found["cell"], seed,
                                        device)
        control = n < args.control
        if hasattr(driver, "reference_run"):
            readings = training_readings(driver, control)
        else:
            readings = answer_readings(driver, control, args.seconds)
        for kind, numbers, seconds in readings:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, "numbers": numbers,
                              "reference_s": seconds}), flush=True)
        del driver
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
