"""The benchmark of kaldi_aslp_tpu_torch on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json on the card(s) of this machine, from the
root of a checkout: set-up (imports, CUDA context, the kernels' libraries,
weights and inputs from the seed, the first steps), a check of the
kernels' launch counters, a window of ``--seconds``, then the check of
what the window's path produced against the plain reference.  The last
line of standard output is one JSON object (correct, attempted, failed,
metrics, device, [breakdown], checks); the last lines of standard error
name each compared number beside its limit.

--trace 0 reports the cell's end-to-end metrics; --trace 1 drives the
window through the parts of a step with CUDA events between them,
profiles a short sub-window after it, and reports the cell's per-layer
metrics instead.  Without a CUDA card, or with fewer cards than the cell
asks for, it exits 2 and prints no result."""

from __future__ import annotations

import ctypes
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# kernel caches inside the checkout, at fixed paths, before torch loads
CACHE = ROOT / ".portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def fix_host_allocator() -> None:
    """glibc's mmap threshold held at its default, 128 KiB, with its
    dynamic raise off (``mallopt(M_MMAP_THRESHOLD)``, this process only):
    every large host buffer the program allocates, such as the scores
    copied back each call, is then fresh memory in every run.  Left
    dynamic, whether such a buffer is fresh or reused depends on the
    process's own history, and the rate of a cell that copies to the
    host swings between runs."""
    mallopt = getattr(ctypes.CDLL(None), "mallopt", None)
    if mallopt is not None:
        mallopt(-3, 128 * 1024)  # M_MMAP_THRESHOLD


def process_start() -> float:
    """The process's start on the ``time.monotonic`` clock (Linux counts
    it in clock ticks since boot, as CLOCK_BOOTTIME does)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    since = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    return time.monotonic() - since


def main(argv=None) -> int:
    t_start = process_start()
    fix_host_allocator()
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from portbench.harness import cells, runner

    found = cells.resolve(args.workload)
    chips = found["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    return runner.report(runner.run(found, args.seed, args.seconds,
                                    bool(args.trace), "cuda",
                                    t_start=t_start))


if __name__ == "__main__":
    sys.exit(main())
