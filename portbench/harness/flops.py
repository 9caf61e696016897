"""Operations and the least time they take: the model FLOPs of a frame
(from the configuration's architecture module; training counts the
forward three times, for the forward and the backward's two products a
weight) and a roofline share over a configuration's peaks."""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

from portbench.harness import model


def forward_flops_per_frame(cfg: dict) -> int:
    return model.architecture(cfg).forward_flops_per_frame(cfg)


def train_flops_per_frame(cfg: dict) -> int:
    return 3 * forward_flops_per_frame(cfg)


def least_seconds(flops: float, nbytes: float, cfg: dict) -> float:
    """The larger of the operations over the peak rate of the
    configuration's dtype and the bytes over the memory rate."""
    return max(flops / cfg["peak_flops_per_s"],
               nbytes / cfg["peak_hbm_bytes_per_s"])


def roofline_pct(calls: Iterable[Tuple[float, float]], device_us: float,
                 cfg: dict) -> Optional[float]:
    """100 x the least time of ``calls`` ((flops, bytes) each) over the
    device time their kernels took; None where nothing was timed."""
    if device_us <= 0:
        return None
    least = sum(least_seconds(f, b, cfg) for f, b in calls)
    return 100.0 * least / (device_us / 1e6)


def mfu_pct(flops_per_frame: float, frames: float, seconds: float,
            cfg: dict) -> Optional[float]:
    if seconds <= 0 or frames <= 0:
        return None
    return 100.0 * flops_per_frame * frames / seconds \
        / cfg["peak_flops_per_s"]


def entry_roofline(records: dict, entry: str, config: dict,
                   work: Callable[[dict], Tuple[float, float]]
                   ) -> Optional[float]:
    """The roofline share of the C entry ``entry`` over the profiled
    sub-window's calls of it: ``work(call)`` gives a call's (FLOPs,
    bytes); None where the entry ran no attributed kernel."""
    calls = [c for c in records["profile"]["entries"] if c["entry"] == entry]
    us = sum(c["device_us"] for c in calls)
    if not calls or us <= 0:
        return None
    return roofline_pct([work(c) for c in calls], us, config)
