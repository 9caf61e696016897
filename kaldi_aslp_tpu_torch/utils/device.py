"""Device selection for the port's entry points.

Every entry point takes an explicit device.  Asking for CUDA on a machine
without it raises; nothing drops to the CPU behind the caller's back."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """Return ``torch.device(device)`` after checking it can be used.

    For CUDA this also keeps float32 products in full float32: the JAX
    reference computes the inference path in float32 end to end, and
    TF32 keeps about three decimal digits."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
