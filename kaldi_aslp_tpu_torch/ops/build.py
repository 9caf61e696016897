"""Build the port's CUDA sources into shared libraries, load them, and
check what their wrappers pass them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``kaldi_aslp_tpu_torch/_build/``
at first use, then loaded with ``ctypes``.  The library name carries a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header is rebuilt and a stale library is never
loaded.  ``nvcc``'s own output (``-Xptxas -v``:
registers, shared memory, spills per kernel) is kept beside the library
in a ``.log`` file.

``load_library.builds`` and ``load_library.loads`` count the ``nvcc`` runs
and the libraries loaded in this process, ``load_library.seconds`` the
seconds both took: what a process pays for its kernels' libraries before
its first launch."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of kaldi_aslp_tpu_torch are "
            "built from csrc/ at first use and need the CUDA toolkit")
    return nvcc


def library_path(source_name: str) -> Path:
    """Where ``csrc/<source_name>`` is built: named by a hash of the
    source bytes, the shared headers and the compiler flags."""
    src = CSRC_DIR / source_name
    headers = b"".join(h.read_bytes()
                       for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def load_library(source_name: str) -> ctypes.CDLL:
    """Compile ``csrc/<source_name>`` if its library is missing, and load
    it (once per process)."""
    lib = _LOADED.get(source_name)
    if lib is not None:
        return lib
    t0 = time.perf_counter()
    try:
        lib = _build_and_load(source_name)
    finally:
        load_library.seconds += time.perf_counter() - t0
    _LOADED[source_name] = lib
    return lib


load_library.builds = 0
load_library.loads = 0
load_library.seconds = 0.0


def _build_and_load(source_name: str) -> ctypes.CDLL:
    so = library_path(source_name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               str(CSRC_DIR / source_name)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed on {source_name} (exit {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}")
        os.replace(tmp, so)
        load_library.builds += 1
    lib = ctypes.CDLL(str(so))
    load_library.loads += 1
    return lib


def check_tensors(device: torch.device,
                  tensors: Dict[str, Tuple[torch.Tensor, tuple, torch.dtype]]
                  ) -> None:
    """Raise unless every named tensor has its shape and dtype, lies on
    ``device`` and is contiguous: a kernel reads raw pointers."""
    for name, (t, shape, dtype) in tensors.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# the stream's handle without a torch.cuda.Stream object around it, which
# costs a short kernel's launch to build; absent from some builds
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, for a C entry."""
    if _RAW_STREAM is not None and device.index is not None:
        return _RAW_STREAM(device.index)
    return torch.cuda.current_stream(device).cuda_stream
