"""HTK feature-file I/O (reference: src/matrix/kaldi-matrix.cc ReadHtk/
WriteHtk, HtkHeader at src/matrix/kaldi-matrix.h:859).

The port's own copy of kaldi_aslp_tpu/io/htk.py (numpy only), for the
HTK fixtures of the reference (src/feat/test_data/test.wav.*_htk.*)."""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Tuple

import numpy as np

_HTK_HAS_CRC = 0o10000  # parmKind "K" qualifier
_HTK_COMPRESSED = 0o2000  # parmKind "C" qualifier


@dataclasses.dataclass
class HtkHeader:
    num_samples: int
    sample_period: int  # in 100 ns units
    sample_size: int    # bytes per sample
    sample_kind: int


def read_htk(path_or_file) -> Tuple[np.ndarray, HtkHeader]:
    """Read an HTK feature file → ([T, D] float32, header)."""
    if hasattr(path_or_file, "read"):
        return _read_htk_stream(path_or_file)
    with open(path_or_file, "rb") as f:
        return _read_htk_stream(f)


def _read_htk_stream(f: BinaryIO) -> Tuple[np.ndarray, HtkHeader]:
    raw = f.read(12)
    if len(raw) != 12:
        raise ValueError("truncated HTK header")
    n, period, size, kind = struct.unpack(">iihH", raw)
    if kind & (_HTK_COMPRESSED | _HTK_HAS_CRC):
        raise NotImplementedError("compressed/CRC HTK files not supported")
    if size % 4 != 0:
        raise ValueError(f"HTK sample size {size} not float-aligned")
    dim = size // 4
    data = np.frombuffer(f.read(n * size), dtype=">f4").astype(np.float32)
    if data.size != n * dim:
        raise ValueError("truncated HTK data")
    return data.reshape(n, dim), HtkHeader(n, period, size, kind)


def write_htk(path_or_file, feats: np.ndarray,
              sample_period: int = 100000, sample_kind: int = 9) -> None:
    """Write [T, D] float features as an HTK file (default kind USER)."""
    feats = np.asarray(feats, np.float32)
    header = struct.pack(
        ">iihH", feats.shape[0], sample_period, 4 * feats.shape[1],
        sample_kind,
    )
    if hasattr(path_or_file, "write"):
        path_or_file.write(header)
        path_or_file.write(feats.astype(">f4").tobytes())
    else:
        with open(path_or_file, "wb") as f:
            f.write(header)
            f.write(feats.astype(">f4").tobytes())
