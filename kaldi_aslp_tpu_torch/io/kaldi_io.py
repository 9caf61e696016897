"""Kaldi binary/text object I/O.

Copy of kaldi_aslp_tpu/io/kaldi_io.py (reference: src/base/io-funcs.h,
src/matrix/kaldi-matrix.cc Matrix::Read/Write,
src/matrix/compressed-matrix.cc, src/matrix/kaldi-vector.cc
Vector::Read/Write, src/hmm/posterior.cc WritePosterior).  That module
imports only numpy, but its package's ``__init__`` pulls in the lattice
I/O and through it JAX, so the port keeps its own copy.
tests/test_torch_train.py and tests/test_torch_io_rest.py hold the copy
to the JAX package's bytes both ways.

Formats:
  - binary stream marker: b"\\0B"
  - token: ASCII token + b" "
  - basic type: size byte (4 or 8) + raw little-endian value
  - float matrix "FM " / "DM ": int32 rows, int32 cols, row-major data
  - compressed matrix "CM "/"CM2 "/"CM3 " (read only)
  - float vector "FV " / "DV ": int32 size, then the data
  - posterior: nested int32/float basic types
  - integer vector: size byte 4, int32 n, raw int32 data
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List, Tuple

import numpy as np

BINARY_MARKER = b"\x00B"


class KaldiIOError(IOError):
    pass


def read_token(f: BinaryIO) -> str:
    """Read a whitespace-terminated token (reference: io-funcs.cc ReadToken)."""
    chars = []
    while True:
        c = f.read(1)
        if not c:
            if chars:
                break
            raise KaldiIOError("EOF while reading token")
        if c in b" \t\n\r":
            if chars:
                break
            continue  # skip leading whitespace
        chars.append(c)
    return b"".join(chars).decode("utf-8")


def write_token(f: BinaryIO, token: str) -> None:
    f.write(token.encode("utf-8") + b" ")


def expect_token(f: BinaryIO, token: str) -> None:
    got = read_token(f)
    if got != token:
        raise KaldiIOError(f"expected token {token!r}, got {got!r}")


def peek_binary_marker(f: BinaryIO) -> bool:
    """Consume b"\\0B" if present; return whether the stream is binary."""
    pos = f.tell()
    if f.read(2) == BINARY_MARKER:
        return True
    f.seek(pos)
    return False


def read_basic_int32(f: BinaryIO) -> int:
    size = f.read(1)
    if size != b"\x04":
        raise KaldiIOError(f"expected int32 size byte 4, got {size!r}")
    return struct.unpack("<i", f.read(4))[0]


def write_basic_int32(f: BinaryIO, value: int) -> None:
    f.write(b"\x04" + struct.pack("<i", value))


def read_basic_float(f: BinaryIO) -> float:
    size = f.read(1)
    if size == b"\x04":
        return struct.unpack("<f", f.read(4))[0]
    if size == b"\x08":
        return struct.unpack("<d", f.read(8))[0]
    raise KaldiIOError(f"expected float size byte, got {size!r}")


def write_basic_float(f: BinaryIO, value: float) -> None:
    f.write(b"\x04" + struct.pack("<f", value))


def _read_compressed_matrix(f: BinaryIO, fmt: int) -> np.ndarray:
    """Decode "CM"/"CM2"/"CM3" (reference: src/matrix/compressed-matrix.cc)."""
    min_value, rng = struct.unpack("<ff", f.read(8))
    num_rows, num_cols = struct.unpack("<ii", f.read(8))

    def u16_to_f(u):  # CompressedMatrix::Uint16ToFloat
        return min_value + rng * 1.52590218966964e-05 * u

    if fmt == 1:
        # per-column 4x uint16 percentile header + uint8 data, column-major
        headers = np.frombuffer(f.read(8 * num_cols), dtype="<u2").reshape(
            num_cols, 4)
        data = np.frombuffer(
            f.read(num_rows * num_cols), dtype=np.uint8
        ).reshape(num_cols, num_rows).astype(np.float32)
        p0, p25, p75, p100 = (u16_to_f(headers[:, i].astype(np.float32))
                              for i in range(4))
        out = np.empty((num_cols, num_rows), dtype=np.float32)
        for c in range(num_cols):
            d = data[c]
            # CharToFloat: three linear segments (compressed-matrix.cc)
            lo = p0[c] + (p25[c] - p0[c]) * (d / 64.0)
            mid = p25[c] + (p75[c] - p25[c]) * ((d - 64.0) / 128.0)
            hi = p75[c] + (p100[c] - p75[c]) * ((d - 192.0) / 63.0)
            out[c] = np.where(d <= 64, lo, np.where(d <= 192, mid, hi))
        return out.T.copy()
    if fmt == 2:
        data = np.frombuffer(
            f.read(2 * num_rows * num_cols), dtype="<u2"
        ).reshape(num_rows, num_cols)
        return u16_to_f(data.astype(np.float32)).astype(np.float32)
    if fmt == 3:
        data = np.frombuffer(
            f.read(num_rows * num_cols), dtype=np.uint8
        ).reshape(num_rows, num_cols)
        return (min_value + rng * (1.0 / 255.0) * data.astype(np.float32)
                ).astype(np.float32)
    raise KaldiIOError(f"unknown compressed-matrix format {fmt}")


def read_matrix(f: BinaryIO, binary: bool = True) -> np.ndarray:
    """Read a Matrix<float/double> as float32 (reference: kaldi-matrix.cc
    Matrix::Read); ``binary=False`` reads the text form, one row a line
    (:func:`read_text_matrix_lines`)."""
    if not binary:
        return _read_text_matrix(f)
    token = read_token(f)
    if token == "CM":
        return _read_compressed_matrix(f, 1)
    if token == "CM2":
        return _read_compressed_matrix(f, 2)
    if token == "CM3":
        return _read_compressed_matrix(f, 3)
    if token not in ("FM", "DM"):
        raise KaldiIOError(f"unexpected matrix token {token!r}")
    dtype = "<f4" if token == "FM" else "<f8"
    rows = read_basic_int32(f)
    cols = read_basic_int32(f)
    itemsize = 4 if token == "FM" else 8
    data = np.frombuffer(f.read(rows * cols * itemsize), dtype=dtype)
    if data.size != rows * cols:
        raise KaldiIOError("truncated matrix data")
    return data.reshape(rows, cols).astype(np.float32)


def write_matrix(f: BinaryIO, mat: np.ndarray, binary: bool = True) -> None:
    mat = np.asarray(mat)
    if mat.ndim != 2:
        raise ValueError("matrix must be 2-D")
    if not binary:
        f.write(b" [")
        for row in mat:
            f.write(b"\n  " + " ".join(repr(float(v)) for v in row).encode())
        f.write(b" ]\n")
        return
    if mat.dtype == np.float64:
        write_token(f, "DM")
        write_basic_int32(f, mat.shape[0])
        write_basic_int32(f, mat.shape[1])
        f.write(np.ascontiguousarray(mat, dtype="<f8").tobytes())
    else:
        write_token(f, "FM")
        write_basic_int32(f, mat.shape[0])
        write_basic_int32(f, mat.shape[1])
        f.write(np.ascontiguousarray(mat, dtype="<f4").tobytes())


def _read_text_matrix(f: BinaryIO) -> np.ndarray:
    """The text form " [\n  r0 ...\n  r1 ... ]" up to its "]", a row a
    line as Kaldi writes and reads it.  JAX's reader puts every value in
    one row (kaldi_aslp_tpu/io/kaldi_io.py:189-207); the port keeps the
    rows (ROADMAP queue 3)."""
    tok = read_token(f)
    if tok != "[":
        raise KaldiIOError(f"expected '[' for text matrix, got {tok!r}")
    body = bytearray()
    while True:
        c = f.read(1)
        if not c:
            raise KaldiIOError("EOF inside a text matrix")
        if c == b"]":
            break
        body += c
    mat = read_text_matrix_lines("[" + body.decode("utf-8") + "]")
    return mat.reshape(0, 0) if mat.size == 0 else mat


def read_text_matrix_lines(text: str) -> np.ndarray:
    """Parse a text-form matrix "[\\n r0...\\n r1... ]" with newline rows."""
    body = text.strip()
    if not body.startswith("["):
        raise KaldiIOError("text matrix must start with '['")
    body = body[1:]
    if body.rstrip().endswith("]"):
        body = body.rstrip()[:-1]
    rows = [
        [float(v) for v in line.split()]
        for line in body.strip().splitlines()
        if line.strip()
    ]
    return np.array(rows, dtype=np.float32)


def read_vector(f: BinaryIO, binary: bool = True) -> np.ndarray:
    """Read Vector<float/double> as float32 (reference: kaldi-vector.cc
    Vector::Read)."""
    if not binary:
        toks = []
        tok = read_token(f)
        if tok != "[":
            raise KaldiIOError(f"expected '[' for text vector, got {tok!r}")
        while True:
            tok = read_token(f)
            if tok == "]":
                break
            toks.append(float(tok))
        return np.array(toks, dtype=np.float32)
    token = read_token(f)
    if token not in ("FV", "DV"):
        raise KaldiIOError(f"unexpected vector token {token!r}")
    size = read_basic_int32(f)
    dtype, itemsize = ("<f4", 4) if token == "FV" else ("<f8", 8)
    data = np.frombuffer(f.read(size * itemsize), dtype=dtype)
    return data.astype(np.float32)


def write_vector(f: BinaryIO, vec: np.ndarray, binary: bool = True) -> None:
    """Write a Vector<float> ("FV"; the text form is "[ v0 v1 ... ]")."""
    vec = np.asarray(vec).reshape(-1)
    if not binary:
        f.write(b" [ " + " ".join(repr(float(v)) for v in vec).encode()
                + b" ]\n")
        return
    write_token(f, "FV")
    write_basic_int32(f, vec.shape[0])
    f.write(np.ascontiguousarray(vec, dtype="<f4").tobytes())


def read_int_vector(f: BinaryIO, binary: bool = True) -> np.ndarray:
    """ReadIntegerVector<int32> (reference: src/base/io-funcs-inl.h); the
    text form is one line of integers."""
    if not binary:
        vals = []
        while True:
            tok_chars = []
            while True:
                c = f.read(1)
                if not c or c in b"\n":
                    break
                if c in b" \t\r":
                    if tok_chars:
                        break
                    continue
                tok_chars.append(c)
            if tok_chars:
                vals.append(int(b"".join(tok_chars)))
            if not c or c == b"\n":
                break
        return np.array(vals, dtype=np.int32)
    size = f.read(1)
    if size != b"\x04":
        raise KaldiIOError(f"expected int32 size byte, got {size!r}")
    n = struct.unpack("<i", f.read(4))[0]
    return np.frombuffer(f.read(4 * n), dtype="<i4").astype(np.int32)


def write_int_vector(f: BinaryIO, vec: np.ndarray,
                     binary: bool = True) -> None:
    vec = np.asarray(vec, dtype=np.int32).reshape(-1)
    if not binary:
        f.write(" ".join(str(int(v)) for v in vec).encode() + b"\n")
        return
    f.write(b"\x04" + struct.pack("<i", vec.shape[0]))
    f.write(np.ascontiguousarray(vec, dtype="<i4").tobytes())


Posterior = List[List[Tuple[int, float]]]


def read_posterior(f: BinaryIO, binary: bool = True) -> Posterior:
    """ReadPosterior (reference: src/hmm/posterior.cc); the text form is
    one line of "[ id p id p ... ]" frames."""
    if not binary:
        line = f.readline().decode()
        post: Posterior = []
        toks = line.replace("]", " ] ").replace("[", " [ ").split()
        frame: List[Tuple[int, float]] = []
        i = 0
        while i < len(toks):
            if toks[i] == "[":
                frame = []
            elif toks[i] == "]":
                post.append(frame)
            else:
                frame.append((int(toks[i]), float(toks[i + 1])))
                i += 1
            i += 1
        return post
    num_frames = read_basic_int32(f)
    post = []
    for _ in range(num_frames):
        n = read_basic_int32(f)
        post.append([(read_basic_int32(f), read_basic_float(f))
                     for _ in range(n)])
    return post


def write_posterior(f: BinaryIO, post: Posterior,
                    binary: bool = True) -> None:
    if not binary:
        parts = ["[ " + " ".join(f"{i} {v}" for i, v in frame) + " ]"
                 for frame in post]
        f.write((" ".join(parts) + "\n").encode())
        return
    write_basic_int32(f, len(post))
    for frame in post:
        write_basic_int32(f, len(frame))
        for idx, val in frame:
            write_basic_int32(f, int(idx))
            write_basic_float(f, float(val))
