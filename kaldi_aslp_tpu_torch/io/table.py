"""Kaldi Table I/O: ark/scp readers and writers.

Copy of kaldi_aslp_tpu/io/table.py (reference: src/util/kaldi-table.h,
kaldi-holder.h) for matrices, float vectors, integer vectors and
posteriors: sequential and random-access readers over ``ark:``,
``ark,t:``, ``scp:`` and piped ``ark:cmd |`` rspecifiers, and writers
over ``ark:``, ``ark,t:`` and ``ark,scp:`` wspecifiers.  The JAX package's ``io/__init__`` loads JAX
(through its lattice I/O), so the port keeps this copy."""

from __future__ import annotations

import io
import os
import subprocess
from typing import BinaryIO, Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from kaldi_aslp_tpu_torch.io import kaldi_io
from kaldi_aslp_tpu_torch.io.kaldi_io import BINARY_MARKER, KaldiIOError


class Specifier:
    """Parsed r/wspecifier (reference: kaldi-table.cc ReadScriptFile etc.)."""

    def __init__(self, spec: str):
        if ":" not in spec:
            raise KaldiIOError(f"bad specifier (missing ':'): {spec!r}")
        opts, self.path = spec.split(":", 1)
        parts = opts.split(",")
        self.kind = parts[0]
        flags = set(parts[1:])
        if "scp" in flags and self.kind == "ark":
            self.kind = "ark,scp"
            flags.discard("scp")
            # path is "foo.ark,foo.scp"
            self.path, self.scp_path = self.path.split(",", 1)
        else:
            self.scp_path = None
        if self.kind not in ("ark", "scp", "ark,scp"):
            raise KaldiIOError(f"bad specifier kind {self.kind!r} in {spec!r}")
        self.permissive = "p" in flags      # tolerate missing entries
        self.binary = "t" not in flags


def _open_rxfilename(path: str) -> BinaryIO:
    """Open an extended input filename: file, '-', 'cmd |', 'file:offset'."""
    path = path.strip()
    if path == "" or path == "-":
        return os.fdopen(os.dup(0), "rb")
    if path.endswith("|"):
        proc = subprocess.Popen(path[:-1], shell=True, stdout=subprocess.PIPE)
        return proc.stdout  # type: ignore[return-value]
    if ":" in path:
        base, _, off = path.rpartition(":")
        if off.isdigit() and os.path.exists(base):
            f = open(base, "rb")
            f.seek(int(off))
            return f
    return open(path, "rb")


def _open_wxfilename(path: str) -> BinaryIO:
    path = path.strip()
    if path == "" or path == "-":
        return os.fdopen(os.dup(1), "wb")
    if path.startswith("|"):
        proc = subprocess.Popen(path[1:], shell=True, stdin=subprocess.PIPE)
        return proc.stdin  # type: ignore[return-value]
    return open(path, "wb")


def _read_key(f: BinaryIO) -> Optional[str]:
    """Read whitespace-terminated key; None at EOF."""
    chars = []
    while True:
        c = f.read(1)
        if not c:
            return b"".join(chars).decode() if chars else None
        if c in b" \t\n":
            if chars:
                return b"".join(chars).decode()
            continue
        chars.append(c)


def _consume_marker(f: BinaryIO) -> bool:
    head = f.read(2)
    if head == BINARY_MARKER:
        return True
    if not _seekable(f):
        raise KaldiIOError("non-seekable text stream")
    f.seek(-len(head), 1)
    return False


def _read_text_through_bracket(f: BinaryIO, parse: Callable):
    """Accumulate text until the matching ']' then parse."""
    buf = []
    depth = 0
    seen_open = False
    while True:
        c = f.read(1)
        if not c:
            break
        buf.append(c)
        if c == b"[":
            depth += 1
            seen_open = True
        elif c == b"]":
            depth -= 1
            if seen_open and depth == 0:
                break
    return parse(b"".join(buf).decode())


class Holder:
    """How one value is read after its key and written after it."""

    def read_entry(self, f: BinaryIO):
        return self.read(f, _consume_marker(f))

    def read(self, f: BinaryIO, binary: bool):
        raise NotImplementedError

    def write(self, f: BinaryIO, value, binary: bool):
        raise NotImplementedError


class MatrixHolder(Holder):
    def read(self, f, binary):
        if binary:
            return kaldi_io.read_matrix(f)
        return _read_text_through_bracket(f, kaldi_io.read_text_matrix_lines)

    def write(self, f, value, binary):
        if binary:
            f.write(BINARY_MARKER)
        kaldi_io.write_matrix(f, np.asarray(value), binary)


class VectorHolder(Holder):
    def read(self, f, binary):
        if binary:
            return kaldi_io.read_vector(f, True)
        return _read_text_through_bracket(
            f, lambda s: np.array(s.strip("[] \n").split(),
                                  dtype=np.float32))

    def write(self, f, value, binary):
        if binary:
            f.write(BINARY_MARKER)
        kaldi_io.write_vector(f, np.asarray(value), binary)


class IntVectorHolder(Holder):
    def read(self, f, binary):
        return kaldi_io.read_int_vector(f, binary)

    def write(self, f, value, binary):
        if binary:
            f.write(BINARY_MARKER)
        kaldi_io.write_int_vector(f, np.asarray(value, dtype=np.int32),
                                  binary)


class PosteriorHolder(Holder):
    def read(self, f, binary):
        return kaldi_io.read_posterior(f, binary)

    def write(self, f, value, binary):
        if binary:
            f.write(BINARY_MARKER)
        kaldi_io.write_posterior(f, value, binary)


def _seekable(f) -> bool:
    try:
        return f.seekable()
    except (AttributeError, ValueError, OSError):
        return False


def _buffered(f: BinaryIO) -> BinaryIO:
    """A seekable stream over ``f`` (a pipe is read whole into memory)."""
    if _seekable(f):
        return f
    data = f.read()
    f.close()
    return io.BufferedReader(io.BytesIO(data))


def _load_scp(path: str):
    entries = []
    with io.TextIOWrapper(_open_rxfilename(path)) as lines:
        for line in lines:
            line = line.strip()
            if not line:
                continue
            key, _, rxfilename = line.partition(" ")
            entries.append((key, rxfilename.strip()))
    return entries


class SequentialTableReader:
    """Iterate (key, value) in file order (reference: kaldi-table.h:93)."""

    def __init__(self, rspecifier: str, holder: Holder):
        self.spec = Specifier(rspecifier)
        self.holder = holder
        if self.spec.kind == "scp":
            self._iter = self._iter_scp(_load_scp(self.spec.path))
        else:
            self._iter = self._iter_ark(
                _buffered(_open_rxfilename(self.spec.path)))

    def _iter_ark(self, f: BinaryIO) -> Iterator[Tuple[str, object]]:
        with f:
            while True:
                key = _read_key(f)
                if key is None:
                    break
                yield key, self.holder.read_entry(f)

    def _iter_scp(self, scp) -> Iterator[Tuple[str, object]]:
        for key, rxfilename in scp:
            try:
                with _buffered(_open_rxfilename(rxfilename)) as f:
                    value = self.holder.read_entry(f)
            except (OSError, KaldiIOError):
                if self.spec.permissive:
                    continue
                raise
            yield key, value

    def __iter__(self) -> Iterator[Tuple[str, object]]:
        return self._iter


class RandomAccessTableReader:
    """Keyed lookup; loads scp lazily, ark eagerly (reference: kaldi-table.h)."""

    def __init__(self, rspecifier: str, holder: Holder):
        self.spec = Specifier(rspecifier)
        self.holder = holder
        self._cache: Dict[str, object] = {}
        if self.spec.kind == "scp":
            self._scp = dict(_load_scp(self.spec.path))
        else:
            self._scp = None
            self._cache.update(SequentialTableReader(rspecifier, holder))

    def __contains__(self, key: str) -> bool:
        if self._scp is not None:
            return key in self._scp
        return key in self._cache

    def __getitem__(self, key: str):
        if key in self._cache:
            return self._cache[key]
        if self._scp is None or key not in self._scp:
            raise KeyError(key)
        with _buffered(_open_rxfilename(self._scp[key])) as f:
            value = self.holder.read_entry(f)
        self._cache[key] = value
        return value


class TableWriter:
    """Write (key, value) entries to ``ark:``, ``ark,t:`` or
    ``ark,scp:``."""

    def __init__(self, wspecifier: str, holder: Holder):
        self.spec = Specifier(wspecifier)
        self.holder = holder
        if self.spec.kind == "scp":
            raise KaldiIOError(
                "writing to scp: alone is unsupported (use ark,scp:)")
        self._f = _open_wxfilename(self.spec.path)
        self._scp_f = (open(self.spec.scp_path, "w")
                       if self.spec.scp_path else None)
        self._abs_path = (
            os.path.abspath(self.spec.path)
            if self.spec.path not in ("", "-")
            and not self.spec.path.startswith("|")
            else self.spec.path)

    def write(self, key: str, value) -> None:
        if " " in key:
            raise KaldiIOError(f"key may not contain spaces: {key!r}")
        self._f.write(key.encode() + b" ")
        if self._scp_f is not None:
            self._scp_f.write(f"{key} {self._abs_path}:{self._f.tell()}\n")
        self.holder.write(self._f, value, self.spec.binary)
        self._f.flush()

    def __setitem__(self, key: str, value) -> None:
        self.write(key, value)

    def close(self) -> None:
        self._f.close()
        if self._scp_f is not None:
            self._scp_f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def sequential_matrix_reader(rspec: str) -> SequentialTableReader:
    return SequentialTableReader(rspec, MatrixHolder())


def sequential_vector_reader(rspec: str) -> SequentialTableReader:
    return SequentialTableReader(rspec, VectorHolder())


def sequential_int_vector_reader(rspec: str) -> SequentialTableReader:
    return SequentialTableReader(rspec, IntVectorHolder())


def sequential_posterior_reader(rspec: str) -> SequentialTableReader:
    return SequentialTableReader(rspec, PosteriorHolder())


def random_access_matrix_reader(rspec: str) -> RandomAccessTableReader:
    return RandomAccessTableReader(rspec, MatrixHolder())


def random_access_vector_reader(rspec: str) -> RandomAccessTableReader:
    return RandomAccessTableReader(rspec, VectorHolder())


def random_access_int_vector_reader(rspec: str) -> RandomAccessTableReader:
    return RandomAccessTableReader(rspec, IntVectorHolder())


def random_access_posterior_reader(rspec: str) -> RandomAccessTableReader:
    return RandomAccessTableReader(rspec, PosteriorHolder())


def matrix_writer(wspec: str) -> TableWriter:
    return TableWriter(wspec, MatrixHolder())


def vector_writer(wspec: str) -> TableWriter:
    return TableWriter(wspec, VectorHolder())


def int_vector_writer(wspec: str) -> TableWriter:
    return TableWriter(wspec, IntVectorHolder())


def posterior_writer(wspec: str) -> TableWriter:
    return TableWriter(wspec, PosteriorHolder())
