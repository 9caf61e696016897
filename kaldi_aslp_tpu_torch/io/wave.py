"""WAV file reading/writing (reference: src/feat/wave-reader.{h,cc}).

The port's own copy of kaldi_aslp_tpu/io/wave.py (numpy only; the JAX
package's ``io/__init__`` loads JAX, so the port keeps its own).

Reads RIFF PCM wave files into float arrays scaled like the reference
(raw int16 range, NOT normalized to [-1,1] — Kaldi feature code expects
sample values in int16 units)."""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO

import numpy as np


@dataclass
class WaveData:
    samp_freq: float
    data: np.ndarray  # (num_channels, num_samples) float32, int16 units

    @property
    def duration(self) -> float:
        return self.data.shape[1] / self.samp_freq


def read_wave(path_or_file) -> WaveData:
    if hasattr(path_or_file, "read"):
        return _read_wave_stream(path_or_file)
    with open(path_or_file, "rb") as f:
        return _read_wave_stream(f)


def _read_wave_stream(f: BinaryIO) -> WaveData:
    riff = f.read(4)
    if riff != b"RIFF":
        raise ValueError(f"not a RIFF file (got {riff!r})")
    f.read(4)  # riff size (untrusted; kaldi ignores for streams)
    if f.read(4) != b"WAVE":
        raise ValueError("not a WAVE file")
    fmt = None
    data = None
    while True:
        header = f.read(8)
        if len(header) < 8:
            break
        chunk_id, size = header[:4], struct.unpack("<I", header[4:])[0]
        if chunk_id == b"fmt ":
            fmt = f.read(size)
        elif chunk_id == b"data":
            data = f.read(size)
            break
        else:
            f.read(size + (size & 1))
    if fmt is None or data is None:
        raise ValueError("missing fmt/data chunk")
    (audio_format, channels, samp_freq, _byte_rate, block_align,
     bits) = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format not in (1, 0xFFFE):  # PCM / extensible
        raise ValueError(f"unsupported wav format {audio_format}")
    if bits == 16:
        samples = np.frombuffer(data, dtype="<i2").astype(np.float32)
    elif bits == 8:
        samples = (np.frombuffer(data, dtype=np.uint8).astype(np.float32)
                   - 128.0) * 256.0
    elif bits == 32:
        samples = np.frombuffer(data, dtype="<i4").astype(np.float32) / 65536.0
    else:
        raise ValueError(f"unsupported bit depth {bits}")
    n = samples.shape[0] // channels
    samples = samples[: n * channels].reshape(n, channels).T
    return WaveData(samp_freq=float(samp_freq), data=samples.copy())


def write_wave(path_or_file, wave: WaveData) -> None:
    data = np.clip(np.round(wave.data), -32768, 32767).astype("<i2")
    channels, n = data.shape
    payload = data.T.reshape(-1).tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, 1, channels, int(wave.samp_freq),
        int(wave.samp_freq) * channels * 2, channels * 2, 16
    )
    hdr += b"data" + struct.pack("<I", len(payload))
    if hasattr(path_or_file, "write"):
        path_or_file.write(hdr + payload)
    else:
        with open(path_or_file, "wb") as f:
            f.write(hdr + payload)
