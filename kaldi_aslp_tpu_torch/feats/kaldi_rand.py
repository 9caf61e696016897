"""Bit-exact replica of glibc ``rand()`` and Kaldi's RandUniform /
RandGauss / Dither built on it (reference: src/base/kaldi-math.h:129-154
Rand/RandUniform/RandGauss; src/feat/feature-functions.cc:51-54 Dither).

The reference dithers with ``RandGauss() * dither`` per windowed sample,
where RandGauss consumes two glibc ``rand()`` draws.  Reproducing glibc's
TYPE_3 additive-feedback generator makes our dithered features bit-
comparable to reference-produced ones for the same seed (validated in
the JAX package's tests against a compiled C probe of the real glibc).

Port of kaldi_aslp_tpu/feats/kaldi_rand.py: numpy on the host, copied as
it is, so both packages draw the same bits from the same seed.
"""

from __future__ import annotations

import math

import numpy as np

RAND_MAX = 2147483647
_M32 = 1 << 32


class GlibcRandom:
    """glibc ``srand(seed)`` + ``rand()`` (TYPE_3, additive feedback:
    r[i] = r[i-3] + r[i-31] mod 2^32, output r[i] >> 1, first 310 outputs
    of the warm-up discarded)."""

    def __init__(self, seed: int = 1):
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = [0] * 34
        r[0] = seed
        # Schrage's method for 16807 * r mod (2^31 - 1) on int32, exactly
        # as glibc initializes TYPE_3 state
        for i in range(1, 31):
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += RAND_MAX
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._r = r
        self._i = 34
        for _ in range(310):
            self._step()

    def _step(self) -> int:
        r = self._r
        val = (r[-31] + r[-3]) % _M32
        r.append(val)
        # bound memory: keep the last 31 entries only
        if len(r) > 128:
            del r[:-31]
        return val

    def rand(self) -> int:
        return self._step() >> 1

    def rand_uniform(self) -> float:
        """(reference: kaldi-math.h:147 — (Rand()+1)/(RAND_MAX+2) as
        float32)."""
        return np.float32((self.rand() + 1.0) / (RAND_MAX + 2.0))

    def rand_gauss(self) -> float:
        """(reference: kaldi-math.h:151 — Box-Muller in float32)."""
        u1 = self.rand_uniform()
        u2 = self.rand_uniform()
        a = np.float32(math.sqrt(np.float32(-2.0 * math.log(float(u1)))))
        b = np.float32(math.cos(np.float32(2.0 * math.pi * float(u2))))
        return np.float32(a * b)


def kaldi_dither(frames: np.ndarray, dither: float,
                 rng: GlibcRandom) -> np.ndarray:
    """Dither extracted frames exactly like the reference's per-frame
    ExtractWindow → Dither loop (reference: feature-functions.cc:148,
    :51-54): RandGauss per sample, row-major over [num_frames,
    window_size]."""
    frames = np.array(frames, np.float32, copy=True)
    flat = frames.reshape(-1)
    for i in range(flat.shape[0]):
        flat[i] += rng.rand_gauss() * np.float32(dither)
    return frames
