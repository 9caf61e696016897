"""Waveform resampling (reference: src/feat/resample.{h,cc}
LinearResample — bandlimited interpolation with a windowed-sinc filter).

Port of kaldi_aslp_tpu/feats/resample.py, numpy on the host copied as it
is: one [out_samples, filter_width] gather and weighted sum in float64,
and additive noise at a target SNR from a seeded ``RandomState``."""

from __future__ import annotations

import math

import numpy as np


def resample_waveform(
    wave: np.ndarray,
    samp_in: float,
    samp_out: float,
    num_zeros: int = 6,
) -> np.ndarray:
    """Bandlimited resample [n] → [round(n*out/in)] (reference:
    LinearResample::Resample)."""
    wave = np.asarray(wave, np.float64)
    if samp_in == samp_out:
        return wave.astype(np.float32)
    n_in = len(wave)
    n_out = int(round(n_in * samp_out / samp_in))
    cutoff = 0.99 * 0.5 * min(samp_in, samp_out)
    dt_in = 1.0 / samp_in
    window_width = num_zeros / (2.0 * cutoff)   # seconds each side
    half_taps = int(math.ceil(window_width / dt_in))
    taps = 2 * half_taps + 1

    out_times = np.arange(n_out) / samp_out
    center_idx = np.floor(out_times * samp_in).astype(np.int64)
    offsets = np.arange(-half_taps, half_taps + 1)
    idx = center_idx[:, None] + offsets[None, :]          # [n_out, taps]
    t_diff = out_times[:, None] - idx * dt_in             # seconds
    # windowed sinc (Hanning window over [-w, w])
    in_window = np.abs(t_diff) < window_width
    window = np.where(
        in_window,
        0.5 + 0.5 * np.cos(math.pi * t_diff / window_width),
        0.0,
    )
    x = 2.0 * cutoff * t_diff
    x_safe = np.where(np.abs(x) < 1e-9, 1.0, x)
    sinc = np.where(np.abs(x) < 1e-9, 1.0,
                    np.sin(math.pi * x_safe) / (math.pi * x_safe))
    weights = 2.0 * cutoff * dt_in * window * sinc
    idx_c = np.clip(idx, 0, n_in - 1)
    valid = (idx >= 0) & (idx < n_in)
    out = (wave[idx_c] * weights * valid).sum(axis=1)
    return out.astype(np.float32)


def add_noise(
    wave: np.ndarray,
    noise: np.ndarray,
    snr_db: float,
    seed: int = 0,
) -> np.ndarray:
    """Mix noise into speech at a target SNR (reference:
    src/aslp-bin/aslp-wav-noise.cc data augmentation).

    The noise is tiled/cropped to the wave length with a random offset."""
    rng = np.random.RandomState(seed)
    wave = np.asarray(wave, np.float64)
    noise = np.asarray(noise, np.float64)
    n = len(wave)
    if len(noise) < n:
        reps = int(np.ceil(n / len(noise)))
        noise = np.tile(noise, reps)
    start = rng.randint(0, len(noise) - n + 1)
    noise = noise[start:start + n]
    p_sig = np.mean(wave ** 2) + 1e-20
    p_noise = np.mean(noise ** 2) + 1e-20
    scale = math.sqrt(p_sig / (p_noise * (10.0 ** (snr_db / 10.0))))
    return (wave + scale * noise).astype(np.float32)
