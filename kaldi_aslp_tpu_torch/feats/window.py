"""Frame extraction: DC removal, preemphasis, windowing, power spectrum.

Port of kaldi_aslp_tpu/feats/window.py (reference:
src/feat/feature-functions.h:73-132, feature-window.cc).  All frames of a
waveform are one [num_frames, frame_length] tensor and every step is a
batched tensor op.  Option defaults mirror the reference exactly.

Dither follows the JAX package's contract (its ``key`` is a
``torch.Generator`` here): frames are dithered only when a generator is
passed, whatever ``opts.dither`` says.  The draws come from torch's
generator, not JAX's PRNG, so dithered values agree with JAX's in
distribution, not bit for bit."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from kaldi_aslp_tpu_torch.utils.config import Config


@dataclasses.dataclass
class FrameExtractionOptions(Config):
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemphasis_coefficient: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey|hamming|hanning|rectangular|blackman
    round_to_power_of_two: bool = True
    blackman_coeff: float = 0.42
    snip_edges: bool = True

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def padded_window_size(self) -> int:
        if self.round_to_power_of_two:
            return 1 << (self.window_size - 1).bit_length()
        return self.window_size


def num_frames(num_samples: int, opts: FrameExtractionOptions) -> int:
    """Frame count (reference: feature-window.cc NumFrames)."""
    if opts.snip_edges:
        if num_samples < opts.window_size:
            return 0
        return 1 + (num_samples - opts.window_size) // opts.window_shift
    return (num_samples + opts.window_shift // 2) // opts.window_shift


def window_function(opts: FrameExtractionOptions) -> np.ndarray:
    """The window vector (reference: feature-window.cc FeatureWindowFunction)."""
    M = opts.window_size
    n = np.arange(M, dtype=np.float64)
    a = 2 * math.pi / (M - 1)
    if opts.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * n)
    elif opts.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * n)
    elif opts.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    elif opts.window_type == "rectangular":
        w = np.ones(M)
    elif opts.window_type == "blackman":
        w = (opts.blackman_coeff - 0.5 * np.cos(a * n)
             + (0.5 - opts.blackman_coeff) * np.cos(2 * a * n))
    else:
        raise ValueError(f"unknown window type {opts.window_type!r}")
    return w.astype(np.float32)


def extract_frames(waveform: torch.Tensor,
                   opts: FrameExtractionOptions) -> torch.Tensor:
    """[..., num_samples] -> [..., num_frames, window_size] strided frame
    matrix (a batch of equal-length waveforms frames row by row)."""
    n = num_frames(waveform.shape[-1], opts)
    shift, size = opts.window_shift, opts.window_size
    if n == 0:
        return waveform.new_zeros(waveform.shape[:-1] + (0, size))
    dev = waveform.device
    if opts.snip_edges:
        starts = torch.arange(n, device=dev) * shift
        return waveform[..., starts[:, None]
                        + torch.arange(size, device=dev)]
    # reflect-pad so each frame is centered on its shift window
    # (reference: feature-window.cc ExtractWindow, snip_edges=false)
    starts = torch.arange(n, device=dev) * shift + shift // 2 - size // 2
    idx = starts[:, None] + torch.arange(size, device=dev)[None, :]
    num_samples = waveform.shape[-1]
    idx = torch.where(idx < 0, -idx - 1, idx)
    idx = torch.where(idx >= num_samples, 2 * num_samples - idx - 1, idx)
    return waveform[..., idx]


def dither_noise(shape, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` from ``generator``, on
    ``device``.  The leading axes are drawn one slice at a time in order,
    so each waveform of a batch takes its own draw in turn (the role of
    the JAX package's ``fold_in`` per utterance)."""
    shape = tuple(shape)
    rows = [torch.randn(shape[-2:], generator=generator,
                        device=generator.device, dtype=torch.float32)
            for _ in range(math.prod(shape[:-2]))]
    return torch.stack(rows).reshape(shape).to(device)


def process_window(frames: torch.Tensor, opts: FrameExtractionOptions,
                   window: torch.Tensor, raw_energy: bool = True,
                   generator: Optional[torch.Generator] = None):
    """Dither -> DC removal -> (raw log-energy) -> preemphasis -> window.

    Returns (processed_frames, log_energy), in the reference's order
    (feature-window.cc ProcessWindow).  Frames are dithered only when a
    ``generator`` is given (kaldi_aslp_tpu/feats/window.py:124-127)."""
    if opts.dither != 0.0 and generator is not None:
        frames = frames + opts.dither * dither_noise(
            frames.shape, generator, frames.device)
    if opts.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    tiny = torch.finfo(torch.float32).tiny
    log_energy = torch.log(torch.clamp((frames * frames).sum(-1), min=tiny))
    if opts.preemphasis_coefficient != 0.0:
        shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - opts.preemphasis_coefficient * shifted
    frames = frames * window
    if not raw_energy:
        log_energy = torch.log(
            torch.clamp((frames * frames).sum(-1), min=tiny))
    return frames, log_energy


def compute_power_spectrum(frames: torch.Tensor,
                           opts: FrameExtractionOptions) -> torch.Tensor:
    """Zero-pad to padded_window_size, rfft, |.|^2:
    [..., num_frames, window_size] -> [..., num_frames, padded/2+1]
    (reference: srfft + ComputePowerSpectrum, feature-functions.cc)."""
    spec = torch.fft.rfft(frames, n=opts.padded_window_size, dim=-1)
    return (spec.real ** 2 + spec.imag ** 2).to(torch.float32)
