"""Spectrogram and PLP features (reference: src/feat/feature-spectrogram.
{h,cc}, feature-plp.{h,cc} — mel/bark filterbank, equal-loudness
preemphasis, intensity-to-loudness compression, autocorrelation → LPC via
Levinson-Durbin, cepstral recursion).

Port of kaldi_aslp_tpu/feats/plp.py.  The framing, the window chain, the
power spectrum, the mel product and the compression run on the
extractor's device (feats/fbank.py's :func:`mel_energies`); the
autocorrelation, Durbin's recursion and the cepstra stay float64 numpy
on the host, as in the JAX package.  Both extractors pad the waveform to
whole seconds before framing, as JAX's do, and dither only when given a
``torch.Generator``."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.feats.fbank import (
    as_waveform,
    floored_log,
    mel_energies,
)
from kaldi_aslp_tpu_torch.feats.mel import (
    MelBanksOptions,
    inverse_mel_scale,
    mel_banks_matrix,
    mel_scale,
    vtln_warp_freq,
)
from kaldi_aslp_tpu_torch.feats.mfcc import lifter_coeffs
from kaldi_aslp_tpu_torch.feats.window import (
    FrameExtractionOptions,
    compute_power_spectrum,
    extract_frames,
    num_frames,
    process_window,
    window_function,
)
from kaldi_aslp_tpu_torch.utils.config import Config
from kaldi_aslp_tpu_torch.utils.device import resolve_device


def _padded_to_seconds(wav: torch.Tensor, samp_freq: float) -> torch.Tensor:
    """Zero-pad [n] to whole seconds (the JAX extractors' bucket)."""
    bucket = int(samp_freq)
    padded = -(-max(wav.shape[-1], 1) // bucket) * bucket
    return torch.nn.functional.pad(wav, (0, padded - wav.shape[-1]))


class Spectrogram:
    """Log power spectrogram (reference: feature-spectrogram.cc) on
    ``device``."""

    def __init__(self, frame_opts: Optional[FrameExtractionOptions] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.frame_opts = frame_opts or FrameExtractionOptions()
        self.device = resolve_device(device)
        self._window = torch.from_numpy(
            window_function(self.frame_opts)).to(self.device)

    @property
    def dim(self) -> int:
        return self.frame_opts.padded_window_size // 2 + 1

    def __call__(self, waveform,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """[num_samples] -> [num_frames, dim] on the extractor's device;
        column 0 holds the log energy."""
        wav = as_waveform(waveform, self.device)
        n_true = num_frames(wav.shape[-1], self.frame_opts)
        wav = _padded_to_seconds(wav, self.frame_opts.samp_freq)
        frames = extract_frames(wav, self.frame_opts)
        frames, log_energy = process_window(frames, self.frame_opts,
                                            self._window, generator=generator)
        out = floored_log(compute_power_spectrum(frames, self.frame_opts))
        out = torch.cat([log_energy[:, None], out[:, 1:]], dim=1)
        return out[:n_true]


@dataclasses.dataclass
class PlpOptions(Config):
    lpc_order: int = 12
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    compress_factor: float = 0.33333
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0
    htk_compat: bool = False


def equal_loudness_curve(mel_opts: MelBanksOptions,
                         frame_opts: FrameExtractionOptions,
                         vtln_warp: float = 1.0) -> np.ndarray:
    """Per-mel-bin equal loudness weights over the (possibly warped)
    bin center frequencies (reference: feature-functions.cc
    GetEqualLoudnessVector over MelBanks::GetCenterFreqs)."""
    nyquist = 0.5 * frame_opts.samp_freq
    low = mel_opts.low_freq
    high = mel_opts.high_freq if mel_opts.high_freq > 0 else \
        nyquist + mel_opts.high_freq
    vtln_high = mel_opts.vtln_high
    if vtln_high < 0:
        vtln_high += nyquist
    mel_low = mel_scale(low)
    mel_high = mel_scale(high)
    delta = (mel_high - mel_low) / (mel_opts.num_bins + 1)
    out = np.zeros(mel_opts.num_bins)
    for b in range(mel_opts.num_bins):
        center_mel = mel_low + (b + 1) * delta
        if vtln_warp != 1.0:
            center_mel = mel_scale(vtln_warp_freq(
                mel_opts.vtln_low, vtln_high, low, high, vtln_warp,
                inverse_mel_scale(center_mel)))
        fsq = inverse_mel_scale(center_mel) ** 2
        fsub = fsq / (fsq + 1.6e5)
        out[b] = fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))
    return out.astype(np.float32)


def _durbin(autocorr: np.ndarray, order: int):
    """Batched Durbin recursion, mirroring the reference's sign
    convention — predicted s_n = sum a_i s_{n-i} with stored pLP = -a
    and the 1e-5 floor on (1-k^2) (reference: mel-computations.cc:262
    Durbin).  [T, order+1] → (pLP [T, order], residual E [T])."""
    T = autocorr.shape[0]
    lp = np.zeros((T, order))
    E = autocorr[:, 0].copy()
    for i in range(order):
        ki = autocorr[:, i + 1].copy()
        for j in range(i):
            ki += lp[:, j] * autocorr[:, i - j]
        ki = ki / E
        c = np.maximum(1.0 - ki * ki, 1.0e-5)
        E = E * c
        new = lp.copy()
        new[:, i] = -ki
        for j in range(i):
            new[:, j] = lp[:, j] - ki * lp[:, i - j - 1]
        lp = new
    return lp, E


def _lpc_to_cepstrum(lp: np.ndarray, order: int) -> np.ndarray:
    """LPC → raw cepstrum, C0 not included (reference:
    mel-computations.cc:295 Lpc2Cepstrum)."""
    T = lp.shape[0]
    c = np.zeros((T, order))
    for i in range(order):
        acc = np.zeros(T)
        for j in range(i):
            acc += (i - j) * lp[:, j] * c[:, i - j - 1]
        c[:, i] = -lp[:, i] - acc / (i + 1)
    return c


class Plp:
    """PLP features (reference: feature-plp.cc Plp::Compute): the
    filterbank and compression on ``device``, the LPC solve per
    utterance on the host in float64."""

    def __init__(self, frame_opts: Optional[FrameExtractionOptions] = None,
                 mel_opts: Optional[MelBanksOptions] = None,
                 plp_opts: Optional[PlpOptions] = None,
                 vtln_warp: float = 1.0,
                 device: Union[str, torch.device] = "cuda"):
        self.frame_opts = frame_opts or FrameExtractionOptions()
        self.mel_opts = mel_opts or MelBanksOptions()
        self.opts = plp_opts or PlpOptions()
        if self.opts.num_ceps > self.opts.lpc_order + 1:
            raise ValueError("num_ceps must be <= lpc_order + 1")
        self.device = resolve_device(device)

        def on_device(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.asarray(a, np.float32)).to(
                self.device)
        self._mel = on_device(
            mel_banks_matrix(self.mel_opts, self.frame_opts, vtln_warp))
        self._eql = on_device(
            equal_loudness_curve(self.mel_opts, self.frame_opts, vtln_warp))
        self._window = on_device(window_function(self.frame_opts))
        self._lifter = lifter_coeffs(self.opts.cepstral_lifter,
                                     self.opts.num_ceps) \
            if self.opts.cepstral_lifter != 0 else None

    @property
    def dim(self) -> int:
        return self.opts.num_ceps

    def __call__(self, waveform,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """[num_samples] -> [num_frames, num_ceps] float32 numpy."""
        wav = as_waveform(waveform, self.device)
        n_true = num_frames(wav.shape[-1], self.frame_opts)
        audspec, log_energy = self.device_part(
            _padded_to_seconds(wav, self.frame_opts.samp_freq), generator)
        audspec = audspec.cpu().numpy().astype(np.float64)[:n_true]
        log_energy = log_energy.cpu().numpy()[:n_true]
        # duplicate first/last bins, then autocorrelation via the IDFT
        # bases (reference: feature-plp.cc:215-224 + feature-functions.cc
        # InitIdftBases — the half-weighted end columns below expand to
        # exactly those bases)
        padded_spec = np.concatenate(
            [audspec[:, :1], audspec, audspec[:, -1:]], axis=1
        )
        M = padded_spec.shape[1]
        order = self.opts.lpc_order
        freqs = np.pi * np.arange(M) / (M - 1)
        idft = np.cos(np.outer(np.arange(order + 1), freqs))
        idft[:, 0] *= 0.5
        idft[:, -1] *= 0.5
        autocorr = padded_spec @ idft.T / (M - 1)
        # Durbin → residual energy forms C0 (reference:
        # feature-functions.cc ComputeLpc "-Log(1.0/ans)")
        lp, resid = _durbin(autocorr, order)
        energy = -np.log(1.0 / np.maximum(resid, np.finfo(np.float32).tiny))
        raw = _lpc_to_cepstrum(lp, order)
        ceps = np.concatenate(
            [energy[:, None], raw[:, :self.opts.num_ceps - 1]], axis=1
        )
        if self._lifter is not None:
            ceps = ceps * self._lifter
        if self.opts.cepstral_scale != 1.0:
            ceps = ceps * self.opts.cepstral_scale
        if self.opts.use_energy:
            e = log_energy
            if self.opts.energy_floor > 0:
                e = np.maximum(e, math.log(self.opts.energy_floor))
            ceps[:, 0] = e
        if self.opts.htk_compat:
            # C0/energy last; unlike MFCC no sqrt(2) rescale
            # (reference: feature-plp.cc:250-259)
            ceps = np.concatenate([ceps[:, 1:], ceps[:, :1]], axis=1)
        return ceps.astype(np.float32)

    def device_part(self, waveform: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[num_samples] on the extractor's device -> (compressed
        auditory spectrum [num_frames, num_bins], log energy)."""
        energies, log_energy = mel_energies(
            waveform, self.frame_opts, self.mel_opts, self._window,
            self._mel, self.opts.raw_energy, generator=generator)
        audspec = (energies * self._eql) ** self.opts.compress_factor
        return audspec, log_energy
