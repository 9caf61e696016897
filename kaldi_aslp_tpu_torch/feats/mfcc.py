"""MFCC features (reference: src/feat/feature-mfcc.{h,cc}).

Port of kaldi_aslp_tpu/feats/mfcc.py:28-140: the mel energies of
feats/fbank.py (:func:`mel_energies`), then a DCT-II matmul and cepstral
liftering, on the device the extractor was built for.  ``compute``
takes a batch of equal-length waveforms [..., samples] (feats/batch.py
stacks a corpus that way); ``__call__`` takes one waveform, padded as
the JAX extractor pads it where that changes a value (fbank.py's
:func:`extract_one`).  Both dither only when given a ``generator``
(feats/window.py: process_window)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.feats.fbank import (
    as_waveform,
    extract_one,
    floored_energy,
    floored_log,
    mel_energies,
)
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions, mel_banks_matrix
from kaldi_aslp_tpu_torch.feats.window import (  # noqa: F401 (JAX's names)
    FrameExtractionOptions,
    compute_power_spectrum,
    extract_frames,
    process_window,
    window_function,
)
from kaldi_aslp_tpu_torch.utils.config import Config
from kaldi_aslp_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class MfccOptions(Config):
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    htk_compat: bool = False


def dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (reference: matrix-functions.cc
    ComputeDctMatrix)."""
    m = np.zeros((num_rows, num_cols), dtype=np.float64)
    m[0, :] = math.sqrt(1.0 / num_cols)
    for r in range(1, num_rows):
        for c in range(num_cols):
            m[r, c] = math.sqrt(2.0 / num_cols) * math.cos(
                math.pi / num_cols * (c + 0.5) * r)
    return m.astype(np.float32)


def lifter_coeffs(q: float, n: int) -> np.ndarray:
    """(reference: mel-computations.cc ComputeLifterCoeffs)."""
    i = np.arange(n, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


class Mfcc:
    """Compute MFCCs (reference: feature-mfcc.cc:94 Mfcc::Compute)."""

    def __init__(
        self,
        frame_opts: Optional[FrameExtractionOptions] = None,
        mel_opts: Optional[MelBanksOptions] = None,
        mfcc_opts: Optional[MfccOptions] = None,
        vtln_warp: float = 1.0,
        device: Union[str, torch.device] = "cuda",
    ):
        self.frame_opts = frame_opts or FrameExtractionOptions()
        self.mel_opts = mel_opts or MelBanksOptions()
        self.opts = mfcc_opts or MfccOptions()
        self.device = resolve_device(device)

        def on_device(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.asarray(a, np.float32)).to(
                self.device)
        self._mel = on_device(
            mel_banks_matrix(self.mel_opts, self.frame_opts, vtln_warp))
        # full-size DCT truncated to num_ceps, transposed for x @ D
        self._dct = on_device(
            dct_matrix(self.opts.num_ceps, self.mel_opts.num_bins).T)
        self._lifter = (
            on_device(lifter_coeffs(self.opts.cepstral_lifter,
                                    self.opts.num_ceps))
            if self.opts.cepstral_lifter != 0.0 else None)
        self._window = on_device(window_function(self.frame_opts))

    @property
    def dim(self) -> int:
        return self.opts.num_ceps

    def __call__(self, waveform,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """[num_samples] (array or tensor) -> [num_frames, dim] on the
        extractor's device; dithered only when ``generator`` is given."""
        return extract_one(self.compute, as_waveform(waveform, self.device),
                           self.frame_opts, generator)

    def compute(self, waveform: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """[..., num_samples] float32 on the extractor's device ->
        [..., num_frames, dim]; each waveform of the batch draws its
        dither from ``generator`` in turn."""
        energies, log_energy = mel_energies(
            waveform, self.frame_opts, self.mel_opts, self._window,
            self._mel, self.opts.raw_energy, generator=generator)
        feats = torch.matmul(floored_log(energies), self._dct)
        if self._lifter is not None:
            feats = feats * self._lifter
        if self.opts.use_energy:
            log_energy = floored_energy(log_energy, self.opts.energy_floor)
            feats = torch.cat([log_energy[..., None], feats[..., 1:]],
                              dim=-1)
        if self.opts.htk_compat:
            # energy/C0 moves to the last column; pure C0 gets the
            # sqrt(2) rescale (reference: feature-mfcc.cc:174-181)
            first = feats[..., :1]
            if not self.opts.use_energy:
                first = first * math.sqrt(2.0)
            feats = torch.cat([feats[..., 1:], first], dim=-1)
        return feats
