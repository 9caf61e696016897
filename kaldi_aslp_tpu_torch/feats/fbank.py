"""Log-mel filterbank features (reference: src/feat/feature-fbank.{h,cc}).

Port of kaldi_aslp_tpu/feats/fbank.py: one strided-frame gather, the
window chain, one ``torch.fft.rfft`` and one matmul against the
precomputed mel matrix, on the device the extractor was built for.  The
JAX version pads the waveform to a 1 s bucket for XLA's compile cache;
the values do not depend on it, and the port does not pad."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions, mel_banks_matrix
from kaldi_aslp_tpu_torch.feats.window import (
    FrameExtractionOptions,
    compute_power_spectrum,
    extract_frames,
    process_window,
    window_function,
)
from kaldi_aslp_tpu_torch.utils.config import Config


@dataclasses.dataclass
class FbankOptions(Config):
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    use_log_fbank: bool = True
    use_power: bool = True
    htk_compat: bool = False


class Fbank:
    """Compute fbank features (reference: feature-fbank.cc:80 Fbank::Compute)."""

    def __init__(
        self,
        frame_opts: Optional[FrameExtractionOptions] = None,
        mel_opts: Optional[MelBanksOptions] = None,
        fbank_opts: Optional[FbankOptions] = None,
        vtln_warp: float = 1.0,
        device: Union[str, torch.device] = "cpu",
    ):
        self.frame_opts = frame_opts or FrameExtractionOptions()
        self.mel_opts = mel_opts or MelBanksOptions()
        self.opts = fbank_opts or FbankOptions()
        self.device = torch.device(device)
        self._mel = torch.from_numpy(np.asarray(
            mel_banks_matrix(self.mel_opts, self.frame_opts, vtln_warp),
            np.float32)).to(self.device)
        self._window = torch.from_numpy(
            window_function(self.frame_opts)).to(self.device)

    @property
    def dim(self) -> int:
        return self.mel_opts.num_bins + (1 if self.opts.use_energy else 0)

    def __call__(self, waveform) -> torch.Tensor:
        """[num_samples] (array or tensor) -> [num_frames, dim] on the
        extractor's device."""
        if isinstance(waveform, torch.Tensor):
            wav = waveform.to(self.device, torch.float32)
        else:
            wav = torch.from_numpy(np.array(waveform, np.float32)).to(
                self.device)
        frames = extract_frames(wav, self.frame_opts)
        frames, log_energy = process_window(
            frames, self.frame_opts, self._window,
            raw_energy=self.opts.raw_energy)
        power = compute_power_spectrum(frames, self.frame_opts)
        if not self.opts.use_power:
            power = torch.sqrt(power)
        # reference MelBanks covers bins [0, N/2); drop the nyquist bin
        mel_energies = torch.matmul(power[:, :-1], self._mel)
        if self.mel_opts.htk_mode:
            # HTK-like energy floor (reference: mel-computations.cc
            # MelBanks::Compute "if (htk_mode_ && energy < 1.0)")
            mel_energies = torch.clamp(mel_energies, min=1.0)
        if self.opts.use_log_fbank:
            mel_energies = torch.log(torch.clamp(
                mel_energies, min=torch.finfo(torch.float32).tiny))
        if self.opts.use_energy:
            if self.opts.energy_floor > 0.0:
                log_energy = torch.clamp(
                    log_energy, min=float(np.log(self.opts.energy_floor)))
            col = log_energy[:, None]
            if self.opts.htk_compat:
                return torch.cat([mel_energies, col], dim=-1)
            return torch.cat([col, mel_energies], dim=-1)
        return mel_energies
