"""Log-mel filterbank features (reference: src/feat/feature-fbank.{h,cc}).

Port of kaldi_aslp_tpu/feats/fbank.py: one strided-frame gather, the
window chain, one ``torch.fft.rfft`` and one matmul against the
precomputed mel matrix, on the device the extractor was built for.
:func:`mel_energies` is that chain up to the mel product, shared with
feats/mfcc.py; :func:`extract_one` runs one waveform through a batched
``compute`` as the JAX extractors do (see there for padding)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions, mel_banks_matrix
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


def as_waveform(waveform, device: torch.device) -> torch.Tensor:
    """[num_samples] array or tensor -> float32 tensor on ``device``."""
    if isinstance(waveform, torch.Tensor):
        return waveform.to(device, torch.float32)
    return torch.from_numpy(np.array(waveform, np.float32)).to(device)


def extract_one(compute: Callable[..., torch.Tensor],
                waveform: torch.Tensor,
                frame_opts: FrameExtractionOptions,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[num_samples] -> [num_frames, dim] through a batched ``compute``.

    With snip_edges=False the last frames reach past the end of the
    waveform and reflect what lies there.  The JAX extractors zero-pad
    every waveform to whole seconds first (a bucket for XLA's compile
    cache), so their last frames reflect zeros; the same padding here
    gives the JAX package's values and those of feats/batch.py's
    ``compute_batched``.  With snip_edges=True no frame reaches past the
    end, and nothing is padded."""
    if frame_opts.snip_edges:
        return compute(waveform, generator)
    n = waveform.shape[-1]
    bucket = int(frame_opts.samp_freq)  # 1 s
    padded = -(-max(n, 1) // bucket) * bucket
    out = compute(torch.nn.functional.pad(waveform, (0, padded - n)),
                  generator)
    return out[:num_frames(n, frame_opts)]


def mel_energies(waveform: torch.Tensor, frame_opts: FrameExtractionOptions,
                 mel_opts: MelBanksOptions, window: torch.Tensor,
                 mel: torch.Tensor, raw_energy: bool, use_power: bool = True,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., num_samples] -> (mel energies [..., num_frames, num_bins],
    log-energy [..., num_frames]): framing, the window chain (dithered
    from ``generator`` when one is given), the power (or magnitude)
    spectrum and the mel product."""
    frames = extract_frames(waveform, frame_opts)
    frames, log_energy = process_window(frames, frame_opts, window,
                                        raw_energy=raw_energy,
                                        generator=generator)
    power = compute_power_spectrum(frames, frame_opts)
    if not use_power:
        power = torch.sqrt(power)
    # reference MelBanks covers bins [0, N/2); drop the nyquist bin
    energies = torch.matmul(power[..., :-1], mel)
    if mel_opts.htk_mode:
        # HTK-like energy floor (reference: mel-computations.cc
        # MelBanks::Compute "if (htk_mode_ && energy < 1.0)")
        energies = torch.clamp(energies, min=1.0)
    return energies, log_energy


def floored_log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=torch.finfo(torch.float32).tiny))


def floored_energy(log_energy: torch.Tensor,
                   energy_floor: float) -> torch.Tensor:
    if energy_floor > 0.0:
        return torch.clamp(log_energy, min=float(np.log(energy_floor)))
    return log_energy


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
        device: Union[str, torch.device] = "cuda",
    ):
        self.frame_opts = frame_opts or FrameExtractionOptions()
        self.mel_opts = mel_opts or MelBanksOptions()
        self.opts = fbank_opts or FbankOptions()
        self.device = resolve_device(device)
        self._mel = torch.from_numpy(np.asarray(
            mel_banks_matrix(self.mel_opts, self.frame_opts, vtln_warp),
            np.float32)).to(self.device)
        self._window = torch.from_numpy(
            window_function(self.frame_opts)).to(self.device)

    @property
    def dim(self) -> int:
        return self.mel_opts.num_bins + (1 if self.opts.use_energy else 0)

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
        feats, log_energy = mel_energies(
            waveform, self.frame_opts, self.mel_opts, self._window,
            self._mel, self.opts.raw_energy, self.opts.use_power,
            generator)
        if self.opts.use_log_fbank:
            feats = floored_log(feats)
        if self.opts.use_energy:
            col = floored_energy(log_energy, self.opts.energy_floor)[..., None]
            if self.opts.htk_compat:
                return torch.cat([feats, col], dim=-1)
            return torch.cat([col, feats], dim=-1)
        return feats
