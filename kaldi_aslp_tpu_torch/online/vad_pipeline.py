"""VAD-gated streaming feature pipeline.

Port of kaldi_aslp_tpu/online/vad_pipeline.py (reference:
src/aslp-online/online-feature-pipeline.h OnlineVadFeaturePipeline -
features only flow for speech regions; silence is dropped before the
decoder, with utterance segmentation driven by the VAD FSM).

Two gates, chosen by the ``vad`` handed in:
  - an energy ``Vad`` (the default ``EnergyVad``): JAX's rule exactly,
    the log total mel energy against an adaptive noise floor;
  - an ``NnetVad``, which must hold a VAD net: one forward of the net
    over the call's frames, and a frame is voiced where its summed
    silence posterior is below ``sil_posterior_threshold``.  The JAX
    pipeline loads such a net and never runs it (its voicing is always
    the energy rule); the port runs it, and a net that is missing or
    fails to run fails the call.
Either way the voicing is smoothed by the same FSM, per call, and the
same boundary rule marks a speech -> silence transition."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.online.feature_pipeline import (
    OnlineFeatureOptions,
    OnlineFeaturePipeline,
)
from kaldi_aslp_tpu_torch.vad.vad import EnergyVad, NnetVad, Vad, VadOptions


class OnlineVadFeaturePipeline:
    """Wraps an OnlineFeaturePipeline with a frame-level VAD gate.

    accept_waveform returns (speech_frames, segment_boundary): frames
    classified as speech since the last call, plus True when a
    speech->silence transition completed (utterance boundary - the
    decode-thread resets the decoder there,
    reference: decode-thread.cc:162-254)."""

    def __init__(
        self,
        feature_opts: Optional[OnlineFeatureOptions] = None,
        vad: Optional[Vad] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.features = OnlineFeaturePipeline(feature_opts, device=device)
        self.vad = vad or EnergyVad(VadOptions(), device=device)
        self.reset()

    def reset(self) -> None:
        self.features.reset()
        self._in_speech = False
        self._noise_floor: Optional[float] = None

    @property
    def dim(self) -> int:
        return self.features.dim

    def _energy_voicing(self, frames: np.ndarray) -> np.ndarray:
        # voicing score: log total mel energy (logsumexp over log-mel
        # bins) against an adaptive noise floor (running min with slow
        # decay) - absolute thresholds don't transfer across gains
        m = frames.max(axis=1, keepdims=True)
        score = (m[:, 0]
                 + np.log(np.exp(frames - m).sum(axis=1) + 1e-10))
        lo = float(score.min())
        self._noise_floor = (lo if self._noise_floor is None
                             else min(self._noise_floor * 0.99 + lo * 0.01,
                                      lo))
        return score > self._noise_floor + self.vad.opts.energy_threshold

    def accept_waveform(self, samples: np.ndarray
                        ) -> Tuple[np.ndarray, bool]:
        frames = self.features.accept_waveform(samples)
        if len(frames) == 0:
            return np.zeros((0, self.dim), np.float32), False
        if isinstance(self.vad, NnetVad):
            # a net-less NnetVad raises here: no quiet energy fallback
            voiced = self.vad.voiced(self.vad.posteriors(frames))
        else:
            voiced = self._energy_voicing(frames)
        smoothed = self.vad.smooth(voiced)
        boundary = False
        if self._in_speech and not smoothed.any():
            boundary = True
            self._in_speech = False
        elif smoothed.any():
            self._in_speech = True
        return frames[smoothed], boundary
