"""Streaming feature pipeline: incremental fbank or MFCC + sliding-window
CMN.

Port of kaldi_aslp_tpu/online/feature_pipeline.py (reference:
src/aslp-online/online-feature-pipeline.h:159 OnlineFeaturePipeline).
Samples buffer on the host; whenever enough arrive, the finished frames
are computed with the batched extractor on the pipeline's device
(identical values to offline: frames depend only on their own samples),
then sliding-window CMN is applied on the host in float64 over the frames
seen so far.  ``feature_type="mfcc"`` builds ``Mfcc`` with the default
mel options and ``num_ceps``, as the JAX pipeline does (it does not read
``num_mel_bins``); any other type raises."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.feats.fbank import Fbank, FbankOptions
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
from kaldi_aslp_tpu_torch.feats.mfcc import Mfcc, MfccOptions
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.utils.config import Config


@dataclasses.dataclass
class OnlineFeatureOptions(Config):
    feature_type: str = "fbank"  # fbank|mfcc
    samp_freq: float = 16000.0
    num_mel_bins: int = 40
    num_ceps: int = 13
    cmn_window: int = 600
    min_cmn_window: int = 100
    apply_cmn: bool = True


class OnlineFeaturePipeline:
    def __init__(self, opts: Optional[OnlineFeatureOptions] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.opts = opts or OnlineFeatureOptions()
        frame_opts = FrameExtractionOptions(
            samp_freq=self.opts.samp_freq, dither=0.0)
        if self.opts.feature_type == "fbank":
            self._extractor = Fbank(
                frame_opts, MelBanksOptions(num_bins=self.opts.num_mel_bins),
                FbankOptions(), device=device)
        elif self.opts.feature_type == "mfcc":
            self._extractor = Mfcc(
                frame_opts, MelBanksOptions(),
                MfccOptions(num_ceps=self.opts.num_ceps), device=device)
        else:
            # JAX builds MFCC for any other name; the port refuses it
            raise NotImplementedError(
                f"feature_type={self.opts.feature_type!r}: the online "
                "pipeline has fbank and mfcc")
        self._frame_opts = frame_opts
        self.reset()

    def reset(self) -> None:
        self._samples = np.zeros(0, np.float32)
        self._consumed_frames = 0
        self._cmn_sum = np.zeros(self.dim, np.float64)
        self._cmn_frames: list = []

    @property
    def dim(self) -> int:
        return self._extractor.dim

    def accept_waveform(self, samples: np.ndarray) -> np.ndarray:
        """Append samples; return the newly finished post-CMN frames."""
        self._samples = np.concatenate(
            [self._samples, np.asarray(samples, np.float32)])
        opts = self._frame_opts
        total = (1 + (len(self._samples) - opts.window_size)
                 // opts.window_shift
                 if len(self._samples) >= opts.window_size else 0)
        if total <= self._consumed_frames:
            return np.zeros((0, self.dim), np.float32)
        # recompute from the first un-consumed frame's samples
        start_sample = self._consumed_frames * opts.window_shift
        feats = self._extractor(self._samples[start_sample:]).cpu().numpy()
        new = feats[: total - self._consumed_frames]
        self._consumed_frames = total
        return self._apply_cmn(new)

    def _apply_cmn(self, frames: np.ndarray) -> np.ndarray:
        if not self.opts.apply_cmn:
            return frames
        out = np.empty_like(frames)
        for i, f in enumerate(frames):
            self._cmn_frames.append(f)
            self._cmn_sum += f
            if len(self._cmn_frames) > self.opts.cmn_window:
                self._cmn_sum -= self._cmn_frames.pop(0)
            # warm-up frames are normalized by the mean so far, as in the
            # JAX pipeline (the reference falls back to global stats)
            out[i] = f - self._cmn_sum / max(len(self._cmn_frames), 1)
        return out
