"""Feature pipeline composition.

Port of kaldi_aslp_tpu/feats/pipeline.py: the reference's per-decode
shell pipe (reference: aslp_scripts/aslp_nnet/decode.sh:116-125 —
``copy-feats | apply-cmvn | add-deltas | splice-feats``) as one chain
that stays on the extractor's device between stages.  As the port's
``Fbank`` and ``Mfcc`` do, it dithers only when given a
``torch.Generator``; without one it gives the JAX pipeline's (undithered)
output whatever ``dither`` says."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from kaldi_aslp_tpu_torch.feats.fbank import Fbank
from kaldi_aslp_tpu_torch.feats.functions import (
    DeltaFeaturesOptions,
    acc_cmvn_stats,
    add_deltas,
    apply_cmvn,
    splice_frames,
)
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
from kaldi_aslp_tpu_torch.feats.mfcc import Mfcc
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.utils.config import Config


@dataclasses.dataclass
class FeaturePipelineOptions(Config):
    feature_type: str = "fbank"  # fbank|mfcc
    num_bins: int = 40           # fbank bins (ASLP recipes use 40)
    samp_freq: float = 16000.0
    dither: float = 1.0
    apply_cmvn: bool = True
    norm_vars: bool = False
    delta_order: int = 0
    splice_left: int = 0
    splice_right: int = 0


class FeaturePipeline:
    """wav → base features → CMVN → deltas → splice, per utterance, on
    ``device``."""

    def __init__(self, opts: Optional[FeaturePipelineOptions] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.opts = opts or FeaturePipelineOptions()
        frame_opts = FrameExtractionOptions(
            samp_freq=self.opts.samp_freq, dither=self.opts.dither
        )
        mel_opts = MelBanksOptions(num_bins=self.opts.num_bins)
        if self.opts.feature_type == "fbank":
            self.base = Fbank(frame_opts, mel_opts, device=device)
        elif self.opts.feature_type == "mfcc":
            # the MFCC keeps its own 23 bins, as in the JAX pipeline
            self.base = Mfcc(frame_opts, MelBanksOptions(), device=device)
        else:
            raise ValueError(f"unknown feature type {self.opts.feature_type}")
        self.device = self.base.device

    @property
    def dim(self) -> int:
        d = self.base.dim
        d *= self.opts.delta_order + 1
        d *= self.opts.splice_left + 1 + self.opts.splice_right
        return d

    def compute_base(self, waveform,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        return self.base(waveform, generator)

    def post_process(self, feats: torch.Tensor,
                     cmvn_stats=None) -> torch.Tensor:
        """CMVN (``cmvn_stats``: a 2 x (dim+1) tensor or array), deltas
        and splicing, as the options ask."""
        if self.opts.apply_cmvn and cmvn_stats is not None:
            stats = torch.as_tensor(cmvn_stats, dtype=torch.float64,
                                    device=feats.device)
            feats = apply_cmvn(feats, stats, self.opts.norm_vars)
        if self.opts.delta_order > 0:
            feats = add_deltas(
                feats, DeltaFeaturesOptions(order=self.opts.delta_order)
            )
        if self.opts.splice_left or self.opts.splice_right:
            feats = splice_frames(
                feats, self.opts.splice_left, self.opts.splice_right
            )
        return feats

    def __call__(self, waveform, cmvn_stats=None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        return self.post_process(self.compute_base(waveform, generator),
                                 cmvn_stats)


def compute_cmvn_stats_per_spk(
    feats_by_utt: Dict[str, torch.Tensor], utt2spk: Dict[str, str]
) -> Dict[str, torch.Tensor]:
    """Per-speaker 2 x (dim+1) float64 stats on the features' device
    (reference: steps/compute_cmvn_stats.sh)."""
    stats: Dict[str, torch.Tensor] = {}
    for utt, feats in feats_by_utt.items():
        spk = utt2spk.get(utt, utt)
        stats[spk] = acc_cmvn_stats(feats, stats.get(spk))
    return stats
