"""GMM-based VAD: class-conditional global GMMs + FSM smoothing.

Port of kaldi_aslp_tpu/vad/gmm_vad.py (reference:
aslp_scripts/vad/run_gmm_vad.sh: a silence GMM and a speech GMM trained
on class-split frames by train_diag_gmm.sh with mdl_prefix=sil / voice;
frames classified by log-likelihood ratio before the kSilence/kSpeech
FSM smoothing the other detectors use, src/aslp-vad/vad.cc:34-80).
The ratios of a call's frames are one batch on ``device`` (the card
unless the caller asks for the CPU); the FSM runs on the host."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.gmm.global_gmm import (
    GlobalGmm,
    global_gmm_loglikes,
    init_from_feats,
)
from kaldi_aslp_tpu_torch.vad.vad import Vad, VadOptions


class GmmVad(Vad):
    """Speech if log p(x|speech) - log p(x|sil) > llr_threshold."""

    def __init__(self, sil_gmm: GlobalGmm, speech_gmm: GlobalGmm,
                 opts: Optional[VadOptions] = None,
                 llr_threshold: float = 0.0,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__(opts)
        self.sil_gmm = sil_gmm
        self.speech_gmm = speech_gmm
        self.llr_threshold = llr_threshold
        self.device = device

    def frame_scores(self, feats: np.ndarray) -> np.ndarray:
        """[T, D] -> [T] log-likelihood ratios (one batch on the
        device)."""
        ll_sp = global_gmm_loglikes(feats, *self.speech_gmm.pack(self.device))
        ll_sil = global_gmm_loglikes(feats, *self.sil_gmm.pack(self.device))
        return (ll_sp - ll_sil).cpu().numpy()

    def is_speech_frame(self, frame) -> bool:
        return bool(self.frame_scores(np.asarray(frame)[None])[0]
                    > self.llr_threshold)

    def detect(self, feats: np.ndarray) -> np.ndarray:
        return self.smooth(self.frame_scores(feats) > self.llr_threshold)


def train_gmm_vad(feats: np.ndarray, targets: np.ndarray,
                  num_gauss: int = 32, num_iters: int = 10,
                  opts: Optional[VadOptions] = None,
                  seed: int = 0,
                  device: Union[str, torch.device] = "cuda") -> GmmVad:
    """Train sil + speech GMMs from frames and 0/1 targets
    (the run_gmm_vad.sh prep: ali-derived sil/speech frame split)."""
    feats = np.asarray(feats, np.float32)
    targets = np.asarray(targets)
    sil = init_from_feats(feats[targets == 0], num_gauss,
                          num_iters=num_iters, seed=seed, device=device)
    speech = init_from_feats(feats[targets == 1], num_gauss,
                             num_iters=num_iters, seed=seed + 1,
                             device=device)
    return GmmVad(sil, speech, opts, device=device)
