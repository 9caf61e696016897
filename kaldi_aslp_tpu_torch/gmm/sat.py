"""Speaker-adapted training (SAT) with fMLLR.

Port of kaldi_aslp_tpu/gmm/sat.py (reference: egs/wsj/s5/steps/
train_sat.sh + align_fmllr.sh: per-speaker fMLLR transforms estimated
from alignments, the model re-estimated on transformed features,
iterating).

Wraps a trained system (mono or deltas): estimate per-speaker
W = [A b] from the current model and alignments, apply it to the
features, re-estimate the GMM, repeat.  The gaussian posteriors, the
transforms' application, the alignment and the GMM statistics run on the
base trainer's device; the fMLLR statistics and solves are host numpy
(feats/transforms.py).

What differs from the JAX module: the re-estimation takes all
utterances' frames in one statistics call (JAX one call an utterance);
and a triphone base works, since the port's ``DeltasTrainer`` has
``align`` (JAX's has none, so JAX's SAT over a triphone system fails at
its first iteration)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.feats.transforms import (
    FmllrStats,
    apply_transform,
    estimate_fmllr,
    gmm_gammas_for_alignment,
)
from kaldi_aslp_tpu_torch.gmm.diag_gmm import AmDiagGmm, GmmStats, mle_update
from kaldi_aslp_tpu_torch.utils.config import Config
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("sat")


@dataclasses.dataclass
class SatOptions(Config):
    num_outer_iters: int = 2
    fmllr_min_count: float = 100.0
    min_gaussian_occupancy: float = 3.0


def estimate_speaker_transforms(
    am: AmDiagGmm,
    feats: Dict[str, np.ndarray],
    pdf_alignments: Dict[str, np.ndarray],
    utt2spk: Dict[str, str],
    min_count: float = 100.0,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, np.ndarray]:
    """Per-speaker fMLLR (reference: align_fmllr.sh / fmllr-diag-gmm).

    Returns spk -> [D, D+1]; speakers below ``min_count`` get the
    identity."""
    dim = am.dim
    stats: Dict[str, FmllrStats] = {}
    for utt, pdfs in pdf_alignments.items():
        if utt not in feats:
            continue
        spk = utt2spk.get(utt, utt)
        n = min(len(pdfs), len(feats[utt]))
        gammas, means, inv_vars = gmm_gammas_for_alignment(
            am, feats[utt][:n], np.asarray(pdfs[:n]), device)
        st = stats.setdefault(spk, FmllrStats(dim))
        st.accumulate(feats[utt][:n], means, inv_vars, gammas)
    identity = np.concatenate(
        [np.eye(dim), np.zeros((dim, 1))], axis=1).astype(np.float32)
    return {spk: (estimate_fmllr(st) if st.beta >= min_count else identity)
            for spk, st in stats.items()}


def apply_speaker_transforms(
    feats: Dict[str, np.ndarray],
    transforms: Dict[str, np.ndarray],
    utt2spk: Dict[str, str],
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, np.ndarray]:
    """Each utterance through its speaker's transform (unchanged where
    the speaker has none)."""
    out = {}
    for utt, f in feats.items():
        W = transforms.get(utt2spk.get(utt, utt))
        out[utt] = (apply_transform(f, W, device).cpu().numpy()
                    if W is not None else f)
    return out


class SatTrainer:
    """Outer SAT loop around a trained GMM system
    (reference: train_sat.sh stage order)."""

    def __init__(self, base_trainer, opts: Optional[SatOptions] = None):
        """base_trainer: MonophoneTrainer or DeltasTrainer (anything with
        ``.align(am, feats, transcripts)``, ``.trans_model`` and
        ``.device``)."""
        self.base = base_trainer
        self.opts = opts or SatOptions()

    def train(
        self,
        am: AmDiagGmm,
        feats: Dict[str, np.ndarray],
        transcripts: Dict[str, List[str]],
        utt2spk: Dict[str, str],
    ) -> Tuple[AmDiagGmm, Dict[str, np.ndarray]]:
        tm = self.base.trans_model
        device = self.base.device
        cur_feats = feats
        transforms: Dict[str, np.ndarray] = {}
        for it in range(self.opts.num_outer_iters):
            alis = self.base.align(am, cur_feats, transcripts)
            pdf_alis = {u: tm.alignment_to_pdfs(a) for u, a in alis.items()}
            transforms = estimate_speaker_transforms(
                am, feats, pdf_alis, utt2spk,
                min_count=self.opts.fmllr_min_count, device=device)
            cur_feats = apply_speaker_transforms(feats, transforms, utt2spk,
                                                 device)
            # re-estimate on the adapted features
            utts = [u for u in pdf_alis if u in cur_feats]
            n = {u: min(len(pdf_alis[u]), len(cur_feats[u])) for u in utts}
            stats = GmmStats(am, device)
            stats.accumulate(
                am.pack(device),
                np.concatenate([cur_feats[u][:n[u]] for u in utts]
                               ).astype(np.float32),
                np.concatenate([pdf_alis[u][:n[u]] for u in utts]
                               ).astype(np.int64))
            occ, mean_acc, var_acc = stats.to_numpy()
            am = mle_update(
                am, occ, mean_acc, var_acc,
                min_gaussian_occupancy=self.opts.min_gaussian_occupancy)
            logger.info("SAT iter %d: %d speakers adapted", it + 1,
                        len(transforms))
        return am, transforms
