"""Monophone GMM-HMM training (reference: egs/wsj/s5/steps/train_mono.sh:
gmm-init-mono -> compile-train-graphs -> align-equal-compiled ->
gmm-acc-stats-ali -> gmm-est loop with realignment and gaussian
mixing-up).

Port of kaldi_aslp_tpu/gmm/mono.py:42-187.  The per-iteration structure
mirrors the recipe; the GMM loglikes, the statistics and the Viterbi
alignment run on ``device`` (the card unless the caller asks for the
CPU), the updates on the host.  JAX pads the statistics' frames to a
multiple of 16,384 to bound its compiles; the port does not pad."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.decoder.viterbi import (
    PackedGraph,
    align_batched,
    equal_align,
)
from kaldi_aslp_tpu_torch.fst.hclg import TrainingGraphCompiler
from kaldi_aslp_tpu_torch.fst.lang import Lang
from kaldi_aslp_tpu_torch.gmm.diag_gmm import (
    AmDiagGmm,
    GmmStats,
    corpus_loglikes,
    mle_update,
    split_gaussians,
)
from kaldi_aslp_tpu_torch.hmm.topology import HmmTopology
from kaldi_aslp_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_aslp_tpu_torch.utils.config import Config
from kaldi_aslp_tpu_torch.utils.device import resolve_device
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("mono")


@dataclasses.dataclass
class MonoTrainOptions(Config):
    num_iters: int = 30
    max_iter_inc: int = 20       # last iter on which gaussians increase
    totgauss: int = 300
    initial_beam: float = 6.0    # unused (exact DP), kept for parity
    realign_iters: str = "1 2 3 4 5 6 7 8 9 10 12 14 16 18 20 23 26 29"
    acoustic_scale: float = 0.1  # --transition-scale/--acoustic-scale story
    min_gaussian_occupancy: float = 3.0


def _monophone_pdf_map(topo: HmmTopology):
    """Sequential pdf assignment: (phone, pdf_class) -> pdf id (the
    monophone ContextDependency, reference: gmm-init-mono.cc)."""
    mapping: Dict[Tuple[int, int], int] = {}
    nxt = 0
    for ph in topo.phones:
        for pc in range(topo.entry(ph).num_pdf_classes):
            mapping[(ph, pc)] = nxt
            nxt += 1
    return (lambda phone, pdf_class: mapping[(phone, pdf_class)]), nxt


class MonophoneTrainer:
    def __init__(self, lang: Lang, topo: Optional[HmmTopology] = None,
                 opts: Optional[MonoTrainOptions] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.lang = lang
        self.opts = opts or MonoTrainOptions()
        self.device = resolve_device(device)
        phones = [lang.phones.id(p) for p in lang.lexicon.phone_set()]
        self.topo = topo or HmmTopology.default(
            phones, sil_phones=[lang.sil_phone_id])
        pdf_map, num_pdfs = _monophone_pdf_map(self.topo)
        self.trans_model = TransitionModel(self.topo, pdf_map)
        self.num_pdfs = num_pdfs
        self.compiler = TrainingGraphCompiler(lang, self.trans_model)
        self._tid_pdf_lut = self.trans_model.alignment_to_pdfs(
            np.arange(self.trans_model.num_transition_ids + 1))

    def train(self, feats: Dict[str, np.ndarray],
              transcripts: Dict[str, List[str]]
              ) -> Tuple[AmDiagGmm, TransitionModel]:
        opts = self.opts
        utts = [u for u in feats if u in transcripts]
        dim = next(iter(feats.values())).shape[1]

        # flat start (gmm-init-mono): global mean/var
        allf = np.concatenate([feats[u] for u in utts])
        am = AmDiagGmm.flat_init(self.num_pdfs, dim, allf.mean(0),
                                 allf.var(0) + 1e-3)

        graphs = {u: self.compiler.compile(transcripts[u]) for u in utts}

        # iteration 0: equal alignment
        alignments = {u: equal_align(graphs[u], self.trans_model,
                                     len(feats[u]))
                      for u in utts}
        am = self._reestimate(am, feats, alignments, utts)

        realign_iters = {int(i) for i in opts.realign_iters.split()}
        cur_gauss = self.num_pdfs
        gauss_inc = max(
            1, (opts.totgauss - cur_gauss) // max(opts.max_iter_inc, 1))
        for it in range(1, opts.num_iters):
            if it in realign_iters:
                alignments = self._align_all(am, graphs, feats, utts)
            if it <= opts.max_iter_inc and cur_gauss < opts.totgauss:
                cur_gauss = min(cur_gauss + gauss_inc, opts.totgauss)
                occ = np.asarray(self._last_occ
                                 if hasattr(self, "_last_occ")
                                 else am.weights)
                am = split_gaussians(am, cur_gauss, occ, seed=it)
            am = self._reestimate(am, feats, alignments, utts)
            # per-iteration progress line (the train_mono.sh "Pass N" +
            # gmm-align log-likelihood role)
            logger.info("iter %d/%d: %d gauss%s", it, opts.num_iters - 1,
                        cur_gauss,
                        ", realigned (avg ll/frame %.3f)"
                        % self._last_align_ll
                        if it in realign_iters else "")
        self._final_alignments = alignments
        return am, self.trans_model

    def _reestimate(self, am: AmDiagGmm, feats, alignments, utts
                    ) -> AmDiagGmm:
        """One gmm-acc-stats-ali + gmm-est pass over all utterances, the
        statistics in one call on the device."""
        stats = GmmStats(am, self.device)
        tcounts = None
        all_f, all_p = [], []
        for u in utts:
            pdfs = self.trans_model.alignment_to_pdfs(alignments[u])
            n = min(len(pdfs), len(feats[u]))
            all_f.append(feats[u][:n])
            all_p.append(pdfs[:n])
            tcounts = self.trans_model.accumulate(alignments[u], tcounts)
        stats.accumulate(am.pack(self.device),
                         np.concatenate(all_f).astype(np.float32),
                         np.concatenate(all_p).astype(np.int64))
        occ, mean_acc, var_acc = stats.to_numpy()
        self._last_occ = occ
        self.trans_model.mle_update(tcounts)
        return mle_update(
            am, occ, mean_acc, var_acc,
            min_gaussian_occupancy=self.opts.min_gaussian_occupancy)

    def _align_all(self, am: AmDiagGmm, graphs, feats, utts
                   ) -> Dict[str, np.ndarray]:
        """Realignment of all utterances: loglikes over concatenated
        frame blocks, then ``align_batched`` over the per-utterance
        training graphs."""
        lls = corpus_loglikes(feats, utts, am.pack(self.device))
        pgs = {u: PackedGraph.from_fst(graphs[u]) for u in utts}
        res = align_batched(pgs, self._tid_pdf_lut, lls,
                            acoustic_scale=1.0, device=self.device)
        nfr = sum(len(lls[u]) for u in utts)
        self._last_align_ll = (sum(res[u][2] for u in utts)
                               / max(nfr, 1))
        return {u: res[u][1] for u in utts}

    def align(self, am: AmDiagGmm, feats: Dict[str, np.ndarray],
              transcripts: Dict[str, List[str]]) -> Dict[str, np.ndarray]:
        """steps/align_si.sh equivalent."""
        utts = [u for u in feats if u in transcripts]
        graphs = {u: self.compiler.compile(transcripts[u]) for u in utts}
        return self._align_all(am, graphs, feats, utts)
