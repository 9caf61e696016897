"""Context-dependent (triphone) GMM training.

Port of kaldi_aslp_tpu/gmm/deltas.py:44-290 (reference:
egs/wsj/s5/steps/train_deltas.sh: acc-tree-stats -> cluster-phones ->
build-tree -> gmm-init-model -> convert-ali -> align/acc/est loop).

Consumes monophone alignments; produces a decision tree, a CD transition
model and a trained CD GMM, plus the graph compilers to align and decode
with it.  The tree statistics, the tree and the updates are host numpy;
the GMM loglikes, the statistics and the Viterbi alignment run on
``device`` (the card unless the caller asks for the CPU) in float64,
handed out in float32, with one-hot statistics (gmm/diag_gmm.py), so the
card and the CPU make the same choices.

What differs from the JAX module, and why:
  - the statistics take the frames unpadded (JAX pads them to a multiple
    of 16,384 to bound its compiles);
  - ``DeltasTrainer.align`` exists: JAX's ``SatTrainer`` calls
    ``base.align`` but JAX's ``DeltasTrainer`` has none, so SAT over a
    triphone system fails there at its first iteration;
  - ``make_cd_decode_graph`` keeps the raw L o G only when determinize
    raises ``NonDeterminizableError``, and says so in a warning; JAX's
    swallows every ``RuntimeError``.

Transition ids depend on the order in which context windows are
interned, so every step interns in JAX's order: ``compose_context``
visits LG breadth first, ``compose_context_shared`` re-interns a
graph's windows into the trainer's table in their local order, and the
decode graph's windows join the same table after the training graphs'."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph, align_batched
from kaldi_aslp_tpu_torch.fst.context import ContextWindows, compose_context
from kaldi_aslp_tpu_torch.fst.determinize import (
    determinize,
    keep_raw_compose,
    minimize_encoded,
)
from kaldi_aslp_tpu_torch.fst.fst import Fst
from kaldi_aslp_tpu_torch.fst.hclg import expand_hmm_cd, triples_from_tree
from kaldi_aslp_tpu_torch.fst.lang import (
    Lang,
    make_lexicon_fst,
    make_linear_acceptor,
)
from kaldi_aslp_tpu_torch.gmm.diag_gmm import (
    AmDiagGmm,
    GmmStats,
    corpus_loglikes,
    mle_update,
    split_gaussians,
)
from kaldi_aslp_tpu_torch.hmm.topology import HmmTopology
from kaldi_aslp_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_aslp_tpu_torch.tree.build_tree import (
    ContextDependency,
    build_tree,
    stats_from_alignment,
)
from kaldi_aslp_tpu_torch.utils.config import Config
from kaldi_aslp_tpu_torch.utils.device import resolve_device
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("deltas")


@dataclasses.dataclass
class DeltasTrainOptions(Config):
    num_iters: int = 25
    max_iter_inc: int = 15
    totgauss: int = 1000
    num_leaves: int = 200
    realign_iters: str = "5 10 15 20"
    min_gaussian_occupancy: float = 3.0
    tree_min_gain: float = 20.0


class CdGraphCompiler:
    """Per-utterance CD training graphs sharing one window table."""

    def __init__(self, lang: Lang, windows: ContextWindows,
                 sil_prob: float = 0.5):
        self.lang = lang
        self.windows = windows
        self.L = make_lexicon_fst(lang, sil_prob=sil_prob
                                  ).arc_sort("olabel")
        self._clg_cache: Dict[Tuple[int, ...], Fst] = {}

    def compile_clg(self, words: List[str]) -> Fst:
        wids = tuple(self.lang.words.id(w) for w in words)
        if wids not in self._clg_cache:
            lg = self.L.compose(make_linear_acceptor(wids))
            clg, _ = compose_context_shared(lg, self.windows)
            self._clg_cache[wids] = clg
        return self._clg_cache[wids]


def compose_context_shared(lg: Fst, table: ContextWindows
                           ) -> Tuple[Fst, ContextWindows]:
    """``compose_context`` interning into an existing shared table: the
    graph's own window ids are re-interned into ``table`` in their local
    order (first sight in the breadth-first visit)."""
    out, local = compose_context(lg)
    remap = {0: 0}
    for wid in range(1, len(local) + 1):
        remap[wid] = table.id(local.window(wid))
    for s in range(out.num_states):
        for a in out.arcs[s]:
            if a.ilabel != 0:
                a.ilabel = remap[a.ilabel]
    return out, table


class DeltasTrainer:
    def __init__(self, lang: Lang, topo: HmmTopology,
                 opts: Optional[DeltasTrainOptions] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.lang = lang
        self.topo = topo
        self.opts = opts or DeltasTrainOptions()
        self.device = resolve_device(device)
        self.windows = ContextWindows()
        self.compiler = CdGraphCompiler(lang, self.windows)
        self.tree: Optional[ContextDependency] = None
        self.trans_model: Optional[TransitionModel] = None

    def build_tree_from_alignments(
        self,
        feats: Dict[str, np.ndarray],
        mono_trans_model: TransitionModel,
        mono_alignments: Dict[str, np.ndarray],
    ) -> ContextDependency:
        """Stages: acc-tree-stats + cluster-phones + build-tree."""
        stats = None
        for u, ali in mono_alignments.items():
            if u not in feats:
                continue
            phones, pdf_classes = \
                mono_trans_model.alignment_to_phone_pdfclass(ali)
            n = min(len(phones), len(feats[u]))
            stats = stats_from_alignment(
                feats[u][:n], phones[:n], pdf_classes[:n], stats)
        phones = [self.lang.phones.id(p)
                  for p in self.lang.lexicon.phone_set()]
        pdf_classes_per_phone = {
            ph: self.topo.entry(ph).num_pdf_classes for ph in phones}
        self.tree = build_tree(
            stats, phones, pdf_classes_per_phone,
            max_leaves=self.opts.num_leaves,
            min_gain=self.opts.tree_min_gain)
        self._tree_stats = stats
        logger.info("built tree with %d leaves", self.tree.num_pdfs)
        return self.tree

    def init_model(self) -> AmDiagGmm:
        """gmm-init-model: one gaussian per leaf from the tree stats."""
        assert self.tree is not None
        dim = next(iter(self._tree_stats.values())).sum.shape[0]
        P = self.tree.num_pdfs
        counts = np.zeros(P)
        sums = np.zeros((P, dim))
        sqs = np.zeros((P, dim))
        for (window, pc), s in self._tree_stats.items():
            pdf = self.tree.compute(window, pc)
            counts[pdf] += s.count
            sums[pdf] += s.sum
            sqs[pdf] += s.sumsq
        glob_mean = sums.sum(0) / max(counts.sum(), 1.0)
        glob_var = sqs.sum(0) / max(counts.sum(), 1.0) - glob_mean ** 2
        means = np.where(counts[:, None] > 0,
                         sums / np.maximum(counts[:, None], 1.0),
                         glob_mean)
        varis = np.where(
            counts[:, None] > 0,
            np.maximum(sqs / np.maximum(counts[:, None], 1.0)
                       - means ** 2, 1e-3),
            glob_var + 1e-3)
        return AmDiagGmm(
            weights=np.ones((P, 1), np.float32),
            means=means[:, None, :].astype(np.float32),
            vars=varis[:, None, :].astype(np.float32))

    def make_transition_model(self) -> TransitionModel:
        """The transition model over the triples of every window seen so
        far; it becomes ``self.trans_model``."""
        triples = triples_from_tree(self.topo, self.tree, self.windows)
        self.trans_model = TransitionModel(self.topo, triples=triples)
        return self.trans_model

    def train(
        self,
        feats: Dict[str, np.ndarray],
        transcripts: Dict[str, List[str]],
        mono_trans_model: TransitionModel,
        mono_alignments: Dict[str, np.ndarray],
    ) -> Tuple[AmDiagGmm, TransitionModel]:
        opts = self.opts
        utts = [u for u in feats if u in transcripts]
        self.build_tree_from_alignments(feats, mono_trans_model,
                                        mono_alignments)
        clgs = {u: self.compiler.compile_clg(transcripts[u]) for u in utts}
        tm = self.make_transition_model()
        graphs = {u: expand_hmm_cd(clgs[u], tm, self.windows, self.tree)
                  for u in utts}
        lut = tm.alignment_to_pdfs(np.arange(tm.num_transition_ids + 1))

        am = self.init_model()
        alignments = self._align_all(am, graphs, feats, utts, lut)
        am = self._reestimate(am, tm, feats, alignments, utts)

        realign = {int(i) for i in opts.realign_iters.split()}
        cur_gauss = self.tree.num_pdfs
        inc = max(1, (opts.totgauss - cur_gauss)
                  // max(opts.max_iter_inc, 1))
        for it in range(1, opts.num_iters):
            if it in realign:
                alignments = self._align_all(am, graphs, feats, utts, lut)
            if it <= opts.max_iter_inc and cur_gauss < opts.totgauss:
                cur_gauss = min(cur_gauss + inc, opts.totgauss)
                am = split_gaussians(am, cur_gauss, self._last_occ,
                                     seed=it)
            am = self._reestimate(am, tm, feats, alignments, utts)
            # per-iteration progress line (train_deltas.sh "Pass N")
            logger.info("iter %d/%d: %d gauss%s", it, opts.num_iters - 1,
                        cur_gauss,
                        ", realigned (avg ll/frame %.3f)"
                        % self._last_align_ll
                        if it in realign else "")
        self._final_alignments = alignments
        return am, tm

    def _align_all(self, am: AmDiagGmm, graphs, feats, utts,
                   lut: np.ndarray) -> Dict[str, np.ndarray]:
        """Realignment of all utterances: loglikes over concatenated
        frame blocks, then ``align_batched`` over the per-utterance
        training graphs (see MonophoneTrainer._align_all)."""
        lls = corpus_loglikes(feats, utts, am.pack(self.device))
        pgs = {u: PackedGraph.from_fst(graphs[u]) for u in utts}
        res = align_batched(pgs, lut, lls, acoustic_scale=1.0,
                            device=self.device)
        nfr = sum(len(lls[u]) for u in utts)
        self._last_align_ll = (sum(res[u][2] for u in utts)
                               / max(nfr, 1))
        return {u: res[u][1] for u in utts}

    def _reestimate(self, am: AmDiagGmm, tm: TransitionModel, feats,
                    alignments, utts) -> AmDiagGmm:
        """One gmm-acc-stats-ali + gmm-est pass over all utterances, the
        statistics in one call on the device."""
        stats = GmmStats(am, self.device)
        tcounts = None
        all_f, all_p = [], []
        for u in utts:
            pdfs = tm.alignment_to_pdfs(alignments[u])
            n = min(len(pdfs), len(feats[u]))
            all_f.append(feats[u][:n])
            all_p.append(pdfs[:n])
            tcounts = tm.accumulate(alignments[u], tcounts)
        stats.accumulate(am.pack(self.device),
                         np.concatenate(all_f).astype(np.float32),
                         np.concatenate(all_p).astype(np.int64))
        occ, mean_acc, var_acc = stats.to_numpy()
        self._last_occ = occ
        tm.mle_update(tcounts)
        return mle_update(
            am, occ, mean_acc, var_acc,
            min_gaussian_occupancy=self.opts.min_gaussian_occupancy)

    def align(self, am: AmDiagGmm, feats: Dict[str, np.ndarray],
              transcripts: Dict[str, List[str]]) -> Dict[str, np.ndarray]:
        """steps/align_si.sh for the triphone system: CD training graphs
        over ``self.trans_model`` (the training model, or the decode
        model once ``make_cd_decode_graph`` has replaced it), realigned
        as ``train`` realigns.  Returns transition-id alignments of
        ``self.trans_model``."""
        if self.trans_model is None:
            raise RuntimeError("align needs a trained system: call train")
        tm = self.trans_model
        utts = [u for u in feats if u in transcripts]
        clgs = {u: self.compiler.compile_clg(transcripts[u]) for u in utts}
        missing = set(triples_from_tree(self.topo, self.tree, self.windows)
                      ) - set(tm._state_index)
        if missing:
            raise ValueError(
                f"the transcripts reach {len(missing)} (phone, state, pdf) "
                "triples the transition model lacks (new context windows); "
                "call make_transition_model and retrain")
        graphs = {u: expand_hmm_cd(clgs[u], tm, self.windows, self.tree)
                  for u in utts}
        lut = tm.alignment_to_pdfs(np.arange(tm.num_transition_ids + 1))
        return self._align_all(am, graphs, feats, utts, lut)


def make_cd_decode_graph(lang: Lang, G: Fst, trainer: DeltasTrainer,
                         sil_prob: float = 0.5, optimize: bool = True
                         ) -> Tuple[Fst, TransitionModel]:
    """CD HCLG: det+min(L o G) -> C -> H (reference: mkgraph.sh triphone
    path: fsttablecompose | fstdeterminizestar | fstminimizeencoded
    before fstcomposecontext).  Returns (HCLG, the decode transition
    model), which also becomes ``trainer.trans_model``.

    Two of the JAX module's fixes (deltas.py:262-275) stay: LG is
    determinized and minimized as on the monophone path (the raw compose
    carries duplicate-path states that eat the frontier budget at a fixed
    max_active), and the decode transition model, re-enumerated over the
    training and decode windows, copies the trained transition
    probabilities instead of reverting to the topology's priors."""
    trained_tm = trainer.trans_model
    L = make_lexicon_fst(lang, sil_prob=sil_prob).arc_sort("olabel")
    lg = L.compose(G)
    if optimize:
        with keep_raw_compose("the CD graph"):
            lg = minimize_encoded(determinize(lg.remove_epsilon()))
    clg, _ = compose_context_shared(lg, trainer.windows)
    tm = trainer.make_transition_model()
    if trained_tm is not None:
        tm.copy_log_probs_from(trained_tm)
    return expand_hmm_cd(clg, tm, trainer.windows, trainer.tree), tm
