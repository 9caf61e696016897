"""TIMIT-shaped CD-phone hybrid recipe: the prepare_cd_phone chain
driven end-to-end to WER.

Port of kaldi_aslp_tpu/recipes/timit_synth.py.  Reference protocol:
aslp_scripts/cd_phone/prepare_cd_phone.sh:29-53 — triphone alignments →
segment-level tree stats (one of the equal/kmeans/viterbi/mean
summarizers, src/aslp-bin/aslp-acc-tree-stats-cd-phone-*.cc) → CD-phone
decision tree (cluster_cd_phone.sh) → fake single-pdf topo
(make_fake_topo.sh:22-41) → alignment conversion (aslp-convert-ali
role) → frame-level NN training on CD-phone targets → decode over the
h3-expanded graph (make_h3_graph.sh, aslp-make-h3-transducer.cc
GetHmmAsFst3's minimum-duration chain).  The egs/timit/s5 shape of the
task: a phone-rich corpus where context-dependent whole-phone units are
the modelling layer.

What differs from the JAX recipe, and why:
  - the corpus features, the GMMs and the DNN run on ``device`` (the
    card unless the caller asks for the CPU);
  - ``prepare_cd_phone_system`` keeps the raw L o G only on
    determinize's own ``NonDeterminizableError``, with a warning that
    names it, and lets every other error through; the JAX function
    swallows every ``RuntimeError`` in silence (:122-125), which would
    hide a fault of the graph code.

Run: python -m kaldi_aslp_tpu_torch.recipes.timit_synth [root] [--small]
     [--methods=equal,kmeans,viterbi] [--device=cpu]
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.fst import arpa_to_fst, make_lexicon_fst
from kaldi_aslp_tpu_torch.fst.context import ContextWindows
from kaldi_aslp_tpu_torch.fst.determinize import (
    determinize,
    keep_raw_compose,
    minimize_encoded,
)
from kaldi_aslp_tpu_torch.fst.hclg import expand_hmm_cd, triples_from_tree
from kaldi_aslp_tpu_torch.gmm.deltas import (
    DeltasTrainer,
    DeltasTrainOptions,
    compose_context_shared,
)
from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu_torch.hmm.topology import HmmTopology
from kaldi_aslp_tpu_torch.hmm.transition_model import TransitionModel
from kaldi_aslp_tpu_torch.recipes.hard_corpus import (
    HardCorpusOptions,
    build_corpus,
)
from kaldi_aslp_tpu_torch.recipes.hybrid import (
    HybridRecipe,
    HybridRecipeOptions,
)
from kaldi_aslp_tpu_torch.tree.cd_phone import (
    acc_tree_stats_cd_phone,
    build_cd_phone_tree,
    compile_questions_phone,
    convert_ali_to_cd_phone,
)
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("timit-synth")


class _Scale:
    def __init__(self, name: str):
        self.name = name
        if name == "small":
            self.corpus = HardCorpusOptions(
                num_words=100, num_train_speakers=8,
                num_test_speakers=3, num_dev_speakers=3)
            self.num_train, self.num_test, self.lm_mult = 60, 20, 8
            self.num_dev = 12
            self.mono = MonoTrainOptions(
                num_iters=8, totgauss=400, realign_iters="1 2 3 4 6")
            self.tri = DeltasTrainOptions(
                num_iters=8, totgauss=900, num_leaves=120,
                realign_iters="2 4 6", tree_min_gain=20.0)
            self.cd_leaves = 80
            self.dnn_hidden, self.dnn_layers, self.dnn_iters = 128, 2, 8
        else:                   # medium
            self.corpus = HardCorpusOptions(
                num_words=1000, num_train_speakers=24,
                num_test_speakers=6, num_dev_speakers=6)
            self.num_train, self.num_test, self.lm_mult = 500, 100, 10
            self.num_dev = 60
            self.mono = MonoTrainOptions(
                num_iters=12, totgauss=700,
                realign_iters="1 2 3 4 5 6 8 10")
            self.tri = DeltasTrainOptions(
                num_iters=10, totgauss=2500, num_leaves=250,
                realign_iters="2 4 6 8", tree_min_gain=20.0)
            self.cd_leaves = 200
            self.dnn_hidden, self.dnn_layers, self.dnn_iters = 256, 3, 12


def prepare_cd_phone_system(lang, tm_tri, tri_alis, train_feats,
                            G, num_leaves: int, method: str,
                            min_frames: int = 3,
                            min_gain: float = 20.0):
    """The prepare_cd_phone.sh chain from existing triphone alignments.

    Returns (targets per utt, num_pdfs, decode HCLG, tid→pdf lut)."""
    stats: Dict = {}
    for u, ali in tri_alis.items():
        if u not in train_feats:
            continue
        stats = acc_tree_stats_cd_phone(
            train_feats[u], ali, tm_tri, method=method, stats=stats)
    phones = sorted({w[1] for (w, _) in stats})
    questions = compile_questions_phone(stats, phones)
    tree = build_cd_phone_tree(stats, phones, num_leaves=num_leaves,
                               questions=questions, min_gain=min_gain)
    logger.info("cd-phone tree (%s): %d contexts -> %d cd phones",
                method, len(stats), tree.num_pdfs)

    targets = {u: convert_ali_to_cd_phone(tm_tri, tree, ali,
                                          per_frame=True)
               for u, ali in tri_alis.items()}

    # decode graph: CLG over the same triphone windows, H-expanded
    # with the minimum-duration fake topo (make_h3_graph.sh)
    all_phones = [lang.phones.id(p) for p in lang.lexicon.phone_set()]
    topo = HmmTopology.fake_min_duration(all_phones,
                                         min_frames=min_frames)
    L = make_lexicon_fst(lang).arc_sort("olabel")
    lg = L.compose(G)
    # det+min like the mono/CD decode-graph paths (the raw compose
    # carries duplicate-path states that eat frontier budget at a fixed
    # max_active)
    with keep_raw_compose("the CD-phone graph"):
        lg = minimize_encoded(determinize(lg.remove_epsilon()))
    windows = ContextWindows()
    clg, windows = compose_context_shared(lg, windows)
    tm_cd = TransitionModel(
        topo, triples=triples_from_tree(topo, tree, windows))
    hclg = expand_hmm_cd(clg, tm_cd, windows, tree)
    lut = tm_cd.alignment_to_pdfs(
        np.arange(tm_cd.num_transition_ids + 1))
    return targets, tree.num_pdfs, hclg, lut


def run(root: str = "exp_timit_synth", scale: str = "medium",
        methods: Optional[List[str]] = None,
        corpus: Optional[dict] = None,
        device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """Runs the CD-phone hybrid per stat method; returns
    {method: WER}.  The mono and triphone systems stay in
    ``run.artifacts``."""
    os.makedirs(root, exist_ok=True)
    sc = _Scale(scale)
    methods = methods or ["equal", "kmeans", "viterbi"]
    t0 = time.time()

    if corpus is None:
        corpus = build_corpus(sc.corpus, num_train=sc.num_train,
                              num_test=sc.num_test,
                              num_dev=sc.num_dev,
                              lm_pool_mult=sc.lm_mult, device=device)
    lang = corpus["lang"]
    G = arpa_to_fst(corpus["arpa"], lang.words)
    train_feats = corpus["train_feats"]
    train_texts = corpus["train_texts"]
    logger.info("corpus: %d words, %.0f s train audio",
                len(corpus["words"]), corpus["train_audio_s"])

    # stage 1-2: mono bootstrap → triphone system → alignments
    mono = MonophoneTrainer(lang, opts=sc.mono, device=device)
    am0, tm0 = mono.train(train_feats, train_texts)
    alis0 = mono.align(am0, train_feats, train_texts)
    tri = DeltasTrainer(lang, mono.topo, sc.tri, device=device)
    am1, tm1 = tri.train(train_feats, train_texts, tm0, alis0)
    tri_alis = tri._final_alignments
    logger.info("triphone system: %d pdfs (%.0fs)", tm1.num_pdfs,
                time.time() - t0)
    run.artifacts = dict(corpus=corpus, mono=mono, am0=am0, tm0=tm0,
                         alis0=alis0, tri=tri, am1=am1, tm1=tm1,
                         systems={})

    results: Dict[str, float] = {}
    for method in methods:
        system = prepare_cd_phone_system(
            lang, tm1, tri_alis, train_feats, G, sc.cd_leaves, method)
        run.artifacts["systems"][method] = system
        hyb = HybridRecipe(lang, HybridRecipeOptions(
            model_type="dnn", hidden_dim=sc.dnn_hidden,
            num_layers=sc.dnn_layers, splice_context=4,
            max_iters=sc.dnn_iters, learn_rate=0.2,
            acoustic_scale=0.1,
            lmwt_sweep=" ".join(str(x) for x in range(4, 16)),
            decode_beam=16.0), device=device)
        st = hyb.run(train_feats, train_texts, corpus["test_feats"],
                     corpus["test_texts"], grammar=G,
                     work_dir=os.path.join(root, f"cd_{method}"),
                     bootstrap=system,
                     dev_feats=corpus.get("dev_feats") or None,
                     dev_texts=corpus.get("dev_texts") or None)
        results[method] = st.wer
        logger.info("cd-phone %s: WER %.2f (dev %.2f)", method, st.wer,
                    hyb.last_dev_wer)

    logger.info("==== CD-phone hybrid WER by stat method (scale=%s) "
                "====", scale)
    for m, wer in results.items():
        logger.info("  %-8s %6.2f%%", m, wer)
    logger.info("total %.0fs", time.time() - t0)
    print("CD_PHONE_WER " + " ".join(f"{m}={w:.2f}"
                                     for m, w in results.items()))
    return results


def main(argv: List[str]) -> int:
    args = [a for a in argv if not a.startswith("--")]
    root = args[0] if args else "exp_timit_synth"
    scale = "small" if "--small" in argv else "medium"
    methods, device = None, "cuda"
    for a in argv:
        if a.startswith("--methods="):
            methods = a.split("=", 1)[1].split(",")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
    run(root, scale=scale, methods=methods, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
