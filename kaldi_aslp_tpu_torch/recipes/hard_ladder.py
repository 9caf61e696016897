"""The WER ladder on the hard synthetic corpus: mono -> tri -> dnn -> ctc.

Port of kaldi_aslp_tpu/recipes/hard_ladder.py (``GMM_BEAM``,
``GMM_MAX_ACTIVE``, ``_Scale`` :77-133, ``run`` :136-331,
``pruning_sensitivity`` :334, ``__main__`` :352-387; reference protocol:
the egs/rm/s5 + aslp_scripts stage chain: train_mono.sh, train_deltas.sh,
run_dnn.sh on the triphone alignments, decode.sh + score_basic.sh's LMWT
sweep, the aslp_scripts/ctc LSTM-CTC recipe).  The corpus has a third
disjoint speaker set (dev): each stage selects its LMWT (mono, tri, dnn)
or its (acoustic, prior) scales (ctc) on dev and scores the test set once
at the selection.

What differs from the JAX ladder, and why:
  - the GMM chain runs as far as the asked stages need it: a mono-only
    run neither realigns the training set with the final model nor
    trains the triphones (the JAX ladder does both whenever a GMM stage
    is asked), and the mono decode graph is built only to score mono;
  - each ``results.jsonl`` row carries the source revision it ran
    from, and the file is truncated at the start of a run (the JAX
    ladder appends rows without provenance);
  - the corpus features, the GMMs and the recipes run on ``device`` (the
    card unless the caller asks for the CPU); ``--cpu`` selects the JAX
    backend there and waits (``--device=cpu`` is the port's).

Run: python -m kaldi_aslp_tpu_torch.recipes.hard_ladder [workdir]
     [--small|--medium] [--stages=mono,tri,dnn,ctc] [--device=cpu]
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Union

import torch

import numpy as np

from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph
from kaldi_aslp_tpu_torch.fst import arpa_to_fst, make_decode_graph
from kaldi_aslp_tpu_torch.gmm.deltas import (
    DeltasTrainer,
    DeltasTrainOptions,
    make_cd_decode_graph,
)
from kaldi_aslp_tpu_torch.gmm.diag_gmm import corpus_loglikes
from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu_torch.recipes.ctc import CtcRecipe, CtcRecipeOptions
from kaldi_aslp_tpu_torch.recipes.hard_corpus import (
    HardCorpusOptions,
    build_corpus,
)
from kaldi_aslp_tpu_torch.recipes.hybrid import (
    HybridRecipe,
    HybridRecipeOptions,
)
from kaldi_aslp_tpu_torch.recipes.score_util import (
    decode_wer_beam,
    decode_wer_dev_test,
)
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("hard_ladder")

STAGES = ("mono", "tri", "dnn", "ctc")

# GMM-stage decode beam and frontier budget
# (kaldi_aslp_tpu/recipes/hard_ladder.py:47-71): 96 is past the mono and
# tri stages' saturation knee; the budget is set per scale (_Scale),
# 8192 past small, the nearest power of two to the reference's
# --max-active=7000 (steps/decode.sh)
GMM_BEAM = 96.0
GMM_MAX_ACTIVE = 8192
LMWT_RANGE = range(4, 16)

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Scale:
    """Corpus, GMM and model sizes per scale preset
    (kaldi_aslp_tpu/recipes/hard_ladder.py:77-133)."""

    def __init__(self, name: str):
        self.name = name
        if name == "small":     # suite-sized
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
            self.dnn_hidden, self.dnn_layers, self.dnn_iters = 128, 2, 8
            self.ctc_hidden, self.ctc_layers, self.ctc_iters = 96, 2, 220
            self.gmm_max_active = 2048
        elif name == "medium":
            self.corpus = HardCorpusOptions(
                num_words=1000, num_train_speakers=24,
                num_test_speakers=6, num_dev_speakers=6)
            self.num_train, self.num_test, self.lm_mult = 1500, 100, 4
            self.num_dev = 60
            self.mono = MonoTrainOptions(
                num_iters=12, totgauss=700,
                realign_iters="1 2 3 4 5 6 8 10")
            self.tri = DeltasTrainOptions(
                num_iters=10, totgauss=1200, num_leaves=250,
                realign_iters="2 4 6 8", tree_min_gain=20.0)
            self.dnn_hidden, self.dnn_layers, self.dnn_iters = 256, 3, 12
            self.ctc_hidden, self.ctc_layers, self.ctc_iters = 160, 3, 60
            self.gmm_max_active = GMM_MAX_ACTIVE
        elif name == "full":
            self.corpus = HardCorpusOptions(
                num_words=5000, num_train_speakers=32,
                num_test_speakers=8, num_dev_speakers=8)
            self.num_train, self.num_test, self.lm_mult = 1600, 200, 12
            self.num_dev = 100
            self.mono = MonoTrainOptions(
                num_iters=14, totgauss=1000,
                realign_iters="1 2 3 4 5 6 8 10 12")
            self.tri = DeltasTrainOptions(
                num_iters=12, totgauss=4000, num_leaves=400,
                realign_iters="2 4 6 8 10", tree_min_gain=20.0)
            self.dnn_hidden, self.dnn_layers, self.dnn_iters = 512, 4, 14
            self.ctc_hidden, self.ctc_layers, self.ctc_iters = 320, 3, 60
            self.gmm_max_active = GMM_MAX_ACTIVE
        else:
            raise ValueError(f"unknown scale {name!r}")


def ctc_options(sc: _Scale) -> CtcRecipeOptions:
    """The ladder's CTC stage options (hard_ladder.py:298-303): the
    saddle policy, low frame rate 3, and the beam decoder at beam 32."""
    return CtcRecipeOptions(
        model_type="blstm", hidden_dim=sc.ctc_hidden,
        num_layers=sc.ctc_layers, learn_rate=0.06, auto_saddle=True,
        lfr_skip=3, max_iters=sc.ctc_iters, num_streams=16,
        acoustic_scale=0.9, decode_beam=32.0)


def dnn_options(sc: _Scale) -> HybridRecipeOptions:
    """The ladder's dnn stage options (hard_ladder.py:264-270): a
    sigmoid DNN on 9 spliced frames, decoded by the beam decoder at beam
    32 with the LMWT sweep."""
    return HybridRecipeOptions(
        model_type="dnn", hidden_dim=sc.dnn_hidden,
        num_layers=sc.dnn_layers, splice_context=4, max_iters=sc.dnn_iters,
        learn_rate=0.2, acoustic_scale=0.1,
        lmwt_sweep=" ".join(str(x) for x in LMWT_RANGE), decode_beam=32.0)


def score_gmm_stage(packed: PackedGraph, lut: np.ndarray, am_packed,
                    corpus: dict, refs: Dict[str, list],
                    dev_refs: Dict[str, list], max_active: int,
                    device: Union[str, torch.device]):
    """A GMM stage's decode (beam ``GMM_BEAM``, frontier ``max_active``)
    and score: LMWT selected on dev where the corpus has one (on test
    otherwise: tests inject corpora without one).  Returns (test WER,
    dev WER, test loglikes, dev loglikes)."""
    test_feats = corpus["test_feats"]
    dev_feats = corpus.get("dev_feats") or {}
    test_ll = corpus_loglikes(test_feats, sorted(test_feats), am_packed)
    if not dev_feats:
        wer, _ = decode_wer_beam(packed, lut, test_ll, refs, 0.1, LMWT_RANGE,
                                 beam=GMM_BEAM, max_active=max_active,
                                 device=device)
        return wer, float("nan"), test_ll, {}
    dev_ll = corpus_loglikes(dev_feats, sorted(dev_feats), am_packed)
    wer, dev_wer, _ = decode_wer_dev_test(
        packed, lut, dev_ll, dev_refs, test_ll, refs, 0.1, LMWT_RANGE,
        beam=GMM_BEAM, max_active=max_active, device=device)
    return wer, dev_wer, test_ll, dev_ll


def train_tri(lang, G, mono: MonophoneTrainer, am0, tm0, feats, texts,
              opts: DeltasTrainOptions,
              device: Union[str, torch.device]) -> dict:
    """train_deltas.sh on the monophone system: the training set aligned
    again with the final monophone model, the triphone system trained on
    those alignments, its CD decode graph.  Returns the ladder's
    artifacts of the stage (``tri``: the trainer, ``am1``, ``tm1``: the
    training transition model, ``hclg1``, ``tm1d``: the decode
    transition model, ``lut1``, ``alis0``)."""
    alis0 = mono.align(am0, feats, texts)
    tri = DeltasTrainer(lang, mono.topo, opts, device=device)
    am1, tm1 = tri.train(feats, texts, tm0, alis0)
    hclg1, tm1d = make_cd_decode_graph(lang, G, tri)
    lut1 = tm1d.alignment_to_pdfs(np.arange(tm1d.num_transition_ids + 1))
    return dict(tri=tri, am1=am1, tm1=tm1, hclg1=hclg1, tm1d=tm1d,
                lut1=lut1, alis0=alis0)


def source_revision() -> str:
    """The git revision of the checkout the package runs from, with
    "+dirty" when a tracked file differs from it; where there is no git
    checkout, a digest of the package's sources."""
    root = os.path.dirname(_PACKAGE)

    def git(*args):
        return subprocess.run(["git", *args], cwd=root, capture_output=True,
                              text=True, timeout=60)
    try:
        head = git("rev-parse", "HEAD")
        if head.returncode == 0:
            dirty = git("status", "--porcelain", "--untracked-files=no")
            return head.stdout.strip() + ("+dirty" if dirty.stdout.strip()
                                          else "")
    except (OSError, subprocess.SubprocessError):
        pass
    digest = hashlib.sha256()
    for d, dirs, files in sorted(os.walk(_PACKAGE)):
        dirs[:] = sorted(x for x in dirs if not x.startswith(("_", ".")))
        for f in sorted(files):
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(d, f)
                digest.update(os.path.relpath(path, _PACKAGE).encode())
                with open(path, "rb") as fh:
                    digest.update(fh.read())
    return "sources-" + digest.hexdigest()[:16]


def run(root: str = "exp_hard", scale: str = "full",
        stages: Optional[List[str]] = None,
        corpus: Optional[dict] = None,
        device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """Runs the ladder's stages; returns {stage: test WER}.  ``corpus``
    lets tests inject a prebuilt corpus dict (build_corpus output)."""
    stages = list(stages or STAGES)
    for s in stages:
        if s not in STAGES:
            raise ValueError(f"unknown stage {s!r}; stages are {STAGES}")
    os.makedirs(root, exist_ok=True)
    sc = _Scale(scale)
    t_start = time.time()
    revision = source_revision()
    results_path = os.path.join(root, "results.jsonl")
    open(results_path, "w").close()     # one run's rows per file

    if corpus is None:
        corpus = build_corpus(sc.corpus, num_train=sc.num_train,
                              num_test=sc.num_test, num_dev=sc.num_dev,
                              lm_pool_mult=sc.lm_mult, device=device)
    lang = corpus["lang"]
    G = arpa_to_fst(corpus["arpa"], lang.words)
    train_feats = corpus["train_feats"]
    test_feats = corpus["test_feats"]
    dev_feats = corpus.get("dev_feats") or {}
    logger.info("corpus: %d words, %.0f s train audio, %d/%d/%d utts "
                "(train/dev/test), G %d states", len(corpus["words"]),
                corpus["train_audio_s"], len(train_feats),
                len(dev_feats), len(test_feats), G.num_states)

    results: Dict[str, float] = {}
    dev_results: Dict[str, float] = {}
    artifacts: Dict[str, object] = {"corpus": corpus, "device": device}

    def emit(stage: str) -> None:
        """Append the stage row to <root>/results.jsonl the moment it
        lands, with the revision it ran from."""
        with open(results_path, "a") as f:
            f.write(json.dumps({
                "stage": stage, "scale": scale,
                "test_wer": results.get(stage),
                "dev_wer": dev_results.get(stage),
                "elapsed_s": round(time.time() - t_start, 1),
                "revision": revision,
            }) + "\n")

    refs = {u: [lang.words.id(w) for w in t]
            for u, t in corpus["test_texts"].items()}
    dev_refs = {u: [lang.words.id(w) for w in t]
                for u, t in (corpus.get("dev_texts") or {}).items()}
    artifacts.update(refs=refs, dev_refs=dev_refs)

    # ---- the GMM chain: monophones (train_mono.sh) ----
    if any(s in stages for s in ("mono", "tri", "dnn")):
        mono = MonophoneTrainer(lang, opts=sc.mono, device=device)
        am0, tm0 = mono.train(train_feats, corpus["train_texts"])
        artifacts.update(mono=mono, am0=am0, tm0=tm0)
    if "mono" in stages:
        hclg0 = make_decode_graph(lang, G, tm0)
        lut0 = tm0.alignment_to_pdfs(np.arange(tm0.num_transition_ids + 1))
        packed0 = PackedGraph.from_fst(hclg0)
        wer, dev_wer, test_ll0, dev_ll0 = score_gmm_stage(
            packed0, lut0, am0.pack(device), corpus, refs, dev_refs,
            sc.gmm_max_active, device)
        results["mono"] = wer
        dev_results["mono"] = dev_wer
        artifacts.update(hclg0=hclg0, packed0=packed0, lut0=lut0,
                         test_ll0=test_ll0)
        if dev_ll0:
            artifacts["dev_ll_mono"] = dev_ll0
        logger.info("mono WER %.2f (dev %.2f; reference role: egs/rm "
                    "mono 8.74%%, RESULTS:6)", wer, dev_wer)
        emit("mono")

    # ---- deltas triphones (train_deltas.sh) ----
    if "tri" in stages or "dnn" in stages:
        artifacts.update(train_tri(lang, G, mono, am0, tm0, train_feats,
                                   corpus["train_texts"], sc.tri, device))
    if "tri" in stages:
        wer, dev_wer, _, dev_ll1 = score_gmm_stage(
            PackedGraph.from_fst(artifacts["hclg1"]), artifacts["lut1"],
            artifacts["am1"].pack(device), corpus, refs, dev_refs,
            sc.gmm_max_active, device)
        results["tri"] = wer
        dev_results["tri"] = dev_wer
        if dev_ll1:
            artifacts["dev_ll_tri"] = dev_ll1
        logger.info("tri WER %.2f (dev %.2f; reference role: egs/rm "
                    "tri1 3.26%%, RESULTS:9)", wer, dev_wer)
        emit("tri")

    # ---- hybrid DNN on the triphone alignments (run_dnn.sh on
    # exp/tri ali) ----
    if "dnn" in stages:
        tm1 = artifacts["tm1"]
        pdf_targets = {u: tm1.alignment_to_pdfs(a) for u, a in
                       artifacts["tri"]._final_alignments.items()}
        hyb = HybridRecipe(lang, dnn_options(sc), device=device)
        st = hyb.run(train_feats, corpus["train_texts"], test_feats,
                     corpus["test_texts"], grammar=G,
                     work_dir=os.path.join(root, "dnn"),
                     bootstrap=(pdf_targets, tm1.num_pdfs,
                                artifacts["hclg1"], artifacts["lut1"]),
                     dev_feats=dev_feats or None,
                     dev_texts=corpus.get("dev_texts") or None)
        artifacts["dnn_recipe"] = hyb
        results["dnn"] = st.wer
        dev_results["dnn"] = hyb.last_dev_wer
        logger.info("dnn WER %.2f (dev %.2f; reference role: run_dnn.sh "
                    "on tri alignments)", st.wer, hyb.last_dev_wer)
        emit("dnn")

    if "ctc" in stages:
        ctc = CtcRecipe(lang, ctc_options(sc), device=device)
        st = ctc.run(train_feats, corpus["train_texts"], test_feats,
                     corpus["test_texts"], grammar=G,
                     work_dir=os.path.join(root, "ctc"),
                     dev_feats=dev_feats or None,
                     dev_texts=corpus.get("dev_texts") or None)
        artifacts["ctc_recipe"] = ctc   # the trained system, for probes
        results["ctc"] = st.wer
        dev_results["ctc"] = ctc.dev_wer
        logger.info("blstm-ctc WER %.2f greedy-PER %.2f (reference "
                    "role: aslp_scripts/ctc + egs/hkust DNN<LSTM "
                    "ordering)", st.wer, ctc.greedy_per)
        emit("ctc")

    logger.info("==== WER ladder (hard synthetic corpus, scale=%s; "
                "scales tuned on dev, test reported once) ====", scale)
    for stage, wer in results.items():
        logger.info("  %-5s test %6.2f%%  dev %6.2f%%", stage, wer,
                    dev_results.get(stage, float("nan")))
    logger.info("total %.0fs", time.time() - t_start)
    print("WER_LADDER " + " ".join(f"{k}={v:.2f}"
                                   for k, v in results.items()))
    if dev_results:
        print("WER_LADDER_DEV " + " ".join(
            f"{k}={v:.2f}" for k, v in dev_results.items() if v == v))
    run.artifacts = artifacts   # for probes and tests
    run.dev_results = dev_results
    return results


def pruning_sensitivity(artifacts, degraded_beam: float = 6.0,
                        lmwt_range=LMWT_RANGE,
                        max_utts: Optional[int] = None):
    """Re-decode the mono stage's test set (its first ``max_utts``
    utterances by name, all by default) at a deliberately degraded beam:
    the benchmark is only meaningful if a pruning regression moves it.
    Returns (healthy_wer, degraded_wer), both at decode_wer_beam's
    default budget, on the device the stage ran on."""
    a = artifacts
    utts = sorted(a["test_ll0"])[:max_utts]
    test_ll = {u: a["test_ll0"][u] for u in utts}
    refs = {u: a["refs"][u] for u in utts}
    healthy, _ = decode_wer_beam(a["packed0"], a["lut0"], test_ll, refs,
                                 0.1, lmwt_range, beam=GMM_BEAM,
                                 device=a["device"])
    degraded, _ = decode_wer_beam(a["packed0"], a["lut0"], test_ll, refs,
                                  0.1, lmwt_range, beam=degraded_beam,
                                  device=a["device"])
    logger.info("pruning sensitivity: healthy %.2f vs degraded %.2f "
                "(beam %.0f -> %.0f)", healthy, degraded, GMM_BEAM,
                degraded_beam)
    return healthy, degraded


def main(argv: List[str]) -> int:
    args = [a for a in argv if not a.startswith("--")]
    root = args[0] if args else "exp_hard"
    scale, stages, device = "full", None, "cuda"
    for a in argv:
        if a in ("--small", "--medium"):
            scale = a[2:]
        elif a.startswith("--stages="):
            stages = a.split("=", 1)[1].split(",")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
    run(root, scale=scale, stages=stages, device=device)
    # the frontier-budget sweep on the freshly trained CTC system
    art = run.artifacts
    if "ctc_recipe" in art and art["corpus"].get("dev_feats"):
        from kaldi_aslp_tpu_torch.recipes.decode_budget_sweep import (
            nn_budget_sweep,
        )
        nn_budget_sweep(art["ctc_recipe"], art["corpus"]["dev_feats"],
                        art["corpus"]["dev_texts"])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
