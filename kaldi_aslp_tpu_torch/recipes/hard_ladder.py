"""The WER ladder on the hard synthetic corpus: its monophone GMM and
BLSTM-CTC stages.

Port of kaldi_aslp_tpu/recipes/hard_ladder.py (``GMM_BEAM``,
``GMM_MAX_ACTIVE``, ``_Scale`` :77-133, ``run`` :136-331 for
``stages`` among ``mono`` and ``ctc``, ``pruning_sensitivity`` :334,
``__main__`` :352-387; reference protocol: the egs/rm/s5 + aslp_scripts
stage chain: train_mono.sh, decode.sh + score_basic.sh's LMWT sweep, the
aslp_scripts/ctc LSTM-CTC recipe).  The corpus has a third disjoint
speaker set (dev): each stage selects its LMWT (mono) or its (acoustic,
prior) scales (ctc) on dev and scores the test set once at the
selection.

What differs from the JAX ladder, and why:
  - the triphone stage (tri) and the hybrid DNN on its alignments (dnn)
    raise ``NotImplementedError``: they wait for the ``tri`` slice
    (gmm/deltas.py, tree/, fst/context.py; ROADMAP.md queue 1 item 10's
    rest).  The hybrid recipe itself (recipes/hybrid.py) is ported;
  - a mono-only run does not align the training set again with the
    final model (the JAX ladder does it for the tri stage, which is not
    ported);
  - each ``results.jsonl`` row carries the source revision it ran
    from, and the file is truncated at the start of a run (the JAX
    ladder appends rows without provenance);
  - the corpus features, the GMM and the recipes run on ``device`` (the
    card unless the caller asks for the CPU); ``--cpu`` selects the JAX
    backend there and waits (``--device=cpu`` is the port's).

Run: python -m kaldi_aslp_tpu_torch.recipes.hard_ladder [workdir]
     [--small|--medium] --stages=mono,ctc [--device=cpu]
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
from kaldi_aslp_tpu_torch.gmm.diag_gmm import corpus_loglikes
from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu_torch.recipes.ctc import CtcRecipe, CtcRecipeOptions
from kaldi_aslp_tpu_torch.recipes.hard_corpus import (
    HardCorpusOptions,
    build_corpus,
)
from kaldi_aslp_tpu_torch.recipes.score_util import (
    decode_wer_beam,
    decode_wer_dev_test,
)
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("hard_ladder")

STAGES = ("mono", "tri", "dnn", "ctc")
TRI_SLICE = ("the tri slice: gmm/deltas.py, tree/, fst/context.py; "
             "ROADMAP.md queue 1 item 10's rest")
UNPORTED = {"tri": f"the triphone GMM ({TRI_SLICE})",
            "dnn": "the hybrid DNN of ROADMAP.md queue 1 item 8 is "
                   "ported, but this stage trains it on the tri stage's "
                   f"alignments ({TRI_SLICE})"}

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
    (kaldi_aslp_tpu/recipes/hard_ladder.py:77-133, without the tri
    stage's options)."""

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
    lets tests inject a prebuilt corpus dict (build_corpus output).
    The mono and ctc stages are ported; the default, every stage,
    raises as the tri and dnn stages do."""
    stages = list(stages or STAGES)
    for s in stages:
        if s not in STAGES:
            raise ValueError(f"unknown stage {s!r}; stages are {STAGES}")
        if s in UNPORTED:
            raise NotImplementedError(
                f"the {s} stage is not ported yet ({UNPORTED[s]}); run "
                "--stages=mono,ctc")
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
    artifacts: Dict[str, object] = {"corpus": corpus}

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

    if "mono" in stages:
        refs = {u: [lang.words.id(w) for w in t]
                for u, t in corpus["test_texts"].items()}
        dev_refs = {u: [lang.words.id(w) for w in t]
                    for u, t in (corpus.get("dev_texts") or {}).items()}
        mono = MonophoneTrainer(lang, opts=sc.mono, device=device)
        am0, tm0 = mono.train(train_feats, corpus["train_texts"])
        hclg0 = make_decode_graph(lang, G, tm0)
        lut0 = tm0.alignment_to_pdfs(np.arange(tm0.num_transition_ids + 1))
        packed0 = PackedGraph.from_fst(hclg0)
        am_packed = am0.pack(device)
        test_ll0 = corpus_loglikes(test_feats, sorted(test_feats), am_packed)
        if dev_feats:
            dev_ll0 = corpus_loglikes(dev_feats, sorted(dev_feats),
                                      am_packed)
            artifacts["dev_ll_mono"] = dev_ll0
            wer, dev_wer, _ = decode_wer_dev_test(
                packed0, lut0, dev_ll0, dev_refs, test_ll0, refs, 0.1,
                LMWT_RANGE, beam=GMM_BEAM, max_active=sc.gmm_max_active,
                device=device)
        else:
            wer, _ = decode_wer_beam(packed0, lut0, test_ll0, refs, 0.1,
                                     LMWT_RANGE, beam=GMM_BEAM,
                                     max_active=sc.gmm_max_active,
                                     device=device)
            dev_wer = float("nan")
        results["mono"] = wer
        dev_results["mono"] = dev_wer
        artifacts.update(mono=mono, am0=am0, tm0=tm0, hclg0=hclg0,
                         packed0=packed0, lut0=lut0, test_ll0=test_ll0,
                         refs=refs, dev_refs=dev_refs, device=device)
        logger.info("mono WER %.2f (dev %.2f; reference role: egs/rm "
                    "mono 8.74%%, RESULTS:6)", wer, dev_wer)
        emit("mono")

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
                        lmwt_range=LMWT_RANGE):
    """Re-decode the mono stage's test set at a deliberately degraded
    beam: the benchmark is only meaningful if a pruning regression moves
    it.  Returns (healthy_wer, degraded_wer), both at decode_wer_beam's
    default budget, on the device the stage ran on."""
    a = artifacts
    healthy, _ = decode_wer_beam(a["packed0"], a["lut0"], a["test_ll0"],
                                 a["refs"], 0.1, lmwt_range, beam=GMM_BEAM,
                                 device=a["device"])
    degraded, _ = decode_wer_beam(a["packed0"], a["lut0"], a["test_ll0"],
                                  a["refs"], 0.1, lmwt_range,
                                  beam=degraded_beam, device=a["device"])
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
