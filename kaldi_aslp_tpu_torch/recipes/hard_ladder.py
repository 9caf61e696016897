"""The WER ladder on the hard synthetic corpus: its BLSTM-CTC stage.

Port of kaldi_aslp_tpu/recipes/hard_ladder.py (``_Scale`` :77-133,
``run`` :136-331 for ``stages=["ctc"]``, ``__main__`` :352-387;
reference protocol: the egs/rm/s5 + aslp_scripts stage chain, the CTC
stage being the aslp_scripts/ctc LSTM-CTC recipe).  The corpus has a
third disjoint speaker set (dev): the recipe selects its (acoustic,
prior) scales on dev and scores the test set once at the selection.

What differs from the JAX ladder, and why:
  - only the CTC stage is ported.  The GMM stages (mono, tri) and the
    hybrid DNN raise ``NotImplementedError`` (ROADMAP.md queue 1, items
    10 and 8); a ctc-only run never needs them (CTC labels come from
    the lexicon, not from alignments), so this module imports nothing
    of the GMM chain;
  - each ``results.jsonl`` row carries the source revision it ran
    from, and the file is truncated at the start of a run (the JAX
    ladder appends rows without provenance);
  - the corpus features and the recipe run on ``device`` (the card
    unless the caller asks for the CPU); ``pruning_sensitivity`` and
    ``--cpu`` need the GMM stage or the JAX backend, and wait.

Run: python -m kaldi_aslp_tpu_torch.recipes.hard_ladder [workdir]
     [--small|--medium] --stages=ctc [--device=cpu]
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

from kaldi_aslp_tpu_torch.fst import arpa_to_fst
from kaldi_aslp_tpu_torch.recipes.ctc import CtcRecipe, CtcRecipeOptions
from kaldi_aslp_tpu_torch.recipes.hard_corpus import (
    HardCorpusOptions,
    build_corpus,
)
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("hard_ladder")

STAGES = ("mono", "tri", "dnn", "ctc")
UNPORTED = {"mono": "ROADMAP.md queue 1 item 10 (the GMM-HMM bootstrap)",
            "tri": "ROADMAP.md queue 1 item 10 (the GMM-HMM bootstrap)",
            "dnn": "ROADMAP.md queue 1 item 8 (the hybrid frame-level "
                   "path, on item 10's alignments)"}

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Scale:
    """Corpus and CTC model sizes per scale preset
    (kaldi_aslp_tpu/recipes/hard_ladder.py:77-133, without the GMM and
    DNN stages' options)."""

    def __init__(self, name: str):
        self.name = name
        if name == "small":     # suite-sized
            self.corpus = HardCorpusOptions(
                num_words=100, num_train_speakers=8,
                num_test_speakers=3, num_dev_speakers=3)
            self.num_train, self.num_test, self.lm_mult = 60, 20, 8
            self.num_dev = 12
            self.ctc_hidden, self.ctc_layers, self.ctc_iters = 96, 2, 220
        elif name == "medium":
            self.corpus = HardCorpusOptions(
                num_words=1000, num_train_speakers=24,
                num_test_speakers=6, num_dev_speakers=6)
            self.num_train, self.num_test, self.lm_mult = 1500, 100, 4
            self.num_dev = 60
            self.ctc_hidden, self.ctc_layers, self.ctc_iters = 160, 3, 60
        elif name == "full":
            self.corpus = HardCorpusOptions(
                num_words=5000, num_train_speakers=32,
                num_test_speakers=8, num_dev_speakers=8)
            self.num_train, self.num_test, self.lm_mult = 1600, 200, 12
            self.num_dev = 100
            self.ctc_hidden, self.ctc_layers, self.ctc_iters = 320, 3, 60
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
    Only ``stages=["ctc"]`` is ported; the default, every stage,
    raises as the GMM and DNN stages do."""
    stages = list(stages or STAGES)
    for s in stages:
        if s not in STAGES:
            raise ValueError(f"unknown stage {s!r}; stages are {STAGES}")
        if s in UNPORTED:
            raise NotImplementedError(
                f"the {s} stage is not ported yet ({UNPORTED[s]}); run "
                "--stages=ctc")
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
