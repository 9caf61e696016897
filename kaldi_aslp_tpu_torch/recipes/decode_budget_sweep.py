"""Frontier-budget (max_active) vs WER sweeps on the hard corpus.

Port of kaldi_aslp_tpu/recipes/decode_budget_sweep.py (``run`` :42-79,
``nn_budget_sweep`` :82-127; reference role: the --max-active/--beam
operating point of decode.sh).  The decoder's per-frame cost is bound by
the frontier budget K and the arc budget A = 4K, independent of graph
size (decoder/beam.py); these measure the dev WER the hard corpus keeps
at descending K, so K is the only variable: ``run`` on the monophone
GMM's loglikes at the ladder's ``GMM_BEAM`` (the weak-acoustics case),
``nn_budget_sweep`` on a trained CTC system at its own settings.

Run: python -m kaldi_aslp_tpu_torch.recipes.decode_budget_sweep [--small]
     [--budgets=2048,1024,512,256,128] [--device=cpu]"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
from kaldi_aslp_tpu_torch.decoder.viterbi import DecodeError, PackedGraph
from kaldi_aslp_tpu_torch.fst import arpa_to_fst, ctc_lut, make_decode_graph
from kaldi_aslp_tpu_torch.gmm.diag_gmm import corpus_loglikes
from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer
from kaldi_aslp_tpu_torch.ops.edit_distance import score_utterances
from kaldi_aslp_tpu_torch.recipes.hard_corpus import build_corpus
from kaldi_aslp_tpu_torch.recipes.hard_ladder import GMM_BEAM, _Scale
from kaldi_aslp_tpu_torch.recipes.score_util import decode_wer_beam
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("budget-sweep")


def run(scale: str = "medium", budgets: Optional[List[int]] = None,
        corpus: Optional[dict] = None,
        device: Union[str, torch.device] = "cuda") -> Dict[int, float]:
    """Dev WER at each frontier budget K of ``budgets`` (default
    2048..128) for the monophone system of ``scale``'s ladder preset,
    decoded at ``GMM_BEAM`` on ``device`` with the LMWT (4..15) selected
    on dev at each K; the test set when the corpus has no dev set.
    ``corpus`` lets a caller inject a prebuilt ``build_corpus`` dict."""
    budgets = budgets or [2048, 1024, 512, 256, 128]
    sc = _Scale(scale)
    if corpus is None:
        corpus = build_corpus(sc.corpus, num_train=sc.num_train,
                              num_test=sc.num_test, num_dev=sc.num_dev,
                              lm_pool_mult=sc.lm_mult, device=device)
    lang = corpus["lang"]
    G = arpa_to_fst(corpus["arpa"], lang.words)
    mono = MonophoneTrainer(lang, opts=sc.mono, device=device)
    am, tm = mono.train(corpus["train_feats"], corpus["train_texts"])
    hclg = make_decode_graph(lang, G, tm)
    lut = tm.alignment_to_pdfs(np.arange(tm.num_transition_ids + 1))
    packed = PackedGraph.from_fst(hclg)
    dev_feats = corpus.get("dev_feats") or corpus["test_feats"]
    dev_texts = corpus.get("dev_texts") or corpus["test_texts"]
    dev_ll = corpus_loglikes(dev_feats, sorted(dev_feats), am.pack(device))
    refs = {u: [lang.words.id(w) for w in s] for u, s in dev_texts.items()}
    logger.info("graph: %d states / %d arcs; %d dev utts",
                hclg.num_states, len(packed.src), len(dev_ll))

    results: Dict[int, float] = {}
    run.seconds = {}
    for K in budgets:
        t0 = time.time()
        wer, _ = decode_wer_beam(packed, lut, dev_ll, refs, 0.1,
                                 range(4, 16), beam=GMM_BEAM,
                                 max_active=K, device=device)
        run.seconds[K] = time.time() - t0
        results[K] = wer
        logger.info("max_active %5d: dev WER %6.2f  (%.1fs)", K, wer,
                    run.seconds[K])
    print("BUDGET_SWEEP " + " ".join(f"{k}={v:.2f}"
                                     for k, v in results.items()))
    return results


def nn_budget_sweep(ctc, dev_feats: Dict[str, np.ndarray],
                    dev_texts: Dict[str, list],
                    budgets: Optional[List[int]] = None
                    ) -> Dict[int, float]:
    """Dev WER at each frontier budget K of ``budgets`` for a trained
    ``CtcRecipe`` (after ``run``): its posteriors over its log priors,
    decoded on its device at its dev-selected acoustic scale
    (``ctc.acoustic_scale``; the JAX version reads the selection back
    from the options, where the JAX recipe writes it) and its decode
    beam (32 when the recipe decoded densely).  An utterance with no
    complete path is scored as a deletion and counted."""
    budgets = budgets or [2048, 1024, 512, 256]
    csr = CsrGraph.from_packed(PackedGraph.from_fst(ctc.tlg))
    lut = ctc_lut(len(ctc.lang.phones) + 1)
    dev_logp = {u: ctc.posteriors(f) - ctc.log_priors
                for u, f in dev_feats.items()}
    results: Dict[int, float] = {}
    for K in budgets:
        dec = BeamSearchDecoder(csr, lut, acoustic_scale=ctc.acoustic_scale,
                                beam=ctc.opts.decode_beam or 32.0,
                                max_active=K, device=ctc.device)
        hyps = {}
        failures = 0
        t0 = time.time()
        for u in sorted(dev_logp):
            try:
                words_out, _, _ = dec.decode(dev_logp[u])
            except DecodeError as e:
                # scored as a full deletion; logged so a degraded column
                # is told apart from a genuine WER loss
                logger.warning("decode failed at K=%d on %s: %s", K, u, e)
                failures += 1
                words_out = []
            hyps[u] = [ctc.lang.words.sym(w) for w in words_out]
        stats = score_utterances(dev_texts, hyps)
        results[K] = stats.wer
        logger.info("NN max_active %5d: dev WER %6.2f  (%.1fs%s)",
                    K, stats.wer, time.time() - t0,
                    f", {failures} decode failures" if failures else "")
    print("NN_BUDGET_SWEEP_DEV " + " ".join(
        f"{k}={v:.2f}" for k, v in results.items()))
    return results


def main(argv: List[str]) -> int:
    scale = "small" if "--small" in argv else "medium"
    budgets, device = None, "cuda"
    for a in argv:
        if a.startswith("--budgets="):
            budgets = [int(x) for x in a.split("=", 1)[1].split(",")]
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
    run(scale, budgets, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
