"""Frontier-budget (max_active) vs WER sweep on a trained CTC system.

Port of kaldi_aslp_tpu/recipes/decode_budget_sweep.py:82-127
(``nn_budget_sweep``; reference role: the --max-active/--beam operating
point of decode.sh).  The decoder's per-frame cost is bound by the
frontier budget K and the arc budget A = 4K, independent of graph size
(decoder/beam.py); this measures the dev WER the hard corpus keeps at
descending K, with the recipe's own settings, so K is the only
variable.

The JAX module's ``run()``, the GMM-side sweep, needs the monophone
stage (ROADMAP.md queue 1 item 10) and is not ported yet."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
from kaldi_aslp_tpu_torch.decoder.viterbi import DecodeError, PackedGraph
from kaldi_aslp_tpu_torch.fst import ctc_lut
from kaldi_aslp_tpu_torch.ops.edit_distance import score_utterances
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("budget-sweep")


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
