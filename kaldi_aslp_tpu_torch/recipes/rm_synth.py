"""RM-shaped synthetic recipe: the egs/rm/s5 stage chain at reduced but
realistic scale, on synthesized audio.

Port of kaldi_aslp_tpu/recipes/rm_synth.py.  The real Resource
Management corpus is not redistributable, so the recipe follows the
published protocol shape instead (reference: egs/rm/s5/run.sh —
MFCC+deltas → train_mono.sh → train_deltas.sh triphones → hybrid DNN;
decode via lattice generation + score_basic.sh LMWT sweep;
aslp_scripts/aslp_nnet/run_dnn.sh for the NN stage): a ~60-word
vocabulary over 25 phones with a word-pair-style bigram grammar,
per-phone formant synthesis at 8 kHz, and the same stage ladder
(reference numbers: egs/rm/s5/RESULTS:6 mono 8.74%, :9 tri1 3.26%).

The lexicon, the sentences, the ARPA text and the waves are the JAX
module's numpy code, copied as it is, so both packages synthesize the
same corpus bit for bit.  What differs from the JAX recipe, and why:
  - the features, the GMMs, the decoders and the DNN run on ``device``
    (the card unless the caller asks for the CPU); the MFCCs come from
    the bucketed batch extractor (feats/batch.py);
  - a decode with no path scores as a full deletion only on the
    decoder's own ``DecodeError`` (recipes/score_util.py); the JAX
    recipe catches every ``RuntimeError``, so a fault of the card would
    score as deletions there;
  - as in the JAX recipe, the DNN stage (``HybridRecipe`` without
    ``bootstrap``) trains on its own monophone alignments.

Run: python -m kaldi_aslp_tpu_torch.recipes.rm_synth [workdir] [--small]
     [--device=cpu]
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph
from kaldi_aslp_tpu_torch.feats.batch import compute_batched
from kaldi_aslp_tpu_torch.feats.functions import (
    DeltaFeaturesOptions,
    acc_cmvn_stats,
    add_deltas,
    apply_cmvn,
)
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
from kaldi_aslp_tpu_torch.feats.mfcc import Mfcc, MfccOptions
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.fst import (
    Lang,
    Lexicon,
    arpa_to_fst,
    make_decode_graph,
)
from kaldi_aslp_tpu_torch.gmm.deltas import (
    DeltasTrainer,
    DeltasTrainOptions,
    make_cd_decode_graph,
)
from kaldi_aslp_tpu_torch.gmm.diag_gmm import corpus_loglikes
from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu_torch.recipes.hybrid import (
    HybridRecipe,
    HybridRecipeOptions,
)
from kaldi_aslp_tpu_torch.recipes.score_util import decode_wer_beam
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("rm_synth")

SAMP_FREQ = 8000.0
PHONES = [f"p{i}" for i in range(25)]


def _phone_formants(i: int) -> Tuple[float, float]:
    """Deterministic distinct spectral signature per phone."""
    rng = np.random.RandomState(1000 + i)
    f0 = 120.0 + 40.0 * (i % 7) + rng.uniform(0, 20)
    f1 = 500.0 + 130.0 * i + rng.uniform(0, 50)
    return f0, min(f1, 3600.0)


def make_lexicon(num_words: int, seed: int = 7) -> str:
    rng = np.random.RandomState(seed)
    lines = ["<SIL> SIL"]
    seen = set()
    w = 0
    while w < num_words:
        n = rng.randint(3, 6)
        phones = tuple(rng.choice(len(PHONES), size=n))
        if phones in seen:
            continue
        seen.add(phones)
        lines.append(f"W{w:03d} " + " ".join(PHONES[p] for p in phones))
        w += 1
    return "\n".join(lines) + "\n"


def make_sentences(words: List[str], num: int, seed: int = 11,
                   max_len: int = 8, grammar_seed: int = 5):
    """Word-pair grammar: each word allows a fixed successor set
    (reference: RM's word-pair grammar).  The successor map depends
    only on ``grammar_seed`` so train and test sentences follow the
    SAME grammar (the sentence paths vary with ``seed``)."""
    grng = np.random.RandomState(grammar_seed)
    succ = {w: list(grng.choice(words, size=min(8, len(words)),
                                replace=False)) for w in words}
    rng = np.random.RandomState(seed)
    sents = []
    for _ in range(num):
        w = words[rng.randint(len(words))]
        sent = [w]
        for _ in range(rng.randint(3, max_len)):
            w = succ[w][rng.randint(len(succ[w]))]
            sent.append(w)
        sents.append(sent)
    return sents


def bigram_arpa(sents: List[List[str]], words: List[str]) -> str:
    """Kneser-Ney-free add-one bigram ARPA from the training text
    (prepare_lm.sh role)."""
    from collections import Counter
    uni = Counter()
    bi = Counter()
    for s in sents:
        seq = ["<s>"] + s + ["</s>"]
        for i, w in enumerate(seq):
            uni[w] += 1
            if i:
                bi[(seq[i - 1], w)] += 1
    vocab = ["<s>", "</s>"] + words
    total = sum(uni.values())
    lines = ["\\data\\", f"ngram 1={len(vocab)}",
             f"ngram 2={len(bi)}", "", "\\1-grams:"]
    for w in vocab:
        p = (uni[w] + 1) / (total + len(vocab))
        # harsh backoff: like RM's word-pair grammar, out-of-grammar
        # word pairs should be strongly penalized
        bo = -2.0
        if w == "</s>":
            lines.append(f"{np.log10(p):.4f}\t{w}")
        else:
            lines.append(f"{np.log10(p):.4f}\t{w}\t{bo:.4f}")
    lines.append("")
    lines.append("\\2-grams:")
    for (a, b), c in sorted(bi.items()):
        p = c / uni[a]
        lines.append(f"{np.log10(p):.4f}\t{a} {b}")
    lines += ["", "\\end\\", ""]
    return "\n".join(lines)


def synthesize(lex: Lexicon, sents: List[List[str]], seed: int = 3
               ) -> Dict[str, np.ndarray]:
    """Per-phone formant audio with coarticulation jitter.

    Noise level and per-utterance frequency/gain jitter are chosen so
    the trained GMMs have speech-like log-likelihood dynamic ranges —
    over-clean audio produces near-singular Gaussians whose loglikes
    swing by hundreds per frame and make any finite decode beam
    meaningless (the dense decoder would be the only exact option)."""
    rng = np.random.RandomState(seed)
    pron = {w: prons[0] for w, prons in lex.prons.items()}
    out = {}
    for i, sent in enumerate(sents):
        warp = 1.0 + 0.015 * rng.randn()       # speaker-ish variation
        gain = 1.0 + 0.2 * rng.rand()
        chunks = [np.zeros(int(0.15 * SAMP_FREQ))]
        for w in sent:
            phones = pron[w]
            for j, ph in enumerate(phones):
                pid = PHONES.index(ph)
                f0, f1 = _phone_formants(pid)
                # coarticulation: formants glide from/to the neighbour
                # phones over the phone edges, so triphone modelling has
                # something real to capture (silence context at edges)
                prev_f = _phone_formants(PHONES.index(phones[j - 1])) \
                    if j > 0 else (f0, f1)
                next_f = _phone_formants(PHONES.index(phones[j + 1])) \
                    if j + 1 < len(phones) else (f0, f1)
                dur = 0.06 + 0.05 * rng.rand()
                n = int(dur * SAMP_FREQ)
                t = np.arange(n) / SAMP_FREQ
                u = np.linspace(0.0, 1.0, n)
                # transition profile: first 35% glides in, last 35% out
                lam_in = np.clip(1.0 - u / 0.35, 0.0, 1.0) * 0.5
                lam_out = np.clip((u - 0.65) / 0.35, 0.0, 1.0) * 0.5
                freq0 = (f0 * (1 - lam_in - lam_out)
                         + prev_f[0] * lam_in + next_f[0] * lam_out)
                freq1 = (f1 * (1 - lam_in - lam_out)
                         + prev_f[1] * lam_in + next_f[1] * lam_out)
                phase0 = 2 * np.pi * np.cumsum(freq0) / SAMP_FREQ
                phase1 = 2 * np.pi * np.cumsum(freq1) / SAMP_FREQ
                env = np.hanning(n) ** 0.5
                sig = env * gain * (
                    3000 * np.sin(warp * phase0)
                    + 1500 * np.sin(warp * phase1))
                chunks.append(sig)
            chunks.append(np.zeros(int((0.04 + 0.05 * rng.rand())
                                       * SAMP_FREQ)))
        wave = np.concatenate(chunks)
        wave = wave + 150 * rng.randn(len(wave))
        out[f"utt{i:04d}"] = wave.astype(np.float32)
    return out


def extract_mfcc_deltas(waves: Dict[str, np.ndarray],
                        device: Union[str, torch.device] = "cuda"
                        ) -> Dict[str, np.ndarray]:
    """MFCC + delta + accel with global CMVN (make_mfcc.sh +
    add-deltas, the RM front end), on ``device``; the statistics are
    summed in the waves' order, as the JAX recipe sums them, and the
    features return to the host as float32 numpy arrays."""
    mfcc = Mfcc(FrameExtractionOptions(samp_freq=SAMP_FREQ, dither=0.0),
                MelBanksOptions(num_bins=23), MfccOptions(), device=device)
    raw = compute_batched(mfcc, waves)
    raw = {u: add_deltas(raw[u], DeltaFeaturesOptions()) for u in waves}
    stats = None
    for f in raw.values():
        stats = acc_cmvn_stats(f, stats)
    return {u: apply_cmvn(f, stats).cpu().numpy() for u, f in raw.items()}


def _decode_wer(packed, lut, test_ll, refs, acoustic_scale, lmwt_range,
                device: Union[str, torch.device] = "cuda"
                ) -> Tuple[float, Dict]:
    """Beam-lattice decode + LMWT sweep (decode.sh + score_basic.sh),
    selecting LMWT on the set it scores, as the JAX recipe does.

    Beam 200: the synthetic phones are far more acoustically
    discriminable than real speech, so the optimal path's transient
    deficit against the frame leader (about 80 for mono, more for the
    sharper triphone gaussians, measured in the JAX package) is an order
    larger than on real corpora, where 13-16 suffices."""
    return decode_wer_beam(packed, lut, test_ll, refs, acoustic_scale,
                           lmwt_range, beam=200.0, max_active=4096,
                           lattice_beam=8.0, chunk=128, device=device)


def run(root: str = "exp_rm_synth", num_words: int = 60,
        num_train: int = 300, num_test: int = 80,
        device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """mono, tri1 and dnn stages; returns {stage: test WER}.  The
    trained systems stay in ``run.artifacts``."""
    os.makedirs(root, exist_ok=True)
    t_start = time.time()
    lex_text = make_lexicon(num_words)
    lex = Lexicon.from_text(lex_text)
    lang = Lang.build(lex)
    words = sorted(w for w in lex.prons if w != "<SIL>")
    train_sents = make_sentences(words, num_train, seed=11)
    test_sents = make_sentences(words, num_test, seed=99)
    logger.info("lexicon %d words; %d train / %d test sentences",
                len(words), len(train_sents), len(test_sents))

    train_feats = extract_mfcc_deltas(synthesize(lex, train_sents, 3),
                                      device)
    test_feats = extract_mfcc_deltas(synthesize(lex, test_sents, 4), device)
    train_texts = {f"utt{i:04d}": s for i, s in enumerate(train_sents)}
    test_refs_sym = {f"utt{i:04d}": s for i, s in enumerate(test_sents)}
    test_refs = {u: [lang.words.id(w) for w in s]
                 for u, s in test_refs_sym.items()}

    arpa = bigram_arpa(train_sents, words)
    G = arpa_to_fst(arpa, lang.words)

    results: Dict[str, float] = {}
    lmwt_range = range(1, 11)
    test_utts = sorted(test_feats)

    # ---- stage 1: mono (train_mono.sh) ----
    mono = MonophoneTrainer(lang, opts=MonoTrainOptions(
        num_iters=12, totgauss=800,
        realign_iters="1 2 3 4 5 6 8 10"), device=device)
    am0, tm0 = mono.train(train_feats, train_texts)
    hclg0 = make_decode_graph(lang, G, tm0)
    lut0 = tm0.alignment_to_pdfs(np.arange(tm0.num_transition_ids + 1))
    test_ll0 = corpus_loglikes(test_feats, test_utts, am0.pack(device))
    wer, _ = _decode_wer(PackedGraph.from_fst(hclg0), lut0, test_ll0,
                         test_refs, 0.1, lmwt_range, device)
    results["mono"] = wer
    logger.info("mono WER %.2f (reference RM mono 8.74, RESULTS:6)", wer)

    # ---- stage 2: deltas triphones (train_deltas.sh) ----
    alis = mono.align(am0, train_feats, train_texts)
    tri = DeltasTrainer(lang, mono.topo, DeltasTrainOptions(
        num_iters=10, totgauss=1800, num_leaves=150,
        realign_iters="2 4 6 8", tree_min_gain=20.0), device=device)
    am1, tm1 = tri.train(train_feats, train_texts, tm0, alis)
    hclg1, tm1d = make_cd_decode_graph(lang, G, tri)
    lut1 = tm1d.alignment_to_pdfs(np.arange(tm1d.num_transition_ids + 1))
    test_ll1 = corpus_loglikes(test_feats, test_utts, am1.pack(device))
    wer, _ = _decode_wer(PackedGraph.from_fst(hclg1), lut1, test_ll1,
                         test_refs, 0.1, lmwt_range, device)
    results["tri1"] = wer
    logger.info("tri1 WER %.2f (reference RM tri1 3.26, RESULTS:9)", wer)

    # ---- stage 3: hybrid DNN (run_dnn.sh) ----
    # lr 0.2: no RBM pretraining here (the reference's 0.008 assumes
    # pretrained stacks, aslp_scripts/aslp_nnet/run_dnn.sh)
    hyb = HybridRecipe(lang, HybridRecipeOptions(
        model_type="dnn", hidden_dim=256, num_layers=2,
        splice_context=4, max_iters=12, learn_rate=0.2,
        acoustic_scale=0.1,
        lmwt_sweep=" ".join(str(x) for x in lmwt_range),
        mono_iters=8, mono_totgauss=300), device=device)
    stats = hyb.run(train_feats, train_texts, test_feats,
                    test_refs_sym, grammar=G,
                    work_dir=os.path.join(root, "dnn"))
    results["dnn"] = stats.wer
    logger.info("dnn WER %.2f (reference RM-family hybrid role: "
                "aslp run_dnn.sh)", stats.wer)

    logger.info("==== WER table (synthetic RM-shaped corpus) ====")
    for stage, w in results.items():
        logger.info("  %-5s %.2f%%", stage, w)
    logger.info("total %.0fs", time.time() - t_start)
    print("WER_TABLE " + " ".join(f"{k}={v:.2f}"
                                  for k, v in results.items()))
    run.artifacts = dict(lang=lang, G=G, mono=mono, am0=am0, tm0=tm0,
                         alis0=alis, tri=tri, am1=am1, tm1=tm1,
                         hclg0=hclg0, hclg1=hclg1, dnn_recipe=hyb,
                         train_feats=train_feats, test_feats=test_feats,
                         train_texts=train_texts, test_refs=test_refs_sym)
    return results


def main(argv: List[str]) -> int:
    args = [a for a in argv if not a.startswith("--")]
    root = args[0] if args else "exp_rm_synth"
    device = "cuda"
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
    if "--small" in argv:
        out = run(root, num_words=20, num_train=40, num_test=15,
                  device=device)
    else:
        out = run(root, device=device)
    return 0 if out["dnn"] < 50.0 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
