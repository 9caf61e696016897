"""HKUST-shaped Mandarin syllable-CTC recipe: the prepare_syllable_ctc
chain driven end-to-end to WER.

Port of kaldi_aslp_tpu/recipes/hkust_synth.py.  Reference protocol:
aslp_scripts/syllable/prepare_syllable_ctc.sh — convert the phone
lexicon to syllables (convert_lexicon_to_syllable.py: initial consonant
+ tonal final → one syllable unit), count syllables over the training
transcripts, tone-bind low-frequency syllables to their majority tone
variant (bind_syllable.py:13-31, bind_lexicon.py:14-22), then train CTC
on the syllable units and decode through the syllable-level TLG
(aslp_scripts/ctc/make_ctc_graph.sh role).  Task shape: egs/hkust/s5 —
conversational Mandarin where the published ladder has LSTM-CTC beating
the DNN hybrid (RESULTS:13-18).

The corpus is the hard-corpus protocol (speaker warp, swept SNR, channel
tilt, held-out LM pool) over a pinyin-like tonal inventory: initials are
frication-heavy, finals carry vowel formants, and TONE IS PITCH ONLY —
tone variants of a final share formants and differ in the f0
multiplier, so tone identity must be read from harmonics relative to the
(unknown, 90-220 Hz) speaker f0, the cue structure of real Mandarin.

The lexicon and the waves are the JAX module's numpy code on the same
seeds, so both packages synthesize the same corpus bit for bit.  The
features (MFCC + pitch, deltas, per-speaker CMVN), the BLSTM's CTC
training (the CTC pair, ``ctc_alpha_beta``, one launch a loss
evaluation) and the beam decode run on ``device``, the card unless the
caller asks for the CPU.  ``max_iters``, ``num_decode`` and
``num_train`` cut the schedule, the decoded test utterances (the first
by name) and the training utterances; 0 keeps the preset's.

Run: python -m kaldi_aslp_tpu_torch.recipes.hkust_synth [root] [--small]
     [--device=cpu]
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.fst import Lang
from kaldi_aslp_tpu_torch.fst.lang import arpa_to_fst
from kaldi_aslp_tpu_torch.recipes.ctc import CtcRecipe, CtcRecipeOptions
from kaldi_aslp_tpu_torch.recipes.hard_corpus import (
    HardCorpusOptions,
    build_corpus,
)
from kaldi_aslp_tpu_torch.recipes.syllable import prepare_syllable_units
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("hkust-synth")

INITIALS = ["b", "d", "g", "zh", "sh", "m", "n", "l",
            "h", "z", "c", "s"]
FINALS = ["a", "e", "i", "u", "ai", "ei", "ao", "ou", "an", "en"]
TONES = [1, 2, 3, 4]
# tone = pitch only: same formants, distinct f0 multiplier
TONE_F0 = {1: 1.55, 2: 1.2, 3: 0.75, 4: 0.95}


def phone_param_table() -> Dict[str, Tuple[float, float, float, float]]:
    """(F1, F2, frication, f0 multiplier) per pinyin-like phone."""
    out: Dict[str, Tuple[float, float, float, float]] = {}
    for i, ini in enumerate(INITIALS):
        # consonant space: low F1, spread F2, heavy frication
        out[ini] = (260.0 + 28.0 * i, 1500.0 + 160.0 * i, 0.55, 1.0)
    for j, fin in enumerate(FINALS):
        f1 = 420.0 + 95.0 * j
        f2 = 2400.0 - 130.0 * j
        for t in TONES:
            out[f"{fin}{t}"] = (f1, f2, 0.04, TONE_F0[t])
    return out


def make_pinyin_lexicon(num_words: int, seed: int = 4321,
                        max_sylls: int = 3) -> str:
    """Word → phone-sequence lexicon where words are 1-3 syllables,
    each an (optional) initial + tonal final — the phone-level lexicon
    the reference's convert_lexicon_to_syllable.py consumes."""
    rng = np.random.RandomState(seed)
    sylls: List[Tuple[str, ...]] = []
    for ini in INITIALS:
        for fin in FINALS:
            for t in TONES:
                sylls.append((ini, f"{fin}{t}"))
    for fin in FINALS:
        for t in TONES:
            sylls.append((f"{fin}{t}",))
    # Zipf over the syllable inventory (real Mandarin syllable
    # frequencies are heavy-tailed — this is what makes tone binding
    # meaningful: rare tone variants get bound to the majority tone)
    zipf = 1.0 / np.arange(1, len(sylls) + 1) ** 1.1
    zipf /= zipf.sum()
    order = rng.permutation(len(sylls))
    prob = np.empty(len(sylls))
    prob[order] = zipf

    prons: List[Tuple[str, ...]] = []
    seen = set()
    while len(prons) < num_words:
        n = 1 + rng.randint(max_sylls)
        parts: List[str] = []
        for _ in range(n):
            parts.extend(sylls[rng.choice(len(sylls), p=prob)])
        p = tuple(parts)
        if p not in seen:
            seen.add(p)
            prons.append(p)
    lines = ["<SIL> SIL"]
    for w, p in enumerate(prons):
        lines.append(f"W{w:05d} " + " ".join(p))
    return "\n".join(lines) + "\n"


class _Scale:
    def __init__(self, name: str):
        # Schedule policy is the SAME as recipes/hard_ladder.py: base
        # lr 0.06 with the automatic saddle detector (train/saddle.py).
        # The ~160-200-unit syllable inventory deepens CTC's all-blank
        # saddle (the JAX package measured: lr 0.06 never crossed —
        # plateau 0.73, SER 100%; lr 0.2 crossed at ~500 steps) — the
        # detector discovers that by escalating the held lr instead of a
        # human re-tuning keep_lr_iters per corpus.
        if name == "small":
            self.num_words = 120
            self.corpus = HardCorpusOptions(
                num_words=120, num_train_speakers=8,
                num_test_speakers=3)
            self.num_train, self.num_test, self.lm_mult = 60, 20, 8
            self.hidden, self.layers, self.iters = 96, 2, 220
            self.bind_thresh = 6
            self.learn_rate = 0.06
        else:                   # medium
            self.num_words = 1000
            self.corpus = HardCorpusOptions(
                num_words=1000, num_train_speakers=24,
                num_test_speakers=6)
            self.num_train, self.num_test, self.lm_mult = 500, 100, 10
            self.hidden, self.layers, self.iters = 160, 3, 80
            self.bind_thresh = 12
            self.learn_rate = 0.06


def build_hkust_corpus(scale: str = "medium",
                       device: Union[str, torch.device] = "cuda",
                       num_train: int = 0) -> dict:
    """The recipe's corpus at a preset: the harmonic source (tone is
    f0-only, so the voiced excitation must be a true harmonic series)
    and 3-dim pitch pasted onto the MFCCs (cepstra discard f0; the
    reference's own Mandarin protocol, egs/hkust/s5 make_mfcc_pitch.sh),
    the features on ``device``."""
    sc = _Scale(scale)
    params = phone_param_table()
    params["SIL"] = (300.0, 1400.0, 0.02, 0.0)   # near-silent hum
    return build_corpus(sc.corpus, num_train=num_train or sc.num_train,
                        num_test=sc.num_test, lm_pool_mult=sc.lm_mult,
                        lexicon_text=make_pinyin_lexicon(sc.num_words),
                        phone_params=params, use_pitch=True,
                        harmonic_source=True, device=device)


def run(root: str = "exp_hkust_synth", scale: str = "medium",
        corpus: Optional[dict] = None,
        device: Union[str, torch.device] = "cuda",
        max_iters: int = 0, num_decode: int = 0,
        num_train: int = 0) -> Dict[str, float]:
    """The recipe on ``device``; returns {"ctc": WER, "greedy_ser": SER}
    and leaves its pieces in ``run.artifacts``."""
    os.makedirs(root, exist_ok=True)
    sc = _Scale(scale)
    t0 = time.time()
    if corpus is None:
        corpus = build_hkust_corpus(scale, device, num_train)
    logger.info("corpus: %d words, %.0f s train audio, %d/%d utts",
                len(corpus["words"]), corpus["train_audio_s"],
                len(corpus["train_feats"]), len(corpus["test_feats"]))

    # ---- syllable unit prep (prepare_syllable_ctc.sh stages) ----
    units = prepare_syllable_units(
        corpus["lexicon"],
        corpus["train_texts"].values(),
        bind_thresh=sc.bind_thresh,
        keep_phones=("SIL",))
    n_bound = sum(1 for k, v in units.bind.items() if k != v)
    logger.info("syllable units: %d (of %d raw; %d tone-bound)",
                len(units.syllable_ids), len(units.syllable_table),
                n_bound)

    # a Lang whose "phones" ARE the bound syllables: the CTC recipe,
    # TLG build and decode then work verbatim on syllable units (this
    # is exactly the reference's move — the syllable lexicon replaces
    # the phone lexicon in make_ctc_graph.sh)
    syl_lang = Lang.build(units.lexicon)

    G = arpa_to_fst(corpus["arpa"], syl_lang.words)
    ctc = CtcRecipe(syl_lang, CtcRecipeOptions(
        model_type="blstm", hidden_dim=sc.hidden,
        num_layers=sc.layers, learn_rate=sc.learn_rate,
        auto_saddle=True, lfr_skip=3,
        max_iters=max_iters or sc.iters, num_streams=16,
        acoustic_scale=0.9, decode_beam=16.0), device=device)
    test_utts = sorted(corpus["test_feats"])
    if num_decode:
        test_utts = test_utts[:num_decode]
    st = ctc.run(corpus["train_feats"], corpus["train_texts"],
                 {u: corpus["test_feats"][u] for u in test_utts},
                 {u: corpus["test_texts"][u] for u in test_utts},
                 grammar=G, work_dir=os.path.join(root, "ctc"))
    logger.info("syllable-CTC WER %.2f greedy syllable-ER %.2f "
                "(%.0fs)", st.wer, ctc.greedy_per, time.time() - t0)
    print(f"HKUST_SYLLABLE_CTC_WER {st.wer:.2f} "
          f"GREEDY_SER {ctc.greedy_per:.2f}")
    run.artifacts = dict(corpus=corpus, units=units, n_bound=n_bound,
                         syl_lang=syl_lang, G=G, recipe=ctc, stats=st,
                         test_utts=test_utts)
    return {"ctc": st.wer, "greedy_ser": ctc.greedy_per}


def main(argv: List[str]) -> int:
    args = [a for a in argv if not a.startswith("--")]
    root = args[0] if args else "exp_hkust_synth"
    device = "cuda"
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
    run(root, scale="small" if "--small" in argv else "medium",
        device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
