"""Hard synthetic corpus: the parity benchmark that can actually fail.

The round-2 verdict's top item: yesno/ls_synth/rm_synth all saturate
(0-6% WER floors), so no acoustic-model or pruning regression is
detectable.  This generator produces a corpus whose difficulty is
CONTROLLED, with the error sources real corpora have (reference
protocol roles: egs/rm, egs/timit, egs/hkust data prep):

  * confusable phone inventory — 40 phones in 8 clusters of 5; within a
    cluster the first formant differs by only ~42 Hz, far less than the
    inter-speaker warp (±12%), so phone identity is NOT decodable from
    raw spectrum without speaker normalization + context;
  * minimal-pair-rich lexicon — a configurable fraction of words are
    single-phone mutations of other words WITHIN the same cluster, the
    synthetic analogue of rhyme-dense vocabularies;
  * per-speaker variation — vocal-tract warp, speaking rate, channel
    tilt (one-pole filter), f0 and gain, with DISJOINT train/test
    speaker sets (the TIMIT/HKUST protocol property);
  * swept-SNR additive noise — every utterance gets its own SNR drawn
    from a range, so systems are graded over a difficulty continuum;
  * held-out LM text — decode LMs are estimated from a text pool
    sampled from the same sentence model but disjoint from the
    acoustic transcripts (egs/librispeech's external-LM protocol).

Difficulty is calibrated so the GMM monophone stage lands well off the
floor and NN stages land mid-range — a 10% pruning or acoustic-model
regression moves WER measurably (tests/test_hard_ladder.py asserts the
ladder ordering AND the benchmark's sensitivity).

Port of kaldi_aslp_tpu/recipes/hard_corpus.py: the synthesis is a numpy
copy with the same seeds, so it gives the same waves bit for bit; the
front end (MFCC, optional pitch, deltas, per-speaker CMVN) runs on the
port's feats/ on a device, the card unless the caller asks for the
CPU."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.feats.batch import compute_batched
from kaldi_aslp_tpu_torch.feats.functions import (
    acc_cmvn_stats,
    add_deltas,
    apply_cmvn,
)
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
from kaldi_aslp_tpu_torch.feats.mfcc import Mfcc, MfccOptions
from kaldi_aslp_tpu_torch.feats.pitch import (
    PitchOptions,
    compute_pitch_batched,
    postprocess_pitch,
)
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.fst.lang import Lang, Lexicon
from kaldi_aslp_tpu_torch.utils.config import Config

SAMP_FREQ = 8000.0
NUM_CLUSTERS = 8
CLUSTER_SIZE = 5
NUM_PHONES = NUM_CLUSTERS * CLUSTER_SIZE
PHONES = [f"p{i:02d}" for i in range(NUM_PHONES)]


@dataclasses.dataclass
class HardCorpusOptions(Config):
    num_words: int = 5000
    minimal_pair_frac: float = 0.4   # fraction of words built as
    #                                  single-phone mutations of others
    num_train_speakers: int = 32
    num_test_speakers: int = 8
    num_dev_speakers: int = 4        # third DISJOINT speaker set: all
    #                                  tuning (LMWT, beams, schedules)
    #                                  selects on dev, test is reported
    #                                  once (the egs/timit dev/test
    #                                  discipline)
    snr_lo_db: float = 5.0           # swept per-utterance SNR range
    snr_hi_db: float = 20.0
    warp_lo: float = 0.88            # per-speaker vocal-tract warp
    warp_hi: float = 1.12
    rate_lo: float = 0.8             # per-speaker speaking rate
    rate_hi: float = 1.3
    sent_len_lo: int = 4
    sent_len_hi: int = 10
    succ_per_word: int = 30          # sentence-model branching factor
    seed: int = 1234


def phone_formants(pid: int) -> Tuple[float, float]:
    """Clustered layout: in-cluster F1 spacing (42 Hz) << speaker warp
    excursion, so phones only separate after speaker normalization."""
    c, k = pid // CLUSTER_SIZE, pid % CLUSTER_SIZE
    f1 = 380.0 + 340.0 * c + 42.0 * k
    f2 = 1150.0 + 310.0 * ((c * 3 + k) % NUM_CLUSTERS) \
        + 55.0 * ((k * 2 + c) % CLUSTER_SIZE)
    return f1, min(f2, 3500.0)


def make_lexicon(opts: HardCorpusOptions) -> str:
    """Minimal-pair-rich lexicon text ("W00000 p03 p17 ...")."""
    rng = np.random.RandomState(opts.seed)
    prons: List[Tuple[int, ...]] = []
    seen = set()
    num_base = int(opts.num_words * (1.0 - opts.minimal_pair_frac))
    while len(prons) < num_base:
        n = rng.randint(3, 7)
        p = tuple(int(x) for x in rng.randint(0, NUM_PHONES, n))
        if p not in seen:
            seen.add(p)
            prons.append(p)
    # minimal pairs: mutate ONE phone of an existing word to a sibling
    # in the SAME cluster (maximally confusable alternative)
    while len(prons) < opts.num_words:
        base = prons[rng.randint(len(prons))]
        pos = rng.randint(len(base))
        old = base[pos]
        sib = (old // CLUSTER_SIZE) * CLUSTER_SIZE \
            + rng.randint(CLUSTER_SIZE)
        if sib == old:
            continue
        p = base[:pos] + (sib,) + base[pos + 1:]
        if p not in seen:
            seen.add(p)
            prons.append(p)
    lines = ["<SIL> SIL"]
    for w, p in enumerate(prons):
        lines.append(f"W{w:05d} " + " ".join(PHONES[i] for i in p))
    return "\n".join(lines) + "\n"


@dataclasses.dataclass
class Speaker:
    warp: float
    rate: float
    tilt: float
    f0: float
    gain: float


def make_speakers(n: int, opts: HardCorpusOptions, seed: int
                  ) -> List[Speaker]:
    rng = np.random.RandomState(seed)
    return [
        Speaker(
            warp=float(rng.uniform(opts.warp_lo, opts.warp_hi)),
            rate=float(rng.uniform(opts.rate_lo, opts.rate_hi)),
            tilt=float(rng.uniform(-0.3, 0.6)),
            f0=float(rng.uniform(90.0, 220.0)),
            gain=float(rng.uniform(0.7, 1.3)),
        )
        for _ in range(n)
    ]


class SentenceModel:
    """Zipf unigram + fixed per-word successor sets: the text source
    for transcripts AND the (disjoint) LM pool."""

    def __init__(self, words: Sequence[str], opts: HardCorpusOptions):
        self.words = list(words)
        self.opts = opts
        rng = np.random.RandomState(opts.seed + 77)
        n = len(self.words)
        zipf = 1.0 / np.arange(1, n + 1) ** 1.05
        order = rng.permutation(n)
        self.unigram = np.empty(n)
        self.unigram[order] = zipf / zipf.sum()
        k = min(opts.succ_per_word, n)
        # successor sets sampled by unigram weight (frequent words
        # appear in many contexts, like real text)
        self.succ = np.stack([
            rng.choice(n, size=k, replace=False, p=self.unigram)
            for _ in range(n)
        ])

    def sample(self, num: int, seed: int) -> List[List[str]]:
        rng = np.random.RandomState(seed)
        opts = self.opts
        n = len(self.words)
        out = []
        for _ in range(num):
            w = int(rng.choice(n, p=self.unigram))
            sent = [w]
            for _ in range(rng.randint(opts.sent_len_lo,
                                       opts.sent_len_hi + 1)):
                w = int(self.succ[w][rng.randint(self.succ.shape[1])])
                sent.append(w)
            out.append([self.words[i] for i in sent])
        return out


def default_phone_params() -> Dict[str, Tuple[float, float, float,
                                              float]]:
    """The clustered 40-phone inventory as a generic phone-parameter
    table: phone → (F1, F2, frication 0..1, f0 multiplier)."""
    out = {}
    for pid, name in enumerate(PHONES):
        f1, f2 = phone_formants(pid)
        out[name] = (f1, f2, 0.35 if pid % 3 == 0 else 0.05, 1.0)
    return out


def synthesize_utt(pron_seq: List[List[str]], spk: Speaker,
                   snr_db: float, rng: np.random.RandomState,
                   phone_params: Optional[Dict[str, Tuple]] = None,
                   harmonic_source: bool = False,
                   ) -> np.ndarray:
    """One utterance: formant synthesis with coarticulation glides,
    speaker warp/rate/channel, then additive noise at ``snr_db``.

    ``phone_params`` maps phone → (F1, F2, frication, f0 multiplier);
    None uses the clustered 40-phone inventory.

    ``harmonic_source`` switches the voiced excitation from three
    additive sinusoids (f0 + two formant tones — the ladder corpus, kept
    for its published numbers) to a source-filter model: harmonics of
    spk.f0·f0m with amplitudes shaped by Lorentzian formant resonances
    at the glided (F1, F2).  Only the harmonic model makes f0 a REAL
    acoustic cue — in the additive model the f0 sine is ~7% of the
    energy and NCCF pitch tracking locks to the formant periods instead
    — so tonal inventories (recipes/hkust_synth.py, where tone is pitch
    only) require it, exactly as real Mandarin requires pitch features
    (egs/hkust/s5 make_mfcc_pitch.sh)."""
    params = phone_params or default_phone_params()
    chunks = [np.zeros(int(0.1 * SAMP_FREQ))]
    for phones in pron_seq:
        rows = [params[p] for p in phones]
        for j, (f1, f2, fric, f0m) in enumerate(rows):
            prev = rows[j - 1][:2] if j > 0 else (f1, f2)
            nxt = rows[j + 1][:2] if j + 1 < len(rows) else (f1, f2)
            dur = (0.045 + 0.05 * rng.rand()) * spk.rate
            n = max(int(dur * SAMP_FREQ), 8)
            u = np.linspace(0.0, 1.0, n)
            lam_in = np.clip(1.0 - u / 0.35, 0.0, 1.0) * 0.5
            lam_out = np.clip((u - 0.65) / 0.35, 0.0, 1.0) * 0.5
            g1 = (f1 * (1 - lam_in - lam_out) + prev[0] * lam_in
                  + nxt[0] * lam_out) * spk.warp
            g2 = (f2 * (1 - lam_in - lam_out) + prev[1] * lam_in
                  + nxt[1] * lam_out) * spk.warp
            env = np.hanning(n) ** 0.5
            if harmonic_source:
                f0_hz = spk.f0 * f0m
                if f0_hz > 1.0:
                    nyq = SAMP_FREQ / 2.0
                    K = max(1, int((nyq - 200.0) / f0_hz))
                    k = np.arange(1, K + 1, dtype=np.float64)
                    fk = (k * f0_hz)[:, None]          # [K, 1]
                    bw = 180.0
                    amp = (2600.0 / (1 + ((fk - g1[None, :]) / bw) ** 2)
                           + 1400.0 / (1 + ((fk - g2[None, :]) / bw) ** 2)
                           + 60.0)                      # [K, n]
                    phase = (2 * np.pi * fk * np.arange(n) / SAMP_FREQ
                             + rng.uniform(0, 2 * np.pi, (K, 1)))
                    voiced = (amp * np.sin(phase)).sum(axis=0)
                    v_rms = np.sqrt(np.mean(voiced ** 2) + 1e-8)
                    voiced *= 2200.0 / v_rms
                else:
                    voiced = np.zeros(n)
                sig = env * spk.gain * (
                    (1 - fric) * voiced + 3000 * fric * rng.randn(n))
            else:
                ph0 = 2 * np.pi * np.cumsum(
                    np.full(n, spk.f0 * f0m)) / SAMP_FREQ
                ph1 = 2 * np.pi * np.cumsum(g1) / SAMP_FREQ
                ph2 = 2 * np.pi * np.cumsum(g2) / SAMP_FREQ
                sig = env * spk.gain * (
                    800 * np.sin(ph0)
                    + 2600 * (1 - fric) * np.sin(ph1)
                    + 1400 * (1 - fric) * np.sin(ph2)
                    + 3000 * fric * rng.randn(n)
                )
            chunks.append(sig)
        chunks.append(np.zeros(int((0.02 + 0.04 * rng.rand())
                                   * SAMP_FREQ)))
    wave = np.concatenate(chunks)
    # channel: per-speaker one-pole tilt
    wave = wave - spk.tilt * np.concatenate([[0.0], wave[:-1]])
    # swept-SNR additive noise
    rms = np.sqrt(np.mean(wave ** 2) + 1e-8)
    noise_rms = rms / (10.0 ** (snr_db / 20.0))
    wave = wave + noise_rms * rng.randn(len(wave))
    return wave.astype(np.float32)


def synthesize_set(
    lex_prons: Dict[str, List[List[str]]],
    sents: List[List[str]],
    speakers: List[Speaker],
    opts: HardCorpusOptions,
    seed: int,
    prefix: str = "utt",
    phone_params: Optional[Dict[str, Tuple]] = None,
    harmonic_source: bool = False,
) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Returns (waves, utt2spk); utterances round-robin over speakers
    with per-utterance swept SNR."""
    rng = np.random.RandomState(seed)
    waves: Dict[str, np.ndarray] = {}
    utt2spk: Dict[str, str] = {}
    for i, sent in enumerate(sents):
        si = i % len(speakers)
        key = f"{prefix}{i:05d}"
        snr = float(rng.uniform(opts.snr_lo_db, opts.snr_hi_db))
        pron_seq = [lex_prons[w][0] for w in sent]
        waves[key] = synthesize_utt(pron_seq, speakers[si], snr, rng,
                                    phone_params=phone_params,
                                    harmonic_source=harmonic_source)
        utt2spk[key] = f"{prefix}spk{si:03d}"
    return waves, utt2spk


def extract_mfcc_deltas_cmvn(
    waves: Dict[str, np.ndarray],
    utt2spk: Dict[str, str],
    norm_vars: bool = True,
    use_pitch: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, np.ndarray]:
    """MFCC + deltas + PER-SPEAKER CMVN (make_mfcc.sh + add-deltas +
    compute_cmvn_stats.sh --per-speaker; per-speaker normalization is
    what makes the warped clusters learnable at all), on ``device``.

    ``use_pitch`` pastes 3-dim processed pitch (pov, mean-subtracted
    log-pitch, delta log-pitch) onto the MFCCs before deltas — the
    make_mfcc_pitch.sh protocol the reference's Mandarin recipes use
    (egs/hkust/s5/run.sh); cepstra discard f0, so tonal inventories
    are unlearnable without it.

    The MFCCs come from the bucketed batch extractor (feats/batch.py)
    and the raw pitch from ``compute_pitch_batched`` on the same device,
    post-processed on the host as in the JAX package; the deltas and
    the normalization from feats/functions.py on the device, the CMVN
    stats' sums on the host in numpy's order (``acc_cmvn_stats``); the
    features return to the host as float32 numpy arrays."""
    mfcc = Mfcc(FrameExtractionOptions(samp_freq=SAMP_FREQ, dither=0.0),
                MelBanksOptions(num_bins=23), MfccOptions(), device=device)
    base = compute_batched(mfcc, waves)
    if use_pitch:
        raw_pitch = compute_pitch_batched(
            waves, PitchOptions(samp_freq=SAMP_FREQ), device=device)
        for u, f in base.items():
            p = postprocess_pitch(raw_pitch[u])
            T = len(f)
            if len(p) < T:      # pitch needs max_lag lookahead, so it
                # runs a couple of frames short; hold the last value
                pad = np.repeat(p[-1:] if len(p) else
                                np.zeros((1, 3), np.float32),
                                T - len(p), axis=0)
                p = np.concatenate([p, pad], axis=0)
            base[u] = torch.cat([f, torch.from_numpy(p[:T]).to(f.device)],
                                dim=1)
    raw = {u: add_deltas(f) for u, f in base.items()}
    stats: Dict[str, torch.Tensor] = {}
    for u in sorted(raw):
        spk = utt2spk[u]
        stats[spk] = acc_cmvn_stats(raw[u], stats.get(spk))
    return {u: apply_cmvn(f, stats[utt2spk[u]], norm_vars=norm_vars)
            .cpu().numpy() for u, f in raw.items()}


def pruned_bigram_arpa(sents: List[List[str]], words: List[str],
                       min_count: int = 2) -> str:
    """Count-cutoff bigram ARPA with absolute-discount backoff (the
    pruned-LM role of the reference's decode G; reference:
    egs/*/local LM prep + src/lmbin/arpa2fst path)."""
    from collections import Counter

    uni: Counter = Counter()
    bi: Counter = Counter()
    for s in sents:
        seq = ["<s>"] + s + ["</s>"]
        for i, w in enumerate(seq):
            uni[w] += 1
            if i:
                bi[(seq[i - 1], w)] += 1
    bi = Counter({k: c for k, c in bi.items() if c >= min_count})
    vocab = ["<s>", "</s>"] + words
    total = sum(uni.values())
    D = 0.7  # absolute discount
    kept_mass: Dict[str, float] = {}
    for (a, b), c in bi.items():
        kept_mass[a] = kept_mass.get(a, 0.0) + (c - D) / uni[a]
    lines = ["\\data\\", f"ngram 1={len(vocab)}",
             f"ngram 2={len(bi)}", "", "\\1-grams:"]
    for w in vocab:
        p = (uni[w] + 1) / (total + len(vocab))
        if w == "</s>":
            lines.append(f"{np.log10(p):.4f}\t{w}")
        else:
            bo = max(1.0 - kept_mass.get(w, 0.0), 1e-4)
            lines.append(f"{np.log10(p):.4f}\t{w}\t{np.log10(bo):.4f}")
    lines += ["", "\\2-grams:"]
    for (a, b), c in sorted(bi.items()):
        p = (c - D) / uni[a]
        lines.append(f"{np.log10(p):.4f}\t{a} {b}")
    lines += ["", "\\end\\", ""]
    return "\n".join(lines)


def synthesize_corpus(opts: Optional[HardCorpusOptions] = None,
                      num_train: int = 1600, num_test: int = 200,
                      lm_pool_mult: int = 12,
                      lexicon_text: Optional[str] = None,
                      phone_params: Optional[Dict[str, Tuple]] = None,
                      harmonic_source: bool = False,
                      num_dev: int = 0) -> Dict:
    """The corpus of :func:`build_corpus`, from the same seeds, before its
    features: lexicon text, Lexicon, Lang, words, the held-out-pool ARPA,
    and ``{split}_waves``, ``{split}_texts`` and ``{split}_utt2spk`` for
    the splits "train", "test" and "dev" (empty without ``num_dev``)."""
    opts = opts or HardCorpusOptions()
    lex_text = lexicon_text if lexicon_text is not None \
        else make_lexicon(opts)
    lex = Lexicon.from_text(lex_text)
    words = sorted(w for w in lex.prons if w != "<SIL>")
    model = SentenceModel(words, opts)

    train_sents = model.sample(num_train, seed=opts.seed + 1)
    test_sents = model.sample(num_test, seed=opts.seed + 2)
    lm_pool = model.sample(lm_pool_mult * num_train, seed=opts.seed + 3)

    train_spk = make_speakers(opts.num_train_speakers, opts,
                              seed=opts.seed + 10)
    test_spk = make_speakers(opts.num_test_speakers, opts,
                             seed=opts.seed + 20)
    out = {"lexicon_text": lex_text, "lexicon": lex,
           "lang": Lang.build(lex), "words": words,
           "dev_waves": {}, "dev_texts": {}, "dev_utt2spk": {}}

    def add(split, prefix, sents, speakers, seed):
        out[f"{split}_waves"], out[f"{split}_utt2spk"] = synthesize_set(
            lex.prons, sents, speakers, opts, seed=seed, prefix=prefix,
            phone_params=phone_params, harmonic_source=harmonic_source)
        out[f"{split}_texts"] = {f"{prefix}{i:05d}": s
                                 for i, s in enumerate(sents)}

    add("train", "tr", train_sents, train_spk, opts.seed + 30)
    add("test", "te", test_sents, test_spk, opts.seed + 40)
    if num_dev > 0:
        dev_sents = model.sample(num_dev, seed=opts.seed + 4)
        dev_spk = make_speakers(opts.num_dev_speakers, opts,
                                seed=opts.seed + 15)
        add("dev", "dv", dev_sents, dev_spk, opts.seed + 50)
    out["arpa"] = pruned_bigram_arpa(lm_pool, words)
    return out


def build_corpus(opts: Optional[HardCorpusOptions] = None,
                 num_train: int = 1600, num_test: int = 200,
                 lm_pool_mult: int = 12,
                 lexicon_text: Optional[str] = None,
                 phone_params: Optional[Dict[str, Tuple]] = None,
                 use_pitch: bool = False,
                 harmonic_source: bool = False,
                 num_dev: int = 0,
                 device: Union[str, torch.device] = "cuda"):
    """Full corpus build, the features extracted on ``device``.  Returns
    a dict with lexicon text, Lang, train/dev/test feats + texts +
    utt2spk, and the held-out-pool ARPA.

    ``lexicon_text``/``phone_params`` swap in a custom phone inventory
    (recipes/hkust_synth.py's tonal pinyin-like phones) while keeping
    the speaker/noise/LM protocol identical.

    ``num_dev`` > 0 synthesizes a third utterance set over a THIRD
    disjoint speaker pool (opts.num_dev_speakers): recipes tune LMWT /
    beams / schedules on dev and report test once (the dev/test
    discipline of egs/timit/s5, whose RESULTS publishes separate dev
    and test rows)."""
    opts = opts or HardCorpusOptions()
    syn = synthesize_corpus(opts, num_train, num_test, lm_pool_mult,
                            lexicon_text, phone_params, harmonic_source,
                            num_dev)
    out = {"opts": opts, "arpa": syn["arpa"], "train_audio_s": sum(
        len(w) for w in syn["train_waves"].values()) / SAMP_FREQ}
    for key in ("lexicon_text", "lexicon", "lang", "words"):
        out[key] = syn[key]
    for split in ("train", "test", "dev"):
        waves, u2s = syn[f"{split}_waves"], syn[f"{split}_utt2spk"]
        out[f"{split}_feats"] = extract_mfcc_deltas_cmvn(
            waves, u2s, use_pitch=use_pitch, device=device) if waves else {}
        out[f"{split}_texts"] = syn[f"{split}_texts"]
        out[f"{split}_utt2spk"] = u2s
    return out
