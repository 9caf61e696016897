"""The hard corpus's front end on the port (kaldi_aslp_tpu_torch/feats/
mfcc.py, functions.py, batch.py and recipes/hard_corpus.py) against the
JAX package on the CPU: MFCCs under several options, the bucketed batch
extractor, deltas, CMVN, ``extract_mfcc_deltas_cmvn`` and a small
``build_corpus``; the synthesized waves, lexicon, texts and ARPA must be
equal bit for bit (the same numpy code on the same seeds).

Tolerance rtol=atol=1e-4, the fbank tests' (tests/test_torch_feats.py),
everywhere, the features after per-speaker CMVN with variance
normalisation included: float32 on both sides, the FFT, the products and
the CMVN sums taken in another order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_aslp_tpu.feats import (
    DeltaFeaturesOptions as JaxDeltaOpts,
    Fbank as JaxFbank,
    FbankOptions as JaxFbankOptions,
    FrameExtractionOptions as JaxFrameOpts,
    MelBanksOptions as JaxMelOpts,
    Mfcc as JaxMfcc,
    MfccOptions as JaxMfccOptions,
    acc_cmvn_stats as jax_acc_cmvn_stats,
    add_deltas as jax_add_deltas,
    apply_cmvn as jax_apply_cmvn,
)
from kaldi_aslp_tpu.feats.batch import compute_batched as jax_compute_batched
from kaldi_aslp_tpu.feats.functions import delta_scales as jax_delta_scales
from kaldi_aslp_tpu.feats.mfcc import (
    dct_matrix as jax_dct_matrix,
    lifter_coeffs as jax_lifter_coeffs,
)
from kaldi_aslp_tpu.recipes import hard_corpus as jax_hc
from kaldi_aslp_tpu_torch.feats.batch import compute_batched
from kaldi_aslp_tpu_torch.feats.fbank import Fbank, FbankOptions
from kaldi_aslp_tpu_torch.feats.functions import (
    DeltaFeaturesOptions,
    acc_cmvn_stats,
    add_deltas,
    apply_cmvn,
    delta_scales,
)
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
from kaldi_aslp_tpu_torch.feats.mfcc import (
    Mfcc,
    MfccOptions,
    dct_matrix,
    lifter_coeffs,
)
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.recipes import hard_corpus as hc

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _wave(seed, n, sr=16000):
    rs = np.random.RandomState(seed)
    t = np.arange(n) / sr
    return (1000 * rs.randn(n) + 3000 * np.sin(2 * np.pi * 440 * t)
            ).astype(np.float32)


MFCC_CASES = {
    "default": ({}, {}, {}),
    "hard-corpus": ({"samp_freq": 8000.0}, {"num_bins": 23}, {}),
    "htk-compat": ({}, {"num_bins": 26}, {"htk_compat": True}),
    "c0-htk": ({}, {}, {"use_energy": False, "htk_compat": True}),
    "no-lifter": ({}, {"num_bins": 30}, {"cepstral_lifter": 0.0,
                                         "num_ceps": 20}),
    "energy-floor": ({"window_type": "hamming"}, {},
                     {"energy_floor": 1e6, "raw_energy": False}),
    # the last frames reflect the zeros of the JAX extractor's 1 s pad
    "no-snip-edges": ({"snip_edges": False}, {}, {}),
}


@pytest.mark.parametrize("case", sorted(MFCC_CASES))
def test_mfcc_matches_jax(case):
    frame, mel, mfcc = MFCC_CASES[case]
    sr = int(frame.get("samp_freq", 16000))
    wave = _wave(len(case), int(0.83 * sr), sr)
    want = np.asarray(JaxMfcc(JaxFrameOpts(dither=0.0, **frame),
                              JaxMelOpts(**mel), JaxMfccOptions(**mfcc))(wave))
    got = Mfcc(FrameExtractionOptions(dither=0.0, **frame),
               MelBanksOptions(**mel), MfccOptions(**mfcc),
               device="cpu")(wave).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_dct_and_lifter_are_the_jax_tables():
    np.testing.assert_array_equal(dct_matrix(13, 23), jax_dct_matrix(13, 23))
    np.testing.assert_array_equal(lifter_coeffs(22.0, 13),
                                  jax_lifter_coeffs(22.0, 13))


def test_compute_batched_matches_jax():
    """Lengths across three 1 s buckets and a batch size that splits one
    bucket: the same frames as JAX's extractor, each utterance trimmed
    to its own frame count."""
    rs = np.random.RandomState(3)
    waves = {f"u{i}": _wave(i, int(rs.randint(300, 2900)), 8000)
             for i in range(9)}
    frame = dict(samp_freq=8000.0, dither=0.0)
    want = jax_compute_batched(
        JaxMfcc(JaxFrameOpts(**frame), JaxMelOpts(num_bins=23)), waves)
    got = compute_batched(Mfcc(FrameExtractionOptions(**frame),
                               MelBanksOptions(num_bins=23), device="cpu"),
                          waves, batch_size=2)
    assert sorted(got) == sorted(want)
    for u in want:
        assert got[u].shape == want[u].shape
        np.testing.assert_allclose(got[u].numpy(), want[u], **TOL)


@pytest.mark.parametrize("snip_edges", [True, False])
def test_fbank_one_and_batched_match_jax(snip_edges):
    """Fbank, one waveform at a time and through ``compute_batched``, on
    the mel energies it shares with Mfcc; without snip_edges the last
    frames reflect the zeros of the JAX extractors' 1 s pad."""
    rs = np.random.RandomState(4)
    waves = {f"u{i}": _wave(i, int(rs.randint(300, 2900)), 8000)
             for i in range(5)}
    frame = dict(samp_freq=8000.0, dither=0.0, snip_edges=snip_edges)
    jax_fbank = JaxFbank(JaxFrameOpts(**frame), JaxMelOpts(num_bins=23),
                         JaxFbankOptions(use_energy=True))
    fbank = Fbank(FrameExtractionOptions(**frame),
                  MelBanksOptions(num_bins=23), FbankOptions(use_energy=True),
                  device="cpu")
    want = jax_compute_batched(jax_fbank, waves)
    got = compute_batched(fbank, waves, batch_size=2)
    for u, w in waves.items():
        one_j = np.asarray(jax_fbank(w))
        one = fbank(w).numpy()
        assert one.shape == one_j.shape == want[u].shape == got[u].shape
        np.testing.assert_allclose(one, one_j, **TOL)
        np.testing.assert_allclose(got[u].numpy(), want[u], **TOL)


@pytest.mark.parametrize("order,window", [(2, 2), (1, 3), (3, 1)])
def test_deltas_match_jax(order, window):
    feats = np.random.RandomState(order).randn(17, 5).astype(np.float32)
    for a, b in zip(delta_scales(DeltaFeaturesOptions(order, window)),
                    jax_delta_scales(JaxDeltaOpts(order, window))):
        np.testing.assert_array_equal(a, b)
    want = np.asarray(jax_add_deltas(jnp.asarray(feats),
                                     JaxDeltaOpts(order, window)))
    got = add_deltas(torch.from_numpy(feats),
                     DeltaFeaturesOptions(order, window)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("norm_vars", [False, True])
def test_cmvn_matches_jax(norm_vars):
    rs = np.random.RandomState(5)
    utts = [(rs.randn(rs.randint(20, 60), 6) * 3 + 10).astype(np.float32)
            for _ in range(3)]
    stats_j = None
    stats = None
    for f in utts:
        stats_j = jax_acc_cmvn_stats(f, stats_j)
        stats = acc_cmvn_stats(torch.from_numpy(f), stats)
    assert stats.dtype == torch.float64 and stats.shape == (2, 7)
    np.testing.assert_allclose(stats.numpy(), stats_j, rtol=1e-6)
    want = np.asarray(jax_apply_cmvn(jnp.asarray(utts[1]), stats_j,
                                     norm_vars=norm_vars))
    got = apply_cmvn(torch.from_numpy(utts[1]), stats,
                     norm_vars=norm_vars).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError, match="no frames"):
        apply_cmvn(torch.from_numpy(utts[0]),
                   torch.zeros((2, 7), dtype=torch.float64))


def _tiny_set(mod, harmonic=False):
    opts = mod.HardCorpusOptions(num_words=12)
    lex_text = mod.make_lexicon(opts)
    words = sorted(line.split()[0] for line in lex_text.splitlines()
                   if line and not line.startswith("<SIL>"))
    model = mod.SentenceModel(words, opts)
    sents = model.sample(5, seed=7)
    prons = {}
    for line in lex_text.splitlines():
        parts = line.split()
        prons.setdefault(parts[0], []).append(parts[1:])
    spk = mod.make_speakers(2, opts, seed=3)
    return mod.synthesize_set(prons, sents, spk, opts, seed=11,
                              prefix="tr", harmonic_source=harmonic)


@pytest.mark.parametrize("harmonic", [False, True],
                         ids=["additive", "harmonic"])
def test_synthesized_waves_are_the_jax_waves(harmonic):
    waves, u2s = _tiny_set(hc, harmonic)
    waves_j, u2s_j = _tiny_set(jax_hc, harmonic)
    assert u2s == u2s_j and sorted(waves) == sorted(waves_j)
    for u in waves:
        assert waves[u].dtype == np.float32
        assert np.array_equal(waves[u], waves_j[u])


def test_extract_mfcc_deltas_cmvn_matches_jax():
    waves, u2s = _tiny_set(hc)
    want = jax_hc.extract_mfcc_deltas_cmvn(waves, u2s)
    got = hc.extract_mfcc_deltas_cmvn(waves, u2s, device="cpu")
    assert sorted(got) == sorted(want)
    for u in want:
        assert got[u].dtype == np.float32 and got[u].shape[1] == 39
        assert got[u].shape == want[u].shape
        np.testing.assert_allclose(got[u], want[u], **TOL)
    plain = hc.extract_mfcc_deltas_cmvn(waves, u2s, norm_vars=False,
                                        device="cpu")
    plain_j = jax_hc.extract_mfcc_deltas_cmvn(waves, u2s, norm_vars=False)
    for u in plain_j:
        np.testing.assert_allclose(plain[u], plain_j[u], **TOL)


def test_build_corpus_matches_jax():
    """A small build with a dev set: the same lexicon, transcripts,
    speakers, ARPA and audio length, and features within TOL."""
    kw = dict(num_train=6, num_test=3, num_dev=2, lm_pool_mult=2)
    opts = dict(num_words=15, num_train_speakers=2, num_test_speakers=1,
                num_dev_speakers=1)
    got = hc.build_corpus(hc.HardCorpusOptions(**opts), device="cpu", **kw)
    want = jax_hc.build_corpus(jax_hc.HardCorpusOptions(**opts), **kw)
    for key in ("lexicon_text", "words", "train_texts", "test_texts",
                "dev_texts", "train_utt2spk", "test_utt2spk",
                "dev_utt2spk", "arpa", "train_audio_s"):
        assert got[key] == want[key], key
    assert len(got["lang"].phones) == len(want["lang"].phones)
    for split in ("train", "test", "dev"):
        f, fj = got[f"{split}_feats"], want[f"{split}_feats"]
        assert sorted(f) == sorted(fj) and f
        for u in fj:
            np.testing.assert_allclose(f[u], fj[u], **TOL)


def test_synthesize_corpus_is_build_corpus_before_its_features():
    """The waves that ``synthesize_corpus`` gives are those that
    ``build_corpus`` extracts, with its texts, speakers and ARPA."""
    kw = dict(num_train=4, num_test=2, num_dev=2, lm_pool_mult=2)
    opts = hc.HardCorpusOptions(num_words=12, num_train_speakers=2,
                                num_test_speakers=1, num_dev_speakers=1)
    syn = hc.synthesize_corpus(opts, **kw)
    built = hc.build_corpus(opts, device="cpu", **kw)
    assert syn["arpa"] == built["arpa"]
    assert syn["lexicon_text"] == built["lexicon_text"]
    for split in ("train", "test", "dev"):
        for key in ("texts", "utt2spk"):
            assert syn[f"{split}_{key}"] == built[f"{split}_{key}"]
        feats = hc.extract_mfcc_deltas_cmvn(
            syn[f"{split}_waves"], syn[f"{split}_utt2spk"], device="cpu")
        assert sorted(feats) == sorted(built[f"{split}_feats"])
        for u, f in feats.items():
            np.testing.assert_array_equal(f, built[f"{split}_feats"][u])


def test_pitch_is_not_ported():
    """The name is kept from before the port had pitch, when
    ``use_pitch=True`` raised.  Pitch is ported now: on an utterance too
    short for the pitch's lookahead (6 pitch frames for 8 MFCC frames,
    the last pitch value held) the features are JAX's 48 columns.  Mean
    normalization only: 8 frames' variance of a near-constant pitch
    column is ill-conditioned in float32 (tests/test_torch_frontend.py
    holds the variance-normalized features on whole utterances)."""
    waves, u2s = {"u": _wave(1, 800, 8000)}, {"u": "s"}
    got = hc.extract_mfcc_deltas_cmvn(waves, u2s, norm_vars=False,
                                      use_pitch=True, device="cpu")
    want = jax_hc.extract_mfcc_deltas_cmvn(waves, u2s, norm_vars=False,
                                           use_pitch=True)
    assert got["u"].shape == want["u"].shape == (8, 48)
    np.testing.assert_allclose(got["u"], want["u"], **TOL)
