"""The rest of the port's feature front end against the JAX package on
the CPU: Kaldi's dither RNG (kaldi_rand.py, bit-equal draws and dither),
resampling and noise mixing (resample.py), sliding-window CMN under
every option (functions.py), the spectrogram and PLP (plp.py), the
feature pipeline with CMVN, deltas and splicing and its per-speaker
stats (pipeline.py), and the hard corpus's 48-dim MFCC + pitch features
(recipes/hard_corpus.py with ``use_pitch=True``: the pitch-augmented
``extract_mfcc_deltas_cmvn`` and ``build_corpus`` with the harmonic
source), on seeded numpy inputs.

Tolerance: ``TOL`` of tests/test_torch_mfcc.py (rtol=atol=1e-4,
float32 on both sides in another order) for every float result but the
RNG's, which must be equal bit for bit.  One addition, in the
spectrogram: a log-power bin far below its frame's peak holds the
float32 FFT's rounding of each package (one bin 80 dB down was 3.0944
on the port, 3.0933 on JAX and 3.0936 in float64), so each bin is held
to TOL plus twice the FFT's error bound in the log domain,
2 eps log2(nfft) sqrt(sum of the frame's powers / the bin's power).

Two compositions are held in parts, where a float32 rounding is
amplified past TOL by the formula itself and not by the port:
  - ``norm_vars`` divides by the one-pass variance E[x^2] - mean^2,
    which for the test tone's log-mel bins cancels to about 1e-3 of
    E[x^2]: the two packages' float32 CMVN sums (equal to 1e-5
    relative, held so) then move a normalized value by up to 1.3e-2.
    So the pipeline is held at TOL with the same stats on both sides,
    and with its own stats where no variance is normalized;
  - the cepstral lifter (22) multiplies c11 and c12 by about 12, so
    without variance normalization a quiet frame's log-mel rounding
    reaches 1.8e-4 there: the pitch-augmented features without
    ``norm_vars`` are held at TOL on the cepstra before liftering (the
    features with it, the recipes' setting, at TOL itself)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_aslp_tpu.feats import (
    FeaturePipeline as JaxPipeline,
    FeaturePipelineOptions as JaxPipelineOptions,
    FrameExtractionOptions as JaxFrameOpts,
    MelBanksOptions as JaxMelOpts,
    Plp as JaxPlp,
    PlpOptions as JaxPlpOptions,
    SlidingWindowCmnOptions as JaxCmnOpts,
    Spectrogram as JaxSpectrogram,
    compute_cmvn_stats_per_spk as jax_stats_per_spk,
    sliding_window_cmn as jax_sliding_window_cmn,
)
from kaldi_aslp_tpu.feats.kaldi_rand import (
    GlibcRandom as JaxGlibcRandom,
    kaldi_dither as jax_kaldi_dither,
)
from kaldi_aslp_tpu.feats.plp import equal_loudness_curve as jax_eql
from kaldi_aslp_tpu.feats.resample import (
    add_noise as jax_add_noise,
    resample_waveform as jax_resample,
)
from kaldi_aslp_tpu.recipes import hard_corpus as jax_hc
from kaldi_aslp_tpu_torch.feats.functions import (
    SlidingWindowCmnOptions,
    sliding_window_cmn,
)
from kaldi_aslp_tpu_torch.feats.kaldi_rand import GlibcRandom, kaldi_dither
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
from kaldi_aslp_tpu_torch.feats.mfcc import lifter_coeffs
from kaldi_aslp_tpu_torch.feats.pipeline import (
    FeaturePipeline,
    FeaturePipelineOptions,
    compute_cmvn_stats_per_spk,
)
from kaldi_aslp_tpu_torch.feats.plp import (
    Plp,
    PlpOptions,
    Spectrogram,
    equal_loudness_curve,
)
from kaldi_aslp_tpu_torch.feats.resample import add_noise, resample_waveform
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.recipes import hard_corpus as hc
from test_torch_mfcc import TOL, _tiny_set, _wave

torch.set_num_threads(1)


# -- kaldi_rand: bit for bit -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 777, 123456789, 2 ** 32 + 5])
def test_glibc_rand_draws_are_the_jax_draws(seed):
    got, want = GlibcRandom(seed), JaxGlibcRandom(seed)
    assert [got.rand() for _ in range(200)] == \
        [want.rand() for _ in range(200)]
    for _ in range(50):
        a, b = got.rand_uniform(), want.rand_uniform()
        assert a == b and type(a) is type(b)
        a, b = got.rand_gauss(), want.rand_gauss()
        assert a == b and a.dtype == np.float32


def test_kaldi_dither_is_the_jax_dither():
    frames = np.random.RandomState(3).randn(7, 40).astype(np.float32)
    got = kaldi_dither(frames, 0.7, GlibcRandom(777))
    want = jax_kaldi_dither(frames, 0.7, JaxGlibcRandom(777))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # row-major order: the first value takes the first RandGauss draw
    assert got[0, 0] == frames[0, 0] + GlibcRandom(777).rand_gauss() \
        * np.float32(0.7)


# -- resample ---------------------------------------------------------------

@pytest.mark.parametrize("rates", [(16000.0, 8000.0), (8000.0, 16000.0),
                                   (16000.0, 11025.0), (8000.0, 8000.0)])
def test_resample_matches_jax(rates):
    wave = _wave(7, 3000, int(rates[0]))
    got = resample_waveform(wave, *rates)
    want = jax_resample(wave, *rates)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("noise_len", [3000, 12000])
def test_add_noise_matches_jax(noise_len):
    rs = np.random.RandomState(1)
    speech = (1000 * rs.randn(8000)).astype(np.float32)
    noise = (500 * rs.randn(noise_len)).astype(np.float32)
    got = add_noise(speech, noise, snr_db=10.0, seed=3)
    want = jax_add_noise(speech, noise, snr_db=10.0, seed=3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


# -- sliding-window CMN -------------------------------------------------------

CMN_CASES = {
    "default": {},
    "short-window": dict(cmn_window=20, min_window=5),
    "min-window-past-T": dict(cmn_window=30, min_window=200),
    "center": dict(cmn_window=25, center=True),
    "center-past-T": dict(cmn_window=400, center=True),
    "variance": dict(cmn_window=20, min_window=8, normalize_variance=True),
    "center-variance": dict(cmn_window=31, center=True,
                            normalize_variance=True),
}


@pytest.mark.parametrize("case", sorted(CMN_CASES))
def test_sliding_window_cmn_matches_jax(case):
    feats = (np.random.RandomState(len(case)).randn(90, 6) * 2 + 1
             ).astype(np.float32)
    kw = CMN_CASES[case]
    want = np.asarray(jax_sliding_window_cmn(jnp.asarray(feats),
                                             JaxCmnOpts(**kw)))
    got = sliding_window_cmn(torch.from_numpy(feats),
                             SlidingWindowCmnOptions(**kw))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- spectrogram and PLP ----------------------------------------------------

def assert_log_spectra_close(got, want):
    """Spectrogram rows [log energy, log power bins...]: the energy at
    TOL, each bin at TOL plus twice the float32 FFT's error bound in the
    log domain (the module docstring)."""
    power = np.exp(want[:, 1:].astype(np.float64))
    nfft = 2 * (want.shape[1] - 1)
    fft_bound = 4 * np.finfo(np.float32).eps * np.log2(nfft) * np.sqrt(
        power.sum(1, keepdims=True) / power)
    err = np.abs(got - want)
    allowed = TOL["atol"] + TOL["rtol"] * np.abs(want)
    allowed[:, 1:] += fft_bound
    assert (err <= allowed).all(), (err - allowed).max()
    np.testing.assert_allclose(got[:, 0], want[:, 0], **TOL)


SPEC_CASES = {"default": {}, "no-snip-edges": dict(snip_edges=False),
              "hamming-8k": dict(samp_freq=8000.0, window_type="hamming")}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spectrogram_matches_jax(case):
    frame = dict(dither=0.0, **SPEC_CASES[case])
    wave = _wave(len(case), int(0.83 * frame.get("samp_freq", 16000)),
                 int(frame.get("samp_freq", 16000)))
    want = np.asarray(JaxSpectrogram(JaxFrameOpts(**frame))(wave))
    spec = Spectrogram(FrameExtractionOptions(**frame), device="cpu")
    got = spec(wave)
    assert spec.dim == want.shape[1] and tuple(got.shape) == want.shape
    assert_log_spectra_close(got.numpy(), want)


PLP_CASES = {
    "default": ({}, {}, {}, 1.0),
    "8k-23-bins": ({"samp_freq": 8000.0}, {"num_bins": 23}, {}, 1.0),
    "htk-compat": ({}, {"htk_mode": True}, {"htk_compat": True}, 1.0),
    "no-lifter-scaled": ({}, {}, {"cepstral_lifter": 0.0,
                                  "cepstral_scale": 2.0, "num_ceps": 10},
                         1.0),
    "energy-floor": ({"window_type": "hamming"}, {},
                     {"energy_floor": 1e6, "raw_energy": False}, 1.0),
    "c0-vtln": ({"snip_edges": False}, {"low_freq": 60.0},
                {"use_energy": False}, 0.9),
}


@pytest.mark.parametrize("case", sorted(PLP_CASES))
def test_plp_matches_jax(case):
    frame, mel, plp, warp = PLP_CASES[case]
    sr = int(frame.get("samp_freq", 16000))
    wave = _wave(len(case) + 20, int(1.3 * sr), sr)
    np.testing.assert_array_equal(
        equal_loudness_curve(MelBanksOptions(**mel),
                             FrameExtractionOptions(**frame), warp),
        jax_eql(JaxMelOpts(**mel), JaxFrameOpts(**frame), warp))
    want = JaxPlp(JaxFrameOpts(dither=0.0, **frame), JaxMelOpts(**mel),
                  JaxPlpOptions(**plp), vtln_warp=warp)(wave)
    got = Plp(FrameExtractionOptions(dither=0.0, **frame),
              MelBanksOptions(**mel), PlpOptions(**plp), vtln_warp=warp,
              device="cpu")(wave)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_plp_refuses_more_ceps_than_the_lpc_order_gives():
    with pytest.raises(ValueError, match="num_ceps"):
        Plp(plp_opts=PlpOptions(num_ceps=14, lpc_order=12), device="cpu")


# -- the pipeline ---------------------------------------------------------

PIPELINE_CASES = {
    "fbank": dict(),
    "fbank-cmvn-deltas-splice": dict(norm_vars=True, delta_order=2,
                                     splice_left=2, splice_right=1),
    "mfcc-deltas": dict(feature_type="mfcc", delta_order=1),
    "mfcc-8k-splice": dict(feature_type="mfcc", samp_freq=8000.0,
                           splice_left=3, splice_right=3, num_bins=23),
    "no-cmvn": dict(apply_cmvn=False, delta_order=1),
}


@pytest.mark.parametrize("case", sorted(PIPELINE_CASES))
def test_feature_pipeline_matches_jax(case):
    kw = PIPELINE_CASES[case]
    sr = int(kw.get("samp_freq", 16000))
    rs = np.random.RandomState(len(case))
    waves = {f"u{i}": _wave(i, int(rs.randint(sr // 2, 2 * sr)), sr)
             for i in range(4)}
    u2s = {"u0": "a", "u1": "b", "u2": "a", "u3": "b"}
    jpipe = JaxPipeline(JaxPipelineOptions(**kw))
    pipe = FeaturePipeline(FeaturePipelineOptions(**kw), device="cpu")
    assert pipe.dim == jpipe.dim
    base_j = {u: np.asarray(jpipe.compute_base(w)) for u, w in waves.items()}
    base = {u: pipe.compute_base(w) for u, w in waves.items()}
    stats_j = jax_stats_per_spk(base_j, u2s)
    stats = compute_cmvn_stats_per_spk(base, u2s)
    assert sorted(stats) == sorted(stats_j) == ["a", "b"]
    for spk in stats:
        assert stats[spk].dtype == torch.float64
        np.testing.assert_allclose(stats[spk].numpy(), stats_j[spk],
                                   rtol=1e-5)
    own = [stats] if not kw.get("norm_vars") else []
    for u, w in waves.items():
        want = np.asarray(jpipe(w, stats_j[u2s[u]]))
        for cmvn in [stats_j[u2s[u]], torch.from_numpy(stats_j[u2s[u]])] + [
                st[u2s[u]] for st in own]:
            got = pipe(w, cmvn)
            assert got.shape[1] == pipe.dim and tuple(got.shape) == \
                want.shape
            np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pipeline_dithers_only_with_a_generator():
    """The dither contract of Fbank and Mfcc: without a generator the
    pipeline's default dither of 1.0 leaves JAX's undithered output;
    with one the base features move."""
    wave = _wave(2, 12000)
    pipe = FeaturePipeline(device="cpu")
    want = np.asarray(JaxPipeline()(wave))
    plain = pipe(wave)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
    dithered = pipe(wave, generator=torch.Generator().manual_seed(0))
    assert not torch.allclose(dithered, plain)


def test_pipeline_refuses_an_unknown_feature_type():
    with pytest.raises(ValueError, match="unknown feature type"):
        FeaturePipeline(FeaturePipelineOptions(feature_type="plp"),
                        device="cpu")


# -- the pitch-augmented corpus features -------------------------------------

def test_extract_mfcc_pitch_deltas_cmvn_matches_jax():
    """The harmonic tiny set (tests/test_torch_mfcc.py::_tiny_set) through
    ``use_pitch=True``: 13 cepstra + 3 pitch dims, with deltas, 48."""
    waves, u2s = _tiny_set(hc, harmonic=True)
    # the lifter of each column: 13 cepstra and 3 pitch dims, three times
    unlifter = np.tile(np.concatenate([lifter_coeffs(22.0, 13),
                                       np.ones(3, np.float32)]), 3)
    for norm_vars, scale in ((True, np.ones(48, np.float32)),
                             (False, unlifter)):
        want = jax_hc.extract_mfcc_deltas_cmvn(waves, u2s, norm_vars,
                                               use_pitch=True)
        got = hc.extract_mfcc_deltas_cmvn(waves, u2s, norm_vars,
                                          use_pitch=True, device="cpu")
        assert sorted(got) == sorted(want)
        for u in want:
            assert got[u].dtype == np.float32 and got[u].shape[1] == 48
            assert got[u].shape == want[u].shape
            np.testing.assert_allclose(got[u] / scale, want[u] / scale,
                                       **TOL)


def test_build_corpus_with_pitch_and_harmonic_source_matches_jax():
    kw = dict(num_train=5, num_test=2, lm_pool_mult=2, use_pitch=True,
              harmonic_source=True)
    opts = dict(num_words=12, num_train_speakers=2, num_test_speakers=1)
    got = hc.build_corpus(hc.HardCorpusOptions(**opts), device="cpu", **kw)
    want = jax_hc.build_corpus(jax_hc.HardCorpusOptions(**opts), **kw)
    for key in ("lexicon_text", "words", "train_texts", "test_texts",
                "train_utt2spk", "test_utt2spk", "arpa", "train_audio_s"):
        assert got[key] == want[key], key
    for split in ("train", "test"):
        f, fj = got[f"{split}_feats"], want[f"{split}_feats"]
        assert sorted(f) == sorted(fj) and f
        for u in fj:
            assert f[u].shape == fj[u].shape and f[u].shape[1] == 48
            np.testing.assert_allclose(f[u], fj[u], **TOL)
