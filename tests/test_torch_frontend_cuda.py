"""The feature front end on the card against the port's CPU path
(kaldi_aslp_tpu_torch/feats/pitch.py, plp.py, pipeline.py, functions.py
and recipes/hard_corpus.py with ``use_pitch=True``), on seeded waves.

Tolerances are those of the CPU tests against JAX
(tests/test_torch_pitch.py, tests/test_torch_frontend.py): for pitch the
lag path equal on every frame, or where a frame differs both paths'
total scores under the CPU's local grid within 1e-5 relative, then POV
within 1e-5 and log-pitch within 1e-6 on equal frames, the NCCF grids
within 1e-5 (the batched grid plus twice the float32 FFT's error bound,
cuFFT against the CPU's FFT); everything else within rtol=atol=1e-4,
the spectrogram's bins plus the FFT bound in the log domain.

There is no hand kernel on this path: the tests hold stock torch ops on
the card (cuFFT, reductions, the lag-Viterbi's frame loop).  They skip
where there is no CUDA card.  This file imports no JAX; run it on the
card with ``python -m pytest --noconftest
tests/test_torch_frontend_cuda.py -q``."""

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.feats import pitch as tp
from kaldi_aslp_tpu_torch.feats.functions import (
    SlidingWindowCmnOptions,
    acc_cmvn_stats,
    sliding_window_cmn,
)
from kaldi_aslp_tpu_torch.feats.pipeline import (
    FeaturePipeline,
    FeaturePipelineOptions,
)
from kaldi_aslp_tpu_torch.feats.plp import Plp, Spectrogram
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.recipes import hard_corpus as hc
from kaldi_aslp_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-4)
NCCF_ATOL, SCORE_RTOL, POV_ATOL, LOGP_ATOL = 1e-5, 1e-5, 1e-5, 1e-6
EPS32 = float(np.finfo(np.float32).eps)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")   # TF32 off


def _tone(f0, dur, sr=16000, amp=5000):
    t = np.arange(int(dur * sr)) / sr
    return amp * (np.sin(2 * np.pi * f0 * t)
                  + 0.4 * np.sin(2 * np.pi * 2 * f0 * t)).astype(np.float32)


def _waves():
    rng = np.random.RandomState(777)
    waves = {"change": np.concatenate([_tone(150.0, 0.5), _tone(300.0, 0.5)]),
             "noise": (3000 * rng.randn(16000)).astype(np.float32)}
    for i, (f0, dur) in enumerate([(120.0, 0.8), (200.0, 1.3),
                                   (95.0, 2.1), (310.0, 1.0)]):
        waves[f"u{i}"] = _tone(f0, dur) + 100 * rng.randn(
            int(dur * 16000)).astype(np.float32)
    return waves


def _path_of(logp, g):
    table = np.log(16000.0 / g.lags.astype(np.float64))
    return np.abs(logp[:, None].astype(np.float64) - table[None]).argmin(1)


def _cost(g, direct):
    if direct:
        ll = g.log_lags.astype(np.float32)
        return np.float32(0.1) * (ll[:, None] - ll[None]) ** 2
    return 0.1 * np.asarray((g.log_lags[:, None] - g.log_lags[None]) ** 2,
                            np.float32)


def _hold(card, cpu, local, cost, g):
    got, want = _path_of(card[:, 1], g), _path_of(cpu[:, 1], g)
    differ = got != want
    if differ.any():
        local = np.asarray(local, np.float64)
        c = np.asarray(cost, np.float64)

        def score(p):
            return local[np.arange(len(p)), p].sum() - c[p[:-1], p[1:]].sum()
        assert abs(score(got) - score(want)) <= SCORE_RTOL * abs(score(want))
    eq = ~differ
    np.testing.assert_allclose(card[eq, 0], cpu[eq, 0], rtol=0, atol=POV_ATOL)
    np.testing.assert_allclose(card[eq, 1], cpu[eq, 1], rtol=0,
                               atol=LOGP_ATOL)
    return int(differ.sum())


def test_direct_pitch_on_the_card_matches_the_cpu():
    dev = _card()
    opts = tp.PitchOptions()
    g = tp._Geometry(opts)
    for name, w in _waves().items():
        card = tp.compute_pitch(w, opts, device=dev)
        cpu = tp.compute_pitch(w, opts, device="cpu")
        assert card.shape == cpu.shape
        grid_card, _ = tp.nccf_grid(torch.from_numpy(w).to(dev), opts)
        grid_cpu, _ = tp.nccf_grid(torch.from_numpy(w), opts)
        np.testing.assert_allclose(grid_card.cpu().numpy(), grid_cpu.numpy(),
                                   rtol=0, atol=NCCF_ATOL)
        local = tp._local_score(grid_cpu, g, opts).numpy()
        _hold(card, cpu, local, _cost(g, True), g)


def _fft_bound(arr, lens, g, opts):
    x = arr.astype(np.float64)
    T = g.num_frames(x.shape[1])
    ext = g.window + g.max_lag
    x2 = x[:, (np.arange(T) * g.shift)[:, None] + np.arange(ext)[None]]
    x1 = x2[..., :g.window]
    cs = np.concatenate([np.zeros(x2.shape[:2] + (1,)),
                         np.cumsum(x2 * x2, axis=-1)], axis=-1)
    e1 = (x1 * x1).sum(-1)
    e2 = cs[..., g.window + g.min_lag:g.window + g.max_lag + 1] \
        - cs[..., g.min_lag:g.max_lag + 1]
    ballast = opts.nccf_ballast * (x * x).sum(1) / np.maximum(lens, 1) \
        * g.window
    scale = np.sqrt(e1 * (x2 * x2).sum(-1))[..., None]
    return 2 * EPS32 * np.log2(1024) * scale / np.sqrt(
        e1[..., None] * e2 + ballast[:, None, None] + 1e-20)


def test_batched_pitch_on_the_card_matches_the_cpu():
    dev = _card()
    opts = tp.PitchOptions()
    g = tp._Geometry(opts)
    waves = _waves()
    card = tp.compute_pitch_batched(waves, opts, batch_size=3, device=dev)
    cpu = tp.compute_pitch_batched(waves, opts, batch_size=3, device="cpu")
    assert sorted(card) == sorted(cpu)
    for u, w in waves.items():
        assert card[u].device.type == "cuda"
        n = -(-len(w) // 16000) * 16000
        arr = np.zeros((1, n), np.float32)
        arr[0, :len(w)] = w
        lens = np.array([len(w)], np.float32)
        grids = [tp.batched_nccf(torch.from_numpy(arr).to(d),
                                 torch.from_numpy(lens).to(d), opts)
                 .cpu().numpy() for d in (dev, "cpu")]
        err = np.abs(grids[0] - grids[1])
        assert (err <= NCCF_ATOL + _fft_bound(arr, lens, g, opts)).all()
        T = len(cpu[u])
        np.testing.assert_allclose(grids[0][0, :T], grids[1][0, :T], rtol=0,
                                   atol=NCCF_ATOL)
        local = tp._local_score(torch.from_numpy(grids[1][0]), g, opts)
        _hold(card[u].cpu().numpy(), cpu[u].numpy(), local.numpy()[:T],
              _cost(g, False), g)


def test_plp_spectrogram_pipeline_and_cmn_on_the_card_match_the_cpu():
    dev = _card()
    rs = np.random.RandomState(5)
    waves = [(1000 * rs.randn(n) + 3000 * np.sin(
        2 * np.pi * 440 * np.arange(n) / 16000)).astype(np.float32)
        for n in (9000, 16000, 23456)]
    frame = FrameExtractionOptions(dither=0.0)
    spec = {d: Spectrogram(frame, device=d) for d in (dev, "cpu")}
    plp = {d: Plp(frame, device=d) for d in (dev, "cpu")}
    pipes = {(kind, d): FeaturePipeline(FeaturePipelineOptions(
        feature_type=kind, delta_order=2, splice_left=2, splice_right=1),
        device=d) for kind in ("fbank", "mfcc") for d in (dev, "cpu")}
    for w in waves:
        got, want = spec[dev](w).cpu().numpy(), spec["cpu"](w).numpy()
        power = np.exp(want[:, 1:].astype(np.float64))
        bound = 4 * EPS32 * np.log2(512) * np.sqrt(
            power.sum(1, keepdims=True) / power)
        allowed = TOL["atol"] + TOL["rtol"] * np.abs(want)
        allowed[:, 1:] += bound
        assert (np.abs(got - want) <= allowed).all()
        np.testing.assert_allclose(plp[dev](w), plp["cpu"](w), **TOL)
        for kind in ("fbank", "mfcc"):
            stats = acc_cmvn_stats(pipes[kind, "cpu"].compute_base(w))
            got = pipes[kind, dev](w, stats).cpu().numpy()
            np.testing.assert_allclose(got, pipes[kind, "cpu"](w, stats)
                                       .numpy(), **TOL)
    feats = (rs.randn(300, 13) * 2 + 1).astype(np.float32)
    for kw in ({}, dict(cmn_window=50, min_window=10,
                        normalize_variance=True),
               dict(cmn_window=41, center=True)):
        o = SlidingWindowCmnOptions(**kw)
        np.testing.assert_allclose(
            sliding_window_cmn(torch.from_numpy(feats).to(dev), o)
            .cpu().numpy(),
            sliding_window_cmn(torch.from_numpy(feats), o).numpy(), **TOL)


def test_pitch_corpus_features_on_the_card_match_the_cpu():
    dev = _card()
    opts = hc.HardCorpusOptions(num_words=12)
    lex_text = hc.make_lexicon(opts)
    prons = {}
    for line in lex_text.splitlines():
        parts = line.split()
        prons.setdefault(parts[0], []).append(parts[1:])
    words = sorted(w for w in prons if w != "<SIL>")
    sents = hc.SentenceModel(words, opts).sample(6, seed=7)
    waves, u2s = hc.synthesize_set(prons, sents,
                                   hc.make_speakers(2, opts, seed=3), opts,
                                   seed=11, prefix="tr", harmonic_source=True)
    card = hc.extract_mfcc_deltas_cmvn(waves, u2s, use_pitch=True, device=dev)
    cpu = hc.extract_mfcc_deltas_cmvn(waves, u2s, use_pitch=True,
                                      device="cpu")
    assert sorted(card) == sorted(cpu)
    for u in cpu:
        assert card[u].shape == cpu[u].shape and cpu[u].shape[1] == 48
        np.testing.assert_allclose(card[u], cpu[u], **TOL)
