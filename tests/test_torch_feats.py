"""The port's fbank front end and online feature pipeline
(kaldi_aslp_tpu_torch/feats/, online/feature_pipeline.py) against the JAX
package's ``Fbank`` and ``OnlineFeaturePipeline``.  Tolerance
rtol=atol=1e-4 on log-mel values: float32 FFTs of two libraries.

Dither: without a generator (JAX: without a key) nothing is dithered,
whatever ``dither`` says; with one, the port's draws are torch's, so
they are held to JAX's through injected noise (JAX's own draws put in
place of the port's) and by their statistics, not bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.feats import (
    Fbank as JaxFbank,
    FrameExtractionOptions as JaxFrameOpts,
    MelBanksOptions as JaxMelOpts,
    Mfcc as JaxMfcc,
)
from kaldi_aslp_tpu.feats.mel import mel_banks_matrix as jax_mel_banks
from kaldi_aslp_tpu.feats.window import extract_frames as jax_extract_frames
from kaldi_aslp_tpu.online.feature_pipeline import (
    OnlineFeatureOptions as JaxOnlineOpts,
    OnlineFeaturePipeline as JaxOnlinePipeline,
)
from kaldi_aslp_tpu_torch.feats import window as port_window
from kaldi_aslp_tpu_torch.feats.batch import compute_batched
from kaldi_aslp_tpu_torch.feats.fbank import Fbank
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions, mel_banks_matrix
from kaldi_aslp_tpu_torch.feats.mfcc import Mfcc
from kaldi_aslp_tpu_torch.feats.window import (
    FrameExtractionOptions,
    extract_frames,
    process_window,
)
from kaldi_aslp_tpu_torch.online.feature_pipeline import (
    OnlineFeatureOptions,
    OnlineFeaturePipeline,
)

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _wave(seed, n=16000):
    rs = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    return (1000 * rs.randn(n) + 3000 * np.sin(2 * np.pi * 440 * t)
            ).astype(np.float32)


@pytest.mark.parametrize("bins", [23, 40])
def test_fbank_matches_jax(bins):
    wave = _wave(bins, 12345)
    want = np.asarray(JaxFbank(JaxFrameOpts(dither=0.0),
                               JaxMelOpts(num_bins=bins))(wave))
    got = Fbank(FrameExtractionOptions(dither=0.0),
                MelBanksOptions(num_bins=bins), device="cpu")(wave).numpy()
    assert got.shape == want.shape == (75, bins)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cmn", [True, False])
@pytest.mark.parametrize("bins", [23, 40])
def test_online_pipeline_matches_jax(bins, cmn):
    """Uneven chunks, and enough audio that the CMN window slides."""
    wave = _wave(100 + bins, 16000 * 7)
    jax_pipe = JaxOnlinePipeline(JaxOnlineOpts(num_mel_bins=bins,
                                               apply_cmn=cmn))
    port_pipe = OnlineFeaturePipeline(
        OnlineFeatureOptions(num_mel_bins=bins, apply_cmn=cmn), "cpu")
    got, want = [], []
    rs = np.random.RandomState(bins)
    start = 0
    while start < len(wave):
        n = int(rs.randint(100, 9000))
        got.append(port_pipe.accept_waveform(wave[start:start + n]))
        want.append(jax_pipe.accept_waveform(wave[start:start + n]))
        assert got[-1].shape == want[-1].shape
        start += n
    got, want = np.concatenate(got), np.concatenate(want)
    assert got.shape == (698, bins)
    np.testing.assert_allclose(got, want, **TOL)


def test_online_pipeline_reset_restarts_the_stream():
    wave = _wave(3, 8000)
    pipe = OnlineFeaturePipeline(OnlineFeatureOptions(num_mel_bins=23),
                                 device="cpu")
    first = pipe.accept_waveform(wave)
    pipe.reset()
    np.testing.assert_array_equal(pipe.accept_waveform(wave), first)


def test_mel_banks_are_the_jax_matrix():
    for bins in (23, 40):
        np.testing.assert_array_equal(
            mel_banks_matrix(MelBanksOptions(num_bins=bins),
                             FrameExtractionOptions()),
            jax_mel_banks(JaxMelOpts(num_bins=bins), JaxFrameOpts()))


def test_extract_frames_without_snip_edges_matches_jax():
    wave = _wave(4, 1000)
    want = np.asarray(jax_extract_frames(
        jnp.asarray(wave), JaxFrameOpts(snip_edges=False)))
    got = extract_frames(torch.from_numpy(wave),
                         FrameExtractionOptions(snip_edges=False)).numpy()
    np.testing.assert_array_equal(got, want)


EXTRACTORS = {"fbank": (Fbank, JaxFbank), "mfcc": (Mfcc, JaxMfcc)}


@pytest.mark.parametrize("kind", sorted(EXTRACTORS))
def test_default_dither_without_a_generator_matches_jax(kind):
    """Default options (dither=1.0) and no generator: undithered, equal
    bit for bit to dither=0.0, and JAX's default output (no key)."""
    port, jax_cls = EXTRACTORS[kind]
    wave = _wave(6, 12345)
    got = port(device="cpu")(wave).numpy()
    np.testing.assert_array_equal(
        got, port(FrameExtractionOptions(dither=0.0), device="cpu")(wave)
        .numpy())
    np.testing.assert_allclose(got, np.asarray(jax_cls()(wave)), **TOL)


@pytest.mark.parametrize("snip_edges", [True, False])
@pytest.mark.parametrize("kind", sorted(EXTRACTORS))
def test_dither_matches_jax_with_its_noise(kind, snip_edges, monkeypatch):
    """With a generator the port dithers where JAX dithers with a key:
    JAX's noise for the key, put in place of the port's draws, gives
    JAX's features.  JAX frames the waveform padded to whole seconds,
    so its noise has a row for every padded frame; frame i takes row i
    on both sides."""
    port, jax_cls = EXTRACTORS[kind]
    opts = dict(dither=3.0, snip_edges=snip_edges)
    wave = _wave(7, 12345)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_cls(JaxFrameOpts(**opts))(wave, key))
    jax_opts = JaxFrameOpts(**opts)
    n_padded = 1 + (16000 - jax_opts.window_size) // jax_opts.window_shift
    if not snip_edges:
        n_padded = (16000 + jax_opts.window_shift // 2) \
            // jax_opts.window_shift
    noise = torch.from_numpy(np.array(jax.random.normal(
        key, (n_padded, jax_opts.window_size), jnp.float32)))

    def jax_noise(shape, generator, device):
        assert generator is not None
        return noise[:shape[-2]].to(device)

    monkeypatch.setattr(port_window, "dither_noise", jax_noise)
    got = port(FrameExtractionOptions(**opts), device="cpu")(
        wave, torch.Generator().manual_seed(0)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
    undithered = port(FrameExtractionOptions(**opts), device="cpu")(wave)
    assert not np.allclose(undithered.numpy(), want, **TOL)


def test_dither_draws_are_standard_normal_times_dither():
    """The noise is ``dither`` x N(0, 1) from the generator, added before
    DC removal: with DC removal, preemphasis and the window switched off
    the frames come back as frames + noise.  The same seed gives the
    same bits; another seed, other bits."""
    opts = FrameExtractionOptions(dither=2.5, remove_dc_offset=False,
                                  preemphasis_coefficient=0.0,
                                  window_type="rectangular")
    frames = torch.full((400, 400), 7.0)
    window = torch.ones(400)

    def noise(seed):
        out, _ = process_window(frames, opts, window,
                                generator=torch.Generator().manual_seed(seed))
        return (out - frames).numpy()

    a = noise(1)
    assert abs(a.mean()) < 0.02 and abs(a.std() - 2.5) < 0.02
    np.testing.assert_array_equal(a, noise(1))
    assert not np.array_equal(a, noise(2))
    out, _ = process_window(frames, opts, window)
    np.testing.assert_array_equal(out.numpy(), frames.numpy())


def test_compute_batched_dithers_each_utterance_in_turn():
    """``compute_batched`` draws each utterance's noise from the one
    generator in turn: two equal waveforms get different noise, and the
    batch equals the utterances extracted one at a time, in the batch's
    order, from the same generator."""
    mfcc = Mfcc(device="cpu")
    wave = _wave(8, 12000)
    waves = {"a": wave, "b": wave.copy(), "c": _wave(9, 9000)}
    got = compute_batched(mfcc, waves, generator=torch.Generator()
                          .manual_seed(5))
    assert not torch.allclose(got["a"], got["b"])
    g = torch.Generator().manual_seed(5)
    for u in ("a", "b", "c"):
        padded = np.zeros(16000, np.float32)
        padded[:len(waves[u])] = waves[u]
        one = mfcc.compute(torch.from_numpy(padded)[None], g)[0]
        np.testing.assert_array_equal(got[u].numpy(),
                                      one[:got[u].shape[0]].numpy())
    plain = compute_batched(mfcc, waves)
    np.testing.assert_array_equal(plain["a"].numpy(), plain["b"].numpy())


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="plp"):
        OnlineFeaturePipeline(OnlineFeatureOptions(feature_type="plp"),
                              device="cpu")
