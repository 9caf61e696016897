"""The port's fbank front end and online feature pipeline
(kaldi_aslp_tpu_torch/feats/, online/feature_pipeline.py) against the JAX
package's ``Fbank`` and ``OnlineFeaturePipeline``.  Tolerance
rtol=atol=1e-4 on log-mel values: float32 FFTs of two libraries."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_aslp_tpu.feats import (
    Fbank as JaxFbank,
    FrameExtractionOptions as JaxFrameOpts,
    MelBanksOptions as JaxMelOpts,
)
from kaldi_aslp_tpu.feats.mel import mel_banks_matrix as jax_mel_banks
from kaldi_aslp_tpu.feats.window import extract_frames as jax_extract_frames
from kaldi_aslp_tpu.online.feature_pipeline import (
    OnlineFeatureOptions as JaxOnlineOpts,
    OnlineFeaturePipeline as JaxOnlinePipeline,
)
from kaldi_aslp_tpu_torch.feats.fbank import Fbank
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions, mel_banks_matrix
from kaldi_aslp_tpu_torch.feats.window import (
    FrameExtractionOptions,
    extract_frames,
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


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="dither"):
        Fbank(device="cpu")(_wave(5, 1000))
    with pytest.raises(NotImplementedError, match="mfcc"):
        OnlineFeaturePipeline(OnlineFeatureOptions(feature_type="mfcc"),
                              device="cpu")
