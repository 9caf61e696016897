"""Pitch on the port (kaldi_aslp_tpu_torch/feats/pitch.py) against the
JAX package on the CPU, on the JAX pitch tests' own signals
(tests/test_pitch.py: a 220 Hz tone, a 150 -> 300 Hz change, noise, and
the four noisy tones batched three at a time), fixed by seed.

Tolerances, for ``compute_pitch`` (direct per-lag NCCF) and
``compute_pitch_batched`` (FFT NCCF over 1 s buckets) each:
  - the NCCF grid within 1e-5 absolute (float32 sums in another order);
    the batched grid is compared as the JAX program hands it to its
    Viterbi, less the lag penalty.  Its frames past an utterance's end
    (the 1 s bucket's padding, which JAX's Viterbi runs over) can hold
    no signal at a lag: the true NCCF is 0 and each package's float32
    FFT leaves its own rounding there (up to 7e-5 on these waves).
    Those frames are held to 1e-5 plus twice the float32 FFT's error
    bound, eps * log2(nfft) * |x1| |x2| / sqrt(e1 e2 + ballast); the
    utterances' own frames to 1e-5 alone;
  - the best-lag path equal on every frame; where a frame differs, both
    paths' total scores under JAX's local grid and transition costs
    agree within 1e-5 relative (a tie broken the other way), and the
    test prints how many frames differ;
  - POV within 1e-5 and log-pitch within 1e-6 on equal frames;
  - given JAX's local grid, the port's lag-Viterbi returns JAX's path
    exactly;
  - ``postprocess_pitch`` within 1e-6.
Then the JAX tests' own checks on the port."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.feats import pitch as jp
from kaldi_aslp_tpu_torch.feats import pitch as tp

torch.set_num_threads(1)

NCCF_ATOL = 1e-5
SCORE_RTOL = 1e-5
POV_ATOL = 1e-5
LOGP_ATOL = 1e-6
POST_ATOL = 1e-6


def _tone(f0, dur, sr=16000, amp=5000):
    t = np.arange(int(dur * sr)) / sr
    # add harmonics for realism
    return amp * (np.sin(2 * np.pi * f0 * t)
                  + 0.4 * np.sin(2 * np.pi * 2 * f0 * t)).astype(np.float32)


SIGNALS = {
    "tone": lambda: _tone(220.0, 1.0),
    "change": lambda: np.concatenate([_tone(150.0, 0.5), _tone(300.0, 0.5)]),
    "noise": lambda: (3000 * np.random.RandomState(777).randn(16000)
                      ).astype(np.float32),
}


def _batch_waves():
    """tests/test_pitch.py::test_pitch_batched_matches_single's waves."""
    rng = np.random.RandomState(777)
    waves = {}
    for i, (f0, dur) in enumerate([(120.0, 0.8), (200.0, 1.3),
                                   (95.0, 2.1), (310.0, 1.0)]):
        waves[f"u{i}"] = _tone(f0, dur) + 100 * rng.randn(
            int(dur * 16000)).astype(np.float32)
    return waves


def _lags(opts):
    return np.arange(int(opts.samp_freq / opts.max_f0),
                     int(opts.samp_freq / opts.min_f0) + 1)


def _path_of(logp, opts):
    """Lag indices from a log-pitch column (neighbouring lags' log-pitch
    differ by more than 3e-3, float32 resolves 1e-6)."""
    table = np.log(opts.samp_freq / _lags(opts).astype(np.float64))
    return np.abs(logp[:, None].astype(np.float64) - table[None]).argmin(1)


def _cost(opts, direct):
    """The transition costs each JAX function builds."""
    log_lags = np.log(_lags(opts).astype(np.float64))
    if direct:
        ll = log_lags.astype(np.float32)
        return np.float32(opts.penalty_factor) * (ll[:, None] - ll[None]) ** 2
    return opts.penalty_factor * np.asarray(
        (log_lags[:, None] - log_lags[None]) ** 2, np.float32)


def _score(local, cost, path):
    local = np.asarray(local, np.float64)
    return (local[np.arange(len(path)), path].sum()
            - np.asarray(cost, np.float64)[path[:-1], path[1:]].sum())


def _hold_paths(name, got, want, feats_got, feats_want, local, cost):
    """The path contract of the module docstring, on one utterance."""
    differ = got != want
    print(f"{name}: {int(differ.sum())} of {len(want)} frames differ")
    if differ.any():
        s_got, s_want = _score(local, cost, got), _score(local, cost, want)
        assert abs(s_got - s_want) <= SCORE_RTOL * abs(s_want), (s_got,
                                                                 s_want)
    eq = ~differ
    np.testing.assert_allclose(feats_got[eq, 0], feats_want[eq, 0],
                               rtol=0, atol=POV_ATOL)
    np.testing.assert_allclose(feats_got[eq, 1], feats_want[eq, 1],
                               rtol=0, atol=LOGP_ATOL)


@pytest.mark.parametrize("signal", sorted(SIGNALS))
def test_nccf_grid_matches_jax(signal):
    wave = SIGNALS[signal]()
    opts = jp.PitchOptions()
    want, lags_j = jp._nccf_grid(jnp.asarray(wave), opts)
    got, lags = tp.nccf_grid(torch.from_numpy(wave), tp.PitchOptions())
    np.testing.assert_array_equal(lags, lags_j)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=NCCF_ATOL)


@pytest.mark.parametrize("signal", sorted(SIGNALS))
def test_compute_pitch_matches_jax(signal, monkeypatch):
    """The direct path: features, the lag path, and the port's Viterbi
    on JAX's own local grid."""
    wave = SIGNALS[signal]()
    opts = jp.PitchOptions()
    grids = []
    inner = jp._lag_viterbi

    def record(local, log_lags, penalty):
        grids.append(np.asarray(local))
        return inner(local, log_lags, penalty)
    monkeypatch.setattr(jp, "_lag_viterbi", record)
    want = jp.compute_pitch(wave, opts)
    got = tp.compute_pitch(wave, tp.PitchOptions(), device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    local, cost = grids[0], _cost(opts, direct=True)
    path_j = _path_of(want[:, 1], opts)
    _hold_paths(signal, _path_of(got[:, 1], opts), path_j, got, want,
                local, cost)
    given = tp.lag_viterbi(torch.from_numpy(np.array(local))[None],
                           torch.from_numpy(cost))[0]
    np.testing.assert_array_equal(given, path_j)


def _fft_bound(arr, lens, opts):
    """[B, T_pad, L] float64: twice the float32 FFT correlation's error
    bound over the NCCF's normalizer, at each frame and lag."""
    g = tp._Geometry(tp.PitchOptions(**vars(opts)))
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
    nfft = 1 << int(np.ceil(np.log2(ext)))
    scale = np.sqrt(e1 * (x2 * x2).sum(-1))[..., None]
    return 2 * np.finfo(np.float32).eps * np.log2(nfft) * scale / np.sqrt(
        e1[..., None] * e2 + ballast[:, None, None] + 1e-20)


def _eager_batched(monkeypatch, waves, opts, batch_size):
    """JAX's ``compute_pitch_batched`` run without jit, each bucket's
    local grid recorded as its program hands it to ``lax.scan``:
    ({utt: [T, 2]}, [(padded waves, lens, local grid [B, T_pad, L])])."""
    records = []

    def scan(f, init, xs, reverse=False):
        if not reverse:
            records.append(np.swapaxes(np.concatenate(
                [np.asarray(init)[None], np.asarray(xs)]), 0, 1))
        return jax.lax.scan(f, init, xs, reverse=reverse)

    chunks = []
    inner = jp._batched_pitch_program

    def program(arr, lens, opts):
        chunks.append((np.asarray(arr), np.asarray(lens)))
        return inner(arr, lens, opts)
    monkeypatch.setattr(jp, "jax", types.SimpleNamespace(
        jit=lambda f: f, lax=types.SimpleNamespace(scan=scan)))
    monkeypatch.setattr(jp, "_batched_pitch_program", program)
    out = jp.compute_pitch_batched(waves, opts, batch_size=batch_size)
    monkeypatch.undo()
    return out, [(a, n, g) for (a, n), g in zip(chunks, records)]


def test_batched_pitch_matches_jax(monkeypatch):
    """The four noisy tones at batch_size=3 (three 1 s buckets, one of
    two utterances): the jitted JAX extractor's features and paths, and
    on each bucket the eager program's local grid against the port's,
    and the port's Viterbi on that grid against the eager path."""
    waves = _batch_waves()
    opts = jp.PitchOptions()
    topts = tp.PitchOptions()
    want = jp.compute_pitch_batched(waves, opts, batch_size=3)
    got = tp.compute_pitch_batched(waves, topts, batch_size=3, device="cpu")
    assert sorted(got) == sorted(want)
    eager, chunks = _eager_batched(monkeypatch, waves, opts, 3)
    assert len(chunks) == 3
    cost = _cost(opts, direct=False)
    g = tp._Geometry(topts)
    for arr, lens, local_j in chunks:
        local = tp._local_score(tp.batched_nccf(
            torch.from_numpy(arr), torch.from_numpy(lens), topts), g, topts)
        err = np.abs(local.numpy() - local_j)
        assert (err <= NCCF_ATOL + _fft_bound(arr, lens, opts)).all(), \
            err.max()
        given = tp.lag_viterbi(torch.from_numpy(local_j),
                               torch.from_numpy(cost))
        for j in range(arr.shape[0]):
            u = next((u for u in waves if lens[j] == len(waves[u])
                      and np.array_equal(arr[j, :len(waves[u])], waves[u])),
                     None)
            if u is None:
                continue     # a padding row
            T = len(eager[u])
            np.testing.assert_allclose(local.numpy()[j, :T],
                                       local_j[j, :T], rtol=0,
                                       atol=NCCF_ATOL)
            np.testing.assert_array_equal(
                given[j, :T], _path_of(eager[u][:, 1], opts))
            _hold_paths(u, _path_of(got[u].numpy()[:, 1], opts),
                        _path_of(want[u][:, 1], opts), got[u].numpy(),
                        want[u], local_j[j, :T], cost)
    for u in waves:
        assert got[u].dtype == torch.float32
        assert tuple(got[u].shape) == want[u].shape


@pytest.mark.parametrize("signal", ["tone-0.6s", "change"])
def test_postprocess_pitch_matches_jax(signal):
    wave = (_tone(200.0, 0.6) if signal == "tone-0.6s"
            else SIGNALS["change"]())
    raw = jp.compute_pitch(wave, jp.PitchOptions())
    want = jp.postprocess_pitch(raw)
    for given in (raw, torch.from_numpy(raw)):
        got = tp.postprocess_pitch(given)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=POST_ATOL)


def test_viterbi_frames_are_counted():
    before = tp.lag_viterbi.frames
    feats = tp.compute_pitch(_tone(220.0, 0.5), device="cpu")
    assert tp.lag_viterbi.frames - before == len(feats) - 1


# -- tests/test_pitch.py's checks on the port ------------------------------

def test_pitch_tracks_tone():
    feats = tp.compute_pitch(_tone(220.0, 1.0), device="cpu")
    assert feats.shape[1] == 2
    f0 = np.exp(feats[5:-5, 1])
    assert abs(np.median(f0) - 220.0) < 8.0, np.median(f0)
    assert feats[5:-5, 0].mean() > 0.6


def test_pitch_follows_change():
    feats = tp.compute_pitch(SIGNALS["change"](), device="cpu")
    T = len(feats)
    first = np.exp(np.median(feats[5:T // 2 - 5, 1]))
    second = np.exp(np.median(feats[T // 2 + 5:-5, 1]))
    assert abs(first - 150.0) < 10
    assert abs(second - 300.0) < 15


def test_pitch_noise_has_low_pov():
    feats = tp.compute_pitch(SIGNALS["noise"](), device="cpu")
    tone_feats = tp.compute_pitch(_tone(220.0, 1.0), device="cpu")
    assert feats[:, 0].mean() < tone_feats[:, 0].mean() - 0.2


def test_pitch_batched_matches_single():
    waves = _batch_waves()
    batched = tp.compute_pitch_batched(waves, batch_size=3, device="cpu")
    for u, w in waves.items():
        ref = tp.compute_pitch(w, device="cpu")
        got = batched[u].numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(np.exp(got[:, 1]), np.exp(ref[:, 1]),
                                   atol=1.0)
        np.testing.assert_allclose(got[:, 0], ref[:, 0], atol=1e-5)


def test_postprocess_pitch_flattens_a_tone():
    raw = tp.compute_pitch(_tone(200.0, 0.6), device="cpu")
    out = tp.postprocess_pitch(raw)
    assert out.shape == (len(raw), 3)
    assert abs(out[10:-10, 1].mean()) < 0.05


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.compute_pitch(_tone(220.0, 0.5))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.compute_pitch_batched({"u": _tone(220.0, 0.5)})
