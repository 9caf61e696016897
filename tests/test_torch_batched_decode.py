"""The port's batched decoders (kaldi_aslp_tpu_torch/decoder/batched.py
``BatchedViterbiDecoder``, decoder/beam.py ``BatchedBeamDecoder``) on the
CPU: each utterance of a ragged batch against the port's single decoder
and against JAX's batched decoder on the same graphs and scores, made
from seeds with numpy.  Words and alignments equal; scores within 1e-5
relative (dense) or 1e-3 (beam, as tests/test_beam_decode.py holds
JAX's own batch)."""

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.decoder.batched import (
    BatchedViterbiDecoder as JaxBatchedViterbi,
)
from kaldi_aslp_tpu.decoder.beam import (
    BatchedBeamDecoder as JaxBatchedBeam,
    CsrGraph as JaxCsr,
)
from kaldi_aslp_tpu_torch.decoder import (
    BatchedBeamDecoder,
    BatchedViterbiDecoder,
    BeamSearchDecoder,
    CsrGraph,
    DecodeError,
    ViterbiDecoder,
)

from test_torch_beam import _case, _peaked, _port, _word_loop, _yes_no

torch.set_num_threads(1)

DENSE_RTOL, BEAM_RTOL = 1e-5, 1e-3


def _ragged(ll, lens):
    """Utterances of ``lens`` frames cut from the rows of ``ll`` (rolled
    so that no two start alike)."""
    return [np.roll(ll, 3 * i, axis=0)[:n] for i, n in enumerate(lens)]


def _batches():
    """(name, JAX graph, lut, utterances, beam kwargs)."""
    g, lut, lang = _yes_no()
    y, n = lang.phones.id("Y"), lang.phones.id("N")
    seqs = [[0, y, y, 0], [0, n, n, 0, y, 0], [0, y, 0, n, 0, y, y, 0, 0],
            [0, n, 0]]
    yield ("yes_no", g, lut, [_peaked(lang, s) for s in seqs],
           dict(beam=1e9, max_active=64, arc_budget=1024, chunk=8))
    g, lut, ll, kw = _case("max_active_binds")
    yield "max_active_binds", g, lut, _ragged(ll, [40, 17, 33, 7, 25]), kw
    g, lut, ll, kw = _case("quantized_ties")
    yield "quantized_ties", g, lut, _ragged(ll, [36, 20, 9]), kw
    g, lut, ll, kw = _case("hub_at_the_cap")
    yield "hub_at_the_cap", g, lut, _ragged(ll, [8, 5, 7]), kw


BATCHES = {name: rest for name, *rest in _batches()}


def _same(got, want, rtol):
    (w1, a1, s1), (w2, a2, s2) = got, want
    assert w1 == w2
    np.testing.assert_array_equal(a1, np.asarray(a2))
    assert s1 == pytest.approx(s2, rel=rtol)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batched_beam_matches_single_and_jax(name):
    g, lut, utts, kw = BATCHES[name]
    port = BatchedBeamDecoder(CsrGraph.from_packed(_port(g)), lut,
                              acoustic_scale=1.0, device="cpu", **kw)
    single = BeamSearchDecoder(CsrGraph.from_packed(_port(g)), lut,
                               acoustic_scale=1.0, device="cpu", **kw)
    jax_dec = JaxBatchedBeam(JaxCsr.from_packed(g), lut, acoustic_scale=1.0,
                             **kw)
    got = port.decode_batch(utts)
    assert len(got) == len(utts)
    for u, r, want in zip(utts, got, jax_dec.decode_batch(utts)):
        _same(r, single.decode(u), 1e-6)
        _same(r, want, BEAM_RTOL)
    # scores already on the device (here the CPU's tensors) decode alike
    for r, t in zip(port.decode_batch([torch.from_numpy(u) for u in utts]),
                    got):
        _same(r, t, 0)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_batched_viterbi_matches_single_and_jax(name):
    g, lut, utts, _ = BATCHES[name]
    port = BatchedViterbiDecoder(_port(g), lut, device="cpu")
    single = ViterbiDecoder(_port(g), lut, device="cpu")
    jax_dec = JaxBatchedViterbi(g, lut, acoustic_scale=1.0)
    got = port.decode_batch(utts)
    for u, r, want in zip(utts, got, jax_dec.decode_batch(utts, bucket=16)):
        _same(r, single.decode(u), 1e-6)
        _same(r, want, DENSE_RTOL)


def test_batched_decoders_at_an_acoustic_scale():
    g, lut, _ = _word_loop(9)
    rng = np.random.RandomState(10)
    utts = [rng.uniform(-6.0, -0.5, size=(n, 17)).astype(np.float32)
            for n in (12, 30, 21, 8)]
    kw = dict(beam=14.0, max_active=16)
    port = BatchedBeamDecoder(_port(g), lut, acoustic_scale=0.3,
                              device="cpu", **kw)
    jax_dec = JaxBatchedBeam(JaxCsr.from_packed(g), lut, acoustic_scale=0.3,
                             **kw)
    for r, want in zip(port.decode_batch(utts), jax_dec.decode_batch(utts)):
        _same(r, want, BEAM_RTOL)
    dense = BatchedViterbiDecoder(_port(g), lut, acoustic_scale=0.3,
                                  device="cpu")
    jax_dense = JaxBatchedViterbi(g, lut, acoustic_scale=0.3)
    for r, want in zip(dense.decode_batch(utts),
                       jax_dense.decode_batch(utts, bucket=16)):
        _same(r, want, DENSE_RTOL)


def test_batched_viterbi_raises_decode_error_without_a_path():
    g, lut, lang = _yes_no()
    dec = BatchedViterbiDecoder(_port(g), lut, device="cpu")
    good = _peaked(lang, [0, lang.phones.id("Y"), 0])
    # every score -inf-like: no complete path in the second utterance
    dead = np.full((4, good.shape[1]), -1e31, np.float32)
    with pytest.raises(DecodeError):
        dec.decode_batch([good, dead])
    assert dec.decode_batch([]) == []


def test_a_batched_frame_is_each_rows_own_frame():
    """``_frame`` on [B, K] frontiers gives each row the planes and the
    frontier of ``_frame`` on that row alone."""
    g, lut, utts, kw = BATCHES["max_active_binds"]
    dec = BatchedBeamDecoder(_port(g), lut, device="cpu", **kw)
    B = len(utts)
    st0 = torch.from_numpy(dec._init_frontier()[0])
    sc0 = torch.from_numpy(dec._init_frontier()[1])
    st, sc = st0.expand(B, -1), sc0.expand(B, -1)
    rows = [(st0, sc0)] * B
    for t in range(5):
        ll = torch.from_numpy(np.stack([u[t] for u in utts]))
        arcs, slots = [], []
        st, sc = dec._frame(ll, st, sc, arcs, slots)
        assert len(arcs) == len(slots) == 1 + dec.eps_rounds
        for b in range(B):
            a1, s1 = [], []
            rows[b] = dec._frame(ll[b], *rows[b], a1, s1)
            assert torch.equal(st[b], rows[b][0])
            assert torch.equal(sc[b], rows[b][1])
            assert all(torch.equal(x[b], y) for x, y in zip(arcs, a1))
            assert all(torch.equal(x[b], y) for x, y in zip(slots, s1))
