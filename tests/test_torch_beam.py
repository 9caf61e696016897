"""The port's beam decoder (kaldi_aslp_tpu_torch/decoder/beam.py) on the
CPU against the JAX package's ``BeamSearchDecoder`` on the graphs and
scores of tests/test_beam_decode.py, made from seeds with numpy: the
same words, the same alignment, and the score within 1e-5 relative.

Ties are common when scores are quantized; the case with scores on a
0.5 grid holds the port's sort orders to JAX's (a stable dedup sort, a
top-K that takes the lower index first), which pick among equal-score
paths."""

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.decoder import PackedGraph as JaxPackedGraph
from kaldi_aslp_tpu.decoder.beam import (
    BeamSearchDecoder as JaxBeam,
    CsrGraph as JaxCsr,
)
from kaldi_aslp_tpu.fst import Lang as JaxLang, Lexicon as JaxLexicon
from kaldi_aslp_tpu.fst import make_unigram_grammar as jax_unigram
from kaldi_aslp_tpu.fst.ctc_graph import (
    ctc_lut as jax_ctc_lut,
    make_ctc_decode_graph as jax_ctc_graph,
)
from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
from kaldi_aslp_tpu_torch.decoder.viterbi import (
    DecodeError,
    PackedGraph,
    ViterbiDecoder,
)

torch.set_num_threads(1)

RTOL = 1e-5


def _port(g: JaxPackedGraph) -> PackedGraph:
    return PackedGraph(src=g.src, dst=g.dst, ilabel=g.ilabel,
                       olabel=g.olabel, weight=g.weight, final=g.final,
                       start=g.start, num_states=g.num_states,
                       eps_diameter=g.eps_diameter)


def _graph(src, dst, il, ol, w, final, eps_diameter=1):
    return JaxPackedGraph(
        src=np.asarray(src, np.int32), dst=np.asarray(dst, np.int32),
        ilabel=np.asarray(il, np.int32), olabel=np.asarray(ol, np.int32),
        weight=np.asarray(w, np.float32),
        final=np.asarray(final, np.float32), start=0,
        num_states=len(final), eps_diameter=eps_diameter)


def _lut(npdf):
    lut = np.arange(-1, npdf, dtype=np.int32)
    lut[0] = 0
    return lut


def _yes_no(words=("YES", "NO"), probs=(0.6, 0.4)):
    """tests/test_beam_decode.py:_small_setup: the CTC TLG of a
    two-word unigram."""
    lex = JaxLexicon.from_text("YES Y\nNO N\n<SIL> SIL\n")
    lang = JaxLang.build(lex)
    G = jax_unigram(dict(zip(words, probs)), lang.words)
    return (JaxPackedGraph.from_fst(jax_ctc_graph(lang, G)),
            jax_ctc_lut(len(lang.phones)), lang)


def _peaked(lang, seq, conf=0.9):
    """tests/test_beam_decode.py:_scores."""
    V = len(lang.phones)
    ll = np.full((len(seq), V), np.log((1 - conf) / (V - 1)), np.float32)
    for t, u in enumerate(seq):
        ll[t, u] = np.log(conf)
    return ll


def _hub(seed=5, n_spokes=200, npdf=8):
    """tests/test_beam_decode.py::test_hub_state_cap_exact's graph: an
    eps hub with out-degree far past the arc budget."""
    rng = np.random.RandomState(seed)
    src, dst, il, ol, w = [], [], [], [], []
    for k in range(n_spokes):
        a = 1 + 2 * k
        src += [0, a, a, a + 1, a + 1]
        dst += [a, a, a + 1, a + 1, 0]
        il += [0, 1 + (k % npdf), 1 + ((k + 3) % npdf),
               1 + ((k + 5) % npdf), 0]
        ol += [k + 1, 0, 0, 0, 0]
        w += [float(rng.uniform(0.1, 9.0)), 0.7, 0.7, 0.7, 0.1]
    final = np.full(1 + 2 * n_spokes, np.inf, np.float32)
    final[0] = 0.0
    ll = rng.uniform(-6.0, -1.0, size=(8, npdf + 1)).astype(np.float32)
    return _graph(src, dst, il, ol, w, final), _lut(npdf), ll


def _word_loop(seed, num_words=40, phones_per_word=2, npdf=16,
               quantum=0.0):
    """A small synth_hclg (tests/test_beam_decode.py): per word a chain
    of 3-state HMMs with self-loops, an eps entry arc from the loop
    state with an LM cost, and a word-end arc back to it.  With
    ``quantum`` the LM costs sit on that grid."""
    rng = np.random.RandomState(seed)
    spw = 3 * phones_per_word
    S = 1 + num_words * spw
    pdf = rng.randint(0, npdf, size=(num_words, spw))
    lm = rng.uniform(1.0, 4.0, size=num_words)
    if quantum:
        lm = np.round(lm / quantum) * quantum
    base = 1 + np.arange(num_words)[:, None] * spw + np.arange(spw)[None]
    tid = pdf + 1
    fw_dst = (base + 1).reshape(-1)
    fw_dst[spw - 1::spw] = 0
    fw_ol = np.zeros(base.size, np.int32)
    fw_ol[spw - 1::spw] = np.arange(1, num_words + 1)
    loop_w = 0.5 if quantum else 0.693
    src = np.concatenate([base.reshape(-1), base.reshape(-1),
                          np.zeros(num_words, np.int64)])
    dst = np.concatenate([base.reshape(-1), fw_dst, base[:, 0]])
    il = np.concatenate([tid.reshape(-1), tid.reshape(-1),
                         np.zeros(num_words, np.int64)])
    ol = np.concatenate([np.zeros(base.size, np.int32), fw_ol,
                         np.zeros(num_words, np.int32)])
    w = np.concatenate([np.full(2 * base.size, loop_w), lm])
    final = np.full(S, np.inf, np.float32)
    final[0] = 0.0
    return _graph(src, dst, il, ol, w, final), _lut(npdf), pdf


def _case(name):
    """(JAX graph, lut, loglikes, decoder kwargs) for each case."""
    if name in ("wide_beam", "narrow_beam"):
        g, lut, lang = _yes_no()
        y, n = lang.phones.id("Y"), lang.phones.id("N")
        if name == "wide_beam":
            ll = _peaked(lang, [0, y, y, 0, n, 0, y, 0])
            return g, lut, ll, dict(beam=1e9, max_active=64,
                                    arc_budget=1024, chunk=8)
        ll = _peaked(lang, [0, y, y, 0], conf=0.99)
        return g, lut, ll, dict(beam=6.0, max_active=8, arc_budget=256,
                                chunk=8)
    if name == "no_eps_arcs":
        g = _graph([0, 1], [1, 2], [1, 2], [7, 0], [0.5, 0.5],
                   [np.inf, np.inf, 0.0])
        ll = np.full((2, 4), -5.0, np.float32)
        ll[0, 0] = ll[1, 1] = -0.1
        return g, _lut(3), ll, dict(beam=10.0, max_active=4, chunk=4)
    if name == "empty_utterance":
        g = _graph([0, 1], [1, 1], [0, 1], [9, 0], [0.25, 0.5],
                   [np.inf, 0.0])
        return g, _lut(2), np.zeros((0, 3), np.float32), dict(
            beam=10.0, max_active=4, chunk=4)
    if name == "hub_at_the_cap":
        g, lut, ll = _hub()
        return g, lut, ll, dict(beam=1e9, max_active=16, chunk=8)
    if name == "max_active_binds":
        g, lut, _ = _word_loop(3)
        rng = np.random.RandomState(4)
        ll = rng.uniform(-6.0, -0.5, size=(40, 17)).astype(np.float32)
        return g, lut, ll, dict(beam=20.0, max_active=12, chunk=16)
    if name == "quantized_ties":
        g, lut, _ = _word_loop(6, quantum=0.5)
        rng = np.random.RandomState(7)
        ll = np.round(rng.uniform(-4.0, 0.0, size=(36, 17)) * 2) / 2
        return g, lut, ll.astype(np.float32), dict(
            beam=12.0, max_active=24, chunk=16)
    if name == "quantized_ctc":
        g, lut, lang = _yes_no(probs=(0.5, 0.5))
        rng = np.random.RandomState(8)
        V = len(lang.phones) + 1
        ll = np.round(rng.uniform(-3.0, 0.0, size=(30, V)) * 2) / 2
        return g, lut, ll.astype(np.float32), dict(
            beam=8.0, max_active=4, arc_budget=16, chunk=8)
    raise KeyError(name)


CASES = ["wide_beam", "narrow_beam", "no_eps_arcs", "empty_utterance",
         "hub_at_the_cap", "max_active_binds", "quantized_ties",
         "quantized_ctc"]


def _decoders(g, lut, kw):
    jdec = JaxBeam(JaxCsr.from_packed(g), lut, acoustic_scale=1.0, **kw)
    pdec = BeamSearchDecoder(CsrGraph.from_packed(_port(g)), lut,
                             acoustic_scale=1.0, device="cpu", **kw)
    return jdec, pdec


def _same(got, want):
    (w1, a1, s1), (w2, a2, s2) = got, want
    assert w1 == w2
    np.testing.assert_array_equal(a1, np.asarray(a2))
    assert s1 == pytest.approx(s2, rel=RTOL)


@pytest.mark.parametrize("name", CASES)
def test_decode_matches_jax(name):
    g, lut, ll, kw = _case(name)
    jdec, pdec = _decoders(g, lut, kw)
    got, want = pdec.decode(ll), jdec.decode(ll)
    _same(got, want)
    # the port's own structure: K, budgets and eps rounds as in JAX
    assert (pdec.K, pdec.A, pdec.A_em, pdec.eps_rounds) == (
        jdec.K, jdec.A, jdec.A_em, jdec.eps_rounds)
    # a tensor input decodes as the numpy one does
    _same(pdec.decode(torch.from_numpy(ll)), got)


def test_cases_exercise_what_they_name():
    """The hub case's hub degree exceeds its arc budget, the max-active
    case's frontier fills, and the tie cases hold equal-score
    candidates in one stage."""
    g, lut, ll, kw = _case("hub_at_the_cap")
    _, pdec = _decoders(g, lut, kw)
    hub_deg = int(np.diff(pdec.graph.ep_row_ptr)[0])
    assert hub_deg == 200 > pdec.A == 64
    for name in ("max_active_binds", "quantized_ties", "quantized_ctc"):
        g, lut, ll, kw = _case(name)
        _, pdec = _decoders(g, lut, kw)
        st = torch.from_numpy(pdec._init_frontier()[0])
        sc = torch.from_numpy(pdec._init_frontier()[1])
        full = ties = 0
        for t in range(len(ll)):
            st, sc = pdec._frame(torch.from_numpy(ll[t]), st, sc, [], [])
            live = sc[st >= 0]
            full += int((st >= 0).all())
            ties += int(len(live) > len(torch.unique(live)))
        assert full > 0, name
        if name.startswith("quantized"):
            assert ties > len(ll) // 2, name


@pytest.mark.parametrize("name", ["wide_beam", "hub_at_the_cap"])
def test_wide_beam_matches_the_dense_viterbi(name):
    g, lut, ll, kw = _case(name)
    _, pdec = _decoders(g, lut, kw)
    words, ali, score = pdec.decode(ll)
    words_d, ali_d, score_d = ViterbiDecoder(_port(g), lut,
                                             device="cpu").decode(ll)
    assert words == words_d
    np.testing.assert_array_equal(ali, ali_d)
    assert score == pytest.approx(score_d, rel=RTOL)


@pytest.mark.parametrize("name", ["wide_beam", "hub_at_the_cap",
                                  "no_eps_arcs", "max_active_binds"])
def test_csr_graph_arrays_equal_jax(name):
    g = _case(name)[0]
    got, want = CsrGraph.from_packed(_port(g)), JaxCsr.from_packed(g)
    for field in ("em_row_ptr", "em_dst", "em_tid", "em_olabel",
                  "em_weight", "em_arc", "ep_row_ptr", "ep_dst",
                  "ep_olabel", "ep_weight", "ep_arc", "final"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        assert np.array_equal(a, b), field
    assert (got.start, got.num_states, got.eps_diameter) == (
        want.start, want.num_states, want.eps_diameter)


def test_empty_frontier_raises_decode_error():
    """tests/test_beam_decode.py::test_decode_empty_frontier_raises: a
    dead-end graph kills every token; the port raises DecodeError (a
    RuntimeError), as JAX raises RuntimeError."""
    g = _graph([0], [1], [1], [1], [0.5], [np.inf, 0.0], eps_diameter=0)
    lut = np.array([0, 0], np.int32)
    kw = dict(beam=10.0, max_active=4, arc_budget=16, chunk=4)
    jdec, pdec = _decoders(g, lut, kw)
    ll = np.full((3, 1), -1.0, np.float32)
    with pytest.raises(RuntimeError, match="empty frontier"):
        jdec.decode(ll)
    with pytest.raises(DecodeError, match="empty frontier"):
        pdec.decode(ll)
    # an utterance the graph can end: one frame reaches the final state
    words, ali, score = pdec.decode(ll[:1])
    assert words == [1] and list(ali) == [1]


def test_decode_many_equals_decode():
    g, lut, lang = _yes_no()
    y, n = lang.phones.id("Y"), lang.phones.id("N")
    lls = [_peaked(lang, s) for s in ([0, y, y, 0], [0, n, n, 0, y, 0],
                                      [0, y, 0, n, 0, y, y, 0, 0], [],
                                      [0, n, 0])]
    kw = dict(beam=1e9, max_active=64, arc_budget=1024, chunk=8)
    jdec, pdec = _decoders(g, lut, kw)
    got = pdec.decode_many(lls, ahead=2)
    assert len(got) == len(lls)
    for x, out in zip(lls, got):
        _same(out, pdec.decode(x))
        _same(out, jdec.decode(x))


def test_packed_graph_input_and_defaults():
    """A PackedGraph is packed to CSR on the way in; the arc budget
    defaults to 4K and the emitting budget to K times the largest
    emitting out-degree."""
    g, lut, _ = _yes_no()
    dec = BeamSearchDecoder(_port(g), lut, max_active=32, device="cpu")
    assert isinstance(dec.graph, CsrGraph)
    assert (dec.K, dec.A, dec.beam, dec.chunk) == (32, 128, 16.0, 128)
    max_deg = int(np.diff(dec.graph.em_row_ptr).max())
    assert dec.A_em == min(128, 32 * max_deg)
