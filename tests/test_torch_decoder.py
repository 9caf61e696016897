"""The port's dense Viterbi decoders and endpoint rules
(kaldi_aslp_tpu_torch/decoder/, online/endpoint.py) against the JAX
package's, on CTC decode graphs built by the shared ``kaldi_aslp_tpu.fst``.
Words, alignments and partial paths must be equal; scores rel=1e-5."""

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.decoder import (
    PackedGraph as JaxPackedGraph,
    ViterbiDecoder as JaxViterbiDecoder,
)
from kaldi_aslp_tpu.decoder.online import (
    OnlineViterbiDecoder as JaxOnlineViterbiDecoder,
)
from kaldi_aslp_tpu.fst import Lang, Lexicon, make_unigram_grammar
from kaldi_aslp_tpu.fst.ctc_graph import ctc_lut, make_ctc_decode_graph
from kaldi_aslp_tpu_torch.decoder.online import OnlineViterbiDecoder
from kaldi_aslp_tpu_torch.decoder.viterbi import (
    DecodeError,
    PackedGraph,
    ViterbiDecoder,
)
from kaldi_aslp_tpu_torch.online.endpoint import (
    OnlineEndpointConfig,
    endpoint_detected,
)

torch.set_num_threads(1)


def _graph(lexicon_text, probs):
    lang = Lang.build(Lexicon.from_text(lexicon_text))
    tlg = make_ctc_decode_graph(lang, make_unigram_grammar(probs, lang.words))
    return lang, tlg, ctc_lut(len(lang.phones))


def _ctc_setup():
    """The graph of tests/test_online.py:_ctc_setup."""
    return _graph("YES Y\nNO N\n<SIL> SIL\n", {"YES": 0.5, "NO": 0.5})


def _larger_setup():
    words = ["AB", "CA", "BC", "DEF", "FED", "ABE"]
    lex = "\n".join(f"{w} {' '.join(w)}" for w in words) + "\n<SIL> SIL\n"
    return _graph(lex, {w: 1.0 / len(words) for w in words})


def _ctc_scores(lang, seq):
    V = len(lang.phones)
    ll = np.full((len(seq), V), np.log(0.01), np.float32)
    for t, u in enumerate(seq):
        ll[t, u] = np.log(0.9)
    return ll


def _cases():
    lang, tlg, lut = _ctc_setup()
    y, n = lang.phones.id("Y"), lang.phones.id("N")
    V = len(lang.phones)
    seq = [0, y, y, 0, 0, n, n, 0, y, 0]
    yield "yes_no", tlg, lut, _ctc_scores(lang, seq)
    # every score equal: every state's best arc is decided by the tie rule
    yield "all_ties", tlg, lut, np.zeros((9, V), np.float32)
    # quantized scores: many exact ties between competing paths
    rs = np.random.RandomState(0)
    yield "coarse_ties", tlg, lut, np.log(
        rs.randint(1, 4, size=(14, V)) / 4.0).astype(np.float32)
    lang, tlg, lut = _larger_setup()
    yield "random", tlg, lut, np.log(np.random.RandomState(1).dirichlet(
        np.ones(len(lang.phones)), size=40)).astype(np.float32)


CASES = list(_cases())
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_viterbi_matches_jax(case):
    _, tlg, lut, ll = case
    words_j, ali_j, score_j = JaxViterbiDecoder(
        JaxPackedGraph.from_fst(tlg), lut).decode(ll)
    words_p, ali_p, score_p = ViterbiDecoder(
        PackedGraph.from_fst(tlg), lut, device="cpu").decode(ll)
    assert words_p == words_j
    np.testing.assert_array_equal(ali_p, ali_j)
    assert score_p == pytest.approx(score_j, rel=1e-5)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_online_viterbi_matches_jax(case):
    _, tlg, lut, ll = case
    jax_dec = JaxOnlineViterbiDecoder(JaxPackedGraph.from_fst(tlg), lut,
                                      chunk_bucket=4)
    port_dec = OnlineViterbiDecoder(PackedGraph.from_fst(tlg), lut,
                                    device="cpu")
    assert port_dec.final_relative_cost() == jax_dec.final_relative_cost()
    bounds = [0, 3, 4, 7] + list(range(11, len(ll), 5)) + [len(ll)]
    for a, b in zip(bounds[:-1], bounds[1:]):
        if a >= b:
            continue
        jax_dec.advance_decoding(ll[a:b])
        port_dec.advance_decoding(ll[a:b])
        assert port_dec.num_frames_decoded == jax_dec.num_frames_decoded
        assert port_dec.get_partial_path() == jax_dec.get_partial_path()
        assert port_dec.final_relative_cost() == pytest.approx(
            jax_dec.final_relative_cost(), rel=1e-5)
        sil = np.array([1, 2])
        assert (port_dec.trailing_silence_frames(sil)
                == jax_dec.trailing_silence_frames(sil))
    words_j, ali_j, score_j = jax_dec.finalize_decoding()
    words_p, ali_p, score_p = port_dec.finalize_decoding()
    assert words_p == words_j
    np.testing.assert_array_equal(ali_p, ali_j)
    assert score_p == pytest.approx(score_j, rel=1e-5)
    port_dec.reset()
    assert port_dec.num_frames_decoded == 0
    assert port_dec.get_partial_path() == []


def test_word_insertion_penalty_matches_jax():
    _, tlg, lut, ll = CASES[3]
    for penalty in (0.5, 3.0):
        want = JaxViterbiDecoder(JaxPackedGraph.from_fst(tlg), lut,
                                 word_ins_penalty=penalty).decode(ll)
        got = ViterbiDecoder(PackedGraph.from_fst(tlg), lut,
                             word_ins_penalty=penalty,
                             device="cpu").decode(ll)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == pytest.approx(want[2], rel=1e-5)


def test_no_complete_path_is_a_decode_error():
    """Scores that leave no path through the graph: JAX raises a
    RuntimeError, the port its subclass DecodeError, the one failure a
    recipe may score as an empty hypothesis."""
    lang, tlg, lut = _ctc_setup()
    ll = np.full((6, len(lang.phones)), -np.inf, np.float32)
    with pytest.raises(RuntimeError, match="no complete path"):
        JaxViterbiDecoder(JaxPackedGraph.from_fst(tlg), lut).decode(ll)
    with pytest.raises(DecodeError, match="no complete path"):
        ViterbiDecoder(PackedGraph.from_fst(tlg), lut,
                       device="cpu").decode(ll)


def test_packed_graph_matches_jax():
    _, tlg, _, _ = CASES[3]
    a, b = PackedGraph.from_fst(tlg), JaxPackedGraph.from_fst(tlg)
    assert a.eps_diameter == b.eps_diameter
    assert a.num_states == b.num_states and a.start == b.start
    for name in ("src", "dst", "ilabel", "olabel", "weight", "final"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_endpoint_rules():
    """The cases of tests/test_online.py:test_endpoint_rules."""
    cfg = OnlineEndpointConfig()
    # mostly silence, 5.5s trailing -> rule 1 (no final state needed)
    assert endpoint_detected(cfg, 600, 550)
    # decoded + short trailing silence -> no endpoint
    assert not endpoint_detected(cfg, 100, 20)
    # 1.1s trailing silence + good final state -> rule 3
    assert endpoint_detected(cfg, 300, 110, final_relative_cost=0.0)
    # 1.1s trailing silence but no reachable final state: rules 2/3
    # gated off by max_relative_cost
    assert not endpoint_detected(cfg, 300, 110)
    # ... until silence reaches rule 4's 2s threshold
    assert endpoint_detected(cfg, 300, 210)
    # rule 2 fires at 0.6s only when the final state is very good
    assert endpoint_detected(cfg, 300, 60, final_relative_cost=1.0)
    assert not endpoint_detected(cfg, 300, 60, final_relative_cost=5.0)
    # very long utterance -> rule 5
    assert endpoint_detected(cfg, 2100, 0)
    assert not endpoint_detected(cfg, 0, 0)
