"""The port's own graph builders (kaldi_aslp_tpu_torch/fst/) against the
JAX package's kaldi_aslp_tpu/fst/: the same CTC decoding graph from the
same lexicon and grammar, compositions equal to the JAX package's
(its native helper where it builds, and its Python path), determinize and
minimize, and the OpenFst text formats both ways.  Graph building is
exact integer and float32 bookkeeping, so everything is compared for
equality."""

import logging

import numpy as np
import pytest

from kaldi_aslp_tpu import fst as jfst
from kaldi_aslp_tpu.fst.ctc_graph import make_ctc_decode_graph as jax_tlg
from kaldi_aslp_tpu_torch import fst as pfst
from kaldi_aslp_tpu_torch.fst import ctc_graph as pctc_graph
from kaldi_aslp_tpu_torch.fst.ctc_graph import make_ctc_decode_graph

LEXICON = ("YES Y EH S\nNO N OW\nYO Y OW\nSEE S IY\nNOSE N OW Z\n"
           "<SIL> SIL\n")
PROBS = {"YES": 0.3, "NO": 0.3, "YO": 0.1, "SEE": 0.2, "NOSE": 0.1}


def _assert_same(got, want):
    ga, wa = got.to_arrays(), want.to_arrays()
    assert sorted(ga) == sorted(wa)
    for key, w in wa.items():
        np.testing.assert_array_equal(np.asarray(ga[key]), np.asarray(w),
                                      err_msg=key)


def _lang(pkg):
    return pkg.Lang.build(pkg.Lexicon.from_text(LEXICON))


@pytest.mark.parametrize("sil_prob", [0.0, 0.5])
def test_ctc_decode_graph_matches_jax(sil_prob):
    lang, lang_j = _lang(pfst), _lang(jfst)
    assert lang.phones.to_text() == lang_j.phones.to_text()
    assert lang.words.to_text() == lang_j.words.to_text()
    got = make_ctc_decode_graph(
        lang, pfst.make_unigram_grammar(PROBS, lang.words),
        sil_prob=sil_prob)
    want = jax_tlg(lang_j, jfst.make_unigram_grammar(PROBS, lang_j.words),
                   sil_prob=sil_prob)
    assert got.num_states > 10
    _assert_same(got, want)
    np.testing.assert_array_equal(pfst.ctc_lut(9), jfst.ctc_lut(9))


def _random_fst(pkg, rs, states, labels, eps_share):
    f = pkg.Fst()
    for _ in range(states):
        f.add_state()
    f.set_start(0)
    for s in range(states):
        for _ in range(rs.randint(1, 4)):
            il = 0 if rs.rand() < eps_share else int(rs.randint(1, labels))
            ol = 0 if rs.rand() < eps_share else int(rs.randint(1, labels))
            f.add_arc(s, pkg.Arc(il, ol, float(np.float32(rs.rand())),
                                 int(rs.randint(0, states))))
    f.set_final(states - 1, 0.5)
    f.set_final(int(rs.randint(0, states - 1)))
    return f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compose_matches_jax_native_and_python(seed):
    """The port keeps only the Python composition; the JAX package's
    ``compose`` takes its native helper where it builds and says the two
    agree, and its ``_compose_py`` is the same algorithm."""
    rs = np.random.RandomState(seed)
    a_rs, b_rs = (np.random.RandomState(rs.randint(1 << 30))
                  for _ in range(2))
    a, b = _random_fst(pfst, a_rs, 7, 5, 0.3), _random_fst(pfst, b_rs, 6, 5,
                                                           0.3)
    a_j = jfst.Fst.from_text(a.to_text())
    b_j = jfst.Fst.from_text(b.to_text())
    got = a.compose(b)
    _assert_same(got, a_j._compose_py(b_j))
    _assert_same(got, a_j.compose(b_j))
    _assert_same(got.remove_epsilon(), a_j.compose(b_j).remove_epsilon())


def test_determinize_and_minimize_match_jax():
    lang, lang_j = _lang(pfst), _lang(jfst)
    lg = pfst.make_lexicon_fst(lang, 0.3).arc_sort("olabel").compose(
        pfst.make_unigram_grammar(PROBS, lang.words)).remove_epsilon()
    lg_j = jfst.make_lexicon_fst(lang_j, 0.3).arc_sort("olabel").compose(
        jfst.make_unigram_grammar(PROBS, lang_j.words)).remove_epsilon()
    _assert_same(lg, lg_j)
    det, det_j = pfst.determinize(lg), jfst.determinize(lg_j)
    _assert_same(det, det_j)
    _assert_same(pfst.minimize_encoded(det), jfst.minimize_encoded(det_j))
    _assert_same(lg.connect().arc_sort(), lg_j.connect().arc_sort())


def test_text_formats_round_trip_both_ways():
    lang = _lang(pfst)
    tlg = make_ctc_decode_graph(lang,
                                pfst.make_unigram_grammar(PROBS, lang.words))
    text = tlg.to_text()
    again = pfst.Fst.from_text(text)
    assert again.to_text() == text
    assert again.num_arcs == tlg.num_arcs and again.finals.keys() == \
        tlg.finals.keys()
    # what each package writes, the other reads (the text keeps weights
    # to 6 digits, as OpenFst's does)
    again_j = jfst.Fst.from_text(text)
    assert again_j.to_text() == text
    _assert_same(again, again_j)
    _assert_same(pfst.Fst.from_text(again_j.to_text()), again)
    words = lang.words.to_text()
    table = pfst.SymbolTable.from_text(words)
    assert table.to_text() == words
    assert jfst.SymbolTable.from_text(words).to_text() == words
    assert [table.sym(i) for i in range(len(table))] == [
        lang.words.sym(i) for i in range(len(lang.words))]
    assert table.id("NOSE") == lang.words.id("NOSE") and "YO" in table


def test_ctc_decode_graph_keeps_the_raw_compose_with_a_warning(monkeypatch,
                                                               caplog):
    """Determinize's own error keeps the raw L o G with a warning that
    names it (the TLG then holds more than one path a labeling, and the
    warning says so in the log); any other error passes through (the
    JAX builder swallows every ``RuntimeError`` in silence,
    kaldi_aslp_tpu/fst/ctc_graph.py:129-132)."""
    lang = _lang(pfst)
    G = pfst.make_unigram_grammar(PROBS, lang.words)
    L = pfst.make_lexicon_fst(lang, sil_prob=1e-7).arc_sort("olabel")
    raw = pfst.expand_ctc(L.compose(G).remove_epsilon(), lambda ph: ph)

    def blowup(fst, *a, **k):
        raise pfst.NonDeterminizableError("determinize: state blowup")
    monkeypatch.setattr(pctc_graph, "determinize", blowup)
    with caplog.at_level(logging.WARNING):
        got = make_ctc_decode_graph(lang, G)
    assert any("not determinizable" in r.getMessage()
               and "state blowup" in r.getMessage() for r in caplog.records)
    _assert_same(got, raw)

    def fault(fst, *a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(pctc_graph, "determinize", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        make_ctc_decode_graph(lang, G)
