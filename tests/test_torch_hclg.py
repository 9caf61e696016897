"""The port's monophone graph compilation (kaldi_aslp_tpu_torch/fst/hclg.py)
against the JAX package's kaldi_aslp_tpu/fst/hclg.py: per-utterance
training graphs (TrainingGraphCompiler.compile) and the HCLG decode graph
(make_decode_graph) on the toy lang of tests/test_gmm_hmm.py and a
five-word lexicon give the same states and arcs, the weights within 1e-6,
from transition models with the same (trained) log-probabilities."""

import logging

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu import fst as jfst
from kaldi_aslp_tpu.fst.hclg import TrainingGraphCompiler as JaxCompiler
from kaldi_aslp_tpu.fst.hclg import make_decode_graph as jax_hclg
from kaldi_aslp_tpu.gmm.mono import MonophoneTrainer as JaxMono
from kaldi_aslp_tpu_torch import fst as pfst
from kaldi_aslp_tpu_torch.fst import hclg as phclg
from kaldi_aslp_tpu_torch.fst.hclg import TrainingGraphCompiler
from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer

torch.set_num_threads(1)

LEXICONS = {"toy": "YES Y\nNO N\n",
            "five": "YES Y EH S\nNO N OW\nYO Y OW\nSEE S IY\nNOSE N OW Z\n"}
WEIGHT_ATOL = 1e-6


def _models(lexicon, trained):
    """(port lang, port transition model, JAX lang, JAX model), the
    models of the monophone trainers; ``trained`` gives both the same
    MLE log-probabilities from one random alignment."""
    lang = pfst.Lang.build(pfst.Lexicon.from_text(LEXICONS[lexicon]))
    jlang = jfst.Lang.build(jfst.Lexicon.from_text(LEXICONS[lexicon]))
    tm = MonophoneTrainer(lang, device="cpu").trans_model
    jtm = JaxMono(jlang).trans_model
    if trained:
        ali = np.random.RandomState(4).randint(
            1, tm.num_transition_ids + 1, 300)
        tm.mle_update(tm.accumulate(ali))
        jtm.mle_update(jtm.accumulate(ali))
    np.testing.assert_array_equal(tm.log_probs, jtm.log_probs)
    return lang, tm, jlang, jtm


def _assert_same(got, want):
    ga, wa = got.to_arrays(), want.to_arrays()
    assert sorted(ga) == sorted(wa)
    for key in wa:
        if key == "weight" or key == "final":
            np.testing.assert_allclose(np.asarray(ga[key]),
                                       np.asarray(wa[key]),
                                       atol=WEIGHT_ATOL, rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(np.asarray(ga[key]),
                                          np.asarray(wa[key]), err_msg=key)


@pytest.mark.parametrize("lexicon,words", [
    ("toy", ["YES", "NO"]), ("toy", ["NO", "NO", "YES", "NO"]),
    ("five", ["NOSE", "SEE", "YO"])])
@pytest.mark.parametrize("trained", [False, True])
def test_training_graphs_match_jax(lexicon, words, trained):
    lang, tm, jlang, jtm = _models(lexicon, trained)
    got = TrainingGraphCompiler(lang, tm).compile(words)
    want = JaxCompiler(jlang, jtm).compile(words)
    assert got.num_states > 4 * len(words)
    _assert_same(got, want)


@pytest.mark.parametrize("lexicon", ["toy", "five"])
@pytest.mark.parametrize("optimize", [False, True])
def test_decode_graph_matches_jax(lexicon, optimize):
    lang, tm, jlang, jtm = _models(lexicon, trained=True)
    words = sorted(pfst.Lexicon.from_text(LEXICONS[lexicon]).prons)
    probs = {w: (i + 1.0) / (len(words) * (len(words) + 1) / 2)
             for i, w in enumerate(words)}
    got = pfst.make_decode_graph(
        lang, pfst.make_unigram_grammar(probs, lang.words), tm,
        optimize=optimize)
    want = jax_hclg(jlang, jfst.make_unigram_grammar(probs, jlang.words),
                    jtm, optimize=optimize)
    _assert_same(got, want)


def test_linear_acceptor_matches_jax():
    ids = [3, 1, 4, 1, 5]
    _assert_same(pfst.make_linear_acceptor(ids),
                 jfst.lang.make_linear_acceptor(ids))


def test_decode_graph_keeps_the_raw_compose_with_a_warning(monkeypatch,
                                                           caplog):
    """Determinize's own error (a non-determinizable G) keeps the raw
    L o G and logs a warning that names it; any other error passes
    through (the JAX builder swallows every ``RuntimeError`` in silence,
    kaldi_aslp_tpu/fst/hclg.py:78-81)."""
    lang, tm, _, _ = _models("five", trained=True)
    G = pfst.make_unigram_grammar({"YES": 0.5, "NO": 0.5}, lang.words)

    def blowup(fst, *a, **k):
        raise pfst.NonDeterminizableError("determinize: state blowup")
    monkeypatch.setattr(phclg, "determinize", blowup)
    with caplog.at_level(logging.WARNING):
        got = phclg.make_decode_graph(lang, G, tm)
    assert any("not determinizable" in r.getMessage()
               and "state blowup" in r.getMessage() for r in caplog.records)
    _assert_same(got, phclg.make_decode_graph(lang, G, tm, optimize=False))

    def fault(fst, *a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(phclg, "determinize", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        phclg.make_decode_graph(lang, G, tm)
