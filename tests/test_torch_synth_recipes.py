"""The port's GMM-side synthetic recipes against the JAX package on the
CPU, from the same numpy-seeded inputs (recipes/rm_synth.py in
tests/test_torch_rm_synth.py):

  * recipes/timit_synth.py: ``prepare_cd_phone_system`` on the same
    triphone system (the port's mono alignments fed to both packages'
    ``DeltasTrainer``, as tests/test_torch_tri.py does) gives JAX's
    targets, number of CD phones, decode graph and lut, for each of the
    three statistics methods; its L o G determinization keeps the raw
    compose only on ``NonDeterminizableError``, with a warning, and lets
    any other error through (JAX's swallows every ``RuntimeError``);
  * recipes/decode_budget_sweep.py ``run``: the monophone sweep's dev
    WER at each frontier budget equals JAX's on the tiny ladder corpus
    of tests/test_torch_ladder.py.

The features fed to both packages are JAX's, so the GMM systems start
from the same numbers."""

import dataclasses
import logging
import os
import sys

import numpy as np
import pytest
import torch

import kaldi_aslp_tpu.recipes.decode_budget_sweep as jbudget
import kaldi_aslp_tpu.recipes.timit_synth as jtimit
from kaldi_aslp_tpu.fst import Lang as JaxLang, Lexicon as JaxLexicon
from kaldi_aslp_tpu.fst.lang import arpa_to_fst as jax_arpa_to_fst
from kaldi_aslp_tpu.gmm import deltas as jdeltas
from kaldi_aslp_tpu.gmm import MonophoneTrainer as JaxMono
from kaldi_aslp_tpu.gmm import MonoTrainOptions as JaxMonoOptions
from kaldi_aslp_tpu.recipes.hard_corpus import (
    HardCorpusOptions as JaxCorpusOptions,
    build_corpus as jax_build_corpus,
)
from kaldi_aslp_tpu.recipes.hard_ladder import _Scale as JaxScale
from kaldi_aslp_tpu_torch.fst import (
    Lang,
    Lexicon,
    NonDeterminizableError,
    arpa_to_fst,
)
from kaldi_aslp_tpu_torch.gmm import deltas as pdeltas
from kaldi_aslp_tpu_torch.gmm import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu_torch.recipes import decode_budget_sweep
from kaldi_aslp_tpu_torch.recipes import timit_synth

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import test_torch_ladder as ladder  # noqa: E402

WEIGHT_ATOL = 1e-6      # graph costs: float32 log-probs
MONO = dict(num_iters=3, totgauss=120, realign_iters="1 2")
TRI = dict(num_iters=3, totgauss=240, num_leaves=60, realign_iters="2",
           tree_min_gain=5.0)


# -- timit_synth -------------------------------------------------------------

@pytest.fixture(scope="module")
def cd_systems():
    """test_timit_hkust_recipes.py:_tiny_corpus in the JAX package; the
    port's monophone alignments fed to both packages' DeltasTrainer."""
    c = jax_build_corpus(JaxCorpusOptions(num_words=30, num_train_speakers=3,
                                          num_test_speakers=1),
                         num_train=14, num_test=4, lm_pool_mult=3)
    feats, texts = c["train_feats"], c["train_texts"]
    lang = Lang.build(Lexicon.from_text(c["lexicon_text"]))
    jlang = JaxLang.build(JaxLexicon.from_text(c["lexicon_text"]))
    mono = MonophoneTrainer(lang, opts=MonoTrainOptions(**MONO),
                            device="cpu")
    am0, tm0 = mono.train(feats, texts)
    alis = mono.align(am0, feats, texts)
    tri = pdeltas.DeltasTrainer(lang, mono.topo,
                                pdeltas.DeltasTrainOptions(**TRI),
                                device="cpu")
    tri.train(feats, texts, tm0, alis)
    jmono = JaxMono(jlang, opts=JaxMonoOptions(**MONO))
    jtri = jdeltas.DeltasTrainer(jlang, jmono.topo,
                                 jdeltas.DeltasTrainOptions(**TRI))
    jtri.train(feats, texts, jmono.trans_model, alis)
    return dict(feats=feats, lang=lang, jlang=jlang, tri=tri, jtri=jtri,
                G=arpa_to_fst(c["arpa"], lang.words),
                jG=jax_arpa_to_fst(c["arpa"], jlang.words))


def test_cd_systems_start_equal(cd_systems):
    tri, jtri = cd_systems["tri"], cd_systems["jtri"]
    assert sorted(tri._final_alignments) == sorted(jtri._final_alignments)
    for u, a in tri._final_alignments.items():
        np.testing.assert_array_equal(a, jtri._final_alignments[u])
    np.testing.assert_array_equal(tri.trans_model.log_probs,
                                  jtri.trans_model.log_probs)


@pytest.mark.parametrize("method", ["equal", "kmeans", "viterbi"])
def test_prepare_cd_phone_system_matches_jax(cd_systems, method):
    s = cd_systems
    got = timit_synth.prepare_cd_phone_system(
        s["lang"], s["tri"].trans_model, s["tri"]._final_alignments,
        s["feats"], s["G"], num_leaves=40, method=method, min_gain=5.0)
    want = jtimit.prepare_cd_phone_system(
        s["jlang"], s["jtri"].trans_model, s["jtri"]._final_alignments,
        s["feats"], s["jG"], num_leaves=40, method=method, min_gain=5.0)
    targets, num_pdfs, hclg, lut = got
    jtargets, jnum_pdfs, jhclg, jlut = want
    assert 1 < num_pdfs == jnum_pdfs <= 40
    assert sorted(targets) == sorted(jtargets)
    for u in targets:
        np.testing.assert_array_equal(targets[u], jtargets[u], err_msg=u)
    assert (hclg.num_states, hclg.num_arcs) == (jhclg.num_states,
                                                jhclg.num_arcs)
    ga, wa = hclg.to_arrays(), jhclg.to_arrays()
    for key in wa:
        if key in ("weight", "final"):
            np.testing.assert_allclose(np.asarray(ga[key]),
                                       np.asarray(wa[key]),
                                       atol=WEIGHT_ATOL, rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(np.asarray(ga[key]),
                                          np.asarray(wa[key]), err_msg=key)
    np.testing.assert_array_equal(lut, jlut)


def test_cd_phone_graph_keeps_the_raw_compose_with_a_warning(
        cd_systems, monkeypatch, caplog):
    s = cd_systems
    args = (s["lang"], s["tri"].trans_model, s["tri"]._final_alignments,
            s["feats"], s["G"])

    def blowup(fst, *a, **k):
        raise NonDeterminizableError("determinize: state blowup")
    monkeypatch.setattr(timit_synth, "determinize", blowup)
    with caplog.at_level(logging.WARNING):
        _, num_pdfs, hclg, lut = timit_synth.prepare_cd_phone_system(
            *args, num_leaves=40, method="equal", min_gain=5.0)
    assert any("not determinizable" in r.getMessage()
               and "state blowup" in r.getMessage() for r in caplog.records)
    assert hclg.num_states > 0 and lut.max() < num_pdfs

    def fault(fst, *a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(timit_synth, "determinize", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        timit_synth.prepare_cd_phone_system(
            *args, num_leaves=40, method="equal", min_gain=5.0)


def test_timit_synth_run_on_an_injected_corpus(tmp_path, capsys,
                                               monkeypatch):
    """``run`` on the tiny ladder corpus with its scale cut to it: one
    WER a method, the CD-phone DNN trained on its targets."""
    small = timit_synth._Scale

    def tiny(name):
        sc = small("small")
        sc.mono = MonoTrainOptions(**MONO)
        sc.tri = dataclasses.replace(sc.tri, num_iters=3, totgauss=40,
                                     num_leaves=12, realign_iters="2",
                                     tree_min_gain=5.0)
        sc.cd_leaves = 8
        sc.dnn_hidden, sc.dnn_layers, sc.dnn_iters = 16, 1, 2
        return sc
    monkeypatch.setattr(timit_synth, "_Scale", tiny)
    out = timit_synth.run(str(tmp_path), scale="small",
                          methods=["equal", "kmeans"],
                          corpus=ladder.tiny_corpus(), device="cpu")
    assert sorted(out) == ["equal", "kmeans"]
    assert all(np.isfinite(w) and w >= 0.0 for w in out.values())
    assert "CD_PHONE_WER equal=" in capsys.readouterr().out
    systems = timit_synth.run.artifacts["systems"]
    assert sorted(systems) == ["equal", "kmeans"]


# -- decode_budget_sweep.run -------------------------------------------------

def test_gmm_budget_sweep_matches_jax(monkeypatch):
    def jax_tiny(name):
        sc = JaxScale(name)
        sc.mono = JaxMonoOptions(num_iters=4, totgauss=30,
                                 realign_iters="1 2 3")
        return sc
    monkeypatch.setattr(decode_budget_sweep, "_Scale", ladder.tiny_scale)
    monkeypatch.setattr(jbudget, "_Scale", jax_tiny)
    corpus = ladder.tiny_corpus()
    jcorpus = dict(corpus, lang=JaxLang.build(JaxLexicon.from_text(
        "YES Y\nNO N\n")))
    budgets = [64, 2]
    got = decode_budget_sweep.run("small", budgets, corpus=corpus,
                                  device="cpu")
    want = jbudget.run("small", budgets, corpus=jcorpus)
    assert list(got) == budgets
    assert got == want
    assert sorted(decode_budget_sweep.run.seconds) == sorted(budgets)
