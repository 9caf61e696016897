"""The tonal syllable-CTC recipe on the port (kaldi_aslp_tpu_torch/
recipes/hkust_synth.py) against the JAX recipe on the CPU, at a tiny
preset (12 words, 24 training and 4 test utterances over 2 + 1
speakers, a 1-layer BLSTM of 8 cells a direction, 3 iterations) put in
place of both modules' ``_Scale``: each package builds its own corpus
(the same waves, its own MFCC + pitch features), the same syllable
units, and the port's recipe starts from the JAX recipe's initial
parameters (carried by models/interop.py).  The same newbob decisions,
the CV losses within 1e-3 relative (the tolerance of
tests/test_torch_ctc_recipe.py::test_recipe_matches_jax_for_three_iterations:
three epochs of momentum SGD on features equal to 1e-4), the same test
hypotheses, WER and greedy syllable error rate."""

import numpy as np
import pytest
import torch

import jax

import kaldi_aslp_tpu.recipes.ctc as jax_ctc
from kaldi_aslp_tpu.recipes import hard_corpus as jax_hc
from kaldi_aslp_tpu.recipes import hkust_synth as jax_hk
from kaldi_aslp_tpu.recipes import syllable as jax_rs
from kaldi_aslp_tpu.train.newbob import NewbobScheduler as JaxNewbob
from kaldi_aslp_tpu_torch.models.interop import params_from_jax
import kaldi_aslp_tpu_torch.recipes.ctc as port_ctc
from kaldi_aslp_tpu_torch.recipes import hard_corpus as hc
from kaldi_aslp_tpu_torch.recipes import hkust_synth as hk

torch.set_num_threads(1)

CV_RTOL = 1e-3


def tiny_scale(module):
    """A ``_Scale`` at the tiny preset for the recipe ``module``."""
    class Tiny:
        def __init__(self, name):
            self.num_words = 12
            self.corpus = module.HardCorpusOptions(
                num_words=12, num_train_speakers=2, num_test_speakers=1)
            self.num_train, self.num_test, self.lm_mult = 24, 4, 2
            self.hidden, self.layers, self.iters = 8, 1, 3
            self.bind_thresh = 3
            self.learn_rate = 0.06
    return Tiny


def _recording(monkeypatch, module):
    calls = []
    inner = module.score_utterances

    def record(refs, hyps):
        calls.append((refs, hyps))
        return inner(refs, hyps)
    monkeypatch.setattr(module, "score_utterances", record)
    return calls


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX recipe at the tiny preset: its result, its newbob
    reports, its scored hypotheses, its recipe and its corpus."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax_hk, "_Scale", tiny_scale(jax_hc))
        reports = []
        inner = JaxNewbob.report

        def report(self, cv_loss, hold=False):
            accepted = inner(self, cv_loss, hold=hold)
            reports.append((float(cv_loss), "HOLD" if hold else (
                "ACCEPT" if accepted else "REJECT")))
            return accepted
        mp.setattr(JaxNewbob, "report", report)
        recipes = []

        class Recording(jax_ctc.CtcRecipe):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                recipes.append(self)
        mp.setattr(jax_hk, "CtcRecipe", Recording)
        scored = _recording(mp, jax_ctc)
        built = []
        inner_build = jax_hk.build_corpus

        def build(*a, **k):
            built.append(inner_build(*a, **k))
            return built[-1]
        mp.setattr(jax_hk, "build_corpus", build)
        out = jax_hk.run(str(tmp_path_factory.mktemp("jax_hkust")), "tiny")
    finally:
        mp.undo()
    return dict(out=out, reports=reports, scored=scored, recipe=recipes[0],
                corpus=built[0])


def test_recipe_matches_jax_from_its_parameters(jax_run, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr(hk, "_Scale", tiny_scale(hc))
    jrec = jax_run["recipe"]
    dim = next(iter(jax_run["corpus"]["train_feats"].values())).shape[1]
    assert dim == 48
    init = jrec._build_net(dim, jrec.num_outputs + 1).init(
        jax.random.PRNGKey(777))
    monkeypatch.setattr(port_ctc.CtcRecipe, "_init_params",
                        lambda self, net: net.load_state_dict(
                            params_from_jax(init)))
    scored = _recording(monkeypatch, port_ctc)
    out = hk.run(str(tmp_path), "tiny", device="cpu")
    art = hk.run.artifacts
    rec = art["recipe"]
    assert [e["decision"] for e in rec.epochs] == \
        [d for _, d in jax_run["reports"]]
    assert len(rec.epochs) == 3
    for e, (cv_j, _) in zip(rec.epochs, jax_run["reports"]):
        assert abs(e["cv_loss"] - cv_j) <= CV_RTOL * abs(cv_j)
    # greedy syllables, then words: the same hypotheses and scores
    assert len(scored) == len(jax_run["scored"]) == 2
    for (refs, hyps), (refs_j, hyps_j) in zip(scored, jax_run["scored"]):
        assert refs == refs_j and hyps == hyps_j
    assert out == jax_run["out"]
    assert rec.num_outputs == jrec.num_outputs + 1


def test_units_and_features_match_jax(jax_run, monkeypatch):
    """The port's corpus at the tiny preset against JAX's: the same
    texts, 48-dim features within TOL; the same syllable units."""
    monkeypatch.setattr(hk, "_Scale", tiny_scale(hc))
    corpus = hk.build_hkust_corpus("tiny", device="cpu")
    want = jax_run["corpus"]
    assert corpus["train_texts"] == want["train_texts"]
    assert corpus["lexicon_text"] == want["lexicon_text"]
    for split in ("train", "test"):
        for u, f in want[f"{split}_feats"].items():
            got = corpus[f"{split}_feats"][u]
            assert got.shape == f.shape
            np.testing.assert_allclose(got, f, rtol=1e-4, atol=1e-4)
    units = hk.prepare_syllable_units(
        corpus["lexicon"], corpus["train_texts"].values(), bind_thresh=3,
        keep_phones=("SIL",))
    units_j = jax_rs.prepare_syllable_units(
        want["lexicon"], want["train_texts"].values(), bind_thresh=3,
        keep_phones=("SIL",))
    assert (units.syllable_ids, units.bind) == (units_j.syllable_ids,
                                                units_j.bind)
