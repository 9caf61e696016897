"""The port's LibriSpeech-shaped recipe (kaldi_aslp_tpu_torch/recipes/
ls_synth.py) against the JAX package's kaldi_aslp_tpu/recipes/ls_synth.py
on the CPU, at a tiny float32 size (1 BLSTMP layer, projection 8, cell
12, 16 training utterances, 3 newbob iterations):

  * the corpus helpers: ``extract_fbank`` within rtol = atol = 1e-4
    (tests/test_torch_feats.py's tolerance), ``phone_labels``, the
    batches' keys and lengths equal;
  * a whole ``run`` from JAX's ``PRNGKey(777)`` initial parameters
    (through models/interop.py): the same newbob decisions, each
    iteration's train and CV losses within 1e-4 relative, every
    posteriors call within 1e-4;
  * the same ``run`` with JAX's posteriors in place of the port's: the
    lattices arc for arc, the LMWT sweep, the greedy PER and the
    small- and large-LM WERs equal.

JAX builds lattices with a native helper that orders arcs its own way;
its numpy build is the port's, so the JAX run here takes it."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import kaldi_aslp_tpu.decoder.beam as JB
import kaldi_aslp_tpu.recipes.ls_synth as jls
import kaldi_aslp_tpu.recipes.rm_synth as jrm
from kaldi_aslp_tpu import native as jax_native
from kaldi_aslp_tpu.fst import Lang as JaxLang, Lexicon as JaxLexicon
from kaldi_aslp_tpu.models import Nnet as JaxNnet
from kaldi_aslp_tpu.models.recurrent import (
    BLstmProjectedStreams as JaxBLstmp,
)
from kaldi_aslp_tpu.models.simple import AffineTransform as JaxAffine
from kaldi_aslp_tpu.train.newbob import NewbobScheduler as JaxNewbob
from kaldi_aslp_tpu.train.trainer import CtcTrainer as JaxCtcTrainer
from kaldi_aslp_tpu_torch.data.sequence import CtcBatcher, CtcBatcherOptions
from kaldi_aslp_tpu_torch.fst import Lang, Lexicon
from kaldi_aslp_tpu_torch.models.interop import params_from_jax
from kaldi_aslp_tpu_torch.recipes import ls_synth, rm_synth

torch.set_num_threads(1)

TINY = dict(num_words=10, num_train=16, num_test=3, layers=1, proj=8,
            cell=12, num_streams=4, max_iters=3, rescore_text_mult=4,
            lm_text_mult=2, bucket_t=64, max_len=4, lattice_beam=1.0,
            learn_rate=0.06, keep_lr=45)
LOSS_RTOL = 1e-4
POST_ATOL = 1e-4
FEAT_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_feats.py's


def arc_key(a):
    return (a.t, a.src, a.dst, a.tid, tuple(a.words), a.graph_cost,
            a.acoustic_cost)


def same_lattice(got, want):
    assert got.num_frames == want.num_frames
    assert got.start == want.start
    assert sorted(map(arc_key, got.arcs)) == sorted(map(arc_key, want.arcs))
    assert got.final_costs == want.final_costs


def jax_init_params(dim, num_outputs):
    """The JAX recipe's initial parameters (ls_synth.py:145-155)."""
    net = JaxNnet()
    d = dim
    for _ in range(TINY["layers"]):
        net.add(JaxBLstmp(d, 2 * TINY["proj"], cell_dim=TINY["cell"],
                          bf16=False))
        d = 2 * TINY["proj"]
    net.add(JaxAffine(d, num_outputs, param_stddev=0.04, bias_mean=0.0,
                      bias_range=0.0))
    return net.init(jax.random.PRNGKey(777))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX recipe's run with its losses, posteriors, lattices, LMWT
    sweep and scored hypotheses recorded."""
    mp = pytest.MonkeyPatch()
    rec = dict(train=[], cv=[], post=[], lats=[], sweeps=[], scored=[])
    mp.setattr(jax_native, "lattice_build", lambda *a, **k: None)

    inner_epoch = JaxCtcTrainer.train_epoch

    def train_epoch(self, *a, **k):
        out = inner_epoch(self, *a, **k)
        rec["train"].append(float(out[2].avg_loss))
        return out
    mp.setattr(JaxCtcTrainer, "train_epoch", train_epoch)
    inner_report = JaxNewbob.report

    def report(self, cv_loss, hold=False):
        accepted = inner_report(self, cv_loss, hold=hold)
        rec["cv"].append((float(cv_loss),
                          "ACCEPT" if accepted else "REJECT"))
        return accepted
    mp.setattr(JaxNewbob, "report", report)
    inner_jit = jax.jit

    def jit(fn, *a, **k):
        compiled = inner_jit(fn, *a, **k)
        if getattr(fn, "__module__", "") != jls.__name__:
            return compiled

        def recorded(p, feats, mask):
            y = compiled(p, feats, mask)
            rec["post"].append(np.asarray(y[0])[: int(mask.sum())])
            return y
        return recorded
    mp.setattr(jax, "jit", jit)
    inner_lattice = JB.BeamSearchDecoder.decode_lattice

    def decode_lattice(self, *a, **k):
        out = inner_lattice(self, *a, **k)
        rec["lats"].append(out[3])
        return out
    mp.setattr(JB.BeamSearchDecoder, "decode_lattice", decode_lattice)
    inner_sweep = jls.score_lmwt_sweep

    def sweep(*a, **k):
        out = inner_sweep(*a, **k)
        rec["sweeps"].append(out)
        return out
    mp.setattr(jls, "score_lmwt_sweep", sweep)
    inner_score = jls.score_utterances

    def score(refs, hyps):
        rec["scored"].append((refs, hyps))
        return inner_score(refs, hyps)
    mp.setattr(jls, "score_utterances", score)
    try:
        rec["out"] = jls.run(str(tmp_path_factory.mktemp("jax")), **TINY)
    finally:
        mp.undo()
    return rec


def port_run(tmp_path, monkeypatch, jax_posteriors=None):
    """The port's run from JAX's initial parameters; with
    ``jax_posteriors`` its posteriors calls return JAX's outputs in
    turn.  Returns (result, artifacts, the port's own posteriors)."""
    monkeypatch.setattr(ls_synth, "init_params", lambda net: (
        net.load_state_dict(params_from_jax(jax_init_params(
            net.nodes[0].input_dim, net.output_dim)))))
    own = []
    inner = ls_synth.make_posteriors

    def make_posteriors(*a, **k):
        fn = inner(*a, **k)
        served = iter(jax_posteriors or ())

        def posteriors(feats):
            y = fn(feats)
            own.append(y)
            if jax_posteriors is None:
                return y
            want = next(served)
            assert want.shape == y.shape
            return want
        return posteriors
    monkeypatch.setattr(ls_synth, "make_posteriors", make_posteriors)
    out = ls_synth.run(str(tmp_path), device="cpu", **TINY)
    return out, ls_synth.run.artifacts, own


def test_fbank_and_labels_match_jax():
    lex_text = rm_synth.make_lexicon(10)
    assert lex_text == jrm.make_lexicon(10)
    lex, jlex = Lexicon.from_text(lex_text), JaxLexicon.from_text(lex_text)
    words = sorted(w for w in lex.prons if w != "<SIL>")
    sents = rm_synth.make_sentences(words, 6, seed=11, max_len=4)
    assert sents == jrm.make_sentences(words, 6, seed=11, max_len=4)
    waves = rm_synth.synthesize(lex, sents, seed=3)
    got = ls_synth.extract_fbank(waves, device="cpu")
    want = jls.extract_fbank(jrm.synthesize(jlex, sents, seed=3))
    assert sorted(got) == sorted(want)
    for u in want:
        assert got[u].dtype == np.float32 and got[u].shape == want[u].shape
        np.testing.assert_allclose(got[u], want[u], err_msg=u, **FEAT_TOL)
    lang, jlang = Lang.build(lex), JaxLang.build(jlex)
    for s in sents:
        np.testing.assert_array_equal(ls_synth.phone_labels(lang, s),
                                      jls.phone_labels(jlang, s))


def test_batches_keep_the_jax_recipes_keys_and_lengths():
    """The recipe's batcher options (full 4-stream batches, LFR 3,
    bucket 64) on the same features give JAX's batches."""
    from kaldi_aslp_tpu.data.sequence import (
        CtcBatcher as JaxBatcher,
        CtcBatcherOptions as JaxBatcherOptions,
    )
    rs = np.random.RandomState(4)
    items = [(f"utt{i:04d}", rs.randn(rs.randint(30, 260), 5)
              .astype(np.float32), rs.randint(1, 9, rs.randint(2, 12))
              .astype(np.int32)) for i in range(23)]
    kw = dict(num_streams=4, frame_limit=10 ** 9, bucket_time=64,
              bucket_labels=64, skip_width=3, drop_len=64 * 3,
              sort_by_length=False)
    got = [b for b in CtcBatcher(iter(items), CtcBatcherOptions(**kw))
           if len(b.keys) == 4]
    want = [b for b in JaxBatcher(iter(items), JaxBatcherOptions(**kw))
            if len(b.keys) == 4]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys == w.keys
        np.testing.assert_array_equal(g.input_lengths, w.input_lengths)
        np.testing.assert_array_equal(g.label_lengths, w.label_lengths)
        np.testing.assert_array_equal(g.feats, w.feats)


def test_run_from_jax_parameters_matches_jax(tmp_path, monkeypatch, jax_run):
    out, art, own = port_run(tmp_path, monkeypatch)
    epochs = art["epochs"]
    assert [e["decision"] for e in epochs] == [d for _, d in jax_run["cv"]]
    assert len(epochs) == len(jax_run["train"]) == TINY["max_iters"]
    for e, tr, (cv, _) in zip(epochs, jax_run["train"], jax_run["cv"]):
        assert abs(e["train_loss"] - tr) <= LOSS_RTOL * abs(tr)
        assert abs(e["cv_loss"] - cv) <= LOSS_RTOL * abs(cv)
    # every posteriors call: 12 prior utterances, then the test set twice
    assert len(own) == len(jax_run["post"]) == 12 + 2 * TINY["num_test"]
    for got, want in zip(own, jax_run["post"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=POST_ATOL)
    assert out["rtf"] > 0 and out["train_tput"] > 0


def test_decode_and_rescore_on_jax_posteriors_match_jax(tmp_path,
                                                        monkeypatch,
                                                        jax_run):
    scored = []
    inner = ls_synth.score_utterances

    def score(refs, hyps):
        scored.append((refs, hyps))
        return inner(refs, hyps)
    monkeypatch.setattr(ls_synth, "score_utterances", score)
    out, art, _ = port_run(tmp_path, monkeypatch,
                           jax_posteriors=jax_run["post"])
    jout = jax_run["out"]
    assert out["per"] == jout["per"]
    assert out["wer_small"] == jout["wer_small"]
    assert out["wer_large"] == jout["wer_large"]
    lats = art["lats"]
    assert len(lats) == len(jax_run["lats"]) == TINY["num_test"]
    for u, want in zip(sorted(lats), jax_run["lats"]):
        same_lattice(lats[u], want)
    (jsweep,) = jax_run["sweeps"]
    assert sorted(art["sweep"]) == sorted(jsweep) == list(range(1, 16))
    for lmwt, st in art["sweep"].items():
        assert dataclasses.asdict(st) == dataclasses.asdict(jsweep[lmwt])
    # the greedy phones, then the 15 rescored sweeps: the same
    # hypotheses scored against the same references
    assert art["skipped"] == []
    assert len(scored) == len(jax_run["scored"]) == 1 + 15
    for (refs, hyps), (jrefs, jhyps) in zip(scored, jax_run["scored"]):
        assert refs == jrefs and hyps == jhyps
