"""The port's diagonal GMM and monophone trainer
(kaldi_aslp_tpu_torch/gmm/) against the JAX package's kaldi_aslp_tpu/gmm/
on the CPU, from the same numpy-seeded inputs:

  * gmm_loglikes and corpus_loglikes within 1e-5 relative;
  * the alignment posteriors and the statistics (occupancies, first and
    second order sums) within 1e-5, relative to each array's largest
    magnitude (the port sums in float64 by one-hot products, JAX in
    float32 by scatter-adds, so a sum near zero differs by rounding of
    the large terms, not of itself);
  * mle_update and split_gaussians equal (host numpy on the same
    arrays);
  * MonophoneTrainer.train at tests/test_gmm_hmm.py:126-151's size: the
    same final alignments as JAX frame for frame, and WER 0;
  * a JAX model carried into the port (models/interop.py) scores as it
    does in JAX, and back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.fst import Lang as JaxLang
from kaldi_aslp_tpu.fst import Lexicon as JaxLexicon
from kaldi_aslp_tpu.gmm import diag_gmm as jgmm
from kaldi_aslp_tpu.gmm import MonophoneTrainer as JaxMono
from kaldi_aslp_tpu.gmm import MonoTrainOptions as JaxMonoOptions
from kaldi_aslp_tpu_torch.decoder import PackedGraph, ViterbiDecoder
from kaldi_aslp_tpu_torch.fst import (
    Lang,
    Lexicon,
    make_decode_graph,
    make_unigram_grammar,
)
from kaldi_aslp_tpu_torch.gmm import diag_gmm as pgmm
from kaldi_aslp_tpu_torch.gmm import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu_torch.models.interop import gmm_from_jax, gmm_to_jax
from kaldi_aslp_tpu_torch.ops.edit_distance import score_utterances

torch.set_num_threads(1)

LL_RTOL = 1e-5
STATS_TOL = 1e-5


def _model(rs, P=5, M=3, D=4, dead=True):
    """Random gauss-padded model; with ``dead`` some slots are empty
    (weight 0), as split_gaussians leaves them."""
    w = rs.rand(P, M).astype(np.float32) + 0.1
    if dead:
        w[1, 2] = w[3, 1:] = 0.0
    w /= w.sum(1, keepdims=True)
    return pgmm.AmDiagGmm(
        weights=w.astype(np.float32),
        means=rs.randn(P, M, D).astype(np.float32),
        vars=(0.3 + rs.rand(P, M, D)).astype(np.float32))


def _jax(am):
    return jgmm.AmDiagGmm(am.weights, am.means, am.vars)


def _scale_close(got, want, tol=STATS_TOL):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("dead", [False, True])
def test_gmm_loglikes_match_jax(dead):
    rs = np.random.RandomState(0)
    am = _model(rs, dead=dead)
    feats = rs.randn(37, 4).astype(np.float32)
    got = pgmm.gmm_loglikes(torch.from_numpy(feats), *am.pack("cpu"))
    want = np.asarray(jgmm.gmm_loglikes(jnp.asarray(feats), *_jax(am).pack()))
    assert got.dtype == torch.float32 and got.shape == (37, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=LL_RTOL)


@pytest.mark.parametrize("block_frames", [16, 65536])
def test_corpus_loglikes_match_jax(block_frames):
    rs = np.random.RandomState(1)
    am = _model(rs)
    feats = {f"u{i}": rs.randn(rs.randint(5, 30), 4).astype(np.float32)
             for i in range(6)}
    utts = sorted(feats)[::-1]
    got = pgmm.corpus_loglikes(feats, utts, am.pack("cpu"),
                               block_frames=block_frames)
    want = jgmm.corpus_loglikes(feats, utts, _jax(am).pack())
    assert list(got) == list(want)
    for u in utts:
        np.testing.assert_allclose(got[u], want[u], rtol=LL_RTOL)


def test_alignment_posteriors_match_jax():
    rs = np.random.RandomState(2)
    am = _model(rs)
    feats = rs.randn(40, 4).astype(np.float32)
    pdfs = rs.randint(0, 5, 40)
    got = pgmm.gmm_posteriors_for_alignment(
        torch.from_numpy(feats), torch.from_numpy(pdfs), *am.pack("cpu"))
    want = jgmm.gmm_posteriors_for_alignment(
        jnp.asarray(feats), jnp.asarray(pdfs), *_jax(am).pack())
    _scale_close(got.numpy(), np.asarray(want))
    assert (got.numpy()[am.weights[pdfs] == 0] == 0).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_statistics_match_jax(weighted, monkeypatch):
    """Two accumulations into one GmmStats, the second over more frames
    than one product block takes."""
    monkeypatch.setattr(pgmm, "STATS_BLOCK", 32)
    rs = np.random.RandomState(3)
    am = _model(rs)
    stats, jstats = pgmm.GmmStats(am, "cpu"), jgmm.GmmStats(_jax(am))
    for T in (50, 77):
        feats = rs.randn(T, 4).astype(np.float32)
        pdfs = rs.randint(0, 5, T).astype(np.int32)
        fw = (rs.rand(T) > 0.3).astype(np.float32) if weighted else None
        stats.accumulate(am.pack("cpu"), feats, pdfs, fw)
        jstats.accumulate(_jax(am).pack(), feats, pdfs, fw)
    for got, want in zip(stats.to_numpy(), jstats.to_numpy()):
        assert got.dtype == np.float32
        _scale_close(got, want)


@pytest.mark.parametrize("min_occ", [3.0, 40.0])
def test_mle_update_matches_jax(min_occ):
    rs = np.random.RandomState(4)
    am = _model(rs)
    stats = pgmm.GmmStats(am, "cpu")
    stats.accumulate(am.pack("cpu"), rs.randn(400, 4).astype(np.float32),
                     rs.randint(0, 5, 400))
    occ, mean_acc, var_acc = stats.to_numpy()
    got = pgmm.mle_update(am, occ, mean_acc, var_acc,
                          min_gaussian_occupancy=min_occ)
    want = jgmm.mle_update(_jax(am), occ, mean_acc, var_acc,
                           min_gaussian_occupancy=min_occ)
    for k in ("weights", "means", "vars"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert not np.array_equal(got.means, am.means)


@pytest.mark.parametrize("target,seed", [(12, 0), (25, 3)])
def test_split_gaussians_matches_jax(target, seed):
    rs = np.random.RandomState(5)
    am = _model(rs)
    occ = rs.rand(*am.weights.shape).astype(np.float32) * (am.weights > 0)
    got = pgmm.split_gaussians(am, target, occ, seed=seed)
    want = jgmm.split_gaussians(_jax(am), target, occ, seed=seed)
    for k in ("weights", "means", "vars"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.num_gauss_per_pdf.sum() == target


def _synth_corpus(rng, num_utts, words_per_utt):
    """tests/test_gmm_hmm.py:_synth_corpus: each phone a gaussian cloud
    in 2-D, silence between words."""
    centers = {"Y": np.array([3.0, 0.0]), "N": np.array([-3.0, 0.0]),
               "SIL": np.array([0.0, 3.0])}
    feats, texts = {}, {}
    for u in range(num_utts):
        words = [("YES" if rng.rand() < 0.5 else "NO")
                 for _ in range(words_per_utt)]
        seq = ["SIL"]
        for w in words:
            seq += ["Y" if w == "YES" else "N", "SIL"]
        frames = [centers[ph] + 0.5 * rng.randn(rng.randint(8, 16), 2)
                  for ph in seq]
        feats[f"u{u}"] = np.concatenate(frames).astype(np.float32)
        texts[f"u{u}"] = words
    return feats, texts


def test_mono_train_matches_jax_and_decodes():
    """tests/test_gmm_hmm.py:126-151's run (12 utterances of 4 words, 8
    iterations, 60 gaussians, realigned on 1..7) in both packages: the
    same final alignments, frame for frame, the same transition model
    and the model within float32 rounding; the port's HCLG decode on it
    scores WER 0."""
    feats, texts = _synth_corpus(np.random.RandomState(777), 12, 4)
    kw = dict(num_iters=8, totgauss=60, realign_iters="1 2 3 4 5 6 7")
    lexicon = "YES Y\nNO N\n"
    mono = MonophoneTrainer(Lang.build(Lexicon.from_text(lexicon)),
                            opts=MonoTrainOptions(**kw), device="cpu")
    am, tm = mono.train(feats, texts)
    jmono = JaxMono(JaxLang.build(JaxLexicon.from_text(lexicon)),
                    opts=JaxMonoOptions(**kw))
    jam, jtm = jmono.train(feats, texts)
    for u in feats:
        np.testing.assert_array_equal(mono._final_alignments[u],
                                      jmono._final_alignments[u], err_msg=u)
    np.testing.assert_array_equal(tm.log_probs, jtm.log_probs)
    np.testing.assert_array_equal(am.weights > 0, jam.weights > 0)
    _scale_close(am.means, jam.means)
    lang = mono.lang
    dec = ViterbiDecoder(
        PackedGraph.from_fst(make_decode_graph(
            lang, make_unigram_grammar({"YES": 0.5, "NO": 0.5}, lang.words),
            tm)),
        tm.alignment_to_pdfs(np.arange(tm.num_transition_ids + 1)),
        device="cpu")
    lls = pgmm.corpus_loglikes(feats, sorted(feats), am.pack("cpu"))
    hyps = {u: [lang.words.sym(w) for w in dec.decode(lls[u])[0]]
            for u in feats}
    stats = score_utterances(texts, hyps)
    assert stats.wer == 0.0, stats.report()


def test_gmm_crosses_from_jax_and_back():
    """A JAX model and its transition probabilities in the port score
    as in JAX; gmm_to_jax gives back the same arrays."""
    rs = np.random.RandomState(6)
    jam = _jax(_model(rs))
    lexicon = "YES Y\nNO N\n"
    jtm = JaxMono(JaxLang.build(JaxLexicon.from_text(lexicon))).trans_model
    jtm.log_probs = np.log(rs.rand(len(jtm.log_probs)).astype(np.float32))
    tm = MonophoneTrainer(Lang.build(Lexicon.from_text(lexicon)),
                          device="cpu").trans_model
    am = gmm_from_jax(jam, jtm.log_probs, tm)
    np.testing.assert_array_equal(tm.log_probs, jtm.log_probs)
    feats = rs.randn(9, 4).astype(np.float32)
    np.testing.assert_allclose(
        pgmm.gmm_loglikes(torch.from_numpy(feats), *am.pack("cpu")).numpy(),
        np.asarray(jgmm.gmm_loglikes(jnp.asarray(feats), *jam.pack())),
        rtol=LL_RTOL)
    back = gmm_to_jax(am, tm)
    for k in ("weights", "means", "vars"):
        np.testing.assert_array_equal(back[k], getattr(jam, k))
    np.testing.assert_array_equal(back["log_probs"], jtm.log_probs)
    with pytest.raises(ValueError, match="log-probabilities"):
        gmm_from_jax(jam, jtm.log_probs[:-1], tm)
