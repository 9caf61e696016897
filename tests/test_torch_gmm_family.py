"""The rest of the port's GMM family against the JAX package on the CPU,
from the same numpy-seeded inputs:

  * feats/transforms.py: LDA (the projected between- and within-class
    scatter, rows equal up to sign: eigh's sign is not defined), MLLT and
    fMLLR estimates (host numpy on the same statistics: 1e-5 relative to
    the largest entry, the statistics' float64 sums in another order),
    ``apply_transform`` (1e-6: float64 products vs float32) and
    ``gmm_gammas_for_alignment`` (1e-5: float64 vs float32 posteriors);
  * gmm/sat.py: per-speaker transforms (1e-4 of the largest entry: the
    fMLLR row solves amplify the gammas' float32 vs float64 rounding),
    the adapted features, SatTrainer over the JAX test's monophone
    system, and SatTrainer over the port's triphone system (JAX's
    fails there), which raises the speaker-adapted likelihood;
  * gmm/ebw.py: numerator and denominator statistics (1e-5 of each
    array's largest magnitude) and ``ebw_update`` (equal on equal stats);
  * gmm/full_gmm.py: ``from_diag`` / ``to_diag``, loglikes (1e-5
    relative: float64 here, float32 factors in JAX), statistics, the MLE
    update, and a full GMM carried across (models/interop.py);
  * gmm/global_gmm.py: loglikes, EM statistics, ``em_update``,
    ``split_global`` (equal), ``init_from_feats`` (the same mixture
    grown, means 1e-4), ``avg_loglike``, and the file format both ways;
  * vad/gmm_vad.py: GmmVad and train_gmm_vad give JAX's speech mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.feats import transforms as jtr
from kaldi_aslp_tpu.fst import Lang as JaxLang
from kaldi_aslp_tpu.fst import Lexicon as JaxLexicon
from kaldi_aslp_tpu.gmm import MonophoneTrainer as JaxMono
from kaldi_aslp_tpu.gmm import MonoTrainOptions as JaxMonoOptions
from kaldi_aslp_tpu.gmm import diag_gmm as jgmm
from kaldi_aslp_tpu.gmm import ebw as jebw
from kaldi_aslp_tpu.gmm import full_gmm as jfull
from kaldi_aslp_tpu.gmm import global_gmm as jglobal
from kaldi_aslp_tpu.gmm import sat as jsat
from kaldi_aslp_tpu.vad import gmm_vad as jvad
from kaldi_aslp_tpu.vad import VadOptions as JaxVadOptions
from kaldi_aslp_tpu_torch.feats import transforms as ptr
from kaldi_aslp_tpu_torch.fst import Lang, Lexicon
from kaldi_aslp_tpu_torch.gmm import deltas as pdeltas
from kaldi_aslp_tpu_torch.gmm import diag_gmm as pgmm
from kaldi_aslp_tpu_torch.gmm import ebw as pebw
from kaldi_aslp_tpu_torch.gmm import full_gmm as pfull
from kaldi_aslp_tpu_torch.gmm import global_gmm as pglobal
from kaldi_aslp_tpu_torch.gmm import sat as psat
from kaldi_aslp_tpu_torch.gmm import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu_torch.models.interop import (
    full_gmm_from_jax,
    full_gmm_to_jax,
    global_gmm_from_jax,
    global_gmm_to_jax,
)
from kaldi_aslp_tpu_torch.vad import VadOptions, gmm_vad as pvad

torch.set_num_threads(1)

TOL = 1e-5


def scale_close(got, want, tol=TOL):
    """Within ``tol`` of the array's largest magnitude."""
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _model(rs, P=5, M=3, D=4):
    w = rs.rand(P, M).astype(np.float32) + 0.1
    w[1, 2] = w[3, 1:] = 0.0
    w /= w.sum(1, keepdims=True)
    return pgmm.AmDiagGmm(weights=w.astype(np.float32),
                          means=rs.randn(P, M, D).astype(np.float32),
                          vars=(0.3 + rs.rand(P, M, D)).astype(np.float32))


def _jax(am):
    return jgmm.AmDiagGmm(am.weights, am.means, am.vars)


# -- transforms ----------------------------------------------------------------

def test_lda_equals_jax_up_to_sign():
    rs = np.random.RandomState(0)
    n, C, D = 600, 4, 5
    classes = rs.randint(0, C, n)
    feats = rs.randn(n, D) * [1, 3, 3, 0.5, 2] + np.eye(C, D)[classes] * 4
    got, want = ptr.LdaStats(C, D), jtr.LdaStats(C, D)
    got.accumulate(feats, classes)
    want.accumulate(feats, classes)
    a = ptr.estimate_lda(got, 3)
    b = jtr.estimate_lda(want, 3)
    assert a.shape == b.shape == (3, D)
    np.testing.assert_allclose(np.abs(a), np.abs(b), rtol=TOL, atol=TOL)
    # the projected scatter is sign-free
    np.testing.assert_allclose(a @ got.total_second @ a.T,
                               b @ want.total_second @ b.T, rtol=TOL)


def test_apply_transform_matches_jax():
    rs = np.random.RandomState(1)
    feats = rs.randn(40, 4).astype(np.float32)
    for W in (rs.randn(3, 4), rs.randn(4, 5)):
        W = W.astype(np.float32)
        got = ptr.apply_transform(feats, W, "cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jtr.apply_transform(feats, W)),
            rtol=1e-6, atol=1e-6)
    # a tensor stays on its device with device=None
    got = ptr.apply_transform(torch.from_numpy(feats), W, None)
    assert got.device.type == "cpu"


def test_gammas_mllt_fmllr_match_jax():
    rs = np.random.RandomState(2)
    am = _model(rs, D=3)
    feats = rs.randn(300, 3).astype(np.float32)
    pdfs = rs.randint(0, am.num_pdfs, 300)
    g, mu, iv = ptr.gmm_gammas_for_alignment(am, feats, pdfs, "cpu")
    jg, jmu, jiv = jtr.gmm_gammas_for_alignment(_jax(am), feats, pdfs)
    assert g.dtype == np.float32
    np.testing.assert_allclose(g, jg, atol=TOL)
    np.testing.assert_array_equal(mu, jmu)
    np.testing.assert_array_equal(iv, jiv)
    # the estimates, each package on its own statistics
    m, jm = ptr.MlltStats(3), jtr.MlltStats(3)
    m.accumulate(feats, mu, iv, g)
    jm.accumulate(feats, jmu, jiv, jg)
    scale_close(ptr.estimate_mllt(m, 10), jtr.estimate_mllt(jm, 10))
    f, jf = ptr.FmllrStats(3), jtr.FmllrStats(3)
    f.accumulate(feats, mu, iv, g)
    jf.accumulate(feats, jmu, jiv, jg)
    scale_close(ptr.estimate_fmllr(f, 10), jtr.estimate_fmllr(jf, 10))
    # on the same statistics: equal
    np.testing.assert_array_equal(ptr.estimate_fmllr(jf, 10),
                                  jtr.estimate_fmllr(jf, 10))


# -- SAT -----------------------------------------------------------------------

def speaker_corpus(rng, utts_per_speaker=8):
    """tests/test_sat_resample.py:_speaker_corpus: two speakers with a
    constant feature-space shift each."""
    centers = {"Y": np.array([3.0, 0.0]), "N": np.array([-3.0, 0.0]),
               "SIL": np.array([0.0, 3.0])}
    shifts = {"spkA": np.array([1.0, -0.8]), "spkB": np.array([-1.2, 0.6])}
    feats, texts, utt2spk = {}, {}, {}
    for spk in sorted(shifts):
        for u in range(utts_per_speaker):
            words = [("YES" if rng.rand() < 0.5 else "NO") for _ in range(3)]
            seq = ["SIL"]
            for w in words:
                seq += ["Y" if w == "YES" else "N", "SIL"]
            fr = [centers[ph] + shifts[spk]
                  + 0.4 * rng.randn(rng.randint(6, 12), 2) for ph in seq]
            key = f"{spk}_u{u}"
            feats[key] = np.concatenate(fr).astype(np.float32)
            texts[key] = words
            utt2spk[key] = spk
    return feats, texts, utt2spk


MONO = dict(num_iters=6, totgauss=40, realign_iters="1 2 3 4 5")


@pytest.fixture(scope="module")
def sat_system():
    feats, texts, utt2spk = speaker_corpus(np.random.RandomState(777))
    lang = Lang.build(Lexicon.from_text("YES Y\nNO N\n"))
    mono = MonophoneTrainer(lang, opts=MonoTrainOptions(**MONO),
                            device="cpu")
    am, tm = mono.train(feats, texts)
    alis = mono.align(am, feats, texts)
    # JAX's trainer trained alike (tests/test_torch_gmm.py holds the two
    # runs equal): both compilers then cache the same training graphs
    jmono = JaxMono(JaxLang.build(JaxLexicon.from_text("YES Y\nNO N\n")),
                    opts=JaxMonoOptions(**MONO))
    jmono.train(feats, texts)
    np.testing.assert_array_equal(jmono.trans_model.log_probs, tm.log_probs)
    return dict(feats=feats, texts=texts, utt2spk=utt2spk, lang=lang,
                mono=mono, am=am, tm=tm, alis=alis, jmono=jmono)


def test_speaker_transforms_match_jax(sat_system):
    s = sat_system
    pdf_alis = {u: s["tm"].alignment_to_pdfs(a) for u, a in s["alis"].items()}
    got = psat.estimate_speaker_transforms(s["am"], s["feats"], pdf_alis,
                                           s["utt2spk"], device="cpu")
    want = jsat.estimate_speaker_transforms(_jax(s["am"]), s["feats"],
                                            pdf_alis, s["utt2spk"])
    assert sorted(got) == sorted(want) == ["spkA", "spkB"]
    for spk in want:
        scale_close(got[spk], want[spk], tol=1e-4)
    adapted = psat.apply_speaker_transforms(s["feats"], got, s["utt2spk"],
                                            "cpu")
    jadapted = jsat.apply_speaker_transforms(s["feats"], got, s["utt2spk"])
    for u in s["feats"]:
        np.testing.assert_allclose(adapted[u], jadapted[u], rtol=1e-5,
                                   atol=1e-5)
    # under the count floor: the identity
    ident = psat.estimate_speaker_transforms(
        s["am"], s["feats"], pdf_alis, s["utt2spk"], min_count=1e9,
        device="cpu")
    np.testing.assert_array_equal(ident["spkA"][:, :2], np.eye(2))


def _adapted_ll(am, feats, pdf_alis):
    """Total log-likelihood of the aligned pdfs."""
    lls = pgmm.corpus_loglikes(feats, sorted(pdf_alis), am.pack("cpu"))
    return sum(float(lls[u][np.arange(len(p)), p].sum())
               for u, p in pdf_alis.items())


def _sat_objective(trainer, am, feats, texts, transforms, utt2spk):
    """The SAT objective of a system: each utterance's features through
    its speaker's transform, realigned by the trainer on them, the
    aligned pdfs' log-likelihood plus log |det A| a frame."""
    adapted = psat.apply_speaker_transforms(feats, transforms, utt2spk,
                                            "cpu")
    tm = trainer.trans_model
    pdf_alis = {u: tm.alignment_to_pdfs(a) for u, a in
                trainer.align(am, adapted, texts).items()}
    logdet = sum(len(p) * np.log(abs(np.linalg.det(
        transforms[utt2spk[u]][:, :-1]))) for u, p in pdf_alis.items())
    return _adapted_ll(am, adapted, pdf_alis) + float(logdet)


def test_sat_over_mono_matches_jax(sat_system):
    s = sat_system
    opts = dict(num_outer_iters=2, fmllr_min_count=20.0)
    am, transforms = psat.SatTrainer(s["mono"], psat.SatOptions(**opts)
                                     ).train(s["am"], s["feats"], s["texts"],
                                             s["utt2spk"])
    jam, jtransforms = jsat.SatTrainer(s["jmono"], jsat.SatOptions(**opts)
                                       ).train(_jax(s["am"]), s["feats"],
                                               s["texts"], s["utt2spk"])
    for spk in jtransforms:
        scale_close(transforms[spk], jtransforms[spk], tol=1e-4)
    np.testing.assert_array_equal(am.weights > 0, jam.weights > 0)
    scale_close(am.means, jam.means, tol=1e-4)


def test_sat_over_the_tri_system_raises_the_adapted_likelihood(sat_system):
    """SAT over the port's triphone system (its DeltasTrainer has
    ``align``; JAX's has not, so JAX's SatTrainer fails on it): the SAT
    objective (aligned log-likelihood of the adapted features plus the
    transforms' log-determinants) of the adapted system beats the
    unadapted system's on the raw features (identity transforms).  The
    tree is kept small (12 leaves) so that its context splits do not
    absorb the two speakers' shifts."""
    s = sat_system
    tri = pdeltas.DeltasTrainer(
        s["lang"], s["mono"].topo,
        pdeltas.DeltasTrainOptions(num_iters=6, totgauss=30, num_leaves=12,
                                   realign_iters="2 4", tree_min_gain=5.0),
        device="cpu")
    am1, tm1 = tri.train(s["feats"], s["texts"], s["tm"], s["alis"])
    assert tri.tree.num_pdfs > s["tm"].num_pdfs
    identity = {spk: np.eye(2, 3, dtype=np.float32)
                for spk in ("spkA", "spkB")}
    before = _sat_objective(tri, am1, s["feats"], s["texts"], identity,
                            s["utt2spk"])
    am_sat, transforms = psat.SatTrainer(tri, psat.SatOptions(
        num_outer_iters=2, fmllr_min_count=20.0)).train(
        am1, s["feats"], s["texts"], s["utt2spk"])
    assert sorted(transforms) == ["spkA", "spkB"]
    assert np.abs(transforms["spkA"] - transforms["spkB"]).max() > 0.1
    after = _sat_objective(tri, am_sat, s["feats"], s["texts"], transforms,
                           s["utt2spk"])
    assert after > before + 10.0, (before, after)
    # the JAX package's SatTrainer cannot take its own triphone trainer
    from kaldi_aslp_tpu.gmm.deltas import DeltasTrainer as JaxDeltas
    assert not hasattr(JaxDeltas, "align")


# -- EBW -----------------------------------------------------------------------

@pytest.mark.parametrize("priors,scale", [(False, 1.0), (True, 0.3)])
def test_ebw_stats_and_update_match_jax(priors, scale):
    rs = np.random.RandomState(3)
    am = _model(rs)
    feats = rs.randn(250, 4).astype(np.float32)
    pdfs = rs.randint(0, am.num_pdfs, 250)
    log_priors = np.log(rs.dirichlet(np.ones(am.num_pdfs))) if priors \
        else None
    num = pebw.accumulate_numerator_stats(am, feats, pdfs, "cpu")
    jnum = jebw.accumulate_numerator_stats(_jax(am), feats, pdfs)
    den = pebw.accumulate_denominator_stats(am, feats, log_priors, scale,
                                            "cpu")
    jden = jebw.accumulate_denominator_stats(_jax(am), feats, log_priors,
                                             scale)
    for a, b in zip(num + den, tuple(jnum) + tuple(jden)):
        assert a.dtype == np.float32 and a.shape == np.shape(b)
        scale_close(a, np.asarray(b))
    for opts in (pebw.EbwOptions(), pebw.EbwOptions(ebw_e=0.5, min_d=0.1)):
        jopts = jebw.EbwOptions(**vars(opts))
        got = pebw.ebw_update(am, num, den, opts)
        want = jebw.ebw_update(_jax(am), num, den, jopts)
        for k in ("weights", "means", "vars"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


# -- full GMM ------------------------------------------------------------------

def _full(rs, P=5, M=3, D=3):
    am = _model(rs, P, M, D)
    full = pfull.AmFullGmm.from_diag(am)
    A = 0.3 * rs.randn(P, M, D, D)
    full.covars = (full.covars + A @ A.transpose(0, 1, 3, 2)).astype(
        np.float32)
    return full


def test_full_gmm_diag_round_trip_and_loglikes_match_jax():
    rs = np.random.RandomState(4)
    am = _model(rs)
    full, jfull_am = pfull.AmFullGmm.from_diag(am), \
        jfull.AmFullGmm.from_diag(_jax(am))
    np.testing.assert_array_equal(full.covars, jfull_am.covars)
    back = full.to_diag()
    np.testing.assert_array_equal(back.vars, am.vars)
    feats = rs.randn(60, 4).astype(np.float32)
    for model in (full, _full(rs, 5, 3, 4)):
        got = pfull.full_gmm_loglikes(feats, *model.pack("cpu"))
        jm = jfull.AmFullGmm(model.weights, model.means, model.covars)
        want = np.asarray(jfull.full_gmm_loglikes(jnp.asarray(feats),
                                                  *jm.pack()))
        assert got.dtype == torch.float32 and got.shape == (60, 5)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL)
    # the diagonal model's loglikes, from its full copy
    np.testing.assert_allclose(
        pfull.full_gmm_loglikes(feats, *full.pack("cpu")).numpy(),
        pgmm.gmm_loglikes(torch.from_numpy(feats), *am.pack("cpu")).numpy(),
        rtol=TOL)


def test_full_gmm_stats_and_update_match_jax():
    rs = np.random.RandomState(5)
    full = _full(rs)
    jm = jfull.AmFullGmm(full.weights, full.means, full.covars)
    feats = rs.randn(400, 3).astype(np.float32)
    pdfs = rs.randint(0, full.num_pdfs, 400)
    got = pfull.full_gmm_accumulate(full, feats, pdfs, "cpu")
    want = jfull.full_gmm_accumulate(jm, feats, pdfs)
    for a, b in zip(got, want):
        scale_close(a, b)
    for min_occ in (10.0, 60.0):
        new = pfull.full_gmm_mle_update(full, *want, min_occupancy=min_occ)
        jnew = jfull.full_gmm_mle_update(jm, *want, min_occupancy=min_occ)
        for k in ("weights", "means", "covars"):
            np.testing.assert_array_equal(getattr(new, k), getattr(jnew, k))
    carried = full_gmm_from_jax(jm)
    for k, v in full_gmm_to_jax(carried).items():
        np.testing.assert_array_equal(v, getattr(jm, k))
    assert jfull.AmFullGmm(**full_gmm_to_jax(full)).dim == 3


# -- global GMM and the GMM VAD -----------------------------------------------

def _mixture(rs, n=400):
    centers = np.array([[-4.0, 0.0], [0.0, 4.0], [4.0, -2.0]])
    return np.concatenate([c + 0.5 * rs.randn(n, 2) for c in centers]
                          ).astype(np.float32)


def test_global_gmm_loglikes_and_em_match_jax():
    rs = np.random.RandomState(6)
    feats = _mixture(rs)
    gmm = pglobal.GlobalGmm(
        np.array([0.5, 0.3, 0.2, 0.0], np.float32),
        rs.randn(4, 2).astype(np.float32),
        (0.5 + rs.rand(4, 2)).astype(np.float32))
    packed = gmm.pack("cpu")
    jpacked = [jnp.asarray(a) for a in (gmm.weights, gmm.means, gmm.vars)]
    np.testing.assert_allclose(
        pglobal.global_gmm_loglikes(feats, *packed).numpy(),
        np.asarray(jglobal.global_gmm_loglikes(jnp.asarray(feats),
                                               *jpacked)), rtol=TOL)
    fw = (rs.rand(len(feats)) > 0.2).astype(np.float32)
    got = pglobal.em_stats(feats, fw, *packed)
    want = jglobal._em_stats(jnp.asarray(feats), jnp.asarray(fw), *jpacked)
    for a, b in zip(got[:3], want[:3]):
        scale_close(a, np.asarray(b))
    np.testing.assert_allclose(got[3], float(want[3]), rtol=TOL)
    jg = jglobal.GlobalGmm(gmm.weights, gmm.means, gmm.vars)
    for a, b in zip(vars(pglobal.em_update(gmm, *want[:3])).values(),
                    vars(jglobal.em_update(jg, *want[:3])).values()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(vars(pglobal.split_global(gmm, 7, seed=3)).values(),
                    vars(jglobal.split_global(jg, 7, seed=3)).values()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_gauss,init,iters", [(3, 0, 25), (8, 2, 10)])
def test_init_from_feats_matches_jax(num_gauss, init, iters):
    rs = np.random.RandomState(7)
    feats = _mixture(rs)
    kw = dict(num_iters=iters, num_gauss_init=init, seed=1)
    got = pglobal.init_from_feats(feats, num_gauss, device="cpu", **kw)
    want = jglobal.init_from_feats(feats, num_gauss, **kw)
    assert got.num_gauss == want.num_gauss
    scale_close(got.weights, want.weights, tol=1e-4)
    scale_close(got.means, want.means, tol=1e-4)
    scale_close(got.vars, want.vars, tol=1e-4)
    np.testing.assert_allclose(pglobal.avg_loglike(got, feats, "cpu"),
                               jglobal.avg_loglike(want, feats), rtol=1e-4)


def test_global_gmm_file_format_both_ways(tmp_path):
    rs = np.random.RandomState(8)
    gmm = pglobal.init_from_feats(_mixture(rs), 3, num_iters=4,
                                  device="cpu")
    gmm.save(str(tmp_path / "port.npz"))
    jgmm_ = jglobal.GlobalGmm.load(str(tmp_path / "port.npz"))
    jg = jglobal.init_from_feats(_mixture(rs), 2, num_iters=3)
    jg.save(str(tmp_path / "jax.npz"))
    back = pglobal.GlobalGmm.load(str(tmp_path / "jax.npz"))
    for k in ("weights", "means", "vars"):
        np.testing.assert_array_equal(getattr(jgmm_, k), getattr(gmm, k))
        np.testing.assert_array_equal(getattr(back, k), getattr(jg, k))
    carried = global_gmm_from_jax(jg)
    for k, v in global_gmm_to_jax(carried).items():
        np.testing.assert_array_equal(v, getattr(jg, k))


def test_gmm_vad_matches_jax():
    """tests/test_gmm_vad.py:52's bands: trained in both packages, the
    same speech mask; the port's ratios of JAX's GMMs within 1e-4."""
    rs = np.random.RandomState(7)
    T = 600
    labels = (np.arange(T) // 100) % 2
    sil = rs.randn(T, 8) * 0.5
    speech = rs.randn(T, 8) * 0.7 + 3.0
    feats = np.where(labels[:, None] == 1, speech, sil).astype(np.float32)
    kw = dict(speech_trigger_ms=30, silence_trigger_ms=50, lookback_ms=0)
    vad = pvad.train_gmm_vad(feats, labels, num_gauss=4, num_iters=8,
                             opts=VadOptions(**kw), device="cpu")
    jv = jvad.train_gmm_vad(feats, labels, num_gauss=4, num_iters=8,
                            opts=JaxVadOptions(**kw))
    mask = vad.detect(feats)
    np.testing.assert_array_equal(mask, jv.detect(feats))
    assert (mask == labels.astype(bool)).mean() > 0.95
    carried = pvad.GmmVad(global_gmm_from_jax(jv.sil_gmm),
                          global_gmm_from_jax(jv.speech_gmm),
                          VadOptions(**kw), device="cpu")
    np.testing.assert_allclose(carried.frame_scores(feats),
                               jv.frame_scores(feats), rtol=1e-4, atol=1e-4)
    assert carried.is_speech_frame(feats[150]) and \
        not carried.is_speech_frame(feats[50])
