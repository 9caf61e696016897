"""The triphone slice's device work on the card: the CD GMM statistics
(one-hot products, float64), the global GMM's EM statistics, the full
GMM's statistics and the EBW denominator each give the same bits run
twice on the card and round to the CPU's float32 values (1e-6 of each
array's largest magnitude); a triphone system's realignment gives the
same alignments twice on the card and the CPU's, frame for frame.  No
hand kernel is on this path.

These tests skip where there is no CUDA card.  This file imports no
JAX; run it on the card with ``python -m pytest --noconftest
tests/test_torch_tri_cuda.py -q``."""

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.fst import Lang, Lexicon
from kaldi_aslp_tpu_torch.fst.hclg import expand_hmm_cd
from kaldi_aslp_tpu_torch.gmm import diag_gmm as g
from kaldi_aslp_tpu_torch.gmm import ebw, full_gmm, global_gmm
from kaldi_aslp_tpu_torch.gmm.deltas import DeltasTrainer, DeltasTrainOptions
from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer, MonoTrainOptions

STATS_TOL = 1e-6
# tests/test_torch_tri.py's options (that file imports JAX)
MONO = dict(num_iters=6, totgauss=40, realign_iters="1 2 3 4 5")
TRI = dict(num_iters=8, totgauss=120, num_leaves=40, realign_iters="2 4 6",
           tree_min_gain=5.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(card, cpu):
    np.testing.assert_allclose(card, cpu, rtol=STATS_TOL,
                               atol=STATS_TOL * float(np.abs(cpu).max()))


def _same_twice_and_as_the_cpu(fn, dev):
    runs = [fn(dev), fn(dev), fn("cpu")]
    for a, b in zip(runs[0], runs[1]):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    for a, c in zip(runs[0], runs[2]):
        _close(np.asarray(a), np.asarray(c))


def _model(rs, P=400, M=8, D=39):
    """A triphone-sized model: 400 leaves, dead slots as after mixing
    up."""
    w = rs.rand(P, M).astype(np.float32) + 0.1
    w[::5, M // 2:] = 0.0
    w /= w.sum(1, keepdims=True)
    return g.AmDiagGmm(weights=w, means=rs.randn(P, M, D).astype(np.float32),
                       vars=(0.3 + rs.rand(P, M, D)).astype(np.float32))


@pytest.mark.cuda
def test_cd_statistics_same_bits_twice_and_as_the_cpu():
    dev = _card()
    rs = np.random.RandomState(0)
    am = _model(rs)
    T = g.STATS_BLOCK + 4001
    feats = rs.randn(T, am.dim).astype(np.float32)
    pdfs = rs.randint(0, am.num_pdfs, T)

    def stats(device):
        s = g.GmmStats(am, device)
        s.accumulate(am.pack(device), feats, pdfs)
        return s.to_numpy()
    _same_twice_and_as_the_cpu(stats, dev)


@pytest.mark.cuda
def test_ebw_denominator_same_bits_twice_and_as_the_cpu():
    dev = _card()
    rs = np.random.RandomState(1)
    am = _model(rs, P=60)
    feats = rs.randn(500, am.dim).astype(np.float32)
    _same_twice_and_as_the_cpu(
        lambda d: ebw.accumulate_denominator_stats(am, feats, device=d), dev)


@pytest.mark.cuda
def test_global_gmm_em_statistics_same_bits_twice_and_as_the_cpu():
    dev = _card()
    rs = np.random.RandomState(2)
    gmm = global_gmm.GlobalGmm(
        np.full(64, 1 / 64, np.float32), rs.randn(64, 39).astype(np.float32),
        (0.5 + rs.rand(64, 39)).astype(np.float32))
    feats = rs.randn(global_gmm.EM_BLOCK + 999, 39).astype(np.float32)
    fw = np.ones(len(feats), np.float32)
    _same_twice_and_as_the_cpu(
        lambda d: global_gmm.em_stats(feats, fw, *gmm.pack(d)), dev)
    grown = {d: global_gmm.init_from_feats(feats[:20000], 16, num_iters=6,
                                           device=d) for d in (dev, "cpu")}
    _close(grown[dev].means, grown["cpu"].means)


@pytest.mark.cuda
def test_full_gmm_statistics_same_bits_twice_and_as_the_cpu():
    dev = _card()
    rs = np.random.RandomState(3)
    full = full_gmm.AmFullGmm.from_diag(_model(rs, P=50, M=4, D=13))
    feats = rs.randn(3000, 13).astype(np.float32)
    pdfs = rs.randint(0, 50, 3000)
    _same_twice_and_as_the_cpu(
        lambda d: full_gmm.full_gmm_accumulate(full, feats, pdfs, d), dev)
    ll = {d: full_gmm.full_gmm_loglikes(feats, *full.pack(d)).cpu().numpy()
          for d in (dev, "cpu")}
    np.testing.assert_allclose(ll[dev], ll["cpu"], rtol=1e-6)


def ctx_corpus(rng, num_utts, words_per_utt=4):
    """tests/test_tree.py:_ctx_corpus: Y's acoustics depend on the
    previous phone."""
    centers = {"Y": np.array([3.0, 0.0]), "N": np.array([-3.0, 0.0]),
               "SIL": np.array([0.0, 3.0])}
    feats, texts = {}, {}
    for u in range(num_utts):
        words = [("YES" if rng.rand() < 0.5 else "NO")
                 for _ in range(words_per_utt)]
        seq = ["SIL"]
        for w in words:
            seq += ["Y" if w == "YES" else "N", "SIL"]
        frames = []
        for i, ph in enumerate(seq):
            c = centers[ph]
            if ph == "Y" and i and seq[i - 1] == "N":
                c = c + np.array([0.0, -2.5])
            frames.append(c + 0.4 * rng.randn(rng.randint(8, 14), 2))
        feats[f"u{u}"] = np.concatenate(frames).astype(np.float32)
        texts[f"u{u}"] = words
    return feats, texts


@pytest.mark.cuda
def test_tri_realignment_same_twice_and_as_the_cpu():
    """A triphone system of tests/test_torch_tri.py's toy corpus, trained
    on the CPU; one realignment of its training graphs on the card, twice,
    and on the CPU."""
    dev = _card()
    feats, texts = ctx_corpus(np.random.RandomState(777), num_utts=40)
    lang = Lang.build(Lexicon.from_text("YES Y\nNO N\n"))
    mono = MonophoneTrainer(lang, opts=MonoTrainOptions(**MONO),
                            device="cpu")
    am0, tm0 = mono.train(feats, texts)
    tri = DeltasTrainer(lang, mono.topo, DeltasTrainOptions(**TRI),
                        device="cpu")
    am, tm = tri.train(feats, texts, tm0, mono.align(am0, feats, texts))
    utts = sorted(feats)
    graphs = {u: expand_hmm_cd(tri.compiler.compile_clg(texts[u]), tm,
                               tri.windows, tri.tree) for u in utts}
    lut = tm.alignment_to_pdfs(np.arange(tm.num_transition_ids + 1))
    runs = []
    for device in (dev, dev, "cpu"):
        tri.device = torch.device(device)
        runs.append(tri._align_all(am, graphs, feats, utts, lut))
    for u in utts:
        np.testing.assert_array_equal(runs[0][u], runs[1][u])
        np.testing.assert_array_equal(runs[0][u], runs[2][u])
