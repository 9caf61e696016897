"""The port's decision trees and context expansion
(kaldi_aslp_tpu_torch/tree/, fst/context.py, the CD half of fst/hclg.py)
against the JAX package on the CPU, from the same numpy-seeded inputs.
All of it is host numpy or plain Python on both sides, so every result
is held equal (no tolerance) but the clustering objectives, which sum
float64 arrays in the same order on both sides and are held equal too:

  * GaussStats, merge_objf_loss, cluster_bottom_up, kmeans_cluster;
  * stats_from_alignment and cluster_phones_into_questions;
  * build_tree: the same tree node for node (questions, key positions,
    leaf pdf ids) on random statistics, on its own questions and given
    ones;
  * compose_context: the same windows, ids and arcs, triphone and
    monophone;
  * expand_hmm_cd and triples_from_tree over a tree carried across
    (models/interop.py tree_from_jax / tree_to_jax)."""

import importlib

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.fst import Lang as JaxLang
from kaldi_aslp_tpu.fst import Lexicon as JaxLexicon
from kaldi_aslp_tpu.fst import context as jcontext
from kaldi_aslp_tpu.fst import hclg as jhclg
from kaldi_aslp_tpu.fst import make_lexicon_fst as jax_lexicon_fst
from kaldi_aslp_tpu.fst import make_unigram_grammar as jax_unigram
from kaldi_aslp_tpu.gmm import MonophoneTrainer as JaxMono
from kaldi_aslp_tpu.tree import cluster as jcluster
from kaldi_aslp_tpu_torch.fst import (
    Lang,
    Lexicon,
    make_lexicon_fst,
    make_unigram_grammar,
)
from kaldi_aslp_tpu_torch.fst import context as pcontext
from kaldi_aslp_tpu_torch.fst import hclg as phclg
from kaldi_aslp_tpu_torch.gmm import MonophoneTrainer
from kaldi_aslp_tpu_torch.models.interop import tree_from_jax, tree_to_jax
from kaldi_aslp_tpu_torch.tree import cluster as pcluster

torch.set_num_threads(1)

# the modules (each package's tree/__init__ exports a function of this name)
jbuild = importlib.import_module("kaldi_aslp_tpu.tree.build_tree")
pbuild = importlib.import_module("kaldi_aslp_tpu_torch.tree.build_tree")

LEXICON = "YES Y EH S\nNO N OW\nYO Y OW\nSEE S IY\nNOSE N OW Z\n"


def _clouds(rs, n=6, dim=3):
    return [rs.randn(rs.randint(20, 60), dim) + 4.0 * (i % 3)
            for i in range(n)]


def test_gauss_stats_and_merge_loss_equal_jax():
    rs = np.random.RandomState(0)
    clouds = _clouds(rs)
    got = [pcluster.GaussStats.from_frames(c) for c in clouds]
    want = [jcluster.GaussStats.from_frames(c) for c in clouds]
    for g, w in zip(got, want):
        assert (g.count, g.objf(), g.objf(0.5)) == (w.count, w.objf(),
                                                    w.objf(0.5))
        np.testing.assert_array_equal(g.sum, w.sum)
    assert pcluster.GaussStats.zero(3).objf() == 0.0
    for i in range(len(clouds) - 1):
        assert pcluster.merge_objf_loss(got[i], got[i + 1]) == \
            jcluster.merge_objf_loss(want[i], want[i + 1]) >= 0.0


@pytest.mark.parametrize("k", [1, 2, 3, 6, 9])
def test_cluster_bottom_up_equals_jax(k):
    rs = np.random.RandomState(1)
    clouds = _clouds(rs, n=7)
    assert pcluster.cluster_bottom_up(
        [pcluster.GaussStats.from_frames(c) for c in clouds], k) == \
        jcluster.cluster_bottom_up(
            [jcluster.GaussStats.from_frames(c) for c in clouds], k)


@pytest.mark.parametrize("k,seed", [(2, 0), (3, 5), (50, 1)])
def test_kmeans_equals_jax(k, seed):
    rs = np.random.RandomState(2)
    v = np.concatenate([rs.randn(30, 2), rs.randn(30, 2) + 8,
                        rs.randn(10, 2) - 6])
    np.testing.assert_array_equal(pcluster.kmeans_cluster(v, k, seed=seed),
                                  jcluster.kmeans_cluster(v, k, seed=seed))


def _stats(module, rs, num_utts=12, phones=(1, 2, 3, 4, 5), dim=3):
    """Per-frame phone and pdf-class runs (three classes a phone) with
    acoustics that depend on the left phone."""
    stats = None
    for _ in range(num_utts):
        seq = [phones[rs.randint(len(phones))] for _ in range(6)]
        ph, pc, frames = [], [], []
        for i, p in enumerate(seq):
            left = seq[i - 1] if i else 0
            for c in range(3):
                n = rs.randint(2, 6)
                ph += [p] * n
                pc += [c] * n
                frames.append(rs.randn(n, dim) + p + 0.7 * left + c)
        stats = module.stats_from_alignment(
            np.concatenate(frames), np.asarray(ph), np.asarray(pc), stats)
    return stats


def test_stats_and_questions_equal_jax():
    got = _stats(pbuild, np.random.RandomState(3))
    want = _stats(jbuild, np.random.RandomState(3))
    assert list(got) == list(want)
    for key in want:
        assert got[key].count == want[key].count
        np.testing.assert_array_equal(got[key].sum, want[key].sum)
        np.testing.assert_array_equal(got[key].sumsq, want[key].sumsq)
    for n in (3, 10):
        assert pbuild.cluster_phones_into_questions(got, [1, 2, 3, 4, 5], n) \
            == jbuild.cluster_phones_into_questions(want, [1, 2, 3, 4, 5], n)


def nodes(tree):
    def walk(node):
        if node.key_pos is None:
            return [("leaf", node.pdf)]
        return ([("split", node.key_pos, sorted(node.question))]
                + walk(node.yes) + walk(node.no))
    return {key: walk(n) for key, n in sorted(tree.roots.items())}


@pytest.mark.parametrize("max_leaves,min_gain,questions", [
    (40, 5.0, None), (18, 5.0, None), (200, 1.0, None),
    (40, 5.0, [[1, 2], [3], [4, 5], [1, 3, 5]])])
def test_build_tree_equals_jax_node_for_node(max_leaves, min_gain,
                                              questions):
    got = _stats(pbuild, np.random.RandomState(4))
    want = _stats(jbuild, np.random.RandomState(4))
    phones = [1, 2, 3, 4, 5, 6]      # 6 unseen: its roots are bare leaves
    kw = dict(questions=questions, max_leaves=max_leaves, min_gain=min_gain,
              min_count=5.0)
    tree = pbuild.build_tree(got, phones, {p: 3 for p in phones}, **kw)
    jtree = jbuild.build_tree(want, phones, {p: 3 for p in phones}, **kw)
    assert tree.num_pdfs == jtree.num_pdfs >= 18    # 18 roots
    assert nodes(tree) == nodes(jtree)
    for window in [(0, 1, 2), (5, 3, 0), (9, 4, 9), (2, 6, 1)]:
        for pc in range(3):
            assert tree.compute(window, pc) == jtree.compute(window, pc)
    with pytest.raises(KeyError):
        tree.compute((1, 7, 1), 0)


def test_tree_crosses_from_jax_and_back():
    jtree = jbuild.build_tree(_stats(jbuild, np.random.RandomState(5)),
                              [1, 2, 3, 4, 5], {p: 3 for p in range(1, 6)},
                              max_leaves=30, min_gain=5.0, min_count=5.0)
    tree = tree_from_jax(jtree)
    assert isinstance(tree, pbuild.ContextDependency)
    assert nodes(tree) == nodes(jtree) and tree.num_pdfs == jtree.num_pdfs
    back = tree_to_jax(tree, jbuild.ContextDependency, jbuild.TreeNode)
    assert isinstance(back.roots[(1, 0)], jbuild.TreeNode)
    assert nodes(back) == nodes(jtree)
    assert (back.context_width, back.central_position) == (3, 1)


def _lgs():
    """L o G of the five-word lexicon in both packages, equal."""
    lang = Lang.build(Lexicon.from_text(LEXICON))
    jlang = JaxLang.build(JaxLexicon.from_text(LEXICON))
    probs = {"YES": 0.3, "NO": 0.2, "YO": 0.1, "SEE": 0.2, "NOSE": 0.2}
    lg = make_lexicon_fst(lang).arc_sort("olabel").compose(
        make_unigram_grammar(probs, lang.words))
    # JAX's Python composition, the port's (its native helper orders the
    # arcs of a state its own way)
    jlg = jax_lexicon_fst(jlang).arc_sort("olabel")._compose_py(
        jax_unigram(probs, jlang.words))
    return lang, lg, jlang, jlg


def _arcs(fst):
    return (fst.start, sorted(fst.finals.items()),
            [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs]
             for arcs in fst.arcs])


@pytest.mark.parametrize("width,central", [(3, 1), (1, 0)])
def test_compose_context_equals_jax(width, central):
    _, lg, _, jlg = _lgs()
    assert _arcs(lg) == _arcs(jlg)
    clg, table = pcontext.compose_context(lg, width, central)
    jclg, jtable = jcontext.compose_context(jlg, width, central)
    assert table.all_windows() == jtable.all_windows()
    assert len(table) == len(jtable) > 5
    assert _arcs(clg) == _arcs(jclg)
    with pytest.raises(NotImplementedError):
        pcontext.compose_context(lg, 2, 1)


def test_expand_hmm_cd_and_triples_equal_jax():
    """The CD H expansion of one CLG over a tree built by JAX and carried
    into the port, and the triples over its windows."""
    lang, lg, jlang, jlg = _lgs()
    clg, table = pcontext.compose_context(lg)
    jclg, jtable = jcontext.compose_context(jlg)
    phones = [lang.phones.id(p) for p in lang.lexicon.phone_set()]
    mono = MonophoneTrainer(lang, device="cpu")
    topo = mono.topo
    rs = np.random.RandomState(6)
    stats = None
    for _ in range(20):
        seq = [phones[rs.randint(len(phones))] for _ in range(5)]
        ph, pc, frames = [], [], []
        for p in seq:
            n_pc = topo.entry(p).num_pdf_classes
            for c in range(n_pc):
                n = rs.randint(3, 7)
                ph += [p] * n
                pc += [c] * n
                frames.append(rs.randn(n, 2) + p + c)
        stats = jbuild.stats_from_alignment(
            np.concatenate(frames), np.asarray(ph), np.asarray(pc), stats)
    jtree = jbuild.build_tree(
        stats, phones, {p: topo.entry(p).num_pdf_classes for p in phones},
        max_leaves=60, min_gain=2.0, min_count=3.0)
    tree = tree_from_jax(jtree)
    trip = phclg.triples_from_tree(topo, tree, table)
    jtrip = jhclg.triples_from_tree(JaxMono(jlang).topo, jtree, jtable)
    assert trip == jtrip and len(trip) > len(phones) * 3
    from kaldi_aslp_tpu.hmm import TransitionModel as JaxTM
    from kaldi_aslp_tpu_torch.hmm import TransitionModel
    tm = TransitionModel(topo, triples=trip)
    jtm = JaxTM(JaxMono(jlang).topo, triples=jtrip)
    ali = np.random.RandomState(7).randint(1, tm.num_transition_ids + 1, 400)
    tm.mle_update(tm.accumulate(ali))
    jtm.mle_update(jtm.accumulate(ali))
    got = phclg.expand_hmm_cd(clg, tm, table, tree)
    want = jhclg.expand_hmm_cd(jclg, jtm, jtable, jtree)
    ga, wa = got.to_arrays(), want.to_arrays()
    for key in wa:
        np.testing.assert_array_equal(np.asarray(ga[key]),
                                      np.asarray(wa[key]), err_msg=key)
