"""The port's alignment conversion (kaldi_aslp_tpu_torch/hmm/convert_ali.py)
and CD-phone label toolchain (tree/cd_phone.py) against the JAX package
on the CPU, from the same numpy-seeded inputs.  Both are host numpy and
plain Python on both sides, so every result is held equal:

  * phone_segments and convert_alignment (mono -> mono, and mono -> a
    triphone system through its tree), on the toy CD-phone corpus of
    tests/test_cd_phone.py aligned by the port's monophone trainer;
  * the summarizers and acc_tree_stats_cd_phone by every method;
  * compile_questions_phone, build_cd_phone_tree (node for node),
    tree_bind_info (the same text) and convert_ali_to_cd_phone (segment
    and frame labels)."""

import importlib

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.fst import Lang as JaxLang
from kaldi_aslp_tpu.fst import Lexicon as JaxLexicon
from kaldi_aslp_tpu.gmm import MonophoneTrainer as JaxMono
from kaldi_aslp_tpu.hmm import convert_ali as jconv
from kaldi_aslp_tpu.tree import cd_phone as jcd
from kaldi_aslp_tpu_torch.fst import Lang, Lexicon
from kaldi_aslp_tpu_torch.gmm import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu_torch.gmm.deltas import DeltasTrainer, DeltasTrainOptions
from kaldi_aslp_tpu_torch.hmm import convert_ali as pconv
from kaldi_aslp_tpu_torch.tree import cd_phone as pcd

torch.set_num_threads(1)

LEXICON = "AB a b\nBA b a\nAA a a\n"
METHODS = ["kmeans", "equal", "viterbi", "mean", "mean-per-frame", "median"]
jbuild = importlib.import_module("kaldi_aslp_tpu.tree.build_tree")


@pytest.fixture(scope="module")
def system():
    """tests/test_cd_phone.py:_mono_system, trained by the port; JAX's
    trainer gives the same transition ids (tests/test_torch_hmm.py)."""
    rng = np.random.RandomState(777)
    lex = Lexicon.from_text(LEXICON)
    lang = Lang.build(lex)

    def center(ph):
        return {"a": np.array([3.0, 0.0]), "b": np.array([-3.0, 0.0]),
                "SIL": np.array([0.0, 3.0])}[ph]

    feats, texts = {}, {}
    words = ["AB", "BA", "AA"]
    pron = {w: p[0] for w, p in lex.prons.items()}
    for u in range(10):
        ws = [words[rng.randint(3)] for _ in range(3)]
        seq = ["SIL"]
        for w in ws:
            seq.extend(pron[w])
            seq.append("SIL")
        frames = [center(ph) + 0.3 * rng.randn(rng.randint(6, 10), 2)
                  for ph in seq]
        feats[f"u{u}"] = np.concatenate(frames).astype(np.float32)
        texts[f"u{u}"] = ws
    mono = MonophoneTrainer(lang, opts=MonoTrainOptions(
        num_iters=5, totgauss=30, realign_iters="1 2 3"), device="cpu")
    am, tm = mono.train(feats, texts)
    alis = mono.align(am, feats, texts)
    jtm = JaxMono(JaxLang.build(JaxLexicon.from_text(LEXICON))).trans_model
    jtm.log_probs = tm.log_probs.copy()
    return dict(lang=lang, mono=mono, am=am, tm=tm, jtm=jtm, feats=feats,
                texts=texts, alis=alis)


def test_phone_segments_and_mono_conversion_equal_jax(system):
    tm, jtm = system["tm"], system["jtm"]
    for u, ali in system["alis"].items():
        segs = pconv.phone_segments(tm, ali)
        assert segs == jconv.phone_segments(jtm, ali)
        assert sum(n for _, _, n in segs) == len(ali)
        got = pconv.convert_alignment(ali, tm, tm)
        np.testing.assert_array_equal(got, jconv.convert_alignment(ali, jtm,
                                                                   jtm))
        assert [(p, n) for p, _, n in pconv.phone_segments(tm, got)] == \
            [(p, n) for p, _, n in segs]


def test_conversion_to_a_triphone_system_equals_jax(system):
    """Mono alignments re-expressed in a triphone system's ids through its
    tree (the convert-ali role), the tree carried to JAX node for node."""
    from kaldi_aslp_tpu.hmm import TransitionModel as JaxTM
    from kaldi_aslp_tpu_torch.models.interop import tree_to_jax
    s = system
    tri = DeltasTrainer(s["lang"], s["mono"].topo, DeltasTrainOptions(
        num_iters=3, totgauss=30, num_leaves=16, realign_iters="2",
        tree_min_gain=2.0), device="cpu")
    _, tm1 = tri.train(s["feats"], s["texts"], s["tm"], s["alis"])
    jtree = tree_to_jax(tri.tree, jbuild.ContextDependency, jbuild.TreeNode)
    jtm1 = JaxTM(s["jtm"].topo, triples=[(st.phone, st.hmm_state, st.pdf)
                                         for st in tm1.states[1:]])
    for u, ali in s["alis"].items():
        got = pconv.convert_alignment(ali, s["tm"], tm1, tree=tri.tree)
        want = jconv.convert_alignment(ali, s["jtm"], jtm1, tree=jtree)
        np.testing.assert_array_equal(got, want, err_msg=u)
        assert len(got) == len(ali)
        assert [p for p, _, _ in pconv.phone_segments(tm1, got)] == \
            [p for p, _, _ in pconv.phone_segments(s["tm"], ali)]


def test_summarizers_equal_jax():
    rs = np.random.RandomState(3)
    for n in (2, 3, 7, 20):
        frames = rs.randn(n, 4)
        for name in ("summarize_equal", "summarize_kmeans",
                     "summarize_mean", "summarize_median"):
            np.testing.assert_array_equal(getattr(pcd, name)(frames),
                                          getattr(jcd, name)(frames))
        pcs = np.sort(rs.randint(0, 3, n))
        np.testing.assert_array_equal(pcd.summarize_viterbi(frames, pcs),
                                      jcd.summarize_viterbi(frames, pcs))


def _stats(module, system, method, ci=()):
    stats = {}
    tm = system["tm"] if module is pcd else system["jtm"]
    for u in system["feats"]:
        stats = module.acc_tree_stats_cd_phone(
            system["feats"][u], system["alis"][u], tm, method=method,
            ci_phones=ci, stats=stats)
    return stats


@pytest.mark.parametrize("method", METHODS)
def test_acc_tree_stats_cd_phone_equal_jax(system, method):
    got, want = _stats(pcd, system, method), _stats(jcd, system, method)
    assert list(got) == list(want) and got
    for key in want:
        assert got[key].count == want[key].count
        np.testing.assert_array_equal(got[key].sum, want[key].sum)
        np.testing.assert_array_equal(got[key].sumsq, want[key].sumsq)
    with pytest.raises(ValueError, match="unknown cd-phone"):
        pcd.acc_tree_stats_cd_phone(system["feats"]["u0"],
                                    system["alis"]["u0"], system["tm"],
                                    method="kmeans3")


@pytest.mark.parametrize("method,ci", [("kmeans", ()), ("equal", (1,))])
def test_cd_phone_pipeline_equals_jax(system, method, ci):
    """prepare_cd_phone.sh: stats -> questions -> tree -> bind info ->
    label conversion, in both packages."""
    got, want = (_stats(pcd, system, method, ci),
                 _stats(jcd, system, method, ci))
    phones = sorted({w[1] for (w, _) in want})
    questions = pcd.compile_questions_phone(got, phones)
    assert questions == jcd.compile_questions_phone(want, phones)
    tree = pcd.build_cd_phone_tree(got, phones, num_leaves=6,
                                   questions=questions, min_gain=1.0)
    jtree = jcd.build_cd_phone_tree(want, phones, num_leaves=6,
                                    questions=questions, min_gain=1.0)
    assert 1 <= tree.num_pdfs == jtree.num_pdfs <= 6
    assert pcd.tree_bind_info(tree, got) == jcd.tree_bind_info(jtree, want)
    for u, ali in system["alis"].items():
        for per_frame in (False, True):
            np.testing.assert_array_equal(
                pcd.convert_ali_to_cd_phone(system["tm"], tree, ali,
                                            per_frame=per_frame),
                jcd.convert_ali_to_cd_phone(system["jtm"], jtree, ali,
                                            per_frame=per_frame))
