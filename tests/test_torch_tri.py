"""The port's triphone system (kaldi_aslp_tpu_torch/gmm/deltas.py) and
the ladder's tri and dnn stages against the JAX package on the CPU, from
the same numpy-seeded inputs:

  * DeltasTrainer on tests/test_tree.py:148-181's coarticulated toy
    corpus, both packages from the same monophone alignments: the tree
    node for node, the training and decode transition models' triples,
    the transition log-probabilities (float32, equal: both packages
    count the same alignments), the final alignments frame for frame;
    the CD HCLG's arcs equal and weights within 1e-6 (as in
    tests/test_torch_hclg.py); the port's decode of it WER 0;
  * make_cd_decode_graph keeps the raw L o G with a warning that names
    the non-determinizable error, and lets any other error through;
  * DeltasTrainer.align gives the training's final alignments again;
  * the ladder's ``--stages=mono,tri,dnn`` on a tiny injected corpus;
  * a process with ``jax`` blocked runs the ladder's tri and dnn stages
    and the GMM family without loading a module of the JAX package."""

import dataclasses
import json
import logging
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.fst import Lang as JaxLang
from kaldi_aslp_tpu.fst import Lexicon as JaxLexicon
from kaldi_aslp_tpu.fst import make_unigram_grammar as jax_unigram
from kaldi_aslp_tpu.gmm import MonophoneTrainer as JaxMono
from kaldi_aslp_tpu.gmm import MonoTrainOptions as JaxMonoOptions
from kaldi_aslp_tpu.gmm import deltas as jdeltas
from kaldi_aslp_tpu_torch.decoder import PackedGraph, ViterbiDecoder
from kaldi_aslp_tpu_torch.fst import (
    Lang,
    Lexicon,
    NonDeterminizableError,
    make_unigram_grammar,
)
from kaldi_aslp_tpu_torch.gmm import deltas as pdeltas
from kaldi_aslp_tpu_torch.gmm import diag_gmm as pgmm
from kaldi_aslp_tpu_torch.gmm import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu_torch.ops.edit_distance import score_utterances
from kaldi_aslp_tpu_torch.recipes import hard_ladder

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEXICON = "YES Y\nNO N\n"
WEIGHT_ATOL = 1e-6      # graph costs: float32 log-probs, float64 sums
# GMM means, against the largest mean's magnitude: the port sums in
# float64, JAX in float32, and EM on a mixed-up pair of nearly equal
# gaussians (split with 0.01 std apart) amplifies that rounding over the
# iterations (1.1e-4 at a largest magnitude of 3.2 on this corpus)
MEANS_TOL = 1e-4
MONO = dict(num_iters=6, totgauss=40, realign_iters="1 2 3 4 5")
TRI = dict(num_iters=8, totgauss=120, num_leaves=40, realign_iters="2 4 6",
           tree_min_gain=5.0)


def ctx_corpus(rng, num_utts=14, words_per_utt=4):
    """tests/test_tree.py:_ctx_corpus: Y's acoustics depend on the
    previous phone (coarticulation)."""
    def center(ph, left):
        base = {"Y": np.array([3.0, 0.0]), "N": np.array([-3.0, 0.0]),
                "SIL": np.array([0.0, 3.0])}[ph]
        if ph == "Y" and left == "N":
            base = base + np.array([0.0, -2.5])
        return base

    feats, texts = {}, {}
    for u in range(num_utts):
        words = [("YES" if rng.rand() < 0.5 else "NO")
                 for _ in range(words_per_utt)]
        seq = ["SIL"]
        for w in words:
            seq += ["Y" if w == "YES" else "N", "SIL"]
        frames = []
        for i, ph in enumerate(seq):
            left = seq[i - 1] if i else "SIL"
            n = rng.randint(8, 14)
            frames.append(center(ph, left) + 0.4 * rng.randn(n, 2))
        feats[f"u{u}"] = np.concatenate(frames).astype(np.float32)
        texts[f"u{u}"] = words
    return feats, texts


def tree_nodes(tree):
    """Every root's nodes in pre-order: (key_pos, sorted question) for a
    split, the pdf for a leaf."""
    def walk(node):
        if node.key_pos is None:
            return [("leaf", node.pdf)]
        return ([("split", node.key_pos, sorted(node.question))]
                + walk(node.yes) + walk(node.no))
    return {key: walk(node) for key, node in sorted(tree.roots.items())}


def assert_same_graph(got, want):
    ga, wa = got.to_arrays(), want.to_arrays()
    assert sorted(ga) == sorted(wa)
    for key in wa:
        if key in ("weight", "final"):
            np.testing.assert_allclose(np.asarray(ga[key]),
                                       np.asarray(wa[key]),
                                       atol=WEIGHT_ATOL, rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(np.asarray(ga[key]),
                                          np.asarray(wa[key]), err_msg=key)


def triples(tm):
    return [(s.phone, s.hmm_state, s.pdf) for s in tm.states[1:]]


@pytest.fixture(scope="module")
def both():
    """The toy corpus's monophone system in the port, its alignments fed
    to both packages' DeltasTrainer."""
    feats, texts = ctx_corpus(np.random.RandomState(777))
    lang = Lang.build(Lexicon.from_text(LEXICON))
    mono = MonophoneTrainer(lang, opts=MonoTrainOptions(**MONO),
                            device="cpu")
    am0, tm0 = mono.train(feats, texts)
    alis = mono.align(am0, feats, texts)
    tri = pdeltas.DeltasTrainer(lang, mono.topo,
                                pdeltas.DeltasTrainOptions(**TRI),
                                device="cpu")
    am, tm = tri.train(feats, texts, tm0, alis)
    final = {u: a.copy() for u, a in tri._final_alignments.items()}
    train_triples, train_lp = triples(tm), tm.log_probs.copy()
    G = make_unigram_grammar({"YES": 0.5, "NO": 0.5}, lang.words)
    hclg, tm_dec = pdeltas.make_cd_decode_graph(lang, G, tri)

    jlang = JaxLang.build(JaxLexicon.from_text(LEXICON))
    jmono = JaxMono(jlang, opts=JaxMonoOptions(**MONO))
    jtri = jdeltas.DeltasTrainer(jlang, jmono.topo,
                                 jdeltas.DeltasTrainOptions(**TRI))
    jam, jtm = jtri.train(feats, texts, jmono.trans_model, alis)
    jtrain_triples, jtrain_lp = triples(jtm), jtm.log_probs.copy()
    jhclg, jtm_dec = jdeltas.make_cd_decode_graph(
        jlang, jax_unigram({"YES": 0.5, "NO": 0.5}, jlang.words), jtri)
    return dict(feats=feats, texts=texts, lang=lang, mono=mono, am0=am0,
                tm0=tm0, alis=alis, tri=tri, am=am, tm=tm, final=final,
                train_triples=train_triples, train_lp=train_lp,
                hclg=hclg, tm_dec=tm_dec, jtri=jtri, jam=jam,
                jtrain_triples=jtrain_triples, jtrain_lp=jtrain_lp,
                jhclg=jhclg, jtm_dec=jtm_dec)


def test_tree_equals_jax_node_for_node(both):
    tree, jtree = both["tri"].tree, both["jtri"].tree
    assert tree.num_pdfs == jtree.num_pdfs > both["tm0"].num_pdfs
    assert tree_nodes(tree) == tree_nodes(jtree)


def test_windows_and_triples_equal_jax(both):
    tri, jtri = both["tri"], both["jtri"]
    assert tri.windows.all_windows() == jtri.windows.all_windows()
    assert both["train_triples"] == both["jtrain_triples"]
    assert triples(both["tm_dec"]) == triples(both["jtm_dec"])
    assert set(both["train_triples"]) <= set(triples(both["tm_dec"]))


def test_transition_log_probs_equal_jax(both):
    np.testing.assert_array_equal(both["train_lp"], both["jtrain_lp"])
    np.testing.assert_array_equal(both["tm_dec"].log_probs,
                                  both["jtm_dec"].log_probs)


def test_final_alignments_and_model_equal_jax(both):
    final, jfinal = both["final"], both["jtri"]._final_alignments
    assert sorted(final) == sorted(jfinal)
    for u in final:
        np.testing.assert_array_equal(final[u], jfinal[u], err_msg=u)
    am, jam = both["am"], both["jam"]
    np.testing.assert_array_equal(am.weights > 0, jam.weights > 0)
    np.testing.assert_allclose(am.means, jam.means, rtol=0,
                               atol=MEANS_TOL * float(np.abs(jam.means).max()))


def test_cd_decode_graph_equals_jax_and_decodes(both):
    assert_same_graph(both["hclg"], both["jhclg"])
    tm, lang = both["tm_dec"], both["lang"]
    dec = ViterbiDecoder(PackedGraph.from_fst(both["hclg"]),
                         tm.alignment_to_pdfs(
                             np.arange(tm.num_transition_ids + 1)),
                         acoustic_scale=1.0, word_ins_penalty=2.0,
                         device="cpu")
    lls = pgmm.corpus_loglikes(both["feats"], sorted(both["feats"]),
                               both["am"].pack("cpu"))
    hyps = {u: [lang.words.sym(w) for w in dec.decode(lls[u])[0]]
            for u in both["feats"]}
    stats = score_utterances(both["texts"], hyps)
    assert stats.wer == 0.0, stats.report()


def test_align_gives_the_training_models_path(both):
    """DeltasTrainer.align (which JAX's trainer lacks), after
    make_cd_decode_graph, aligns over the decode transition model: the
    same pdfs, frame for frame, as a realignment of the training graphs
    over the training model on the same GMM."""
    tri, feats, texts = both["tri"], both["feats"], both["texts"]
    tm_dec, tm = both["tm_dec"], both["tm"]
    assert tri.trans_model is tm_dec
    got = tri.align(both["am"], feats, texts)
    assert sorted(got) == sorted(feats)
    graphs = {u: pdeltas.expand_hmm_cd(tri.compiler.compile_clg(texts[u]),
                                       tm, tri.windows, tri.tree)
              for u in feats}
    want = tri._align_all(both["am"], graphs, feats, list(feats),
                          tm.alignment_to_pdfs(
                              np.arange(tm.num_transition_ids + 1)))
    for u in feats:
        assert len(got[u]) == len(feats[u])
        np.testing.assert_array_equal(tm_dec.alignment_to_pdfs(got[u]),
                                      tm.alignment_to_pdfs(want[u]),
                                      err_msg=u)


def test_align_refuses_new_triples(both):
    """A fresh trainer over the training model only: transcripts that
    reach context windows whose triples the model lacks raise."""
    tri = both["tri"]
    fresh = pdeltas.DeltasTrainer(both["lang"], tri.topo, tri.opts,
                                  device="cpu")
    with pytest.raises(RuntimeError, match="call train"):
        fresh.align(both["am"], both["feats"], both["texts"])


def test_make_cd_decode_graph_keeps_the_raw_compose_with_a_warning(
        both, monkeypatch, caplog):
    """Determinize's own error (a non-determinizable G) keeps the raw
    L o G and logs a warning that names it; the graph still decodes the
    same words.  Any other error passes through."""
    tri, lang = both["tri"], both["lang"]
    G = make_unigram_grammar({"YES": 0.5, "NO": 0.5}, lang.words)

    def blowup(fst, *a, **k):
        raise NonDeterminizableError("determinize: state blowup")
    monkeypatch.setattr(pdeltas, "determinize", blowup)
    logger = logging.getLogger("kaldi_aslp_tpu_torch")
    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level(logging.WARNING):
        hclg, tm = pdeltas.make_cd_decode_graph(lang, G, tri)
    assert any("not determinizable" in r.getMessage()
               and "state blowup" in r.getMessage() for r in caplog.records)
    raw, _ = pdeltas.make_cd_decode_graph(lang, G, tri, optimize=False)
    assert_same_graph(hclg, raw)

    def fault(fst, *a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(pdeltas, "determinize", fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        pdeltas.make_cd_decode_graph(lang, G, tri)


def test_compose_context_shared_interns_in_local_order(both):
    """The shared table takes a graph's windows in the order the graph
    first saw them, after the windows already there."""
    tri = both["tri"]
    table = pdeltas.ContextWindows()
    table.id((9, 9, 9))
    lg = tri.compiler.L.compose(pdeltas.make_linear_acceptor(
        tuple(both["lang"].words.id(w) for w in ["NO", "YES"])))
    clg, local = pdeltas.compose_context(lg)
    shared, same = pdeltas.compose_context_shared(lg, table)
    assert same is table
    assert table.all_windows() == [(9, 9, 9)] + local.all_windows()


# -- the ladder's tri and dnn stages -----------------------------------------

def test_ladder_mono_tri_dnn(tmp_path, monkeypatch, capsys):
    """``hard_ladder.main([dir, --small, --stages=mono,tri,dnn,
    --device=cpu])`` on the tiny injected corpus: three rows; the DNN
    trained on the triphone system's final alignments, as pdfs of its
    training transition model, and decoded over its CD graph."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import test_torch_ladder as t
    monkeypatch.setattr(hard_ladder, "build_corpus",
                        lambda *a, **kw: t.tiny_corpus())
    monkeypatch.setattr(hard_ladder, "_Scale", t.tiny_scale)
    root = str(tmp_path / "ladder")
    assert hard_ladder.main([root, "--small", "--stages=mono,tri,dnn",
                             "--device=cpu"]) == 0
    with open(os.path.join(root, "results.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["stage"] for r in rows] == ["mono", "tri", "dnn"]
    assert "WER_LADDER mono=" in capsys.readouterr().out
    art = hard_ladder.run.artifacts
    hyb, tri, tm1 = art["dnn_recipe"], art["tri"], art["tm1"]
    assert sorted(hyb.pdf_targets) == sorted(tri._final_alignments)
    for u, a in tri._final_alignments.items():
        np.testing.assert_array_equal(hyb.pdf_targets[u],
                                      tm1.alignment_to_pdfs(a))
    assert hyb.num_pdfs == tm1.num_pdfs == tri.tree.num_pdfs
    assert hyb.hclg is art["hclg1"]


_NO_JAX_TRI = r"""
import importlib.abc, sys


class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, BlockJax())
import os
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
import test_torch_ladder as t
from kaldi_aslp_tpu_torch.fst.context import compose_context
from kaldi_aslp_tpu_torch.gmm import deltas, global_gmm
from kaldi_aslp_tpu_torch.gmm.sat import SatOptions, SatTrainer
from kaldi_aslp_tpu_torch.recipes import hard_ladder
from kaldi_aslp_tpu_torch.tree import build_tree
from kaldi_aslp_tpu_torch.vad import train_gmm_vad
hard_ladder.build_corpus = lambda *a, **kw: t.tiny_corpus()
hard_ladder._Scale = t.tiny_scale
rc = hard_ladder.main([sys.argv[1], "--small", "--stages=mono,tri,dnn",
                       "--device=cpu"])
art = hard_ladder.run.artifacts
corpus = art["corpus"]
utt2spk = {u: u[:2] for u in corpus["train_feats"]}
_, transforms = SatTrainer(art["tri"], SatOptions(
    num_outer_iters=1, fmllr_min_count=20.0)).train(
    art["am1"], corpus["train_feats"], corpus["train_texts"], utt2spk)
frames = np.concatenate(list(corpus["train_feats"].values()))
gmm = global_gmm.init_from_feats(frames, 4, num_iters=4, device="cpu")
vad = train_gmm_vad(frames, (frames[:, 1] < 1.5).astype(int), num_gauss=2,
                    num_iters=3, device="cpu")
shared = sorted({m.split(".")[1] for m in sys.modules
                 if m.startswith("kaldi_aslp_tpu.")})
print("RESULT", rc, len(transforms) > 0, gmm.num_gauss,
      vad.detect(frames[:50]).dtype, "jax" in sys.modules, shared)
"""


def test_tri_path_runs_with_jax_blocked(tmp_path):
    """The ladder's ``--stages=mono,tri,dnn`` (gmm.deltas, tree,
    fst.context), SAT over its triphone system, a global GMM and the GMM
    VAD in a process with ``jax`` blocked: no module of the JAX package
    loads."""
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_TRI, str(tmp_path), REPO],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RESULT 0 True 4 bool False []" in proc.stdout, \
        proc.stdout[-2000:]
    assert "WER_LADDER mono=" in proc.stdout and "tri=" in proc.stdout


def test_kws_state_map_of_the_tri_system_equals_jax(both, tmp_path):
    """aslp-kws-gen-state-map on the port's pickled tri decode model and
    tree (chip_smoke.py phase 25's input) writes JAX's files for JAX's
    system."""
    import pickle

    from kaldi_aslp_tpu.kws import gen_state_map, write_state_map
    from kaldi_aslp_tpu_torch.cli.__main__ import main

    lang = both["lang"]
    (tmp_path / "phones.txt").write_text(lang.phones.to_text() + "\n")
    lexicon = [["YN", "Y", "N"], ["NYN", "N", "Y", "N"]]
    (tmp_path / "kw.lex").write_text(
        "".join(" ".join(row) + "\n" for row in lexicon))
    for name, obj in (("tri.mdl", both["tm_dec"]),
                      ("tri.tree", both["tri"].tree)):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(obj, f)
    sil = lang.phones.sym(lang.sil_phone_id)
    assert main(["aslp-kws-gen-state-map", f"--silence={sil}"] + [
        str(tmp_path / n) for n in ("phones.txt", "kw.lex", "tri.mdl",
                                    "tri.tree", "t.map", "t.txt")]) == 0
    syms = {s: lang.phones.id(s) for s in lang.lexicon.phone_set()}
    write_state_map(gen_state_map(syms, lexicon, both["jtm_dec"],
                                  both["jtri"].tree, silence=sil),
                    str(tmp_path / "j.map"), str(tmp_path / "j.txt"))
    for a, b in (("t.map", "j.map"), ("t.txt", "j.txt")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
    assert len((tmp_path / "t.map").read_text().splitlines()) == \
        both["tm_dec"].num_transition_ids
