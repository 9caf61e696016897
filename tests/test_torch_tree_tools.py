"""The port's CD-phone tree tools (kaldi_aslp_tpu_torch/cli/tree_tools.py,
run through ``python -m kaldi_aslp_tpu_torch.cli``) against the JAX
package's kaldi_aslp_tpu/cli/tree_tools.py on the CPU.

Both packages' tools read the same feature and alignment arks; each
reads its own package's pickled transition models and trees (a JAX
pickle names ``kaldi_aslp_tpu`` classes, which the port does not load),
made from the same triphone system: the port's monophone alignments fed
to both packages' ``DeltasTrainer``, as tests/test_torch_tri.py does.
The tools' outputs are held equal: the tree statistics of all six
summarizers, the question sets, the bind info, the converted alignments
(byte-equal arks) and the CTC and H3 transducers (equal FST texts).  The
two CTC trainer aliases are the port's CTC trainer."""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.cli import tree_tools as jtools
from kaldi_aslp_tpu.fst import Lang as JaxLang, Lexicon as JaxLexicon
from kaldi_aslp_tpu.gmm import MonophoneTrainer as JaxMono
from kaldi_aslp_tpu.gmm import MonoTrainOptions as JaxMonoOptions
from kaldi_aslp_tpu.gmm import deltas as jdeltas
from kaldi_aslp_tpu.tree.cd_phone import (
    build_cd_phone_tree as jax_build_cd_phone_tree,
)
from kaldi_aslp_tpu_torch.cli import train_tools
from kaldi_aslp_tpu_torch.cli.__main__ import TOOLS
from kaldi_aslp_tpu_torch.cli.__main__ import main as cli_main
from kaldi_aslp_tpu_torch.fst import (
    Lang,
    Lexicon,
    make_lexicon_fst,
    make_unigram_grammar,
)
from kaldi_aslp_tpu_torch.gmm import deltas as pdeltas
from kaldi_aslp_tpu_torch.gmm import MonophoneTrainer, MonoTrainOptions
from kaldi_aslp_tpu_torch.io import int_vector_writer, matrix_writer
from kaldi_aslp_tpu_torch.tree.cd_phone import build_cd_phone_tree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_torch_tri import LEXICON, MONO, TRI, ctx_corpus  # noqa: E402

STATS_TOOLS = ["cd-phone-equal", "cd-phone-kmeans", "cd-phone-viterbi",
               "phone-mean", "phone-mean-per-frame", "phone-median"]
JAX_STATS_TOOLS = {
    "cd-phone-equal": jtools.acc_tree_stats_cd_phone_equal,
    "cd-phone-kmeans": jtools.acc_tree_stats_cd_phone_kmeans,
    "cd-phone-viterbi": jtools.acc_tree_stats_cd_phone_viterbi,
    "phone-mean": jtools.acc_tree_stats_phone_mean,
    "phone-mean-per-frame": jtools.acc_tree_stats_phone_mean_per_frame,
    "phone-median": jtools.acc_tree_stats_phone_median,
}


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return str(path)


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The toy corpus's arks and each package's pickled models: the
    monophone models, the triphone model and tree, and an L o G text."""
    d = tmp_path_factory.mktemp("tree_tools")
    feats, texts = ctx_corpus(np.random.RandomState(777))
    lang = Lang.build(Lexicon.from_text(LEXICON))
    mono = MonophoneTrainer(lang, opts=MonoTrainOptions(**MONO),
                            device="cpu")
    am0, tm0 = mono.train(feats, texts)
    alis = mono.align(am0, feats, texts)
    tri = pdeltas.DeltasTrainer(lang, mono.topo,
                                pdeltas.DeltasTrainOptions(**TRI),
                                device="cpu")
    _, tm = tri.train(feats, texts, tm0, alis)
    jlang = JaxLang.build(JaxLexicon.from_text(LEXICON))
    jmono = JaxMono(jlang, opts=JaxMonoOptions(**MONO))
    jmono.trans_model.log_probs[:] = tm0.log_probs
    jtri = jdeltas.DeltasTrainer(jlang, jmono.topo,
                                 jdeltas.DeltasTrainOptions(**TRI))
    _, jtm = jtri.train(feats, texts, jmono.trans_model, alis)
    with matrix_writer(f"ark:{d}/feats.ark") as w:
        for u in sorted(feats):
            w[u] = feats[u]
    for name, table in (("mono", alis), ("tri", tri._final_alignments)):
        with int_vector_writer(f"ark:{d}/{name}_ali.ark") as w:
            for u in sorted(table):
                w[u] = table[u]
    G = make_unigram_grammar({"YES": 0.5, "NO": 0.5}, lang.words)
    lg = make_lexicon_fst(lang).arc_sort("olabel").compose(G)
    with open(f"{d}/lg.txt", "w") as f:
        f.write(lg.to_text())
    with open(f"{d}/phone_map.txt", "w") as f:
        for p in range(1, len(lang.phones) + 1):
            f.write(f"{p} {p}\n")
    out = dict(dir=d, num_utts=len(feats))
    for tag, m0, m1, tree in (("p", tm0, tm, tri.tree),
                              ("j", jmono.trans_model, jtm, jtri.tree)):
        out[f"{tag}_mono"] = _dump(d / f"{tag}_mono.pkl", m0)
        out[f"{tag}_tri"] = _dump(d / f"{tag}_tri.pkl", m1)
        out[f"{tag}_tree"] = _dump(d / f"{tag}_tree.pkl", tree)
    return out


def _same_stats(got, want):
    assert sorted(got) == sorted(want) and len(got) > 0
    for key in want:
        g, w = got[key], want[key]
        assert g.count == w.count, key
        np.testing.assert_array_equal(g.sum, w.sum, err_msg=str(key))
        np.testing.assert_array_equal(g.sumsq, w.sumsq, err_msg=str(key))


def _stats(files, tool, tag):
    d = files["dir"]
    return f"{d}/{tag}_{tool}.pkl"


@pytest.fixture(scope="module")
def stats(files):
    """Each summarizer's statistics, from both packages' tools."""
    d = files["dir"]
    for tool in STATS_TOOLS:
        argv = [f"ark:{d}/feats.ark", f"ark:{d}/tri_ali.ark"]
        assert cli_main([f"aslp-acc-tree-stats-{tool}", files["p_tri"],
                         *argv, _stats(files, tool, "p")]) == 0
        assert JAX_STATS_TOOLS[tool]([files["j_tri"], *argv,
                                      _stats(files, tool, "j")]) == 0
    return {tool: (_load(_stats(files, tool, "p")),
                   _load(_stats(files, tool, "j"))) for tool in STATS_TOOLS}


@pytest.mark.parametrize("tool", STATS_TOOLS)
def test_acc_tree_stats_tools_match_jax(stats, tool):
    got, want = stats[tool]
    _same_stats(got, want)
    assert type(next(iter(got.values()))).__module__.startswith(
        "kaldi_aslp_tpu_torch.")


@pytest.mark.parametrize("tool", ["cd-phone-kmeans", "phone-mean"])
def test_compile_questions_and_bind_info_match_jax(files, stats, tool):
    d = files["dir"]
    out = {}
    for tag, run in (("p", lambda a: cli_main(
            ["aslp-compile-questions-phone", *a])),
                     ("j", jtools.compile_questions_phone_cli)):
        q = f"{d}/{tag}_{tool}_questions.txt"
        assert run([_stats(files, tool, tag), q]) == 0
        out[tag] = open(q).read()
    assert out["p"] == out["j"] and out["p"].count("\n") > 0
    questions = [[int(p) for p in line.split()]
                 for line in out["p"].splitlines()]
    got, want = stats[tool]
    phones = sorted({w[1] for (w, _) in want})
    trees = {"p": build_cd_phone_tree(got, phones, 4, questions, 0.0),
             "j": jax_build_cd_phone_tree(want, phones, 4, questions, 0.0)}
    bind = {}
    for tag, run in (("p", lambda a: cli_main(["aslp-tree-bind-info", *a])),
                     ("j", jtools.tree_bind_info_cli)):
        tree = _dump(f"{d}/{tag}_{tool}_cdtree.pkl", trees[tag])
        txt = f"{d}/{tag}_{tool}_bind.txt"
        assert run([tree, _stats(files, tool, tag), txt]) == 0
        bind[tag] = open(txt).read()
    assert bind["p"] == bind["j"]
    assert bind["p"].count("\n") == len(got)


def test_cluster_kmeans_self_test(capsys):
    assert cli_main(["aslp-cluster-kmeans-cd-phone-test"]) == 0
    assert "aslp-cluster-kmeans-cd-phone-test: OK" in capsys.readouterr().out


@pytest.mark.parametrize("new_tree", [True, False])
def test_convert_ali_matches_jax(files, new_tree):
    """Monophone alignments to the triphone system (through its tree),
    and the triphone alignments back to the monophone system ('-')."""
    d = files["dir"]
    arks = {}
    for tag, run in (("p", lambda a: cli_main(["aslp-convert-ali", *a])),
                     ("j", jtools.convert_ali_cli)):
        if new_tree:
            argv = [files[f"{tag}_mono"], files[f"{tag}_tri"],
                    files[f"{tag}_tree"], f"ark:{d}/mono_ali.ark"]
        else:
            argv = [files[f"{tag}_tri"], files[f"{tag}_mono"], "-",
                    f"ark:{d}/tri_ali.ark"]
        out = f"{d}/{tag}_conv_{new_tree}.ark"
        assert run([*argv, f"ark:{out}"]) == 0
        arks[tag] = open(out, "rb").read()
    assert arks["p"] == arks["j"] and len(arks["p"]) > 0


@pytest.mark.parametrize("tool", ["aslp-make-ctc-transducer",
                                  "aslp-make-h3-transducer"])
def test_transducers_match_jax(files, tool):
    d = files["dir"]
    texts = {}
    for tag in ("p", "j"):
        first = (f"{d}/phone_map.txt" if tool == "aslp-make-ctc-transducer"
                 else files[f"{tag}_mono"])
        out = f"{d}/{tag}_{tool}.txt"
        argv = [first, f"{d}/lg.txt", out]
        if tag == "p":
            assert cli_main([tool, *argv]) == 0
        else:
            fn = (jtools.make_ctc_transducer_cli
                  if tool == "aslp-make-ctc-transducer"
                  else jtools.make_h3_transducer_cli)
            assert fn(argv) == 0
        texts[tag] = open(out).read()
    assert texts["p"] == texts["j"] and texts["p"].count("\n") > 10


def test_stats_tool_counts_missing_alignments(files, tmp_path):
    """An utterance without an alignment is skipped; none aligned fails."""
    d = files["dir"]
    with int_vector_writer(f"ark:{tmp_path}/none.ark") as w:
        w["absent"] = np.ones(3, np.int32)
    assert cli_main(["aslp-acc-tree-stats-cd-phone-equal", files["p_tri"],
                     f"ark:{d}/feats.ark", f"ark:{tmp_path}/none.ark",
                     str(tmp_path / "s.pkl")]) == 1


def test_registry_has_the_tree_tools_and_ctc_aliases():
    for name in ("aslp-nnet-train-ctc", "aslp-nnet-train-warp-ctc-streams"):
        assert TOOLS[name] is train_tools.nnet_train_ctc_streams
    tree = [n for n in TOOLS if TOOLS[n].__module__.endswith("tree_tools")]
    assert len(tree) == 12
