"""The port's hard ladder (kaldi_aslp_tpu_torch/recipes/hard_ladder.py)
and its frontier-budget sweep (recipes/decode_budget_sweep.py) on the
CPU, on a tiny injected corpus (the toy corpus of
tests/test_torch_ctc_recipe.py with a dev set) and the ladder's CTC
options cut to a one-layer model and two iterations: the stage's row
carries a revision, a second run truncates the file, the tri and dnn
stages (with the GMM chain cut to the toy task) give their rows, an
unknown stage raises, the sweep reads the recipe's dev-selected scale, and a
process with ``jax`` blocked runs ``main`` through the sweep without
loading a module of the JAX package."""

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph
from kaldi_aslp_tpu_torch.fst import Lang, Lexicon, ctc_lut
from kaldi_aslp_tpu_torch.ops.edit_distance import score_utterances
from kaldi_aslp_tpu_torch.recipes import decode_budget_sweep, hard_ladder

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARPA = ("\\data\\\nngram 1=4\n\n\\1-grams:\n-0.6\t</s>\n-99\t<s>\t0.0\n"
        "-0.3\tYES\t0.0\n-0.3\tNO\t0.0\n\n\\end\\\n")
ROW_KEYS = {"stage", "scale", "test_wer", "dev_wer", "elapsed_s",
            "revision"}


def _split(rng, num_utts):
    """tests/test_torch_ctc_recipe.py:_corpus: three separable phone
    centres, three words an utterance."""
    centers = {"Y": [3.0, 0.0, 0.0], "N": [-3.0, 0.0, 0.0],
               "SIL": [0.0, 3.0, 0.0]}
    feats, texts = {}, {}
    for u in range(num_utts):
        words = [("YES" if rng.rand() < 0.5 else "NO") for _ in range(3)]
        seq = ["SIL"]
        for w in words:
            seq += ["Y" if w == "YES" else "N", "SIL"]
        feats[f"u{u:02d}"] = np.concatenate(
            [np.asarray(centers[p]) + 0.4 * rng.randn(rng.randint(6, 12), 3)
             for p in seq]).astype(np.float32)
        texts[f"u{u:02d}"] = words
    return feats, texts


def tiny_corpus(seed=3):
    rng = np.random.RandomState(seed)
    corpus = {"lang": Lang.build(Lexicon.from_text("YES Y\nNO N\n")),
              "arpa": ARPA, "words": ["YES", "NO"], "train_audio_s": 0.0}
    for split, n in (("train", 16), ("test", 4), ("dev", 4)):
        corpus[f"{split}_feats"], corpus[f"{split}_texts"] = _split(rng, n)
    return corpus


LADDER_OPTIONS = hard_ladder.ctc_options


def tiny_options(sc):
    """The ladder's CTC options at a tiny width and depth; the decode
    beam, the scales and the frame rate stay the ladder's."""
    return dataclasses.replace(LADDER_OPTIONS(sc), hidden_dim=8,
                               num_layers=1, max_iters=2, num_streams=4)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(hard_ladder, "ctc_options", tiny_options)
    return tiny_corpus()


def _rows(root):
    with open(os.path.join(root, "results.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_ctc_stage_rows_carry_a_revision_and_a_run_truncates(tmp_path,
                                                            tiny):
    root = str(tmp_path / "ladder")
    results = hard_ladder.run(root, scale="small", stages=["ctc"],
                              corpus=tiny, device="cpu")
    rows = _rows(root)
    assert len(rows) == 1 and set(rows[0]) == ROW_KEYS
    row = rows[0]
    assert (row["stage"], row["scale"]) == ("ctc", "small")
    assert row["test_wer"] == results["ctc"]
    assert row["revision"] == hard_ladder.source_revision() != ""
    ctc = hard_ladder.run.artifacts["ctc_recipe"]
    assert row["dev_wer"] == ctc.dev_wer == hard_ladder.run.dev_results[
        "ctc"]
    assert np.isfinite(row["dev_wer"])
    # the stage decoded with the beam decoder at the ladder's settings
    assert (ctc.opts.decode_beam, ctc.opts.decode_max_active,
            ctc.opts.lfr_skip, ctc.opts.acoustic_scale) == (32.0, 2048, 3,
                                                            0.9)
    assert len(ctc.epochs) == 2
    hard_ladder.run(root, scale="small", stages=["ctc"], corpus=tiny,
                    device="cpu")
    assert len(_rows(root)) == 1


def test_source_revision_without_git_is_a_digest_of_the_sources(
        tmp_path, monkeypatch):
    """A copy without .git (the package moved out of its checkout)
    still gets a revision, which follows the sources."""
    def no_git(*args, **kwargs):
        raise OSError("git not found")
    monkeypatch.setattr(hard_ladder.subprocess, "run", no_git)
    rev = hard_ladder.source_revision()
    assert rev.startswith("sources-") and len(rev) == len("sources-") + 16
    assert hard_ladder.source_revision() == rev


LADDER_SCALE = hard_ladder._Scale


def tiny_scale(name):
    """The ladder's preset with its GMM stages and its DNN cut to the toy
    task."""
    sc = LADDER_SCALE(name)
    sc.mono = dataclasses.replace(sc.mono, num_iters=4, totgauss=30,
                                  realign_iters="1 2 3")
    sc.tri = dataclasses.replace(sc.tri, num_iters=4, totgauss=40,
                                 num_leaves=12, realign_iters="2",
                                 tree_min_gain=5.0)
    sc.dnn_hidden, sc.dnn_layers, sc.dnn_iters = 16, 1, 2
    return sc


@pytest.mark.parametrize("stages,rows", [
    (["mono", "tri"], ["mono", "tri"]), (["tri"], ["tri"]),
    (["dnn"], ["dnn"]), (["ctc", "dnn"], ["dnn", "ctc"]),
    (None, ["mono", "tri", "dnn", "ctc"]), (["mono", "trii"], None)])
def test_gmm_stages_run_and_give_rows(tmp_path, tiny, monkeypatch, stages,
                                      rows):
    """The tri and dnn stages run (the default, every stage, too), each
    giving its row with a revision in the ladder's order; an unknown
    stage still raises before anything runs."""
    monkeypatch.setattr(hard_ladder, "_Scale", tiny_scale)
    root = str(tmp_path / "ladder")
    if rows is None:
        with pytest.raises(ValueError, match="unknown stage 'trii'"):
            hard_ladder.run(root, scale="small", stages=stages, corpus=tiny,
                            device="cpu")
        assert not os.path.exists(os.path.join(root, "results.jsonl"))
        return
    results = hard_ladder.run(root, scale="small", stages=stages,
                              corpus=tiny, device="cpu")
    got = _rows(root)
    assert [r["stage"] for r in got] == rows == list(results)
    for r in got:
        assert set(r) == ROW_KEYS and r["revision"] == \
            hard_ladder.source_revision()
        assert 0.0 <= r["test_wer"] == results[r["stage"]]
        assert np.isfinite(r["dev_wer"])
    art = hard_ladder.run.artifacts
    assert ("hclg0" in art) == ("mono" in rows)
    if "tri" in rows or "dnn" in rows:
        tri = art["tri"]
        assert tri.tree.num_pdfs == art["tm1"].num_pdfs > art["tm0"].num_pdfs
        assert tri.trans_model is art["tm1d"]
    if "dnn" in rows:
        assert art["dnn_recipe"].num_pdfs == art["tm1"].num_pdfs


def test_unknown_stage_and_scale_raise(tmp_path):
    with pytest.raises(ValueError, match="unknown stage"):
        hard_ladder.run(str(tmp_path), stages=["ctx"], device="cpu")
    with pytest.raises(ValueError, match="unknown scale"):
        hard_ladder._Scale("huge")


def test_scales_are_the_jax_ladders():
    """The corpus sizes and CTC widths of the three presets, as in
    kaldi_aslp_tpu/recipes/hard_ladder.py:_Scale."""
    from kaldi_aslp_tpu.recipes.hard_ladder import _Scale as JaxScale
    for name in ("small", "medium", "full"):
        got, want = hard_ladder._Scale(name), JaxScale(name)
        for key in ("num_train", "num_test", "num_dev", "lm_mult",
                    "ctc_hidden", "ctc_layers", "ctc_iters"):
            assert getattr(got, key) == getattr(want, key), (name, key)
        assert dataclasses.asdict(got.corpus) == dataclasses.asdict(
            want.corpus)


def test_nn_budget_sweep_reads_the_recipes_selected_scale(tmp_path, tiny,
                                                          monkeypatch):
    """The sweep decodes at ``ctc.acoustic_scale`` (the recipe's dev
    selection), not at ``ctc.opts.acoustic_scale``, and its WER at each
    K is that of a direct decode at that scale."""
    hard_ladder.run(str(tmp_path), scale="small", stages=["ctc"],
                    corpus=tiny, device="cpu")
    trained = hard_ladder.run.artifacts["ctc_recipe"]
    ctc = types.SimpleNamespace(
        tlg=trained.tlg, lang=trained.lang, posteriors=trained.posteriors,
        log_priors=trained.log_priors, device=trained.device,
        acoustic_scale=1.1,
        opts=dataclasses.replace(trained.opts, acoustic_scale=0.5))
    seen = []
    inner = BeamSearchDecoder.__init__

    def init(self, graph, lut, **kw):
        seen.append((kw["acoustic_scale"], kw["max_active"], kw["beam"]))
        inner(self, graph, lut, **kw)
    monkeypatch.setattr(BeamSearchDecoder, "__init__", init)
    got = decode_budget_sweep.nn_budget_sweep(
        ctc, tiny["dev_feats"], tiny["dev_texts"], budgets=[16, 4])
    assert seen == [(1.1, 16, 32.0), (1.1, 4, 32.0)]
    monkeypatch.setattr(BeamSearchDecoder, "__init__", inner)
    csr = CsrGraph.from_packed(PackedGraph.from_fst(trained.tlg))
    for K in (16, 4):
        dec = BeamSearchDecoder(csr, ctc_lut(len(ctc.lang.phones) + 1),
                                acoustic_scale=1.1, beam=32.0, max_active=K,
                                device="cpu")
        hyps = {u: [ctc.lang.words.sym(w) for w in dec.decode(
            ctc.posteriors(f) - ctc.log_priors)[0]]
            for u, f in tiny["dev_feats"].items()}
        assert got[K] == score_utterances(tiny["dev_texts"], hyps).wer


_NO_JAX_LADDER = r"""
import importlib.abc, sys


class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, BlockJax())
import json, os
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
import test_torch_ladder as t
from kaldi_aslp_tpu_torch.recipes import decode_budget_sweep, hard_ladder
hard_ladder.build_corpus = lambda *a, **kw: t.tiny_corpus()
hard_ladder.ctc_options = t.tiny_options
swept = []
inner = decode_budget_sweep.nn_budget_sweep
decode_budget_sweep.nn_budget_sweep = (
    lambda *a, **kw: swept.append(inner(*a, **kw)))
rc = hard_ladder.main([sys.argv[1], "--small", "--stages=ctc",
                       "--device=cpu"])
shared = sorted({m.split(".")[1] for m in sys.modules
                 if m.startswith("kaldi_aslp_tpu.")})
print("RESULT", rc, sorted(swept[0]), "jax" in sys.modules, shared)
"""


def test_main_runs_with_jax_blocked(tmp_path):
    """``python -m kaldi_aslp_tpu_torch.recipes.hard_ladder <dir> --small
    --stages=ctc`` (here ``main`` with the corpus and the widths cut)
    runs the stage and the budget sweep with ``jax`` blocked, and loads
    no module of the JAX package."""
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_LADDER, str(tmp_path), REPO],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RESULT 0 [256, 512, 1024, 2048] False []" in proc.stdout, \
        proc.stdout[-2000:]
    assert "NN_BUDGET_SWEEP_DEV" in proc.stdout
    assert len(_rows(str(tmp_path))) == 1
