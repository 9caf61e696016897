"""The port's hybrid HMM/NN path on the CPU, against the JAX package:

  * ``HybridRecipe`` (kaldi_aslp_tpu_torch/recipes/hybrid.py) at
    tests/test_hybrid_sweep.py's size, on the monophone bootstrap (the
    same pdf targets and priors as JAX's bootstrap with the recipe's
    options) and on an injected bootstrap (JAX's monophone system carried
    in through models/interop.py, its graph built by the port), through
    every decode route, WER <= 10 as JAX's test holds; the newbob resume
    rules; the LSTM and pretraining routes;
  * ``aslp-nnet-train-simple`` and its aliases on a written ark/scp,
    against the JAX CLI from the same model zip: the same report (loss
    within 1e-4 relative, the same frames and frame accuracy); for
    ``--objective-function=mse``, whose JAX CLI fails (int targets do not
    broadcast against the outputs), against JAX's FrameTrainer on the
    one-hot targets;
  * the port's ladder at ``--stages=mono`` on a tiny injected corpus,
    with pruning_sensitivity;
  * a process with ``jax`` blocked runs the recipe, the CLI and the
    ladder's mono stage without loading a module of the JAX package (it
    imports this file's helpers, so the JAX package is imported inside
    the tests that use it)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.cli.__main__ import main as cli_main
from kaldi_aslp_tpu_torch.fst import (
    Lang,
    Lexicon,
    make_decode_graph,
    make_unigram_grammar,
)
from kaldi_aslp_tpu_torch.gmm import MonophoneTrainer
from kaldi_aslp_tpu_torch.io import int_vector_writer, matrix_writer
from kaldi_aslp_tpu_torch.models.flagship import build_dnn_hybrid
from kaldi_aslp_tpu_torch.models.interop import gmm_from_jax, params_from_jax
from kaldi_aslp_tpu_torch.recipes import hard_ladder
from kaldi_aslp_tpu_torch.recipes.hybrid import (
    HybridRecipe,
    HybridRecipeOptions,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEXICON = "YES Y\nNO N\n"
LOSS_RTOL = 1e-4
# tests/test_hybrid_sweep.py's options
SWEEP_OPTS = dict(model_type="dnn", hidden_dim=32, num_layers=1,
                  splice_context=1, learn_rate=0.2, max_iters=8,
                  minibatch_size=64, mono_iters=6, mono_totgauss=40,
                  acoustic_scale=1.0, lmwt_sweep="1 2 4", lattice_beam=8.0)


def toy_corpus(rng, num_utts, words_per_utt=4):
    """tests/test_recipes.py:_corpus: three separable phone centres."""
    centers = {"Y": np.array([3.0, 0.0, 0.0]),
               "N": np.array([-3.0, 0.0, 0.0]),
               "SIL": np.array([0.0, 3.0, 0.0])}
    feats, texts = {}, {}
    for u in range(num_utts):
        words = [("YES" if rng.rand() < 0.5 else "NO")
                 for _ in range(words_per_utt)]
        seq = ["SIL"]
        for w in words:
            seq += ["Y" if w == "YES" else "N", "SIL"]
        fr = [centers[ph] + 0.4 * rng.randn(rng.randint(6, 12), 3)
              for ph in seq]
        feats[f"u{u}"] = np.concatenate(fr).astype(np.float32)
        texts[f"u{u}"] = words
    return feats, texts


def sweep_corpus():
    """tests/test_hybrid_sweep.py's draws: 14 training and 5 test
    utterances from RandomState(777)."""
    rng = np.random.RandomState(777)
    return toy_corpus(rng, 14) + toy_corpus(rng, 5)


def _lang():
    return Lang.build(Lexicon.from_text(LEXICON))


def _jax_bootstrap(tr_f, tr_t):
    """JAX's monophone bootstrap as its HybridRecipe runs it with
    SWEEP_OPTS (recipes/hybrid.py:113-130)."""
    from kaldi_aslp_tpu.fst import Lang as JaxLang
    from kaldi_aslp_tpu.fst import Lexicon as JaxLexicon
    from kaldi_aslp_tpu.gmm import MonophoneTrainer as JaxMono
    from kaldi_aslp_tpu.gmm import MonoTrainOptions as JaxMonoOptions
    n = SWEEP_OPTS["mono_iters"]
    mono = JaxMono(JaxLang.build(JaxLexicon.from_text(LEXICON)),
                   opts=JaxMonoOptions(
                       num_iters=n, totgauss=SWEEP_OPTS["mono_totgauss"],
                       realign_iters=" ".join(str(i) for i in range(1, n))))
    am, tm = mono.train(tr_f, tr_t)
    alis = mono.align(am, tr_f, tr_t)
    return am, tm, {u: tm.alignment_to_pdfs(a) for u, a in alis.items()}


def test_mono_bootstrap_targets_and_priors_match_jax(tmp_path):
    from kaldi_aslp_tpu.decoder.decodable import PdfPrior as JaxPdfPrior
    tr_f, tr_t, te_f, te_t = sweep_corpus()
    recipe = HybridRecipe(_lang(), HybridRecipeOptions(**SWEEP_OPTS),
                          device="cpu")
    stats = recipe.run(tr_f, tr_t, te_f, te_t, work_dir=str(tmp_path))
    assert stats.wer <= 10.0, stats.report()
    _, jtm, targets = _jax_bootstrap(tr_f, tr_t)
    assert recipe.num_pdfs == jtm.num_pdfs
    assert sorted(recipe.pdf_targets) == sorted(targets)
    for u in targets:
        np.testing.assert_array_equal(recipe.pdf_targets[u], targets[u])
    np.testing.assert_array_equal(
        recipe.prior.log_priors,
        JaxPdfPrior.from_alignments(targets, jtm.num_pdfs).log_priors)
    # newbob: the CV scored every epoch's new parameters, best moved only
    # on acceptance
    assert [e["decision"] for e in recipe.epochs][0] == "ACCEPT"
    assert len(recipe.epochs) <= SWEEP_OPTS["max_iters"]


def _injected():
    """JAX's monophone system carried into the port: the targets, and an
    HCLG built by the port from a transition model holding JAX's
    trained log-probabilities."""
    tr_f, tr_t, te_f, te_t = sweep_corpus()
    jam, jtm, targets = _jax_bootstrap(tr_f, tr_t)
    lang = _lang()
    tm = MonophoneTrainer(lang, device="cpu").trans_model
    gmm_from_jax(jam, jtm.log_probs, tm)
    G = make_unigram_grammar({"YES": 0.5, "NO": 0.5}, lang.words)
    hclg = make_decode_graph(lang, G, tm)
    lut = tm.alignment_to_pdfs(np.arange(tm.num_transition_ids + 1))
    np.testing.assert_array_equal(
        lut, jtm.alignment_to_pdfs(np.arange(jtm.num_transition_ids + 1)))
    return lang, (targets, jtm.num_pdfs, hclg, lut), (tr_f, tr_t, te_f, te_t)


ROUTES = {"dense": dict(lmwt_sweep=""),
          "beam": dict(lmwt_sweep="", decode_beam=16.0),
          "lattice": dict(),
          "beam_lattice": dict(decode_beam=16.0),
          "beam_lattice_dev": dict(decode_beam=16.0)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_injected_bootstrap_every_decode_route(tmp_path, route):
    from kaldi_aslp_tpu.decoder.decodable import PdfPrior as JaxPdfPrior
    lang, boot, (tr_f, tr_t, te_f, te_t) = _injected()
    recipe = HybridRecipe(lang, HybridRecipeOptions(
        **{**SWEEP_OPTS, **ROUTES[route]}), device="cpu")
    dev = dict(dev_feats=te_f, dev_texts=te_t) if route.endswith(
        "_dev") else {}
    stats = recipe.run(tr_f, tr_t, te_f, te_t, work_dir=str(tmp_path),
                       bootstrap=boot, **dev)
    assert stats.wer <= 10.0, stats.report()
    assert recipe.pdf_targets is boot[0] and recipe.hclg is boot[2]
    np.testing.assert_array_equal(
        recipe.prior.log_priors,
        JaxPdfPrior.from_alignments(boot[0], boot[1]).log_priors)
    assert np.isnan(recipe.last_dev_wer) != bool(dev)


@pytest.mark.parametrize("kind", ["lstm", "pretrain"])
def test_lstm_and_pretrain_routes(tmp_path, kind):
    lang, boot, (tr_f, tr_t, te_f, te_t) = _injected()
    extra = (dict(model_type="lstm", hidden_dim=16, max_iters=4)
             if kind == "lstm" else
             dict(num_layers=2, pretrain_iters=2, pretrain_learn_rate=0.2,
                  max_iters=4))
    recipe = HybridRecipe(lang, HybridRecipeOptions(**{**SWEEP_OPTS,
                                                       **extra}),
                          device="cpu")
    stats = recipe.run(tr_f, tr_t, te_f, te_t, work_dir=str(tmp_path),
                       bootstrap=boot)
    assert stats.wer <= 15.0, stats.report()
    tokens = [c.token for c in recipe.net.nodes]
    assert tokens == (["<Lstm>", "<AffineTransform>"] if kind == "lstm"
                      else ["<AffineTransform>", "<Sigmoid>"] * 2
                      + ["<AffineTransform>"])
    assert recipe.epochs[1]["train_loss"] < recipe.epochs[0]["train_loss"]


def test_resume_rules(tmp_path):
    """A newbob state without its model is dropped (a clean start); with
    nnet_best.knet the schedule resumes and the best model comes back."""
    lang, boot, (tr_f, tr_t, te_f, te_t) = _injected()
    work = tmp_path / "exp"
    work.mkdir()
    state = work / "newbob_state.json"
    state.write_text(json.dumps(
        {"iter": 7, "learn_rate": 1e-6, "halving": True,
         "best_cv_loss": -1.0, "done": False}))

    def run(max_iters):
        recipe = HybridRecipe(lang, HybridRecipeOptions(
            **{**SWEEP_OPTS, "max_iters": max_iters}), device="cpu")
        recipe.run(tr_f, tr_t, te_f, te_t, work_dir=str(work),
                   bootstrap=boot)
        return recipe

    first = run(2)
    assert [e["iter"] for e in first.epochs] == [1, 2]
    assert first.epochs[0]["learn_rate"] == SWEEP_OPTS["learn_rate"]
    assert (work / "nnet_best.knet").exists()
    # as if the run had been cut after its second epoch
    marker = json.loads(state.read_text())
    state.write_text(json.dumps({**marker, "done": False}))
    second = run(4)
    assert [e["iter"] for e in second.epochs] == [3, 4]
    # it trained on from the accepted model, not from a fresh draw
    assert second.epochs[0]["train_loss"] < first.epochs[0]["train_loss"]


def test_constructors_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for one without")
    for make in (lambda: HybridRecipe(_lang()),
                 lambda: MonophoneTrainer(_lang())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


# -- aslp-nnet-train-simple ---------------------------------------------------

def _write_frames(tmp_path, V=5, D=7, seed=3):
    """An ark/scp corpus of frame targets (a function of the features)
    in both packages' table format, and a JAX model zip."""
    rs = np.random.RandomState(seed)
    w = rs.randn(D, V)
    feats = str(tmp_path / "feats")
    targets = str(tmp_path / "ali.ark")
    with matrix_writer(f"ark,scp:{feats}.ark,{feats}.scp") as fw, \
            int_vector_writer(f"ark:{targets}") as tw:
        for u in range(9):
            x = rs.randn(int(rs.randint(40, 90)), D).astype(np.float32)
            fw[f"u{u}"] = x
            tw[f"u{u}"] = (x @ w).argmax(1).astype(np.int32)
    net = build_dnn_hybrid(input_dim=D, hidden_dim=16, num_layers=2,
                           num_pdfs=V)
    net.reset_parameters(torch.Generator().manual_seed(4))
    model = str(tmp_path / "model.zip")
    net.save(model)
    return f"scp:{feats}.scp", f"ark:{targets}", model


def _report(text):
    loss = float(text.split("AvgLoss: ")[1].split()[0])
    name = text.split("(")[1].split(")")[0]
    frames = int(text.split("[frames ")[1].split("]")[0])
    acc = (float(text.split("FRAME_ACCURACY >> ")[1].split("%")[0])
           if "FRAME_ACCURACY" in text else None)
    return loss, name, frames, acc


@pytest.mark.parametrize("tool", ["aslp-nnet-train-simple",
                                  "aslp-nnet-train-mse",
                                  "aslp-nnet-train-frame"])
def test_train_simple_cli_reports_as_jax(tmp_path, capsys, tool):
    from kaldi_aslp_tpu.cli.__main__ import main as jax_main
    from kaldi_aslp_tpu.models import Nnet as JaxNnet
    feats, targets, model = _write_frames(tmp_path)
    flags = ["--learn-rate=0.4", "--momentum=0.5", "--minibatch-size=32",
             "--randomizer-size=200"]
    reports = {}
    for who, main, extra in (("port", cli_main, ["--device=cpu"]),
                             ("jax", jax_main, [])):
        out = str(tmp_path / f"{who}.zip")
        assert main([tool] + extra + flags + [feats, targets, model,
                                              out]) == 0
        train = _report(capsys.readouterr().out)
        assert main([tool] + extra + ["--cross-validate=true", feats,
                                      targets, out]) == 0
        reports[who] = (train, _report(capsys.readouterr().out), out)
    for got, want in zip(reports["port"][:2], reports["jax"][:2]):
        assert got[0] == pytest.approx(want[0], rel=LOSS_RTOL)
        assert got[1:3] == want[1:3]
        assert got[3] == pytest.approx(want[3], abs=1e-3)
    assert reports["port"][1][1] == "xent-cv"
    # the port's model loads in JAX, near JAX's own
    _, p_port, _ = JaxNnet.load(reports["port"][2])
    _, p_jax, _ = JaxNnet.load(reports["jax"][2])
    _, p_init, _ = JaxNnet.load(model)
    for k, v in params_from_jax(p_jax).items():
        got = params_from_jax(p_port)[k].numpy()
        np.testing.assert_allclose(got, v.numpy(), rtol=0,
                                   atol=1e-4 * float(v.abs().max()))
        assert not np.array_equal(got, params_from_jax(p_init)[k].numpy())


def test_train_mse_cli_matches_jax_on_one_hot_targets(tmp_path, capsys):
    from kaldi_aslp_tpu.data.randomizer import (
        FrameRandomizer as JaxRandomizer,
        RandomizerOptions as JaxRandomizerOptions,
    )
    from kaldi_aslp_tpu.io import (
        random_access_int_vector_reader,
        sequential_matrix_reader,
    )
    from kaldi_aslp_tpu.models import Nnet as JaxNnet
    from kaldi_aslp_tpu.train import FrameTrainer as JaxFrameTrainer
    from kaldi_aslp_tpu.train import NnetTrainOptions as JaxTrainOptions
    from kaldi_aslp_tpu.train import init_velocity as jax_velocity
    feats, targets, model = _write_frames(tmp_path, seed=5)
    flags = ["--learn-rate=0.2", "--minibatch-size=32",
             "--randomizer-size=200", "--objective-function=mse"]
    out = str(tmp_path / "out.zip")
    assert cli_main(["aslp-nnet-train-mse", "--device=cpu"] + flags
                    + [feats, targets, model, out]) == 0
    got = _report(capsys.readouterr().out)
    jnet, params, _ = JaxNnet.load(model)
    tgt = random_access_int_vector_reader(targets)
    r = JaxRandomizer(JaxRandomizerOptions(randomizer_size=200,
                                           minibatch_size=32))
    batches = []
    for u, f in sequential_matrix_reader(feats):
        r.feed(f, np.eye(5, dtype=np.float32)[np.asarray(tgt[u])])
        if r.full():
            batches.extend(r.iterate_minibatches())
    batches.extend(r.flush())
    trainer = JaxFrameTrainer(jnet, JaxTrainOptions(learn_rate=0.2), "mse")
    _, _, rep = trainer.train_epoch(params, jax_velocity(params),
                                    iter(batches), 0.2)
    assert got[0] == pytest.approx(rep.avg_loss, rel=LOSS_RTOL)
    assert got[1:3] == ("mse", int(rep.frames)) and got[3] is None


def test_train_simple_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for one without")
    feats, targets, model = _write_frames(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["aslp-nnet-train-simple", feats, targets, model])


# -- the ladder's mono stage ---------------------------------------------------

ARPA = ("\\data\\\nngram 1=4\n\n\\1-grams:\n-0.6\t</s>\n-99\t<s>\t0.0\n"
        "-0.3\tYES\t0.0\n-0.3\tNO\t0.0\n\n\\end\\\n")


def tiny_corpus(seed=3):
    """Sixteen training, four test and four dev utterances of the toy
    task, with the ladder's corpus keys."""
    rng = np.random.RandomState(seed)
    corpus = {"lang": _lang(), "arpa": ARPA, "words": ["YES", "NO"],
              "train_audio_s": 0.0}
    for split, n in (("train", 16), ("test", 4), ("dev", 4)):
        corpus[f"{split}_feats"], corpus[f"{split}_texts"] = toy_corpus(
            rng, n, 3)
    return corpus


LADDER_SCALE = hard_ladder._Scale


def tiny_scale(name):
    """The ladder's preset with its mono stage cut to the toy task."""
    sc = LADDER_SCALE(name)
    sc.mono = dataclasses.replace(sc.mono, num_iters=4, totgauss=30,
                                  realign_iters="1 2 3")
    return sc


def test_ladder_mono_stage(tmp_path, monkeypatch):
    monkeypatch.setattr(hard_ladder, "_Scale", tiny_scale)
    root = str(tmp_path / "ladder")
    results = hard_ladder.run(root, scale="small", stages=["mono"],
                              corpus=tiny_corpus(), device="cpu")
    with open(os.path.join(root, "results.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["stage"] for r in rows] == ["mono"]
    assert rows[0]["test_wer"] == results["mono"] <= 20.0
    assert np.isfinite(rows[0]["dev_wer"])
    art = hard_ladder.run.artifacts
    assert art["device"] == "cpu" and sorted(art["dev_ll_mono"]) == sorted(
        art["corpus"]["dev_feats"])
    healthy, degraded = hard_ladder.pruning_sensitivity(art)
    assert healthy == results["mono"] or np.isfinite(healthy)
    assert degraded >= healthy


def test_ladder_scales_keep_the_jax_ladders_gmm_options():
    from kaldi_aslp_tpu.recipes import hard_ladder as jax_ladder
    for name in ("small", "medium", "full"):
        got, want = hard_ladder._Scale(name), jax_ladder._Scale(name)
        assert dataclasses.asdict(got.mono) == dataclasses.asdict(want.mono)
        assert dataclasses.asdict(got.tri) == dataclasses.asdict(want.tri)
        for key in ("gmm_max_active", "dnn_hidden", "dnn_layers",
                    "dnn_iters"):
            assert getattr(got, key) == getattr(want, key), (name, key)
    assert (hard_ladder.GMM_BEAM, hard_ladder.GMM_MAX_ACTIVE) == (
        jax_ladder.GMM_BEAM, jax_ladder.GMM_MAX_ACTIVE)


# -- no JAX --------------------------------------------------------------------

_NO_JAX_HYBRID = r"""
import importlib.abc, sys


class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, BlockJax())
import os
import torch
torch.set_num_threads(1)
sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
import test_torch_hybrid as t
from kaldi_aslp_tpu_torch.cli.__main__ import main
from kaldi_aslp_tpu_torch.recipes import hard_ladder
from kaldi_aslp_tpu_torch.recipes.hybrid import HybridRecipe, \
    HybridRecipeOptions
import pathlib
tmp = pathlib.Path(sys.argv[1])
tr_f, tr_t, te_f, te_t = t.sweep_corpus()
st = HybridRecipe(t._lang(), HybridRecipeOptions(**t.SWEEP_OPTS),
                  device="cpu").run(tr_f, tr_t, te_f, te_t,
                                    work_dir=str(tmp / "hyb"))
feats, targets, model = t._write_frames(tmp)
rc = main(["aslp-nnet-train-simple", "--device=cpu", feats, targets, model,
           str(tmp / "out.zip")])
hard_ladder.build_corpus = lambda *a, **kw: t.tiny_corpus()
hard_ladder._Scale = t.tiny_scale
rc2 = hard_ladder.main([str(tmp / "ladder"), "--small", "--stages=mono",
                        "--device=cpu"])
shared = sorted({m.split(".")[1] for m in sys.modules
                 if m.startswith("kaldi_aslp_tpu.")})
print("RESULT", st.wer <= 10.0, rc, rc2, "jax" in sys.modules, shared)
"""


def test_hybrid_path_runs_with_jax_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_HYBRID, str(tmp_path), REPO],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RESULT True 0 0 False []" in proc.stdout, proc.stdout[-2000:]
    assert "WER_LADDER mono=" in proc.stdout
