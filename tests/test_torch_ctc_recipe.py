"""The port's phone-CTC recipe (kaldi_aslp_tpu_torch/recipes/ctc.py) on
the CPU: against the JAX recipe for 3 iterations from the same initial
parameters on the toy corpus of tests/test_recipes.py (the same
ACCEPT/HOLD/REJECT sequence, CV losses within 1e-3 relative, the same
test hypotheses); the port's copies of tests/test_recipes.py::
test_ctc_recipe and tests/test_saddle.py::
test_ctc_recipe_crosses_saddle_with_auto_policy with the JAX tests' own
thresholds; its ``final.ckpt`` loaded by JAX; the caller's options left
alone; the unported transports refused; a run with ``jax`` blocked; and the
CTC trainer CLI on the recipe's cells.

The CV-loss tolerance is 1e-3 relative: three epochs of momentum SGD
compound the float32 differences of two implementations of the same
math."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import kaldi_aslp_tpu.recipes.ctc as jax_ctc
from kaldi_aslp_tpu.fst import Lang as JaxLang, Lexicon as JaxLexicon
from kaldi_aslp_tpu.models import Nnet as JaxNnet
from kaldi_aslp_tpu.models.recurrent import BLstm as JaxBLstm
from kaldi_aslp_tpu.models.simple import AffineTransform as JaxAffine
from kaldi_aslp_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from kaldi_aslp_tpu.train.newbob import NewbobScheduler as JaxNewbob
from kaldi_aslp_tpu_torch.cli.__main__ import main as cli_main
from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder
from kaldi_aslp_tpu_torch.decoder.viterbi import DecodeError, ViterbiDecoder
from kaldi_aslp_tpu_torch.fst import Lang, Lexicon
from kaldi_aslp_tpu_torch.io import int_vector_writer, matrix_writer
from kaldi_aslp_tpu_torch.models.interop import params_from_jax
import kaldi_aslp_tpu_torch.recipes.ctc as port_ctc
from kaldi_aslp_tpu_torch.recipes import CtcRecipe, CtcRecipeOptions
from kaldi_aslp_tpu_torch.train import load_checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEXICON = "YES Y\nNO N\n"
CV_RTOL = 1e-3


def _corpus(rng, num_utts, words_per_utt=4):
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
            seq.append("Y" if w == "YES" else "N")
            seq.append("SIL")
        fr = [centers[ph] + 0.4 * rng.randn(rng.randint(6, 12), 3)
              for ph in seq]
        feats[f"u{u}"] = np.concatenate(fr).astype(np.float32)
        texts[f"u{u}"] = words
    return feats, texts


def _toy(seed=777):
    rng = np.random.RandomState(seed)
    tr = _corpus(rng, 20, words_per_utt=3)
    te = _corpus(rng, 6, words_per_utt=3)
    return tr, te


TOY_OPTS = dict(model_type="lstm", hidden_dim=32, num_layers=1,
                learn_rate=0.1, max_iters=25, num_streams=8)


def test_ctc_recipe(tmp_path):
    """tests/test_recipes.py::test_ctc_recipe on the port."""
    (tr_f, tr_t), (te_f, te_t) = _toy()
    recipe = CtcRecipe(Lang.build(Lexicon.from_text(LEXICON)),
                       CtcRecipeOptions(**TOY_OPTS), device="cpu")
    stats = recipe.run(tr_f, tr_t, te_f, te_t,
                       work_dir=str(tmp_path / "ctc"))
    assert stats.wer <= 15.0, stats.report()
    assert len(recipe.epochs) == 25
    # the final model loads in the JAX package's checkpoint reader
    params, velocity, states, meta = jax_load_checkpoint(
        str(tmp_path / "ctc" / "final.ckpt"))
    assert velocity is None and meta["wer"] == stats.wer
    assert sorted(params) == ["0", "1"]
    assert sorted(params["0"]) == ["bias", "w_gifo_r", "w_gifo_x"]
    np.testing.assert_array_equal(np.asarray(states["log_priors"]),
                                  recipe.log_priors)
    for name, p in params_from_jax(params).items():
        np.testing.assert_array_equal(
            p.numpy(), recipe.best_params[name].numpy())
    # and in the port's
    got, _, states_p, meta_p = load_checkpoint(
        str(tmp_path / "ctc" / "final.ckpt"))
    assert sorted(got) == sorted(recipe.best_params) and meta_p == meta
    assert torch.equal(states_p["log_priors"],
                       torch.from_numpy(recipe.log_priors))


def test_ctc_recipe_crosses_saddle_with_auto_policy(tmp_path):
    """tests/test_saddle.py::test_ctc_recipe_crosses_saddle_with_auto_policy
    on the port: the model leaves the all-blank regime and reaches a sane
    greedy PER with the detector in place of hand-tuned keep_lr_iters."""
    rng = np.random.RandomState(0)
    lang = Lang.build(Lexicon.from_text("<SIL> SIL\na p1\nb p2\nc p3\n"))

    def utt(words):
        segs = []
        for w in words:
            pid = {"a": 0, "b": 1, "c": 2}[w]
            f = np.zeros((4, 4), np.float32)
            f[:, pid] = 2.0
            segs.append(f + 0.1 * rng.randn(4, 4).astype(np.float32))
        return np.concatenate(segs, 0)

    texts, feats = {}, {}
    for i in range(24):
        ws = [["a", "b", "c"][rng.randint(3)] for _ in range(4)]
        texts[f"u{i:02d}"] = ws
        feats[f"u{i:02d}"] = utt(ws)
    ctc = CtcRecipe(lang, CtcRecipeOptions(
        model_type="lstm", hidden_dim=16, num_layers=1,
        learn_rate=0.1, auto_saddle=True, max_iters=60,
        num_streams=4, bucket_time=32, bucket_labels=8), device="cpu")
    ctc.run(feats, texts, feats, texts, work_dir=str(tmp_path))
    assert ctc.greedy_per < 50.0, ctc.greedy_per


def _recording(monkeypatch, module):
    """Record the (refs, hyps) of every score_utterances call of a
    recipe module."""
    calls = []
    inner = module.score_utterances

    def record(refs, hyps):
        calls.append((refs, hyps))
        return inner(refs, hyps)
    monkeypatch.setattr(module, "score_utterances", record)
    return calls


@pytest.mark.parametrize("decode_beam", [0.0, 32.0])
@pytest.mark.parametrize("model_type,hidden", [("lstm", 32), ("blstm", 8)])
def test_recipe_matches_jax_for_three_iterations(tmp_path, monkeypatch,
                                                 model_type, hidden,
                                                 decode_beam):
    """The same decisions, CV losses and test hypotheses as the JAX
    recipe, both starting from the JAX recipe's initial parameters; at
    ``decode_beam=32`` both decode with their beam decoders."""
    (tr_f, tr_t), (te_f, te_t) = _toy(seed=5)
    opts = dict(TOY_OPTS, model_type=model_type, hidden_dim=hidden,
                max_iters=3, decode_beam=decode_beam)

    jax_reports = []
    inner = JaxNewbob.report

    def report(self, cv_loss, hold=False):
        accepted = inner(self, cv_loss, hold=hold)
        jax_reports.append((float(cv_loss), "HOLD" if hold else (
            "ACCEPT" if accepted else "REJECT")))
        return accepted
    monkeypatch.setattr(JaxNewbob, "report", report)
    jax_scored = _recording(monkeypatch, jax_ctc)
    jrec = jax_ctc.CtcRecipe(JaxLang.build(JaxLexicon.from_text(LEXICON)),
                             jax_ctc.CtcRecipeOptions(**opts))
    jstats = jrec.run(tr_f, tr_t, te_f, te_t, work_dir=str(tmp_path / "j"))
    init = jrec._build_net(3, jrec.num_outputs + 1).init(
        jax.random.PRNGKey(777))

    port_scored = _recording(monkeypatch, port_ctc)
    decoder = BeamSearchDecoder if decode_beam else ViterbiDecoder
    decoded = []
    inner_decode = decoder.decode

    def decode(self, loglikes):
        decoded.append(len(loglikes))
        return inner_decode(self, loglikes)
    monkeypatch.setattr(decoder, "decode", decode)
    rec = CtcRecipe(Lang.build(Lexicon.from_text(LEXICON)),
                    CtcRecipeOptions(**opts), device="cpu")
    rec._init_params = lambda net: net.load_state_dict(
        params_from_jax(init))
    stats = rec.run(tr_f, tr_t, te_f, te_t, work_dir=str(tmp_path / "p"))

    assert [e["decision"] for e in rec.epochs] == [d for _, d in
                                                   jax_reports]
    for e, (cv_j, _) in zip(rec.epochs, jax_reports):
        assert abs(e["cv_loss"] - cv_j) <= CV_RTOL * abs(cv_j)
    # greedy phones, then words: the same hypotheses, the same scores
    assert len(port_scored) == len(jax_scored) == 2
    for (refs, hyps), (refs_j, hyps_j) in zip(port_scored, jax_scored):
        assert refs == refs_j and hyps == hyps_j
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert rec.greedy_per == jrec.greedy_per
    assert len(decoded) == len(te_f)
    np.testing.assert_allclose(rec.log_priors, jrec.log_priors, rtol=1e-3,
                               atol=1e-4)


def test_recipe_keeps_the_dev_selection_and_leaves_the_options(tmp_path):
    """With a dev set the selected scales land on the recipe; the
    caller's options object is left as it was (the JAX recipe writes the
    selection into it, recipes/ctc.py:297-298)."""
    (tr_f, tr_t), (te_f, te_t) = _toy(seed=6)
    rng = np.random.RandomState(9)
    dv_f, dv_t = _corpus(rng, 4, words_per_utt=3)
    opts = CtcRecipeOptions(**dict(TOY_OPTS, max_iters=2,
                                   acoustic_scale=0.6, prior_scale=0.3))
    before = dataclasses.asdict(opts)
    rec = CtcRecipe(Lang.build(Lexicon.from_text(LEXICON)), opts,
                    device="cpu")
    rec.run(tr_f, tr_t, te_f, te_t, work_dir=str(tmp_path),
            dev_feats=dv_f, dev_texts=dv_t)
    assert dataclasses.asdict(opts) == before
    assert rec.acoustic_scale in (0.7, 0.9, 1.1)
    assert rec.prior_scale in (0.5, 1.0)
    assert np.isfinite(rec.dev_wer)


def test_unported_options_raise():
    lang = Lang.build(Lexicon.from_text(LEXICON))
    with pytest.raises(ValueError, match="transport"):
        CtcRecipe(lang, CtcRecipeOptions(transport="bf16"), device="cpu")


def test_only_a_decode_without_a_path_scores_as_deletions(tmp_path,
                                                          monkeypatch):
    """A test utterance the graph holds no path for is scored as an empty
    hypothesis; any other fault of the decoder (on the card a launch
    failure or an out-of-memory, both RuntimeErrors) leaves the run."""
    (tr_f, tr_t), (te_f, te_t) = _toy(seed=8)
    lang = Lang.build(Lexicon.from_text(LEXICON))
    opts = CtcRecipeOptions(**dict(TOY_OPTS, max_iters=1))

    def no_path(self, loglikes):
        raise DecodeError("no complete path found (empty decode)")
    monkeypatch.setattr(ViterbiDecoder, "decode", no_path)
    stats = CtcRecipe(lang, opts, device="cpu").run(
        tr_f, tr_t, te_f, te_t, work_dir=str(tmp_path / "a"))
    assert stats.deletions == stats.ref_length > 0 and stats.wer == 100.0

    def card_fault(self, loglikes):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(ViterbiDecoder, "decode", card_fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        CtcRecipe(lang, opts, device="cpu").run(
            tr_f, tr_t, te_f, te_t, work_dir=str(tmp_path / "b"))


def test_stale_newbob_state_is_removed(tmp_path):
    """A newbob state left by a dead run is never resumed: the recipe
    checkpoints no per-iteration model to resume it with."""
    (tr_f, tr_t), (te_f, te_t) = _toy(seed=7)
    (tmp_path / "newbob_state.json").write_text(
        '{"iter": 40, "learn_rate": 1e-06, "halving": true, '
        '"best_cv_loss": 0.0, "done": false}')
    rec = CtcRecipe(Lang.build(Lexicon.from_text(LEXICON)),
                    CtcRecipeOptions(**dict(TOY_OPTS, max_iters=1)),
                    device="cpu")
    rec.run(tr_f, tr_t, te_f, te_t, work_dir=str(tmp_path))
    assert [e["iter"] for e in rec.epochs] == [1]
    assert rec.epochs[0]["learn_rate"] == 0.1


_NO_JAX_RECIPE = r"""
import importlib.abc, sys


class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, BlockJax())
import numpy as np
import torch
torch.set_num_threads(1)
import kaldi_aslp_tpu_torch.recipes
from kaldi_aslp_tpu_torch.fst import Lang, Lexicon, arpa_to_fst
from kaldi_aslp_tpu_torch.recipes import CtcRecipe, CtcRecipeOptions
rng = np.random.RandomState(1)
feats, texts = {}, {}
for u in range(10):
    words = [("YES" if rng.rand() < 0.5 else "NO") for _ in range(2)]
    feats[f"u{u}"] = rng.randn(20, 3).astype(np.float32)
    texts[f"u{u}"] = words
lang = Lang.build(Lexicon.from_text("YES Y\nNO N\n"))
G = arpa_to_fst("\\data\\\nngram 1=4\n\n\\1-grams:\n-0.6\t</s>\n"
                "-99\t<s>\t0.0\n-0.3\tYES\t0.0\n-0.3\tNO\t0.0\n\n\\end\\\n",
                lang.words)
rec = CtcRecipe(lang, CtcRecipeOptions(model_type="blstm", hidden_dim=4,
                num_layers=1, max_iters=2, num_streams=4), device="cpu")
stats = rec.run(feats, texts, feats, texts, grammar=G, work_dir=sys.argv[1])
shared = sorted({m.split(".")[1] for m in sys.modules
                 if m.startswith("kaldi_aslp_tpu.")})
print("RESULT", len(rec.epochs), "jax" in sys.modules, shared)
"""


def test_recipe_runs_with_jax_blocked(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RECIPE, str(tmp_path)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RESULT 2 False []" in proc.stdout, proc.stdout[-2000:]
    assert (tmp_path / "final.ckpt").exists()


def test_ctc_trainer_cli_trains_the_recipes_cells(tmp_path, capsys):
    """aslp-nnet-train-ctc-streams --device=cpu on a <BLstm> + affine
    zip, and JAX's Nnet.load reads what it writes."""
    D, V = 5, 6
    net = JaxNnet()
    net.add(JaxBLstm(D, 8))
    net.add(JaxAffine(8, V, param_stddev=0.04, bias_mean=0.0,
                      bias_range=0.0))
    params = net.init(jax.random.PRNGKey(4))
    net.save(str(tmp_path / "m.zip"), params)
    rs = np.random.RandomState(2)
    with matrix_writer(f"ark,scp:{tmp_path}/f.ark,{tmp_path}/f.scp") as fw, \
            int_vector_writer(f"ark:{tmp_path}/l.ark") as lw:
        for i in range(5):
            fw[f"u{i}"] = rs.randn(rs.randint(9, 14), D).astype(np.float32)
            lw[f"u{i}"] = rs.randint(1, V, 3).astype(np.int32)
    out = str(tmp_path / "out.zip")
    assert cli_main(["aslp-nnet-train-ctc-streams", "--device=cpu",
                     "--learn-rate=0.05", "--momentum=0.9",
                     "--num-streams=2", "--bucket-time=4",
                     f"scp:{tmp_path}/f.scp", f"ark:{tmp_path}/l.ark",
                     str(tmp_path / "m.zip"), out]) == 0
    assert "(ctc)" in capsys.readouterr().out
    net2, params2, _ = JaxNnet.load(out)
    assert [n.comp.token for n in net2.nodes] == ["<BLstm>",
                                                  "<AffineTransform>"]
    moved = max(float(np.abs(np.asarray(params2["0"][d][k])
                             - np.asarray(params["0"][d][k])).max())
                for d in ("fwd", "bwd") for k in params["0"][d])
    assert np.isfinite(moved) and moved > 0
