"""The CTC recipe's training loop and scoring pieces against the JAX
package: the newbob schedule and the saddle detector on scripted series
of CV losses and blank fractions (the same decisions, learning rates and
``newbob_state.json``, resumed alike), checkpoints read across the two
packages both ways, edit distance and ``ErrorStats`` on random pairs,
and ``parse_arpa`` / ``arpa_to_fst`` on a generated bigram ARPA.  Also the
port's device defaults: the constructors that take a device run on the
card unless the caller asks for the CPU, and raise without CUDA.

All of these are exact: the same Python, integer or float64 arithmetic
on both sides."""

import io
import json
import zipfile

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.fst import Lang as JaxLang, Lexicon as JaxLexicon
from kaldi_aslp_tpu.fst.lang import (
    arpa_to_fst as jax_arpa_to_fst,
    parse_arpa as jax_parse_arpa,
)
from kaldi_aslp_tpu.ops.edit_distance import (
    align_errors as jax_align_errors,
    edit_distance as jax_edit_distance,
    score_utterances as jax_score_utterances,
)
from kaldi_aslp_tpu.recipes.hard_corpus import (
    pruned_bigram_arpa as jax_pruned_bigram_arpa,
)
from kaldi_aslp_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint,
)
from kaldi_aslp_tpu.train.newbob import (
    NewbobOptions as JaxNewbobOptions,
    NewbobScheduler as JaxNewbobScheduler,
)
from kaldi_aslp_tpu.train.saddle import (
    SaddleDetector as JaxSaddleDetector,
    SaddleOptions as JaxSaddleOptions,
)
from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder
from kaldi_aslp_tpu_torch.decoder.online import OnlineViterbiDecoder
from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph, ViterbiDecoder
from kaldi_aslp_tpu_torch.feats.fbank import Fbank
from kaldi_aslp_tpu_torch.feats.mfcc import Mfcc
from kaldi_aslp_tpu_torch.fst import (
    Lang,
    Lexicon,
    arpa_to_fst,
    ctc_lut,
    make_ctc_decode_graph,
    make_unigram_grammar,
    parse_arpa,
)
from kaldi_aslp_tpu_torch.models import Nnet
from kaldi_aslp_tpu_torch.models.interop import params_from_jax
from kaldi_aslp_tpu_torch.online.feature_pipeline import (
    OnlineFeaturePipeline,
)
from kaldi_aslp_tpu_torch.ops.edit_distance import (
    ErrorStats,
    align_errors,
    edit_distance,
    score_utterances,
)
from kaldi_aslp_tpu_torch.recipes.hard_corpus import pruned_bigram_arpa
from kaldi_aslp_tpu_torch.train import (
    NewbobOptions,
    NewbobScheduler,
    SaddleDetector,
    SaddleOptions,
    load_checkpoint,
    save_checkpoint,
)

torch.set_num_threads(1)

# a CTC run's shape: a blank saddle with a plateau (holds, an lr
# escalation), a crossing, newbob's accepts, a reject, halving, the end
CV_LOSSES = [3.1, 2.4, 2.39, 2.389, 2.3885, 2.388, 2.3879, 2.3878, 1.9,
             1.5, 1.2, 1.25, 1.1, 1.095, 1.094, 1.0939, 1.0939, 1.0938]
BLANKS = [1.0, 0.99, 0.99, 0.98, 0.99, 0.99, 0.97, 0.99, 0.95, 0.7,
          0.5, 0.45, 0.4, 0.4, 0.39, 0.38, 0.38, 0.38]


def _schedule(sched_cls, opts_cls, det_cls, det_opts_cls, work_dir,
              resume_at=None, max_iters=14):
    """Drive one package's scheduler and detector through the script;
    at ``resume_at`` rebuild both from the work dir, as a resumed run
    does.  Returns one (decision, lr, state json) a step."""
    def make():
        return (sched_cls(work_dir, initial_lr=0.06,
                          opts=opts_cls(max_iters=max_iters)),
                det_cls(det_opts_cls(escalate_iters=3)))
    sched, det = make()
    out = []
    for i, (cv, blank) in enumerate(zip(CV_LOSSES, BLANKS)):
        if sched.done:
            break
        if i == resume_at:
            sched, _ = make()
        hold = det.update(blank, cv, sched)
        accepted = sched.report(cv, hold=hold)
        with open(f"{work_dir}/newbob_state.json") as f:
            state = json.load(f)
        out.append(("HOLD" if hold else "ACCEPT" if accepted else "REJECT",
                    sched.learn_rate, state))
    return out


@pytest.mark.parametrize("resume_at", [None, 6], ids=["straight", "resumed"])
def test_newbob_and_saddle_decide_as_jax(tmp_path, resume_at):
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    want = _schedule(JaxNewbobScheduler, JaxNewbobOptions,
                     JaxSaddleDetector, JaxSaddleOptions,
                     str(tmp_path / "j"), resume_at)
    got = _schedule(NewbobScheduler, NewbobOptions, SaddleDetector,
                    SaddleOptions, str(tmp_path / "p"), resume_at)
    assert got == want
    decisions = [d for d, _, _ in got]
    # the script reaches every branch
    assert {"HOLD", "ACCEPT", "REJECT"} <= set(decisions)
    assert max(lr for _, lr, _ in got) > 0.06 > min(lr for _, lr, _ in got)
    assert (tmp_path / "p" / "newbob_state.json").read_text() == (
        tmp_path / "j" / "newbob_state.json").read_text()


def test_newbob_resumes_from_the_other_packages_state(tmp_path):
    """A state file written by the JAX scheduler drives the port's, and
    the next decisions agree."""
    jsched = JaxNewbobScheduler(str(tmp_path), 0.1,
                                JaxNewbobOptions(max_iters=6))
    for cv in (2.0, 1.9, 1.899):
        jsched.report(cv)
    port = NewbobScheduler(str(tmp_path), 0.5, NewbobOptions(max_iters=6))
    assert port.learn_rate == jsched.learn_rate
    assert port.state.halving and port.state.iter == 3
    j2 = JaxNewbobScheduler(str(tmp_path), 0.5,
                            JaxNewbobOptions(max_iters=6))
    assert port.report(1.7) == j2.report(1.7)
    assert port.learn_rate == j2.learn_rate


def _jax_tree(seed):
    rs = np.random.RandomState(seed)
    return {"0": {"fwd": {"w_gifo_x": rs.randn(8, 3).astype(np.float32),
                          "bias": rs.randn(8).astype(np.float32)},
                  "bwd": {"w_gifo_x": rs.randn(8, 3).astype(np.float32),
                          "bias": rs.randn(8).astype(np.float32)}},
            "1": {"w": rs.randn(4, 4).astype(np.float32),
                  "b": rs.randn(4).astype(np.float32)}}


def _equal_trees(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]))


def test_checkpoint_written_by_the_port_loads_in_jax(tmp_path):
    params = params_from_jax(_jax_tree(1))
    velocity = params_from_jax(_jax_tree(2))
    states = {"log_priors": torch.arange(5, dtype=torch.float32),
              "bn": {"mean": torch.ones(3)}}
    path = str(tmp_path / "p.ckpt")
    save_checkpoint(path, params, velocity, states, {"wer": 12.5})
    p_j, v_j, s_j, meta = jax_load_checkpoint(path)
    assert meta == {"wer": 12.5}
    _equal_trees(p_j, _jax_tree(1))
    _equal_trees(v_j, _jax_tree(2))
    _equal_trees(s_j, {"log_priors": np.arange(5, dtype=np.float32),
                       "bn": {"mean": np.ones(3, np.float32)}})
    # and the keys are the JAX package's own
    jax_save_checkpoint(str(tmp_path / "j.ckpt"), _jax_tree(1),
                        _jax_tree(2), {k: np.asarray(v) if k != "bn" else
                                       {"mean": np.ones(3, np.float32)}
                                       for k, v in states.items()},
                        {"wer": 12.5})
    assert _npz_keys(tmp_path / "p.ckpt") == _npz_keys(tmp_path / "j.ckpt")
    assert "params['0']['fwd']['w_gifo_x']" in _npz_keys(tmp_path / "p.ckpt")


def _npz_keys(path):
    with zipfile.ZipFile(str(path)) as z:
        return sorted(np.load(io.BytesIO(z.read("arrays.npz"))).files)


def test_checkpoint_written_by_jax_loads_in_the_port(tmp_path):
    path = str(tmp_path / "j.ckpt")
    jax_save_checkpoint(path, _jax_tree(3), _jax_tree(4),
                        {"log_priors": np.linspace(-3, 0, 6,
                                                   dtype=np.float32)},
                        {"greedy_per": 40.0})
    params, velocity, states, meta = load_checkpoint(path)
    assert meta == {"greedy_per": 40.0}
    for got, tree in ((params, _jax_tree(3)), (velocity, _jax_tree(4))):
        want = params_from_jax(tree)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k])
    assert torch.equal(states["log_priors"], torch.from_numpy(
        np.linspace(-3, 0, 6, dtype=np.float32)))
    # without velocity or states
    save_checkpoint(path, params)
    assert load_checkpoint(path)[1:] == (None, None, {})


def test_checkpoint_params_load_into_an_nnet(tmp_path):
    from kaldi_aslp_tpu_torch.models import AffineTransform, BLstm
    net = Nnet()
    net.add(BLstm(3, 8))
    net.add(AffineTransform(8, 5))
    net.reset_parameters(torch.Generator().manual_seed(3))
    path = str(tmp_path / "n.ckpt")
    save_checkpoint(path, net.state_dict())
    other = Nnet()
    other.add(BLstm(3, 8))
    other.add(AffineTransform(8, 5))
    other.load_state_dict(load_checkpoint(path)[0], strict=True)
    for a, b in zip(net.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)


def test_edit_distance_and_error_stats_match_jax():
    rs = np.random.RandomState(0)
    refs, hyps = {}, {}
    for i in range(60):
        ref = list(rs.randint(0, 6, rs.randint(0, 9)))
        hyp = list(rs.randint(0, 6, rs.randint(0, 9)))
        assert edit_distance(ref, hyp) == jax_edit_distance(ref, hyp)
        assert align_errors(ref, hyp) == jax_align_errors(ref, hyp)
        refs[f"u{i}"] = [f"w{x}" for x in ref]
        hyps[f"u{i}"] = [f"w{x}" for x in hyp]
    del hyps["u3"]   # a missing hypothesis scores as empty
    got = score_utterances(refs, hyps)
    want = jax_score_utterances(refs, hyps)
    for field in ("insertions", "deletions", "substitutions", "ref_length",
                  "num_sentences", "num_wrong_sentences"):
        assert getattr(got, field) == getattr(want, field)
    assert got.wer == want.wer and got.ser == want.ser
    assert got.report() == want.report()
    assert ErrorStats().wer == 0.0


def _bigram_text():
    rs = np.random.RandomState(4)
    words = [f"W{i:03d}" for i in range(12)]
    sents = [[words[j] for j in rs.randint(0, 12, rs.randint(2, 7))]
             for _ in range(80)]
    return words, sents


def _arcs(fst):
    return [sorted((a.ilabel, a.olabel, round(a.weight, 12), a.nextstate)
                   for a in fst.arcs[s]) for s in range(fst.num_states)]


def test_arpa_to_fst_matches_jax():
    words, sents = _bigram_text()
    text = pruned_bigram_arpa(sents, words)
    assert text == jax_pruned_bigram_arpa(sents, words)
    assert parse_arpa(text) == jax_parse_arpa(text)
    lex = "\n".join(f"{w} p{i % 5}" for i, w in enumerate(words))
    lang = Lang.build(Lexicon.from_text(lex))
    jlang = JaxLang.build(JaxLexicon.from_text(lex))
    G, Gj = arpa_to_fst(text, lang.words), jax_arpa_to_fst(text,
                                                          jlang.words)
    assert G.num_states == Gj.num_states and G.start == Gj.start
    assert G.num_arcs == Gj.num_arcs
    assert {s: round(w, 12) for s, w in G.finals.items()} == {
        s: round(w, 12) for s, w in Gj.finals.items()}
    # the same arcs out of every state, in the same numbering: weights
    # are the same float64 arithmetic on the same text
    assert [[(a.ilabel, a.olabel, a.weight, a.nextstate)
             for a in G.arcs[s]] for s in range(G.num_states)] == [
        [(a.ilabel, a.olabel, a.weight, a.nextstate) for a in Gj.arcs[s]]
        for s in range(Gj.num_states)]
    assert len(lang.words) == len(jlang.words)


def test_arpa_to_fst_skips_unk_and_adds_unknown_words():
    text = ("\\data\\\nngram 1=5\nngram 2=1\n\n\\1-grams:\n-1.0\t</s>\n"
            "-99\t<s>\t-0.2\n-0.5\tA\t-0.1\n-0.7\tNEW\t-0.3\n"
            "-2.0\t<unk>\n\n\\2-grams:\n-0.1\tA NEW\n\n\\end\\\n")
    lang = Lang.build(Lexicon.from_text("A a\n"))
    jlang = JaxLang.build(JaxLexicon.from_text("A a\n"))
    G, Gj = arpa_to_fst(text, lang.words), jax_arpa_to_fst(text,
                                                          jlang.words)
    assert "NEW" in lang.words and "<unk>" not in lang.words
    assert _arcs(G) == _arcs(Gj)


def _tiny_graph():
    lang = Lang.build(Lexicon.from_text("A a\nB b\n"))
    G = make_unigram_grammar({"A": 0.5, "B": 0.5}, lang.words)
    return PackedGraph.from_fst(make_ctc_decode_graph(lang, G)), ctc_lut(4)


CONSTRUCTORS = {
    "BeamSearchDecoder": lambda: BeamSearchDecoder(*_tiny_graph()),
    "ViterbiDecoder": lambda: ViterbiDecoder(*_tiny_graph()),
    "OnlineViterbiDecoder": lambda: OnlineViterbiDecoder(*_tiny_graph()),
    "Fbank": lambda: Fbank(),
    "OnlineFeaturePipeline": lambda: OnlineFeaturePipeline(),
    "Mfcc": lambda: Mfcc(),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructors_default_to_the_card(name):
    """Built without ``device`` they take the card; without CUDA they
    raise (utils/device.py:resolve_device) rather than run on the
    CPU."""
    if torch.cuda.is_available():
        obj = CONSTRUCTORS[name]()
        dev = getattr(obj, "device", None) or obj._extractor.device
        assert dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CONSTRUCTORS[name]()


def test_nnet_state_defaults_to_the_parameters_device():
    from kaldi_aslp_tpu_torch.models import BLstm
    net = Nnet()
    net.add(BLstm(3, 8))
    net.to("meta")
    state = net.init_state(2)
    assert state["0"]["fwd"]["c"].device.type == "meta"
    assert Nnet().init_state(2) == {}
