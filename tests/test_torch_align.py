"""The port's forced alignment (kaldi_aslp_tpu_torch/decoder/viterbi.py:
align_batched, equal_align) against the JAX package's on the CPU: per
utterance training graphs of a five-word lexicon, ragged utterances in
one batch, numpy-seeded loglikes (continuous, and quantized to force
ties).  equal_align is host code and must be equal; align_batched must
give the same words and alignments and scores within 1e-4, however the
utterances are batched."""

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.decoder.viterbi import align_batched as jax_align
from kaldi_aslp_tpu.decoder.viterbi import equal_align as jax_equal
from kaldi_aslp_tpu.fst import Lang as JaxLang
from kaldi_aslp_tpu.fst import Lexicon as JaxLexicon
from kaldi_aslp_tpu.gmm.mono import MonophoneTrainer as JaxMono
from kaldi_aslp_tpu_torch.decoder import PackedGraph, ViterbiDecoder
from kaldi_aslp_tpu_torch.decoder.viterbi import align_batched, equal_align
from kaldi_aslp_tpu_torch.fst import Lang, Lexicon
from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer

torch.set_num_threads(1)

LEXICON = ("YES Y EH S\nNO N OW\nYO Y OW\nSEE S IY\nNOSE N OW Z\n")
TRANSCRIPTS = [["YES"], ["NO", "SEE"], ["NOSE", "YO", "YES"],
               ["SEE", "SEE"], ["YO", "NO", "NOSE", "YES"], ["NO"]]
SCORE_RTOL = 1e-4


def _trainers():
    mono = MonophoneTrainer(Lang.build(Lexicon.from_text(LEXICON)),
                            device="cpu")
    jmono = JaxMono(JaxLang.build(JaxLexicon.from_text(LEXICON)))
    ali = np.random.RandomState(2).randint(
        1, mono.trans_model.num_transition_ids + 1, 500)
    for tm in (mono.trans_model, jmono.trans_model):
        tm.mle_update(tm.accumulate(ali))
    return mono, jmono


def _case(mono, jmono, quantized):
    rs = np.random.RandomState(11)
    graphs, jgraphs, lls = {}, {}, {}
    for i, words in enumerate(TRANSCRIPTS):
        u = f"u{i}"
        graphs[u] = mono.compiler.compile(words)
        jgraphs[u] = jmono.compiler.compile(words)
        T = int(rs.randint(12 * len(words), 25 * len(words)))
        ll = -3.0 * rs.rand(T, mono.num_pdfs).astype(np.float32)
        lls[u] = np.round(ll * 2) / 2 if quantized else ll
    return graphs, jgraphs, lls


@pytest.mark.parametrize("num_frames", [5, 9, 40, 200])
@pytest.mark.parametrize("words", [["YES"], ["NOSE", "YO", "SEE"]])
def test_equal_align_matches_jax(num_frames, words):
    """The same alignment, or, where the frames cannot hold the
    transcript's states, the same refusal."""
    mono, jmono = _trainers()
    graph = mono.compiler.compile(words)
    jgraph = jmono.compiler.compile(words)
    try:
        want = jax_equal(jgraph, jmono.trans_model, num_frames)
    except RuntimeError as e:
        with pytest.raises(RuntimeError, match=str(e).split(" ")[0]):
            equal_align(graph, mono.trans_model, num_frames)
        assert num_frames < 40
        return
    got = equal_align(graph, mono.trans_model, num_frames)
    np.testing.assert_array_equal(got, want)
    assert len(got) == num_frames and (got > 0).all()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("batch", [64, 2])
@pytest.mark.parametrize("acoustic_scale", [1.0, 0.1])
def test_align_batched_matches_jax(quantized, batch, acoustic_scale):
    mono, jmono = _trainers()
    graphs, jgraphs, lls = _case(mono, jmono, quantized)
    lut = mono._tid_pdf_lut
    got = align_batched({u: PackedGraph.from_fst(g)
                         for u, g in graphs.items()}, lut, lls,
                        acoustic_scale=acoustic_scale, batch=batch,
                        device="cpu")
    want = jax_align(jgraphs, jmono._tid_pdf_lut, lls,
                     acoustic_scale=acoustic_scale)
    assert sorted(got) == sorted(want)
    for u in want:
        (w, a, s), (jw, ja, js) = got[u], want[u]
        assert w == jw, u
        np.testing.assert_array_equal(a, ja, err_msg=u)
        assert s == pytest.approx(js, rel=SCORE_RTOL)
        # alone, through the single-utterance decoder, the same path
        single = ViterbiDecoder(PackedGraph.from_fst(graphs[u]), lut,
                                acoustic_scale=acoustic_scale,
                                device="cpu").decode(lls[u])
        assert single[0] == w and single[2] == s
        np.testing.assert_array_equal(single[1], a)


def test_align_batched_fails_where_jax_fails():
    """An utterance too short for its transcript has no path: both
    packages raise (a RuntimeError; the port's DecodeError is one)."""
    mono, jmono = _trainers()
    words = ["NOSE", "YO"]
    lls = {"short": np.zeros((4, mono.num_pdfs), np.float32)}
    with pytest.raises(RuntimeError):
        jax_align({"short": jmono.compiler.compile(words)},
                  jmono._tid_pdf_lut, lls)
    with pytest.raises(RuntimeError, match="no complete path"):
        align_batched({"short": mono.compiler.compile(words)},
                      mono._tid_pdf_lut, lls, device="cpu")
