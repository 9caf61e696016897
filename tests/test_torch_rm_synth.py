"""The port's RM-shaped recipe (kaldi_aslp_tpu_torch/recipes/rm_synth.py)
against the JAX package's kaldi_aslp_tpu/recipes/rm_synth.py on the CPU:
the lexicon, the sentences, the ARPA text and the synthesized waves
equal (the numpy synthesis is copied as it is); MFCC + deltas + global
CMVN within rtol = atol = 1e-4 (tests/test_torch_feats.py's
tolerance); the whole chain (mono, tri1, dnn) at a tiny size gives its
WER table."""

import numpy as np
import pytest
import torch

import kaldi_aslp_tpu.recipes.rm_synth as jrm
from kaldi_aslp_tpu.fst import Lexicon as JaxLexicon
from kaldi_aslp_tpu_torch.fst import Lexicon
from kaldi_aslp_tpu_torch.recipes import rm_synth

torch.set_num_threads(1)

FEAT_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_feats.py's


@pytest.mark.parametrize("num_words,seed", [(20, 7), (60, 7), (12, 3)])
def test_rm_lexicon_sentences_and_arpa_equal_jax(num_words, seed):
    text = rm_synth.make_lexicon(num_words, seed=seed)
    assert text == jrm.make_lexicon(num_words, seed=seed)
    words = sorted(w for w in Lexicon.from_text(text).prons if w != "<SIL>")
    for kw in (dict(seed=11), dict(seed=99, max_len=5, grammar_seed=2)):
        sents = rm_synth.make_sentences(words, 9, **kw)
        assert sents == jrm.make_sentences(words, 9, **kw)
    assert rm_synth.bigram_arpa(sents, words) == jrm.bigram_arpa(sents,
                                                                 words)
    assert rm_synth.PHONES == jrm.PHONES
    assert rm_synth.SAMP_FREQ == jrm.SAMP_FREQ
    for i in range(len(rm_synth.PHONES)):
        assert rm_synth._phone_formants(i) == jrm._phone_formants(i)


def test_rm_waves_and_features_match_jax():
    text = rm_synth.make_lexicon(12)
    lex, jlex = Lexicon.from_text(text), JaxLexicon.from_text(text)
    words = sorted(w for w in lex.prons if w != "<SIL>")
    sents = rm_synth.make_sentences(words, 5, seed=11)
    waves = rm_synth.synthesize(lex, sents, seed=3)
    jwaves = jrm.synthesize(jlex, sents, seed=3)
    assert sorted(waves) == sorted(jwaves)
    for u in waves:
        assert waves[u].dtype == np.float32
        np.testing.assert_array_equal(waves[u], jwaves[u])
    got = rm_synth.extract_mfcc_deltas(waves, device="cpu")
    want = jrm.extract_mfcc_deltas(jwaves)
    for u in want:
        assert got[u].shape == want[u].shape and got[u].shape[1] == 39
        np.testing.assert_allclose(got[u], want[u], err_msg=u, **FEAT_TOL)


def test_rm_synth_runs_its_three_stages(tmp_path, capsys):
    out = rm_synth.run(str(tmp_path), num_words=8, num_train=12, num_test=4,
                       device="cpu")
    assert sorted(out) == ["dnn", "mono", "tri1"]
    assert all(np.isfinite(w) and w >= 0.0 for w in out.values())
    assert out["mono"] < 60.0, out      # chance is near 100 % on 8 words
    assert "WER_TABLE mono=" in capsys.readouterr().out
    art = rm_synth.run.artifacts
    assert art["tri"].tree.num_pdfs > art["tm0"].num_pdfs
