"""The port's CRF (kaldi_aslp_tpu_torch/ops/crf.py) and punctuation
processor (online/punctuation.py) on the CPU against the JAX package's:
the log-likelihood against JAX and by brute force
(tests/test_crf_punctuation.py:25), Viterbi against JAX, one SGD step's
loss and gradients against ``jax.value_and_grad`` (1e-5), training on
the JAX test's toy pattern, the pickle file both ways, and the decode
session's final punctuated."""

import itertools
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.ops.crf import (
    CrfParams as JaxCrfParams,
    crf_log_likelihood as jax_crf_ll,
    crf_viterbi as jax_crf_viterbi,
)
from kaldi_aslp_tpu.online.punctuation import (
    PunctuationProcessor as JaxPunctuation,
    token_features as jax_token_features,
)
from kaldi_aslp_tpu_torch.ops.crf import (
    CrfParams,
    crf_log_likelihood,
    crf_loss,
    crf_params_from_jax,
    crf_tag,
    crf_viterbi,
    init_crf,
)
from kaldi_aslp_tpu_torch.online.punctuation import (
    MARKS,
    TAGS,
    PunctuationProcessor,
    token_features,
)

from test_crf_punctuation import _toy_corpus

torch.set_num_threads(1)


def _jax_params(rs, F, Y, scale=1.0):
    return JaxCrfParams(*(jnp.asarray(scale * rs.randn(*shape).astype(
        np.float32)) for shape in ((F, Y), (Y, Y), (Y,), (Y,))))


def _case(seed, F=64, Y=5, T=11, K=5, pad=0):
    rs = np.random.RandomState(seed)
    params = _jax_params(rs, F, Y)
    feat_ids = rs.randint(-1, F, (T + pad, K)).astype(np.int32)
    tags = rs.randint(0, Y, T + pad).astype(np.int32)
    mask = np.r_[np.ones(T), np.zeros(pad)].astype(np.float32)
    return params, feat_ids, tags, mask


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("seed,pad", [(0, 0), (1, 21), (2, 5)])
def test_crf_log_likelihood_and_viterbi_match_jax(seed, pad):
    jp, feat_ids, tags, mask = _case(seed, pad=pad)
    p = crf_params_from_jax(jp, "cpu")
    got = crf_log_likelihood(p, *_t(feat_ids, tags, mask))
    want = jax_crf_ll(jp, jnp.asarray(feat_ids), jnp.asarray(tags),
                      jnp.asarray(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-4)
    T = int(mask.sum())
    got_tags = crf_viterbi(p, *_t(feat_ids, mask)).numpy()[:T]
    want_tags = np.asarray(jax_crf_viterbi(
        jp, jnp.asarray(feat_ids), jnp.asarray(mask)))[:T]
    np.testing.assert_array_equal(got_tags, want_tags)


def test_crf_log_likelihood_matches_brute_force():
    F, Y, T, K = 16, 3, 4, 2
    rs = np.random.RandomState(3)
    p = crf_params_from_jax(_jax_params(rs, F, Y), "cpu")
    feat_ids = rs.randint(0, F, (T, K))
    tags = rs.randint(0, Y, T)
    em = p.emission.numpy()[feat_ids].sum(axis=1)
    trans, start, end = (p.transition.numpy(), p.start.numpy(),
                         p.end.numpy())

    def score(seq):
        s = start[seq[0]] + em[0, seq[0]]
        for t in range(1, T):
            s += trans[seq[t - 1], seq[t]] + em[t, seq[t]]
        return s + end[seq[-1]]

    seqs = list(itertools.product(range(Y), repeat=T))
    logz = np.log(np.sum(np.exp([score(s) for s in seqs])))
    got = crf_log_likelihood(p, *_t(feat_ids, tags, np.ones(T, np.float32)))
    assert float(got) == pytest.approx(score(tags) - logz, abs=1e-4)
    best = max(seqs, key=score)
    assert list(crf_viterbi(p, *_t(feat_ids, np.ones(T))).numpy()) == list(
        best)


def test_one_sgd_step_matches_jax_value_and_grad():
    jp, feat_ids, tags, mask = _case(4, F=1 << 15, T=9, pad=23)
    l2 = 1e-4

    def loss_fn(q):
        ll = jax_crf_ll(q, jnp.asarray(feat_ids), jnp.asarray(tags),
                        jnp.asarray(mask))
        return -ll + l2 * (jnp.sum(q.emission ** 2)
                           + jnp.sum(q.transition ** 2))

    want, want_g = jax.value_and_grad(loss_fn)(jp)
    p = crf_params_from_jax(jp, "cpu")
    for q in p.fields():
        q.requires_grad_(True)
    loss = crf_loss(p, *_t(feat_ids, tags, mask), l2=l2)
    grads = torch.autograd.grad(loss, p.fields())
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    for g, name in zip(grads, ("emission", "transition", "start", "end")):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(getattr(want_g, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_token_features_are_jax_s():
    toks = "alpha beta 你好 huh stop".split()
    np.testing.assert_array_equal(token_features(toks),
                                  jax_token_features(toks))


def test_init_crf_shapes_and_generator():
    a = init_crf(32, 5, torch.Generator().manual_seed(1), "cpu")
    b = init_crf(32, 5, torch.Generator().manual_seed(1), "cpu")
    assert a.emission.shape == (32, 5) and a.transition.shape == (5, 5)
    assert all(torch.equal(x, y) for x, y in zip(a.fields(), b.fields()))
    assert float(a.emission.abs().max()) < 0.1


def test_punctuation_processor_learns_pattern():
    proc = PunctuationProcessor.train(_toy_corpus(), num_epochs=12,
                                      learn_rate=0.5, device="cpu")
    tags = proc.tag(["alpha", "beta", "huh", "stop"])
    assert tags[-1] == "J" and tags[2] == "W" and tags[0] == "N"
    out = proc.process("alpha beta huh stop")
    assert out.endswith("stop" + MARKS["J"])
    assert "huh" + MARKS["W"] in out
    assert proc.process("") == ""


def test_pickle_files_load_in_both_packages(tmp_path):
    rs = np.random.RandomState(5)
    jax_proc = JaxPunctuation(_jax_params(rs, 1 << 15, len(TAGS), 0.5))
    port_proc = PunctuationProcessor.train(_toy_corpus(20), num_epochs=2,
                                           device="cpu")
    toks = ["alpha", "beta", "huh", "stop", "gamma", "and", "delta"]
    for writer, reader, loader in (
            (jax_proc, "port", lambda p: PunctuationProcessor.load(
                p, device="cpu")),
            (port_proc, "jax", JaxPunctuation.load)):
        path = str(tmp_path / f"for_{reader}.crf")
        writer.save(path)
        with open(path, "rb") as f:
            d = pickle.load(f)
        assert sorted(d) == ["emission", "end", "start", "transition"]
        assert all(isinstance(v, np.ndarray) for v in d.values())
        assert loader(path).tag(toks) == writer.tag(toks)


def test_crf_tag_pads_to_buckets_as_jax_does():
    rs = np.random.RandomState(6)
    jp = _jax_params(rs, 1 << 15, len(TAGS))
    feats = token_features(["w%d" % i for i in range(45)])
    from kaldi_aslp_tpu.ops.crf import crf_tag as jax_crf_tag
    np.testing.assert_array_equal(
        crf_tag(crf_params_from_jax(jp, "cpu"), feats),
        jax_crf_tag(jp, feats))


def test_session_applies_punctuation():
    """The decode session's final runs the processor (reference:
    decode-thread.cc final-result chain), and keeps it in ``finals``."""
    from kaldi_aslp_tpu_torch.online.server import DecodeSession

    class FakeDecoder:
        num_frames_decoded = 5

        def finalize_decoding(self):
            return [1, 2], np.zeros(5, np.int32), 0.0

        def reset(self):
            pass

    class FakeFeatures:
        dim = 4

        def reset(self):
            pass

    class Syms:
        def sym(self, w):
            return {1: "alpha", 2: "stop"}[w]

    proc = PunctuationProcessor.train(_toy_corpus(20), num_epochs=6,
                                      device="cpu")
    sess = DecodeSession(FakeFeatures(), FakeDecoder(), None, Syms(),
                         punctuation=proc)
    out = sess.finalize()
    assert out == {"type": "final", "text": proc.process("alpha stop")}
    assert out["text"].endswith(MARKS["J"])
    assert sess.finals == [out["text"]]


def test_crf_params_carry_numpy_and_dicts():
    rs = np.random.RandomState(7)
    jp = _jax_params(rs, 8, 3)
    a = crf_params_from_jax(jp, "cpu")
    b = crf_params_from_jax({k: np.asarray(v) for k, v in
                             zip(("emission", "transition", "start", "end"),
                                 (jp.emission, jp.transition, jp.start,
                                  jp.end))}, "cpu")
    assert isinstance(a, CrfParams)
    assert all(torch.equal(x, y) for x, y in zip(a.fields(), b.fields()))
    assert a.numpy()["transition"].dtype == np.float32
