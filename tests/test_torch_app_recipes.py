"""The KWS and VAD recipes of the port (kaldi_aslp_tpu_torch/recipes/kws.py,
vad.py) against the JAX package's (kaldi_aslp_tpu/recipes/) at the JAX
tests' sizes (KWS 16 training and 12 test utterances, VAD 10 and 4), on
the CPU.  JAX's ``PRNGKey(0)`` initial weights cross through the
recipes' ``init_params`` (models/interop.py); each JAX recipe runs once
a module.  Held: the waveforms and labels equal (the same
``RandomState`` draws), the results dict within 1e-4, the files the
recipes write (``keyword.fst.txt``, ``roc.txt``, ``segment.info``,
``u0.TextGrid``) byte for byte."""

import numpy as np
import pytest
import torch

import jax

import kaldi_aslp_tpu.models as J
from kaldi_aslp_tpu.recipes import kws as jkws
from kaldi_aslp_tpu.recipes import vad as jvad
from kaldi_aslp_tpu_torch.models.interop import params_from_jax
from kaldi_aslp_tpu_torch.recipes import kws, vad

torch.set_num_threads(1)

RESULT_TOL = 1e-4
FBANK_DIM = 23


def jax_init(hidden, out):
    """The JAX recipes' initial DNN parameters (``PRNGKey(0)``) as a
    state dict in the port's format."""
    net = J.Nnet()
    net.add(J.AffineTransform(FBANK_DIM, hidden))
    net.add(J.Sigmoid(hidden, hidden))
    net.add(J.AffineTransform(hidden, out))
    net.add(J.Softmax(out, out))
    return params_from_jax(net.init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def vad_runs(tmp_path_factory):
    jroot = tmp_path_factory.mktemp("jax_vad")
    troot = tmp_path_factory.mktemp("torch_vad")
    want = jvad.run(str(jroot), num_train=10, num_test=4)
    got = vad.run(str(troot), num_train=10, num_test=4,
                  init_params=jax_init(vad.HIDDEN, 2), device="cpu")
    return got, want, troot, jroot


@pytest.fixture(scope="module")
def kws_runs(tmp_path_factory):
    jroot = tmp_path_factory.mktemp("jax_kws")
    troot = tmp_path_factory.mktemp("torch_kws")
    want = jkws.run(str(jroot), num_train=16, num_test=12)
    got = kws.run(str(troot), num_train=16, num_test=12,
                  init_params=jax_init(kws.HIDDEN, len(kws.PHONES)),
                  device="cpu")
    return got, want, troot, jroot


def assert_results_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= RESULT_TOL, (k, got[k], want[k])


@pytest.mark.parametrize("seed", [777, 778, 3])
def test_vad_waveforms_equal_jax(seed):
    got_w, got_l = vad.synthesize(3, seed=seed)
    want_w, want_l = jvad.synthesize(3, seed=seed)
    for a, b in zip(got_w + got_l, want_w + want_l):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [777, 778, 3])
def test_kws_waveforms_equal_jax(seed):
    got = kws.synthesize(4, keyword_prob=0.5, seed=seed)
    want = jkws.synthesize(4, keyword_prob=0.5, seed=seed)
    assert got[2] == want[2]
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_mask_to_intervals_matches_jax():
    rs = np.random.RandomState(0)
    for mask in [rs.rand(50) < 0.5, np.zeros(4), np.ones(4),
                 np.array([0, 1, 1, 0, 0, 1])]:
        assert vad.mask_to_intervals(mask) == jvad.mask_to_intervals(mask)


def test_vad_recipe_matches_jax(vad_runs):
    got, want, _, _ = vad_runs
    assert_results_close(got, want)
    assert got["energy_auc"] > 0.95 and got["dnn_auc"] > 0.95
    assert got["num_segments"] >= 1


@pytest.mark.parametrize("name", ["segment.info", "u0.TextGrid"])
def test_vad_recipe_files_equal_jax(vad_runs, name):
    _, _, troot, jroot = vad_runs
    assert (troot / name).read_bytes() == (jroot / name).read_bytes()


def test_kws_recipe_matches_jax(kws_runs):
    got, want, _, _ = kws_runs
    assert_results_close(got, want)
    assert got["kws_auc"] > 0.9 and got["kws_best_acc"] > 0.85


@pytest.mark.parametrize("name", ["keyword.fst.txt", "roc.txt"])
def test_kws_recipe_files_equal_jax(kws_runs, name):
    _, _, troot, jroot = kws_runs
    assert (troot / name).read_bytes() == (jroot / name).read_bytes()


def test_recipes_default_init_is_a_seeded_generator(tmp_path):
    """Without ``init_params`` the weights come from a torch generator
    seeded 0: two runs give the same results."""
    a = kws.run(str(tmp_path / "a"), num_train=4, num_test=4, device="cpu")
    b = kws.run(str(tmp_path / "b"), num_train=4, num_test=4, device="cpu")
    assert a == b
    net = kws.build_net(FBANK_DIM)
    vad.init_net(net, None)
    w = net.nodes[0].w.detach().clone()
    vad.init_net(net, None)
    assert torch.equal(w, net.nodes[0].w)


def test_recipes_refuse_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for mod in (kws, vad):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.run(str(tmp_path / mod.__name__), device="cuda")
