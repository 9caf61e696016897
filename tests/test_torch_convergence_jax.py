"""The port's convergence task and trajectories against the JAX package
on the CPU (kaldi_aslp_tpu_torch/parallel/convergence.py against
kaldi_aslp_tpu/parallel/convergence.py), built once per module: JAX's
``make_hard_frame_task(seed=0)`` takes about 30 s here.

The task.  ``make_hard_frame_task(seed=0, device="cpu")`` must give
JAX's targets exactly and JAX's features within a bound derived per
feature dim d.  Everything after the MFCC's FFT is JAX's arithmetic:
given the same MFCCs, the port's deltas and per-speaker CMVN equal JAX's
bit for bit (``test_post_processing_is_jax_bit_for_bit``; the CMVN sums
are taken in numpy's order, as JAX's are).  What is left is the float32
FFT of two libraries: the pre-CMVN features differ by some delta_d (the
fbank / MFCC tests hold it to 1e-4).  Per-speaker CMVN maps x to
z = (x - mu) / sigma.  A perturbation of at most delta in every frame
moves mu by at most delta and sigma by at most delta (the standard
deviation is 1-Lipschitz in the largest perturbation), so z by at most
delta (2 + |z|) / sigma.  The stats' float32 sums of the perturbed
frames also round differently: at each frame a sum rounds to the other
side with a probability near |delta x^2| / ulp, for one ulp, so in
expectation the rounding adds as much to mu and to sigma again as the
perturbation itself.  Hence the bound for dim d, over each speaker s of
both splits:

    1e-5 + max_s delta_{s,d} (3 + 2 max|z_{s,d}|) / sigma_{s,d}.

c0's sigma is about 1 against a mean near 18, which is why a summation
order that is not JAX's (the port's before this test) moved c0 by
4.6e-4, 24 times this bound; at seed 0 the largest gap is 0.82 of it.

The trajectories.  From JAX's task arrays and JAX's ``net.init(
PRNGKey(0))``, each of the six strategies (MASGD at server momentum 0.9
and 0.5) runs 10 rounds at lr 1.0, 8 rows a worker, on 4 ranks (a
spawned gloo group, one torch thread a rank) beside JAX's
``run_convergence_comparison`` on 4 of the conftest's CPU mesh devices.
The 11 held-out losses agree within 1e-5 relative for BSP, BMUF, EASGD
and SOD (float32 sums in another order, 10 rounds).  The ASGD / MASGD
server adds the W = 4 workers' deltas in turn, each add rounding to
u = 2^-24 of the server's parameter; when the two packages' deltas
differ by their rounding, each of the R * W adds may round to the other
side, so the server drifts by up to R * W * u relative (ASGD), and
MASGD's momentum buffer m carries each such rounding on for 1 / (1 - m)
rounds: 1e-5 + R W u for ASGD, 1e-5 + R W u (1 + 1 / (1 - m)) for MASGD
(the held-out xent's logits are linear in the last layer, so the loss
moves no more, relative, than the parameters)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.feats import (
    FrameExtractionOptions as JaxFrameOpts,
    MelBanksOptions as JaxMelOpts,
    Mfcc as JaxMfcc,
    MfccOptions as JaxMfccOptions,
)
from kaldi_aslp_tpu.feats import batch as jax_batch
from kaldi_aslp_tpu.parallel import convergence as jax_conv
from kaldi_aslp_tpu.recipes import hard_corpus as jax_hc
from kaldi_aslp_tpu_torch.feats.batch import compute_batched
from kaldi_aslp_tpu_torch.feats.functions import add_deltas
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
from kaldi_aslp_tpu_torch.feats.mfcc import Mfcc, MfccOptions
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.parallel import convergence
from kaldi_aslp_tpu_torch.recipes import hard_corpus as hc

torch.set_num_threads(1)

R, W, U = 10, 4, 2.0 ** -24
RUN_TIMEOUT_S = 240
CASES = [("bsp", 0.9), ("bmuf", 0.9), ("easgd", 0.9), ("asgd", 0.9),
         ("masgd", 0.9), ("sod", 0.9), ("masgd", 0.5)]


def rel_bound(strategy, momentum):
    if strategy == "asgd":
        return 1e-5 + R * W * U
    if strategy == "masgd":
        return 1e-5 + R * W * U * (1 + 1 / (1 - momentum))
    return 1e-5


@pytest.fixture(scope="module")
def jax_task():
    return jax_conv.make_hard_frame_task(seed=0)


@pytest.fixture(scope="module")
def seed0_front_end():
    """The seed-0 corpus's waves and, per split, both packages' pre-CMVN
    features (MFCC + deltas) and final features, and the port's final
    features from JAX's MFCCs.  JAX's MFCCs are taken once: both
    packages' extractors get them through their ``compute_batched``."""
    opts = hc.HardCorpusOptions(num_words=30, num_train_speakers=4,
                                num_test_speakers=2, seed=1234)
    syn = hc.synthesize_corpus(opts, 14, 4, 2)
    mfcc = Mfcc(FrameExtractionOptions(samp_freq=hc.SAMP_FREQ, dither=0.0),
                MelBanksOptions(num_bins=23), MfccOptions(), device="cpu")
    jmfcc = JaxMfcc(JaxFrameOpts(samp_freq=hc.SAMP_FREQ, dither=0.0),
                    JaxMelOpts(num_bins=23), JaxMfccOptions())
    out = {}
    for split in ("train", "test"):
        waves, u2s = syn[f"{split}_waves"], syn[f"{split}_utt2spk"]
        jbase = {u: np.asarray(f, np.float32) for u, f in
                 jax_batch.compute_batched(jmfcc, waves).items()}
        fe = dict(
            waves=waves, u2s=u2s,
            port_raw={u: add_deltas(f).numpy()
                      for u, f in compute_batched(mfcc, waves).items()},
            jax_raw={u: add_deltas(torch.from_numpy(f.copy())).numpy()
                     for u, f in jbase.items()},
            port=hc.extract_mfcc_deltas_cmvn(waves, u2s, device="cpu"))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_batch, "compute_batched",
                       lambda ex, waves: jbase)
            mp.setattr(hc, "compute_batched", lambda ex, waves: {
                u: torch.from_numpy(f.copy()) for u, f in jbase.items()})
            fe["jax"] = jax_hc.extract_mfcc_deltas_cmvn(waves, u2s)
            fe["port_on_jax_mfcc"] = hc.extract_mfcc_deltas_cmvn(
                waves, u2s, device="cpu")
        out[split] = fe
    return out


def feature_bound(front_end):
    """The module docstring's per-dim bound over both splits' speakers."""
    bound = np.zeros(39)
    for fe in front_end.values():
        for spk in sorted(set(fe["u2s"].values())):
            us = [u for u in fe["waves"] if fe["u2s"][u] == spk]
            x = np.concatenate([fe["jax_raw"][u] for u in us])
            z = np.concatenate([fe["jax"][u] for u in us])
            delta = np.max([np.abs(fe["port_raw"][u] - fe["jax_raw"][u])
                            .max(0) for u in us], axis=0)
            bound = np.maximum(bound, delta * (3 + 2 * np.abs(z).max(0))
                               / x.std(0))
    return 1e-5 + bound


def test_post_processing_is_jax_bit_for_bit(seed0_front_end):
    """JAX's MFCCs through both packages' deltas and per-speaker CMVN give
    the same bits."""
    for fe in seed0_front_end.values():
        for u, want in fe["jax"].items():
            np.testing.assert_array_equal(fe["port_on_jax_mfcc"][u], want,
                                          err_msg=u)


def test_front_end_within_the_fft_bound(seed0_front_end):
    """The extracted features, each speaker's utterances within the
    derived bound; the pre-CMVN gap within the MFCC tests' 1e-4."""
    bound = feature_bound(seed0_front_end)
    assert bound.max() < 2e-4
    for fe in seed0_front_end.values():
        for u in fe["waves"]:
            np.testing.assert_allclose(fe["port_raw"][u], fe["jax_raw"][u],
                                       rtol=1e-4, atol=1e-4, err_msg=u)
            gap = np.abs(fe["port"][u] - fe["jax"][u]).max(0)
            assert (gap <= bound).all(), (u, gap / bound)


def test_hard_frame_task_matches_jax(jax_task, seed0_front_end):
    """``make_hard_frame_task(seed=0)``: JAX's shapes and pdf count, its
    targets exactly and its features within the derived bound."""
    task = convergence.make_hard_frame_task(seed=0, device="cpu")
    assert task[4] == jax_task[4] == 112
    for i in (1, 3):
        np.testing.assert_array_equal(task[i], jax_task[i])
    bound = feature_bound(seed0_front_end)
    for i in (0, 2):
        assert task[i].shape == jax_task[i].shape
        gap = np.abs(task[i] - jax_task[i]).max(axis=(0, 1))
        assert (gap <= bound).all(), gap / bound


@pytest.fixture(scope="module")
def trajectories(jax_task):
    """{(strategy, momentum): (port, jax)} 11 held-out losses each."""
    from kaldi_aslp_tpu.models.nnet import Nnet as JaxNnet
    from kaldi_aslp_tpu.models.recurrent import BLstm as JaxBLstm
    from kaldi_aslp_tpu.models.simple import AffineTransform as JaxAffine
    import jax

    net = JaxNnet()
    net.add(JaxBLstm(jax_task[0].shape[-1], 32))
    net.add(JaxAffine(32, jax_task[4]))
    init = jax.tree_util.tree_map(np.asarray,
                                  net.init(jax.random.PRNGKey(0)))
    runs = ((0.9, convergence.ALL_STRATEGIES), (0.5, ("masgd",)))

    def kw(m, strategies):
        return dict(n_rounds=R, learn_rate=1.0, per_device_batch=8,
                    strategies=strategies, task="hard_blstm",
                    masgd_momentum=m)

    def port_runs():
        return {m: convergence.run_convergence_comparison(
            W, device="cpu", task_data=jax_task, init_params=init,
            threads=1, run_timeout_s=RUN_TIMEOUT_S, **kw(m, strategies))
            for m, strategies in runs}

    # the port's spawned ranks train while JAX runs in this process
    with ThreadPoolExecutor(1) as pool, pytest.MonkeyPatch.context() as mp:
        port = pool.submit(port_runs)
        mp.setattr(jax_conv, "make_hard_frame_task",
                   lambda chunk=32, seed=0: jax_task)
        want = {m: jax_conv.run_convergence_comparison(W, **kw(m, strats))
                for m, strats in runs}
        got = port.result()
    return {(s, m): (np.asarray(got[m][s]), np.asarray(want[m][s]))
            for m, strategies in runs for s in strategies}


@pytest.mark.parametrize("strategy,momentum", CASES)
def test_ten_rounds_match_jax_from_jax_start(trajectories, strategy,
                                             momentum):
    got, want = trajectories[(strategy, momentum)]
    assert got.shape == want.shape == (R + 1,)
    np.testing.assert_allclose(got, want,
                               rtol=rel_bound(strategy, momentum), atol=0)
    assert want[-1] < want[0]
