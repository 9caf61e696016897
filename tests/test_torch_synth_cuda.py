"""The LibriSpeech-shaped recipe's path on the card (recipes/ls_synth.py):
at a small depth (one full-width BLSTMP layer, C = 512, P = 320, 8
streams, 24 training utterances, 2 newbob iterations) its run on the
card trains through the x-fused pair (one launch each way a layer and
step) and the CTC pair (one launch a loss evaluation), and its
posteriors run on ``blstmp_forward`` (one launch a layer and call), with
no per-step or wide kernel; one training step's loss and gradients on the
card against the same step through the plain versions on the CPU (bf16
storage on both sides), within the bf16 CTC tolerances of chip_smoke.py
(loss 1e-3 relative, each gradient 5e-2 of its tensor's largest
magnitude); one utterance's posteriors within 1e-3.  The GMM-side
recipes (rm_synth at a tiny size) on the card launch no hand kernel.

The card has no CPU mode here, so these tests skip where there is no CUDA
card.  This file imports no JAX; run it on the card with
``python -m pytest --noconftest tests/test_torch_synth_cuda.py -q``."""

import inspect

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.models.losses import ctc_batch_loss
from kaldi_aslp_tpu_torch.ops import (
    bilstmp_train,
    bilstmp_xg_train,
    ctc_recursions as ctc_alpha_beta,
    lstmp,
    lstmp_train,
)
from kaldi_aslp_tpu_torch.recipes import ls_synth, rm_synth
from kaldi_aslp_tpu_torch.train.trainer import upload
from kaldi_aslp_tpu_torch.utils.device import resolve_device

LOSS_RTOL, GRAD_RTOL, POST_ATOL = 1e-3, 5e-2, 1e-3
SMALL = dict(num_words=20, num_train=24, num_test=2, layers=1, num_streams=8,
             max_iters=2, rescore_text_mult=2, lm_text_mult=2, max_len=4,
             lattice_beam=2.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")   # TF32 off


def _wrappers():
    return {"bilstmp_train_fwd": bilstmp_train.bilstmp_train_fwd,
            "bilstmp_train_bwd": bilstmp_train.bilstmp_train_bwd,
            "bilstmp_train_bwd_dir": bilstmp_train.bilstmp_train_bwd_dir,
            "bilstmp_xg_train_fwd": bilstmp_xg_train.bilstmp_xg_train_fwd,
            "bilstmp_xg_train_bwd": bilstmp_xg_train.bilstmp_xg_train_bwd,
            "lstmp_train_fwd": lstmp_train.lstmp_train_fwd,
            "lstmp_train_bwd": lstmp_train.lstmp_train_bwd,
            "ctc_alpha_beta": ctc_alpha_beta.ctc_alpha_beta,
            "lstmp_forward": lstmp.lstmp_forward,
            "blstmp_forward": lstmp.blstmp_forward}


def _zero(wrappers):
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "per_step"):
            w.per_step = 0
    wrappers["ctc_alpha_beta"].wide = 0


@pytest.fixture(scope="module")
def card_run(tmp_path_factory):
    _card()
    wrappers = _wrappers()
    _zero(wrappers)
    calls = [0]
    inner = ls_synth.make_posteriors

    def counted(*a, **k):
        fn = inner(*a, **k)

        def posteriors(feats):
            calls[0] += 1
            return fn(feats)
        return posteriors
    ls_synth.make_posteriors = counted
    try:
        out = ls_synth.run(str(tmp_path_factory.mktemp("ls")), **SMALL)
    finally:
        ls_synth.make_posteriors = inner
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items()}
    per_step = {n: w.per_step for n, w in wrappers.items()
                if hasattr(w, "per_step")}
    return dict(out=out, art=ls_synth.run.artifacts, calls=calls[0],
                launches=launches, per_step=per_step,
                wide=wrappers["ctc_alpha_beta"].wide)


@pytest.mark.cuda
def test_run_launches_the_fused_pair_the_ctc_pair_and_the_forward(card_run):
    art, launches = card_run["art"], card_run["launches"]
    epochs = len(art["epochs"])
    steps = epochs * len(art["tr_batches"])
    evals = epochs * len(art["cv_batches"])
    assert steps > 0 and evals > 0 and card_run["calls"] > 0
    assert art["net"].nodes[0].attrs["bf16"] is True
    want = {"bilstmp_train_fwd": steps, "bilstmp_train_bwd": steps,
            "ctc_alpha_beta": steps + evals,
            "blstmp_forward": evals + card_run["calls"]}
    assert {n: launches[n] for n in want} == want
    assert not {n: k for n, k in launches.items() if k and n not in want}
    assert not any(card_run["per_step"].values()) and card_run["wide"] == 0
    out = card_run["out"]
    assert np.isfinite([out["per"], out["wer_small"], out["wer_large"]]).all()


@pytest.mark.cuda
def test_one_step_and_the_posteriors_match_the_cpu(card_run):
    art = card_run["art"]
    net = art["net"]
    state = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    batch = art["tr_batches"][0]
    V = len(art["lang"].phones) + 1
    utt = sorted(art["test_feats"])[0]
    got = {}
    for dev in (resolve_device("cuda"), torch.device("cpu")):
        copy = ls_synth.build_net(net.nodes[0].input_dim, V, 1, 320, 512,
                                  bf16=True)
        copy.load_state_dict(state)
        copy.to(dev).train()
        feats, labels, in_lens, lab_lens, mask = upload(batch, dev)
        y, _ = copy(feats, mask=mask)
        loss, _ = ctc_batch_loss(y, labels, in_lens, lab_lens)
        loss.backward()
        post = ls_synth.make_posteriors(copy, ls_synth.BUCKET_T, 3, dev)(
            art["test_feats"][utt])
        got[dev.type] = (float(loss.detach()), {
            k: p.grad.cpu().double() for k, p in copy.named_parameters()},
            post)
    card, cpu = got["cuda"], got["cpu"]
    assert abs(card[0] - cpu[0]) <= LOSS_RTOL * abs(cpu[0])
    for k, g in cpu[1].items():
        err = float((card[1][k] - g).abs().max() / g.abs().max().clamp(
            min=1e-12))
        assert err <= GRAD_RTOL, k
    np.testing.assert_allclose(card[2], cpu[2], rtol=0, atol=POST_ATOL)


@pytest.mark.cuda
def test_rm_synth_launches_no_hand_kernel(tmp_path):
    _card()
    wrappers = _wrappers()
    _zero(wrappers)
    out = rm_synth.run(str(tmp_path), num_words=8, num_train=12, num_test=4)
    assert sorted(out) == ["dnn", "mono", "tri1"]
    assert not {n: w.launches for n, w in wrappers.items() if w.launches}


def test_small_config_is_the_flagship_width():
    """The card tests cut depth only: the recipe's default widths."""
    params = inspect.signature(ls_synth.run).parameters
    assert (params["proj"].default, params["cell"].default) == (320, 512)
    assert params["bucket_t"].default == ls_synth.BUCKET_T == 192
    assert not {"proj", "cell", "bucket_t"} & set(SMALL)
