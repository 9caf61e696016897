"""The hybrid path's device work on the card: the GMM statistics (one-hot
products, float64) give the same bits run twice and round to the CPU's
float32 values; the GMM log-likelihoods on the card against the CPU; the
forced alignment on the card against the CPU (the same words and
alignments, the same scores); one ``FrameTrainer`` step of a DNN hybrid
on the card against the CPU (loss 1e-5 relative, gradients 1e-4 of each
tensor's largest magnitude, TF32 off).  No hand kernel is on this path.

These tests skip where there is no CUDA card.  This file imports no
JAX; run it on the card with ``python -m pytest --noconftest
tests/test_torch_hybrid_cuda.py -q``."""

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.decoder.viterbi import align_batched
from kaldi_aslp_tpu_torch.fst import Lang, Lexicon
from kaldi_aslp_tpu_torch.gmm import diag_gmm as g
from kaldi_aslp_tpu_torch.gmm.mono import MonophoneTrainer
from kaldi_aslp_tpu_torch.models.flagship import build_dnn_hybrid
from kaldi_aslp_tpu_torch.train import (
    FrameTrainer,
    NnetTrainOptions,
    init_velocity,
)

LL_RTOL = 1e-4
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
LEXICON = "YES Y EH S\nNO N OW\nYO Y OW\nSEE S IY\nNOSE N OW Z\n"


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(rs, P=120, M=6, D=39):
    w = rs.rand(P, M).astype(np.float32) + 0.1
    w[::7, M // 2:] = 0.0           # dead slots, as after mixing up
    w /= w.sum(1, keepdims=True)
    return g.AmDiagGmm(weights=w, means=rs.randn(P, M, D).astype(np.float32),
                       vars=(0.3 + rs.rand(P, M, D)).astype(np.float32))


@pytest.mark.cuda
def test_gmm_statistics_same_bits_twice_and_as_the_cpu():
    dev = _card()
    rs = np.random.RandomState(0)
    am = _model(rs)
    T = 3 * g.STATS_BLOCK + 17
    feats = rs.randn(T, am.dim).astype(np.float32)
    pdfs = rs.randint(0, am.num_pdfs, T)
    runs = []
    for device in (dev, dev, "cpu"):
        stats = g.GmmStats(am, device)
        stats.accumulate(am.pack(device), feats, pdfs)
        runs.append(stats.to_numpy())
    for a, b in zip(runs[0], runs[1]):
        assert a.tobytes() == b.tobytes()
    for a, c in zip(runs[0], runs[2]):
        np.testing.assert_allclose(a, c, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(c).max()))


@pytest.mark.cuda
def test_gmm_loglikes_card_against_cpu():
    dev = _card()
    rs = np.random.RandomState(1)
    am = _model(rs)
    feats = torch.from_numpy(rs.randn(700, am.dim).astype(np.float32))
    got = g.gmm_loglikes(feats.to(dev), *am.pack(dev)).cpu().numpy()
    want = g.gmm_loglikes(feats, *am.pack("cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=LL_RTOL)


@pytest.mark.cuda
def test_forced_alignment_card_against_cpu():
    dev = _card()
    mono = MonophoneTrainer(Lang.build(Lexicon.from_text(LEXICON)),
                            device=dev)
    rs = np.random.RandomState(2)
    transcripts = [["YES"], ["NO", "SEE"], ["NOSE", "YO", "YES"],
                   ["YO", "NO", "NOSE", "YES", "SEE"]] * 3
    graphs, lls = {}, {}
    for i, words in enumerate(transcripts):
        graphs[f"u{i}"] = mono.compiler.compile(words)
        T = int(rs.randint(15 * len(words), 40 * len(words)))
        lls[f"u{i}"] = -4.0 * rs.rand(T, mono.num_pdfs).astype(np.float32)
    got = align_batched(graphs, mono._tid_pdf_lut, lls, batch=5, device=dev)
    want = align_batched(graphs, mono._tid_pdf_lut, lls, device="cpu")
    for u in want:
        assert got[u][0] == want[u][0]
        np.testing.assert_array_equal(got[u][1], want[u][1])
        assert got[u][2] == want[u][2]


@pytest.mark.cuda
def test_frame_step_card_against_cpu():
    dev = _card()
    rs = np.random.RandomState(3)
    net = build_dnn_hybrid(input_dim=351, hidden_dim=512, num_layers=4,
                           num_pdfs=120)
    net.reset_parameters(torch.Generator().manual_seed(4))
    card = build_dnn_hybrid(input_dim=351, hidden_dim=512, num_layers=4,
                            num_pdfs=120)
    card.load_state_dict(net.state_dict())
    card.to(dev)
    batch = (rs.randn(256, 351).astype(np.float32),
             rs.randint(0, 120, 256).astype(np.int64),
             np.ones(256, np.float32))
    out = {}
    for name, model, device in (("cpu", net, "cpu"), ("card", card, dev)):
        trainer = FrameTrainer(model, NnetTrainOptions(momentum=0.9))
        loss, _ = trainer.step(init_velocity(model), tuple(
            torch.from_numpy(a).to(device) for a in batch), 0.2)
        out[name] = (float(loss), {k: p.grad.cpu().numpy()
                                   for k, p in model.named_parameters()})
    assert out["card"][0] == pytest.approx(out["cpu"][0], rel=LOSS_RTOL)
    for k, want in out["cpu"][1].items():
        np.testing.assert_allclose(out["card"][1][k], want, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(want).max()))
