"""The CTC recipe's path on the card against the CPU: a full-width
``BLstm`` layer (C = 320 a direction, the hard ladder's full-scale CTC
model) forward and every gradient, the MFCC front end, the dense
Viterbi built without a device (it takes the card), and a toy recipe run
built without a device, whose every loss evaluation launches the CTC
pair once.

The card has no CPU mode here, so these tests skip where there is no CUDA
card.  This file imports no JAX; run it on the card with
``python -m pytest --noconftest tests/test_torch_ctc_recipe_cuda.py -q``.
Tolerances: values 1e-4 and gradients 1e-3 relative to each tensor's
largest magnitude (float32 on both sides with TF32 off, the products
summed in another order over up to 96 dependent frames); MFCCs
rtol=atol=1e-4."""

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph, ViterbiDecoder
from kaldi_aslp_tpu_torch.feats.mel import MelBanksOptions
from kaldi_aslp_tpu_torch.feats.mfcc import Mfcc
from kaldi_aslp_tpu_torch.feats.window import FrameExtractionOptions
from kaldi_aslp_tpu_torch.fst import (
    Lang,
    Lexicon,
    ctc_lut,
    make_ctc_decode_graph,
    make_unigram_grammar,
)
from kaldi_aslp_tpu_torch.models import BLstm
from kaldi_aslp_tpu_torch.ops import ctc_recursions as ctc_alpha_beta
from kaldi_aslp_tpu_torch.recipes import CtcRecipe, CtcRecipeOptions
from kaldi_aslp_tpu_torch.utils.device import resolve_device

VALUE_RTOL, GRAD_RTOL = 1e-4, 1e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")   # TF32 off


def _rel(got, want):
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-12))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [39, 640])
def test_full_width_blstm_layer_matches_the_cpu(D):
    dev = _card()
    S, T, C = 16, 96, 320
    rs = np.random.RandomState(D)
    layer = BLstm(D, 2 * C)
    layer.reset_parameters(torch.Generator().manual_seed(777))
    x = torch.from_numpy(rs.randn(S, T, D).astype(np.float32))
    lens = rs.randint(T // 2, T + 1, S)
    lens[0] = T
    mask = torch.from_numpy((np.arange(T)[None] < lens[:, None])
                            .astype(np.float32))
    c0 = torch.from_numpy(0.3 * rs.randn(S, C).astype(np.float32))
    cot = torch.from_numpy(rs.randn(S, T, 2 * C).astype(np.float32))
    out = {}
    for device in ("cpu", dev):
        lay = BLstm(D, 2 * C).to(device)
        lay.load_state_dict(layer.state_dict())
        xd = x.to(device, copy=True).requires_grad_()
        c0d = c0.to(device, copy=True).requires_grad_()
        ys, st = lay(xd, {"fwd": {"c": c0d, "r": torch.zeros_like(c0d)}},
                     mask=mask.to(device))
        ((ys * cot.to(device)).sum() + st["fwd"]["c"].sum()).backward()
        out[str(device)] = {"ys": ys, "final_c": st["fwd"]["c"],
                            "x": xd.grad, "c0": c0d.grad,
                            **{n: p.grad for n, p in lay.named_parameters()}}
    cpu, card = out["cpu"], out[str(dev)]
    for name in ("ys", "final_c"):
        assert _rel(card[name], cpu[name]) <= VALUE_RTOL, name
    errs = {n: _rel(card[n], cpu[n]) for n in cpu
            if n not in ("ys", "final_c")}
    assert max(errs.values()) <= GRAD_RTOL, errs


@pytest.mark.cuda
def test_mfcc_on_the_card_matches_the_cpu():
    dev = _card()
    wave = np.random.RandomState(1).randn(2 * 8000 + 123).astype(
        np.float32) * 1000
    opts = (FrameExtractionOptions(samp_freq=8000.0, dither=0.0),
            MelBanksOptions(num_bins=23))
    got = Mfcc(*opts)(wave)
    assert got.device.type == "cuda"
    want = Mfcc(*opts, device="cpu")(wave)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-4)


def _graph():
    lang = Lang.build(Lexicon.from_text("A a b\nB b a\nC c\n"))
    G = make_unigram_grammar({"A": 0.4, "B": 0.4, "C": 0.2}, lang.words)
    return lang, PackedGraph.from_fst(make_ctc_decode_graph(lang, G))


@pytest.mark.cuda
def test_viterbi_decoder_defaults_to_the_card():
    _card()
    lang, graph = _graph()
    V = len(lang.phones) + 1
    ll = np.log(np.random.RandomState(2).dirichlet(np.ones(V), 40)
                ).astype(np.float32)
    dec = ViterbiDecoder(graph, ctc_lut(V))
    assert dec.device.type == "cuda"
    got = dec.decode(ll)
    want = ViterbiDecoder(graph, ctc_lut(V), device="cpu").decode(ll)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == pytest.approx(want[2], rel=1e-5)


@pytest.mark.cuda
def test_toy_recipe_defaults_to_the_card(tmp_path):
    """Every training step and CV batch is one CTC pair launch."""
    _card()
    rs = np.random.RandomState(3)
    lang = Lang.build(Lexicon.from_text("YES Y\nNO N\n"))
    feats, texts = {}, {}
    for u in range(12):
        texts[f"u{u}"] = ["YES" if rs.rand() < 0.5 else "NO"
                          for _ in range(3)]
        feats[f"u{u}"] = rs.randn(40, 5).astype(np.float32)
    rec = CtcRecipe(lang, CtcRecipeOptions(model_type="blstm", hidden_dim=16,
                                           num_layers=2, max_iters=2,
                                           num_streams=4))
    assert rec.device.type == "cuda"
    ctc_alpha_beta.ctc_alpha_beta.launches = 0
    stats = rec.run(feats, texts, feats, texts, work_dir=str(tmp_path))
    evaluations = sum(e["train_batches"] + e["cv_batches"]
                      for e in rec.epochs)
    assert ctc_alpha_beta.ctc_alpha_beta.launches == evaluations
    assert next(rec.net.parameters()).device.type == "cuda"
    assert np.isfinite(stats.wer)
    assert (tmp_path / "final.ckpt").exists()
