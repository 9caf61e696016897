"""The cross-session batched serving path on the card: the inference
kernel's two-direction entry at S = 2..16 streams of T = 32 frames (a
batcher's 16-frame chunks padded to its 32-frame bucket) with ragged
masks against its plain version, each row against the row's own valid
frames at S = 1, and one ``BatchedBeamDecoder`` batch on the card
against the CPU, on the serving TLG of chip_smoke.py.

These tests skip where there is no CUDA card.  This file imports no
JAX; run it on the card with ``python -m pytest --noconftest
tests/test_torch_serve_cuda.py -q``."""

import os
import sys

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.decoder.beam import BatchedBeamDecoder, CsrGraph
from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph
from kaldi_aslp_tpu_torch.fst.fst import Fst
from kaldi_aslp_tpu_torch.ops import sweep_plan as sp
from kaldi_aslp_tpu_torch.ops.lstmp import (
    blstmp_forward,
    blstmp_forward_reference,
    plan_for,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
C, P, T = 512, 320, 32
SCORE_TOL = 1e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(dev, S, seed=0):
    """A batch as the batcher makes it: rows of 1..16 valid frames
    padded to 32, a zero initial state, the model's init scale."""
    rs = np.random.RandomState(seed + S)

    def u(*shape):
        return torch.from_numpy(
            (0.1 * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32)).to(dev)
    lens = rs.randint(1, 17, size=S)
    lens[0] = 16
    mask = torch.from_numpy(
        (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)).to(dev)
    xgs = [torch.from_numpy(rs.randn(S, T, 4 * C).astype(np.float32)).to(dev)
           for _ in range(2)]
    weights = [(u(4 * C, P), u(P, C), u(3, C)) for _ in range(2)]
    zeros = torch.zeros((S, C), device=dev), torch.zeros((S, P), device=dev)
    return lens, (*xgs, mask, *weights, *zeros)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 3, 4, 5, 8, 11, 16])
def test_batched_call_matches_plain_and_each_row_alone(S):
    dev = _card()
    lens, args = _args(dev, S)
    assert plan_for(S, C, P, 2, dev).regime == sp.FEW
    before = (blstmp_forward.launches, blstmp_forward.per_step)
    with torch.no_grad():
        got = blstmp_forward(*args)
        want = blstmp_forward_reference(*args)
    torch.cuda.synchronize()
    assert (blstmp_forward.launches, blstmp_forward.per_step) == (
        before[0] + 1, before[1])
    torch.testing.assert_close(got[0], want[0], **TOL)
    xg_f, xg_b, mask, w_f, w_b, c0, r0 = args
    for s in range(S):
        n = int(lens[s])
        with torch.no_grad():
            alone, _, _ = blstmp_forward(
                xg_f[s:s + 1, :n].contiguous(), xg_b[s:s + 1, :n].contiguous(),
                mask[s:s + 1, :n].contiguous(), w_f, w_b, c0[:1], r0[:1])
        torch.testing.assert_close(got[0][s, :n], alone[0], **TOL)
        assert not got[0][s, n:].any()


@pytest.fixture(scope="module")
def serving_graph(tmp_path_factory):
    _card()
    sys.path.insert(0, REPO)
    import chip_smoke
    paths = chip_smoke.write_model_and_graph(
        str(tmp_path_factory.mktemp("serving")))
    with open(paths[2]) as f:
        graph = CsrGraph.from_packed(PackedGraph.from_fst(
            Fst.from_text(f.read())))
    return graph, np.loadtxt(paths[1], dtype=np.int32)


@pytest.mark.cuda
def test_batched_beam_on_the_card_matches_the_cpu(serving_graph):
    graph, lut = serving_graph
    rs = np.random.RandomState(3)
    V = int(lut.max()) + 1
    utts = []
    for n in (120, 37, 90, 64):
        x = 3.0 * rs.randn(n, V)
        utts.append((x - np.log(np.exp(x).sum(1, keepdims=True))).astype(
            np.float32))
    card = BatchedBeamDecoder(graph, lut, beam=32.0, max_active=2048)
    assert card.device.type == "cuda"
    cpu = BatchedBeamDecoder(graph, lut, beam=32.0, max_active=2048,
                             device="cpu")
    on_card = [torch.from_numpy(u).cuda() for u in utts]
    for got, want in zip(card.decode_batch(on_card), cpu.decode_batch(utts)):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == pytest.approx(want[2], rel=SCORE_TOL)
