"""The beam decoder (kaldi_aslp_tpu_torch/decoder/beam.py) on the card
against itself on the CPU, on the serving TLG of chip_smoke.py
(``write_model_and_graph``: 200 words over 71 phones + blank) with
random log-likelihoods, T = 300, at K = 2048 and K = 256: the same words
and alignment, the score within 1e-3 (float32 adds in the same order
on both sides; the tolerance only covers a different ``exp``/``log`` in
the inputs' making, which here is the same numpy on the host).

The decoder built without a device takes the card.  These tests skip
where there is no CUDA card.  This file imports no JAX; run it on the
card with ``python -m pytest --noconftest tests/test_torch_beam_cuda.py
-q``."""

import os
import sys

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph
from kaldi_aslp_tpu_torch.fst.fst import Fst

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


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


def _loglikes(T, V, seed):
    rs = np.random.RandomState(seed)
    x = 3.0 * rs.randn(T, V)
    return (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2048, 256])
def test_card_decode_matches_the_cpu(serving_graph, K):
    graph, lut = serving_graph
    ll = _loglikes(300, int(lut.max()) + 1, seed=K)
    card = BeamSearchDecoder(graph, lut, beam=32.0, max_active=K)
    assert card.device.type == "cuda"
    cpu = BeamSearchDecoder(graph, lut, beam=32.0, max_active=K,
                            device="cpu")
    words, ali, score = card.decode(ll)
    words_c, ali_c, score_c = cpu.decode(ll)
    assert words == words_c and len(words) > 0
    np.testing.assert_array_equal(ali, ali_c)
    assert abs(score - score_c) <= SCORE_TOL * abs(score_c)
    # scores already on the card decode as the host array does
    words_t, ali_t, score_t = card.decode(torch.from_numpy(ll).cuda())
    assert words_t == words and score_t == score
    np.testing.assert_array_equal(ali_t, ali)
