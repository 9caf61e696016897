"""Lattice generation (kaldi_aslp_tpu_torch/decoder/beam.py
``decode_lattice``, decoder/lattice.py ``generate_lattice``) on the card
against the same code on the CPU.

``decode_lattice`` runs on the serving TLG of chip_smoke.py
(``write_model_and_graph``: 200 words over 71 phones + blank, 1,853
states) with random log-likelihoods, T = 120, at latgen-faster-mapped's
settings (acoustic scale 0.1, beam 16, K = 7000, lattice beam 8) and at
a narrow K = 256 with a small record budget (escalation and compacted
forward planes): the same words and alignment, the score equal to the
bit, and the same lattice, arc for arc with costs to the bit (float32
adds in the same order on both sides; the host build is the same numpy
on the same kept arcs).  ``generate_lattice`` runs on a 12-word CTC
graph: the same lattice to the bit.

These tests skip where there is no CUDA card.  This file imports no
JAX; run it on the card with ``python -m pytest --noconftest
tests/test_torch_lattice_cuda.py -q``."""

import os
import sys

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
from kaldi_aslp_tpu_torch.decoder.lattice import generate_lattice
from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph
from kaldi_aslp_tpu_torch.fst import (
    Lang,
    Lexicon,
    ctc_lut,
    make_ctc_decode_graph,
    make_unigram_grammar,
)
from kaldi_aslp_tpu_torch.fst.fst import Fst

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _arcs(lat):
    return sorted((a.t, a.src, a.dst, a.tid, a.words, a.graph_cost,
                   a.acoustic_cost) for a in lat.arcs)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [7000, 256])
def test_card_lattice_matches_the_cpu(serving_graph, K):
    graph, lut = serving_graph
    ll = _loglikes(120, int(lut.max()) + 1, seed=K)
    kw = dict(acoustic_scale=0.1, beam=16.0, max_active=K)
    card = BeamSearchDecoder(graph, lut, **kw)
    assert card.device.type == "cuda"
    cpu = BeamSearchDecoder(graph, lut, device="cpu", **kw)
    if K == 256:
        for d in (card, cpu):
            d.rec_budget, d.record_mem_bytes, d.rec_fwd_budget = 4, 0, 64
    words, ali, score, lat = card.decode_lattice(ll, lattice_beam=8.0)
    words_c, ali_c, score_c, lat_c = cpu.decode_lattice(ll,
                                                        lattice_beam=8.0)
    assert words == words_c and len(words) > 0
    np.testing.assert_array_equal(ali, ali_c)
    assert score == score_c
    assert _arcs(lat) == _arcs(lat_c) and lat.num_arcs() > len(ll)
    assert lat.final_costs == lat_c.final_costs
    assert card.rec_budget == cpu.rec_budget
    assert card.last_record_drops == cpu.last_record_drops
    # scores already on the card give the same
    again = card.decode_lattice(torch.from_numpy(ll).cuda(), 8.0)
    assert again[0] == words and again[2] == score
    assert _arcs(again[3]) == _arcs(lat)


@pytest.mark.cuda
def test_card_generate_lattice_matches_the_cpu():
    _card()
    rs = np.random.RandomState(3)
    phones = [f"P{i}" for i in range(8)]
    lex = "\n".join(f"W{i} " + " ".join(rs.choice(phones, 2))
                    for i in range(12)) + "\n<SIL> SIL\n"
    lang = Lang.build(Lexicon.from_text(lex))
    g = PackedGraph.from_fst(make_ctc_decode_graph(
        lang, make_unigram_grammar({f"W{i}": 1 / 12 for i in range(12)},
                                   lang.words)))
    lut = ctc_lut(len(lang.phones))
    ll = _loglikes(30, len(lang.phones), seed=4)
    got = generate_lattice(g, ll, lut, acoustic_scale=0.5, beam=6.0)
    want = generate_lattice(g, ll, lut, acoustic_scale=0.5, beam=6.0,
                            device="cpu")
    assert _arcs(got) == _arcs(want) and got.num_arcs() > len(ll)
    assert got.final_costs == want.final_costs
