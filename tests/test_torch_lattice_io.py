"""The port's lattice layers on the CPU against the JAX package: the
Kaldi lattice shapes and their operations (decoder/compact.py), MBR
(decoder/mbr.py), N-best (decoder/nbest.py), the lattice files
(io/lattice_io.py) and the recipes' decode-and-score helper
(recipes/score_util.py).

The lattices are the port's ``decode_lattice`` output on the yes/no
CTC graph of tests/test_lattice_io.py:37 (scores made from seeds with
numpy), handed to both packages as the same values.  Tolerance: none;
every result (objects field by field, costs, posteriors, WERs) equals
JAX's exactly, and the files are byte-equal both ways, text and binary:
the two packages run the same Python and numpy arithmetic on the same
values."""

import dataclasses

import numpy as np
import pytest
import torch

import kaldi_aslp_tpu.decoder as J
from kaldi_aslp_tpu.decoder.lattice import (
    Lattice as JaxLattice,
    LatticeArc as JaxLatticeArc,
)
from kaldi_aslp_tpu.decoder.nbest import (
    lm_score_words as jax_lm_score_words,
    rescore_nbest as jax_rescore_nbest,
)
from kaldi_aslp_tpu.fst import make_unigram_grammar as jax_unigram
from kaldi_aslp_tpu.io import lattice_io as jax_lattice_io
from kaldi_aslp_tpu.recipes import score_util as jax_score_util
import kaldi_aslp_tpu_torch.decoder as P
from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
from kaldi_aslp_tpu_torch.decoder.nbest import lm_score_words, rescore_nbest
from kaldi_aslp_tpu_torch.fst import Lang, Lexicon, make_unigram_grammar
from kaldi_aslp_tpu_torch.io import lattice_io
from kaldi_aslp_tpu_torch.recipes import score_util
from test_torch_beam import _graph, _peaked, _port, _yes_no

torch.set_num_threads(1)


def fields(obj):
    return dataclasses.astuple(obj)


@pytest.fixture(scope="module")
def yes_no():
    g, lut, lang = _yes_no()
    dec = BeamSearchDecoder(CsrGraph.from_packed(_port(g)), lut,
                            beam=1e9, max_active=64, arc_budget=1024,
                            device="cpu")
    y, n = lang.phones.id("Y"), lang.phones.id("N")
    rng = np.random.RandomState(12)
    lats = {}
    for i, (seq, conf) in enumerate([([0, n, n, 0, y, 0], 0.9),
                                     ([0, y, 0, n, 0, y, 0], 0.5),
                                     (list(rng.choice([0, y, n], 9)),
                                      0.45)]):
        words, ali, score, lat = dec.decode_lattice(
            _peaked(lang, seq, conf), lattice_beam=10.0)
        lats[f"u{i}"] = dict(words=words, ali=ali, score=score, lat=lat)
    return dict(g=g, lut=lut, lang=lang, lats=lats)


def to_jax(lat):
    return JaxLattice(lat.num_frames,
                      [JaxLatticeArc(*fields(a)) for a in lat.arcs],
                      lat.start, dict(lat.final_costs))


def lattices(yes_no):
    return [(u["lat"], to_jax(u["lat"])) for u in yes_no["lats"].values()]


def test_state_lattice_conversions_match_jax(yes_no):
    for lat, jlat in lattices(yes_no):
        slat, jslat = P.lattice_to_state(lat), J.lattice_to_state(jlat)
        assert fields(slat) == fields(jslat)
        back, jback = P.state_to_lattice(slat), J.state_to_lattice(jslat)
        assert fields(back) == fields(jback)
        assert back.num_arcs() == lat.num_arcs()


@pytest.mark.parametrize("prune", [None, 1.0])
def test_determinize_matches_jax(yes_no, prune):
    for lat, jlat in lattices(yes_no):
        got = P.determinize_lattice(lat, prune=prune)
        assert fields(got) == fields(J.determinize_lattice(jlat,
                                                           prune=prune))
        assert got.num_states > 1


def test_determinize_pruned_retries_as_in_jax(yes_no):
    """A work budget too small for the whole lattice halves the prune
    beam, as in JAX, and fails the same way when every retry does."""
    lat, jlat = lattices(yes_no)[2]
    got = P.determinize_lattice_pruned(lat, prune=8.0, max_work=800)
    want = J.determinize_lattice_pruned(jlat, prune=8.0, max_work=800)
    assert fields(got) == fields(want)
    # the budget bound: 8 and 4 overran it, 2 too, 1 fits
    assert fields(got) == fields(P.determinize_lattice(lat, prune=1.0))
    with pytest.raises(P.DeterminizeFailed):
        P.determinize_lattice(lat, prune=2.0, max_work=800)
    with pytest.raises(P.DeterminizeFailed):
        P.determinize_lattice_pruned(lat, prune=8.0, max_work=5)
    with pytest.raises(J.DeterminizeFailed):
        J.determinize_lattice_pruned(jlat, prune=8.0, max_work=5)


def test_scale_and_both_best_paths_match_jax(yes_no):
    for u, (lat, jlat) in zip(yes_no["lats"].values(), lattices(yes_no)):
        slat, jslat = P.lattice_to_state(lat), J.lattice_to_state(jlat)
        clat, jclat = P.determinize_lattice(lat), J.determinize_lattice(jlat)
        for scales in ((1.0, 1.0), (2.0, 0.5), (1.0, 0.1)):
            for a, b in ((slat, jslat), (clat, jclat)):
                assert fields(P.scale_lattice(a, *scales)) == fields(
                    J.scale_lattice(b, *scales))
            got = P.state_lattice_best_path(slat, *scales)
            assert got == J.state_lattice_best_path(jslat, *scales)
            got_c = P.compact_lattice_best_path(clat, *scales)
            assert got_c == J.compact_lattice_best_path(jclat, *scales)
        words, ali, cost = P.compact_lattice_best_path(clat)
        assert words == u["words"] and len(ali) == len(u["ali"])
        assert -cost == pytest.approx(u["score"], abs=1e-3)
    u0 = yes_no["lats"]["u0"]
    ali = P.compact_lattice_best_path(P.determinize_lattice(u0["lat"]))[1]
    assert ali == list(u0["ali"])


def test_a_pathless_lattice_raises_a_lattice_error():
    slat = P.StateLattice(2, 0, [], {1: (0.0, 0.0)})
    with pytest.raises(P.LatticeError):
        P.state_lattice_best_path(slat)
    with pytest.raises(P.LatticeError):
        P.minimum_bayes_risk(P.Lattice(1, [], 0, {0: 0.0}))


def grammars(lang_port, lang_jax):
    old = {"YES": 0.6, "NO": 0.4}
    new = {"YES": 0.999, "NO": 0.001}
    return ((make_unigram_grammar(old, lang_port.words),
             jax_unigram(old, lang_jax.words)),
            (make_unigram_grammar(new, lang_port.words),
             jax_unigram(new, lang_jax.words)))


def test_lmrescore_matches_jax(yes_no):
    lang = Lang.build(Lexicon.from_text("YES Y\nNO N\n<SIL> SIL\n"))
    (old, jold), (new, jnew) = grammars(lang, yes_no["lang"])
    for lat, jlat in lattices(yes_no):
        clat, jclat = P.determinize_lattice(lat), J.determinize_lattice(jlat)
        base = P.compact_lattice_lmrescore(clat, old, lm_scale=-1.0)
        jbase = J.compact_lattice_lmrescore(jclat, jold, lm_scale=-1.0)
        assert fields(base) == fields(jbase)
        got = P.compact_lattice_lmrescore(base, new, lm_scale=1.0)
        assert fields(got) == fields(
            J.compact_lattice_lmrescore(jbase, jnew, lm_scale=1.0))
        assert lang.words.id("NO") not in P.compact_lattice_best_path(
            got)[0]


def test_mbr_matches_jax(yes_no):
    for scales in ((1.0, 1.0), (0.5, 1.0)):
        for lat, jlat in lattices(yes_no):
            words, confs, slots = P.minimum_bayes_risk(lat, *scales)
            jwords, jconfs, jslots = J.minimum_bayes_risk(jlat, *scales)
            assert (words, confs) == (jwords, jconfs)
            assert list(map(fields, slots)) == list(map(fields, jslots))
            assert P.lattice_arc_posteriors(
                lat, *scales, return_positions=True) == \
                J.lattice_arc_posteriors(jlat, *scales,
                                         return_positions=True)
    u = yes_no["lats"]["u0"]
    assert P.minimum_bayes_risk(u["lat"])[0] == u["words"]


def test_nbest_and_its_rescoring_match_jax(yes_no):
    lang = Lang.build(Lexicon.from_text("YES Y\nNO N\n<SIL> SIL\n"))
    (old, jold), (new, jnew) = grammars(lang, yes_no["lang"])
    for lat, jlat in lattices(yes_no):
        nb = P.lattice_nbest(lat, n=5, acoustic_scale=0.5)
        jnb = J.lattice_nbest(jlat, n=5, acoustic_scale=0.5)
        assert list(map(fields, nb)) == list(map(fields, jnb))
        for e in nb:
            assert lm_score_words(new, e.words) == jax_lm_score_words(
                jnew, e.words)
        for old_g, jold_g in ((old, jold), (None, None)):
            got = rescore_nbest(nb, old_g, new, acoustic_scale=0.5)
            want = jax_rescore_nbest(jnb, jold_g, jnew, acoustic_scale=0.5)
            assert list(map(fields, got)) == list(map(fields, want))
    assert len(P.lattice_nbest(lattices(yes_no)[2][0], n=5)) >= 2


def objects(yes_no):
    """(port, JAX) state and compact lattices of the three lattices."""
    out = []
    for lat, jlat in lattices(yes_no):
        out.append((P.lattice_to_state(lat), J.lattice_to_state(jlat)))
        out.append((P.determinize_lattice(lat), J.determinize_lattice(jlat)))
    return out


@pytest.mark.parametrize("spec", ["ark,t:", "ark:"])
def test_lattice_files_are_jax_bytes_both_ways(yes_no, tmp_path, spec):
    pairs = objects(yes_no)
    mine, theirs = tmp_path / "port.lats", tmp_path / "jax.lats"
    with lattice_io.lattice_writer(f"{spec}{mine}") as w:
        for i, (obj, _) in enumerate(pairs):
            w[f"k{i}"] = obj
    with jax_lattice_io.lattice_writer(f"{spec}{theirs}") as w:
        for i, (_, obj) in enumerate(pairs):
            w[f"k{i}"] = obj
    assert mine.read_bytes() == theirs.read_bytes()
    # each reads the other's file back to the same objects
    got = list(lattice_io.sequential_lattice_reader(f"ark:{theirs}"))
    want = list(jax_lattice_io.sequential_lattice_reader(f"ark:{mine}"))
    assert [k for k, _ in got] == [k for k, _ in want] == [
        f"k{i}" for i in range(len(pairs))]
    for (_, a), (_, b) in zip(got, want):
        assert type(a).__name__ == type(b).__name__
        assert fields(a) == fields(b)
    # a compact writer and a random-access reader over an scp
    scp = tmp_path / "c.scp"
    with lattice_io.compact_lattice_writer(
            f"ark,scp:{tmp_path}/c.ark,{scp}") as w:
        w["c"] = pairs[1][0]
    ra = lattice_io.random_access_lattice_reader(f"scp:{scp}")
    seq = dict(lattice_io.sequential_lattice_reader(f"ark:{tmp_path}/c.ark"))
    assert "c" in ra and fields(ra["c"]) == fields(seq["c"])
    assert P.compact_lattice_best_path(ra["c"])[0] == \
        P.compact_lattice_best_path(pairs[1][0])[0]
    with pytest.raises(lattice_io.KaldiIOError):
        with lattice_io.compact_lattice_writer(f"ark:{tmp_path}/x") as w:
            w["s"] = pairs[0][0]


def test_float_text_forms_are_jax_bit_for_bit():
    rng = np.random.RandomState(3)
    values = np.concatenate([
        rng.randn(200).astype(np.float32) * 10.0 ** rng.randint(-6, 6, 200),
        np.asarray([0.0, -0.0, 1.0, -3.0, np.inf, -np.inf, 1e-30, 2.5e8],
                   np.float32)])
    for v in values.astype(float):
        text = lattice_io._fmt_f(v)
        assert text == jax_lattice_io._fmt_f(v)
        assert lattice_io._parse_f(text) == jax_lattice_io._parse_f(text)
        assert np.float32(lattice_io._parse_f(text)) == np.float32(v) or \
            np.isnan(v)


def score_sets(yes_no, n_dev=3, n_test=4):
    lang = yes_no["lang"]
    y, n = lang.phones.id("Y"), lang.phones.id("N")
    yes, no = lang.words.id("YES"), lang.words.id("NO")
    rng = np.random.RandomState(21)
    sets = []
    for count in (n_dev, n_test):
        ll, refs = {}, {}
        for i in range(count):
            seq = [0] + [int(x) for x in rng.choice([y, n, 0], 7)] + [0]
            ll[f"u{len(sets)}{i}"] = _peaked(lang, seq, conf=0.55)
            refs[f"u{len(sets)}{i}"] = list(rng.choice(
                [yes, no], rng.randint(1, 4)))
        sets += [ll, refs]
    return sets


def test_decode_wer_dev_test_matches_jax(yes_no):
    sets = score_sets(yes_no)
    kw = dict(acoustic_scale=1.0, lmwt_range=range(1, 12), beam=12.0,
              max_active=16, lattice_beam=6.0)
    got = score_util.decode_wer_dev_test(_port(yes_no["g"]), yes_no["lut"],
                                         *sets, device="cpu", **kw)
    want = jax_score_util.decode_wer_dev_test(yes_no["g"], yes_no["lut"],
                                              *sets, **kw)
    assert got == want
    wer, sweep = score_util.decode_wer_beam(
        _port(yes_no["g"]), yes_no["lut"], sets[2], sets[3],
        device="cpu", **kw)
    jwer, jsweep = jax_score_util.decode_wer_beam(
        yes_no["g"], yes_no["lut"], sets[2], sets[3], **kw)
    assert wer == jwer
    assert {k: vars(v) for k, v in sweep.items()} == {
        k: vars(v) for k, v in jsweep.items()}


def test_utterances_without_a_path_score_as_deletions_as_in_jax():
    """A dead-end graph: every decode fails; both packages score every
    reference word as a deletion."""
    g = _graph([0], [1], [1], [1], [0.5], [np.inf, 0.0], eps_diameter=0)
    lut = np.array([0, 0], np.int32)
    ll = {"a": np.full((3, 1), -1.0, np.float32),
          "b": np.full((2, 1), -1.0, np.float32)}
    refs = {"a": [1, 1], "b": [1]}
    kw = dict(acoustic_scale=1.0, lmwt_range=[5, 6], beam=10.0,
              max_active=4, lattice_beam=4.0)
    got = score_util.decode_wer_dev_test(_port(g), lut, ll, refs, ll, refs,
                                         device="cpu", **kw)
    assert got == jax_score_util.decode_wer_dev_test(g, lut, ll, refs, ll,
                                                     refs, **kw)
    assert got[:2] == (100.0, 100.0)


def test_a_card_fault_is_not_scored_as_a_deletion(yes_no, monkeypatch):
    def fault(self, *a, **k):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(BeamSearchDecoder, "decode_lattice", fault)
    sets = score_sets(yes_no, 1, 1)
    with pytest.raises(RuntimeError, match="out of memory"):
        score_util.decode_wer_dev_test(
            _port(yes_no["g"]), yes_no["lut"], *sets, acoustic_scale=1.0,
            lmwt_range=[5], device="cpu")
