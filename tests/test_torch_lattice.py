"""The port's lattice generation (kaldi_aslp_tpu_torch/decoder/beam.py
``decode_lattice`` with its record planes and record prune, and
decoder/lattice.py) on the CPU against the JAX package, on the graphs and
scores of tests/test_beam_decode.py and tests/test_lattice_io.py, made
from seeds with numpy.

Tolerance: none.  The words, the alignment, the score and every lattice
arc (frame, source, destination, transition id, words, graph cost,
acoustic cost) and final cost equal JAX's to the bit: both sides add the
same float32 values in the same order on the device and the same float64
values in the host build.  JAX builds its lattices with a native helper
where a C++ compiler is found; its own test holds that helper to the
numpy build, which is the port's, so these tests switch JAX to the numpy
build."""

import numpy as np
import pytest
import torch

import kaldi_aslp_tpu.decoder.beam as JB
from kaldi_aslp_tpu import native as jax_native
from kaldi_aslp_tpu.decoder.lattice import (
    Lattice as JaxLattice,
    LatticeArc as JaxLatticeArc,
    generate_lattice as jax_generate_lattice,
    lattice_best_path as jax_lattice_best_path,
    score_lmwt_sweep as jax_score_lmwt_sweep,
)
from kaldi_aslp_tpu_torch.decoder import (
    DecodeError,
    Lattice,
    LatticeError,
    generate_lattice,
    lattice_best_path,
    score_lmwt_sweep,
)
from kaldi_aslp_tpu_torch.decoder.lattice import LatticeArc
from kaldi_aslp_tpu_torch.decoder.beam import BeamSearchDecoder, CsrGraph
from test_beam_decode import synth_hclg
from test_torch_beam import (
    CASES,
    _case,
    _graph,
    _lut,
    _peaked,
    _port,
    _word_loop,
    _yes_no,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def jax_numpy_build(monkeypatch):
    monkeypatch.setattr(jax_native, "lattice_build", lambda *a, **k: None)


def arc_key(a):
    return (a.t, a.src, a.dst, a.tid, tuple(a.words), a.graph_cost,
            a.acoustic_cost)


def same_lattice(got, want):
    assert got.num_frames == want.num_frames
    assert got.start == want.start
    assert sorted(map(arc_key, got.arcs)) == sorted(map(arc_key, want.arcs))
    assert got.final_costs == want.final_costs


def decoders(g, lut, acoustic_scale=1.0, **kw):
    jdec = JB.BeamSearchDecoder(JB.CsrGraph.from_packed(g), lut,
                                acoustic_scale=acoustic_scale, **kw)
    pdec = BeamSearchDecoder(CsrGraph.from_packed(_port(g)), lut,
                             acoustic_scale=acoustic_scale, device="cpu",
                             **kw)
    return jdec, pdec


def same_decode(got, want):
    (w1, a1, s1, l1), (w2, a2, s2, l2) = got, want
    assert w1 == w2
    np.testing.assert_array_equal(a1, np.asarray(a2))
    assert s1 == s2
    same_lattice(l1, l2)


def pseudo_final_graph():
    """tests/test_beam_decode.py::test_lattice_pseudo_finals_when_no_
    final_reached: one frame ends on the non-final state 1."""
    g = _graph([0, 1, 2], [1, 2, 0], [1, 2, 0], [7, 0, 0],
               [0.5, 0.5, 0.1], [np.inf, np.inf, 0.0])
    ll = np.full((1, 4), -5.0, np.float32)
    ll[0, 0] = -0.1
    return g, _lut(3), ll


def no_eps_round_graph():
    """A graph of emitting arcs only, eps diameter 0: no eps stage and
    zero-width eps record planes."""
    g = _graph([0, 0, 1, 1, 2], [0, 1, 1, 2, 2], [1, 2, 2, 3, 3],
               [0, 4, 0, 5, 0], [0.5, 1.0, 0.4, 1.2, 0.3],
               [np.inf, 0.5, 0.0], eps_diameter=0)
    rng = np.random.RandomState(3)
    ll = rng.uniform(-4.0, -0.5, size=(9, 4)).astype(np.float32)
    return g, _lut(3), ll


@pytest.mark.parametrize("name", CASES)
def test_decode_lattice_matches_jax(name):
    g, lut, ll, kw = _case(name)
    jdec, pdec = decoders(g, lut, **kw)
    got = pdec.decode_lattice(ll, lattice_beam=7.0)
    same_decode(got, jdec.decode_lattice(ll, lattice_beam=7.0))
    # the best path is decode()'s
    w, a, s = pdec.decode(ll)
    assert (w, s) == (got[0], got[2])
    np.testing.assert_array_equal(a, got[1])
    # a tensor input gives the same
    same_decode(pdec.decode_lattice(torch.from_numpy(ll), 7.0), got)


def test_decode_lattice_on_the_yes_no_fixture_matches_jax():
    """tests/test_lattice_io.py:37's fixture, at an acoustic scale of
    0.1 (the float32 scale multiplies as in JAX)."""
    g, lut, lang = _yes_no()
    y, n = lang.phones.id("Y"), lang.phones.id("N")
    ll = _peaked(lang, [0, n, n, 0, y, 0])
    for scale in (1.0, 0.1):
        jdec, pdec = decoders(g, lut, acoustic_scale=scale, beam=1e9,
                              max_active=64, arc_budget=1024, chunk=8)
        got = pdec.decode_lattice(ll, lattice_beam=10.0)
        same_decode(got, jdec.decode_lattice(ll, lattice_beam=10.0))
        if scale == 1.0:
            assert got[0] == [lang.words.id("NO"), lang.words.id("YES")]
        assert got[3].num_arcs() > len(ll)


def test_pseudo_finals_match_jax():
    g, lut, ll = pseudo_final_graph()
    jdec, pdec = decoders(g, lut, beam=10.0, max_active=4, chunk=4)
    got = pdec.decode_lattice(ll, lattice_beam=8.0)
    same_decode(got, jdec.decode_lattice(ll, lattice_beam=8.0))
    assert got[3].final_costs == {1: 0.0}
    assert lattice_best_path(got[3])[0] == [7] == got[0]


def test_empty_utterance_matches_jax():
    g, lut, ll, kw = _case("empty_utterance")
    jdec, pdec = decoders(g, lut, **kw)
    got = pdec.decode_lattice(ll)
    same_decode(got, jdec.decode_lattice(ll))
    assert got[0] == [9] and len(got[1]) == 0 and got[3].num_frames == 0


def test_graph_without_eps_rounds_matches_jax():
    g, lut, ll = no_eps_round_graph()
    jdec, pdec = decoders(g, lut, beam=12.0, max_active=4)
    assert pdec.eps_rounds == 0
    got = pdec.decode_lattice(ll, lattice_beam=6.0)
    same_decode(got, jdec.decode_lattice(ll, lattice_beam=6.0))
    assert got[3].num_arcs() > len(ll)


def flat_yes_no():
    """test_beam_decode.py's budget tests: flat scores, many
    survivors."""
    g, lut, lang = _yes_no()
    y, n = lang.phones.id("Y"), lang.phones.id("N")
    return g, lut, _peaked(lang, [0, n, n, 0, y, 0], conf=0.4)


WIDE = dict(beam=1e9, max_active=64, arc_budget=1024, chunk=8)


def test_record_budget_escalation_persists_as_in_jax():
    """A budget of 2 escalates to the next power of two past the widest
    frame, keeps every arc, and stays escalated for the next decode, as
    JAX's does; a sequence of decodes gives JAX's sequence."""
    g, lut, ll = flat_yes_no()
    jdec, pdec = decoders(g, lut, **WIDE)
    jdec.rec_budget = pdec.rec_budget = 2
    lls = [ll, ll[:3], _peaked(_yes_no()[2], [0, 1, 0])]
    for x in lls:
        got = pdec.decode_lattice(x, lattice_beam=10.0)
        same_decode(got, jdec.decode_lattice(x, lattice_beam=10.0))
        assert pdec.rec_budget == jdec.rec_budget
        assert pdec.last_record_drops == jdec.last_record_drops == 0
    assert pdec.rec_budget > 2


def test_record_budget_cap_drops_as_in_jax():
    g, lut, ll = flat_yes_no()
    jdec, pdec = decoders(g, lut, **WIDE)
    for d in (jdec, pdec):
        d.rec_budget, d.rec_budget_max = 2, 4
    got = pdec.decode_lattice(ll, lattice_beam=10.0)
    same_decode(got, jdec.decode_lattice(ll, lattice_beam=10.0))
    assert pdec.last_record_drops == jdec.last_record_drops > 0
    assert pdec.rec_budget == jdec.rec_budget == 2
    full = decoders(g, lut, **WIDE)[1].decode_lattice(ll, 10.0)[3]
    assert got[3].num_arcs() < full.num_arcs()
    assert lattice_best_path(got[3])[0] == got[0]


@pytest.mark.parametrize("fwd_budget", [2, 16])
def test_forward_record_escalation_matches_jax(fwd_budget):
    """Past record_mem_bytes the forward stores rec_fwd_budget entries a
    stage and re-runs at the next power of two when a survivor was cut:
    the lattice is JAX's, and the natural-width one."""
    g, lut, ll = flat_yes_no()
    jdec, pdec = decoders(g, lut, **WIDE)
    for d in (jdec, pdec):
        d.rec_fwd_budget, d.record_mem_bytes = fwd_budget, 0
    calls = []
    record_forward = pdec._record_forward
    pdec._record_forward = lambda ll_, R: calls.append(R) or \
        record_forward(ll_, R)
    got = pdec.decode_lattice(ll, lattice_beam=10.0)
    same_decode(got, jdec.decode_lattice(ll, lattice_beam=10.0))
    assert calls[0] == fwd_budget and len(calls) >= 2
    same_lattice(got[3], decoders(g, lut, **WIDE)[1].decode_lattice(
        ll, 10.0)[3])


@pytest.mark.parametrize("name", ["flat_yes_no", "max_active_binds"])
def test_compact_prune_inputs_on_and_off_match_jax(name):
    if name == "flat_yes_no":
        g, lut, ll = flat_yes_no()
        kw = WIDE
    else:
        g, lut, ll, kw = _case(name)
    lats = []
    for on in (True, False):
        jdec, pdec = decoders(g, lut, **kw)
        jdec.compact_prune_inputs = pdec.compact_prune_inputs = on
        got = pdec.decode_lattice(ll, lattice_beam=10.0)
        same_decode(got, jdec.decode_lattice(ll, lattice_beam=10.0))
        lats.append(got[3])
    same_lattice(*lats)


def synth_case(seed=11, T=37):
    g, _pdf, lut = synth_hclg(120, 2, 24, seed=seed)
    rng = np.random.RandomState(seed + 2)
    ll = rng.uniform(-9.0, -6.0, size=(T, 24)).astype(np.float32)
    ll[np.arange(T), rng.randint(0, 24, T)] = -0.5
    return g, lut, ll


def test_record_prune_keeps_jax_arcs_on_the_same_planes():
    """JAX's _record_prune_chunk and the port's prune given identical
    packed record planes (JAX's, its padding frames cut off) keep the
    same arcs at every frame, with the same budget escalation."""
    import jax.numpy as jnp

    g, lut, ll = synth_case()
    T = len(ll)
    jdec, pdec = decoders(g, lut, beam=8.0, max_active=128, chunk=8)
    states0, scores0, _ = jdec._init_frontier()
    st, sc = jnp.asarray(states0), jnp.asarray(scores0)
    ll_dev, _ = jdec._pad_device(ll, T)
    planes = []
    for t0 in range(0, T, jdec.chunk):
        (st, sc), outs = jdec._scan_chunk(ll_dev, t0, T, st, sc, True, 0)
        planes.append(outs[3:5])
    states, scores = np.asarray(st), np.asarray(sc)
    _, best, is_final = jdec._best_final(states, scores)
    pseudo = None if is_final else (states, scores)
    jdec.rec_budget = pdec.rec_budget = 2
    j_tt, j_arcs = jdec._prune_records_device(planes, ll_dev, T, best, 7.0,
                                              pseudo)
    em = torch.from_numpy(np.concatenate(
        [np.asarray(p[0]) for p in planes])[:T])
    eps = torch.from_numpy(np.concatenate(
        [np.asarray(p[1]) for p in planes])[:T])
    p_tt, p_arcs = pdec._prune_records_device(em, eps, best, 7.0, pseudo)
    assert pdec.rec_budget == jdec.rec_budget > 2
    for t in range(T):
        assert sorted(p_arcs[p_tt == t]) == sorted(j_arcs[j_tt == t]), t
    assert len(p_arcs) == len(j_arcs) > T


@pytest.mark.parametrize("R", [0, 8])
def test_port_record_planes_equal_jax_planes(R):
    """The port's packed record planes are JAX's: the same (position,
    score, source, destination, ac - w) rows at every frame and stage, at
    natural width (R = 0) and cut to the R best forward scores (the
    lower index first on ties), with the same survivor counts."""
    import jax.numpy as jnp

    g, lut, ll = synth_case(seed=5, T=21)
    T = len(ll)
    jdec, pdec = decoders(g, lut, beam=8.0, max_active=64, chunk=8)
    states0, scores0, _ = jdec._init_frontier()
    st, sc = jnp.asarray(states0), jnp.asarray(scores0)
    ll_dev, _ = jdec._pad_device(ll, T)
    j_em, j_eps, j_cnt = [], [], []
    for t0 in range(0, T, jdec.chunk):
        (st, sc), outs = jdec._scan_chunk(ll_dev, t0, T, st, sc, True, R)
        j_em.append(np.asarray(outs[3]))
        j_eps.append(np.asarray(outs[4]))
        j_cnt.append(np.asarray(outs[5]))
    j_em = np.concatenate(j_em)[:T]
    j_eps = np.concatenate(j_eps)[:T]
    *_, p_em, p_eps, counts = pdec._record_forward(torch.from_numpy(ll), R)
    np.testing.assert_array_equal(p_em.numpy(), j_em)
    np.testing.assert_array_equal(p_eps.numpy(), j_eps)
    if R:
        assert p_em.shape[-1] == R
        want = np.concatenate(j_cnt)[:T]
        np.testing.assert_array_equal(counts.numpy(), want)
        assert want.max() > R       # the cut dropped survivors
    else:
        assert counts is None


@pytest.mark.parametrize("trial", range(3))
def test_lattice_contains_the_decoders_best_path(trial):
    """tests/test_beam_decode.py::test_lattice_always_contains_decoder_
    best_path on the port, and the lattice equal to JAX's."""
    g, _pdf, lut = synth_hclg(200, 2, 32, seed=3)
    rng = np.random.RandomState(7 + trial)
    T = int(rng.randint(40, 70))
    ll = rng.uniform(-9.0, -6.0, size=(T, 32)).astype(np.float32)
    ll[np.arange(T), rng.randint(0, 32, T)] = -0.5
    jdec, pdec = decoders(g, lut, beam=9.0, max_active=256, chunk=16)
    got = pdec.decode_lattice(ll, lattice_beam=7.0)
    same_decode(got, jdec.decode_lattice(ll, lattice_beam=7.0))
    words, cost = lattice_best_path(got[3])
    assert words == got[0]
    assert -cost == pytest.approx(got[2], abs=1e-2)


def test_empty_frontier_raises_decode_error():
    g = _graph([0], [1], [1], [1], [0.5], [np.inf, 0.0], eps_diameter=0)
    pdec = decoders(g, np.array([0, 0], np.int32), beam=10.0,
                    max_active=4, arc_budget=16)[1]
    with pytest.raises(DecodeError, match="empty frontier"):
        pdec.decode_lattice(np.full((3, 1), -1.0, np.float32))


@pytest.mark.parametrize("case", ["yes_no", "word_loop"])
def test_generate_lattice_matches_jax(case):
    if case == "yes_no":
        g, lut, lang = _yes_no()
        y, n = lang.phones.id("Y"), lang.phones.id("N")
        ll = _peaked(lang, [0, y, y, 0, n, 0])
        scale, beam = 1.0, 10.0
    else:
        g, lut, _ = _word_loop(3, num_words=6)
        ll = np.random.RandomState(9).uniform(
            -6.0, -0.5, size=(12, 17)).astype(np.float32)
        scale, beam = 0.5, 6.0
    got = generate_lattice(_port(g), ll, lut, acoustic_scale=scale,
                           beam=beam, device="cpu")
    want = jax_generate_lattice(g, ll, lut, acoustic_scale=scale, beam=beam)
    same_lattice(got, want)
    assert got.num_arcs() > len(ll)
    assert lattice_best_path(got) == jax_lattice_best_path(want)


def test_generate_lattice_without_a_path_raises_decode_error():
    g = _graph([0], [1], [1], [1], [0.5], [np.inf, 0.0], eps_diameter=0)
    with pytest.raises(DecodeError, match="no complete path"):
        generate_lattice(_port(g), np.full((3, 1), -1.0, np.float32),
                         np.array([0, 0]), device="cpu")


def both_lattices(arcs, T, finals):
    return (Lattice(T, [LatticeArc(*a) for a in arcs], 0, dict(finals)),
            JaxLattice(T, [JaxLatticeArc(*a) for a in arcs], 0,
                       dict(finals)))


def test_score_lmwt_sweep_error_stats_match_jax():
    """Per LMWT the same ErrorStats; a path-less and an empty lattice
    score as deletions."""
    g, lut, lang = _yes_no()
    y, n = lang.phones.id("Y"), lang.phones.id("N")
    pdec = decoders(g, lut, **WIDE)[1]
    rng = np.random.RandomState(4)
    lats_p, lats_j, refs = {}, {}, {}
    for i in range(4):
        seq = list(rng.choice([0, y, n], size=8))
        ll = _peaked(lang, seq, conf=0.5)
        lat = pdec.decode_lattice(ll, lattice_beam=10.0)[3]
        lats_p[f"u{i}"] = lat
        lats_j[f"u{i}"] = JaxLattice(
            lat.num_frames, [JaxLatticeArc(a.t, a.src, a.dst, a.tid,
                                           a.words, a.graph_cost,
                                           a.acoustic_cost)
                             for a in lat.arcs], lat.start,
            dict(lat.final_costs))
        refs[f"u{i}"] = list(rng.randint(1, 3, size=rng.randint(1, 4)))
    arcs = [(1, 0, 1, 1, (2,), 0.5, 1.0)]
    lats_p["pathless"], lats_j["pathless"] = both_lattices(arcs, 2, {1: 0})
    lats_p["empty"], lats_j["empty"] = both_lattices([], 2, {})
    refs["pathless"], refs["empty"] = [1, 2], [2]
    got = score_lmwt_sweep(lats_p, refs, lmwt_range=range(1, 16))
    want = jax_score_lmwt_sweep(lats_j, refs, lmwt_range=range(1, 16))
    assert list(got) == list(want)
    for lmwt in got:
        assert vars(got[lmwt]) == vars(want[lmwt]), lmwt
    assert got[1].deletions >= 3


def test_only_the_decoders_no_path_error_scores_as_deletions(monkeypatch):
    """A path-less lattice is a LatticeError (a DecodeError); any other
    error of the best path leaves the sweep."""
    lat, _ = both_lattices([], 2, {})
    with pytest.raises(LatticeError):
        lattice_best_path(lat)
    import kaldi_aslp_tpu_torch.decoder.lattice as L

    def card_fault(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(L, "_best_path", card_fault)
    with pytest.raises(RuntimeError, match="illegal memory"):
        score_lmwt_sweep({"u": lat}, {"u": [1]}, lmwt_range=[10])


def random_lattice(seed, T=12, S=6, arcs_per_frame=14):
    """A random time-synchronous lattice with costs on a 0.5 grid (ties
    everywhere), some arcs leaving unreached nodes, and 2 finals."""
    rng = np.random.RandomState(seed)
    arcs = []
    for t in range(1, T + 1):
        for _ in range(arcs_per_frame):
            words = tuple(int(w) for w in rng.randint(1, 5, rng.randint(0, 3)))
            arcs.append((t, int(rng.randint(S)), int(rng.randint(S)),
                         int(rng.randint(1, 9)), words,
                         float(rng.randint(0, 6) * 0.5),
                         float(rng.randint(0, 8) * 0.5)))
    finals = {int(s): float(rng.randint(0, 3) * 0.5)
              for s in rng.choice(S, 2, replace=False)}
    return both_lattices(arcs, T, finals)


@pytest.mark.parametrize("seed", range(6))
def test_lattice_best_path_matches_jax_on_ties(seed):
    """The frame-at-once best path keeps the arc JAX's one-at-a-time DP
    keeps: the same words and cost at every scale, on lattices full of
    equal scores."""
    lat, jlat = random_lattice(seed)
    for ac, lm in ((1.0, 1.0), (0.1, 1.0), (1.0, 0.0), (0.25, 2.0)):
        assert lattice_best_path(lat, ac, lm) == jax_lattice_best_path(
            jlat, ac, lm)
