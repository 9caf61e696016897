"""Keyword spotting (kaldi_aslp_tpu_torch/kws/) against the JAX package
(kaldi_aslp_tpu/kws/) on the same inputs: the spotter's hits equal and
its confidences within 1e-12 (both float64 DPs; ties forced, where the
self-loop must keep its token), the keyword-filler text FST byte for
byte, ``simulation_ali``, ``gen_state_map`` on small trees (two keyword
CD states on one pdf: the later one wins), the phone-map errors and the
ROC sweep's rows equal."""

import numpy as np
import pytest
import torch

import kaldi_aslp_tpu.kws as JK
from kaldi_aslp_tpu.hmm import HmmTopology as JTopo
from kaldi_aslp_tpu.hmm import TransitionModel as JTm
from kaldi_aslp_tpu.kws.text_fst import (
    build_keyword_filler_text_fst as j_text_fst,
    simulation_ali as j_sim_ali,
)
from kaldi_aslp_tpu.tree.build_tree import build_tree as j_build_tree
from kaldi_aslp_tpu.tree.cluster import GaussStats as JStats
import kaldi_aslp_tpu_torch.kws as TK
from kaldi_aslp_tpu_torch.hmm import HmmTopology as TTopo
from kaldi_aslp_tpu_torch.hmm import TransitionModel as TTm
from kaldi_aslp_tpu_torch.kws.text_fst import (
    build_keyword_filler_text_fst as t_text_fst,
    simulation_ali as t_sim_ali,
)
from kaldi_aslp_tpu_torch.tree.build_tree import build_tree as t_build_tree
from kaldi_aslp_tpu_torch.tree.cluster import GaussStats as TStats

torch.set_num_threads(1)

CONF_TOL = 1e-12
PHONES = {"sil": 1, "a": 2, "b": 3, "c": 4}


def _hits(hits):
    return [(h.keyword, h.start_frame, h.end_frame) for h in hits]


def assert_same_hits(post, keywords, **opts):
    want = JK.KeywordSpotter(keywords, JK.KwsOptions(**opts)).spot(post)
    got = TK.KeywordSpotter(keywords, TK.KwsOptions(**opts)).spot(post)
    assert _hits(got) == _hits(want)
    for g, w in zip(got, want):
        assert abs(g.confidence - w.confidence) <= CONF_TOL
    return got


def _jax_apps_post():
    """tests/test_apps.py's stream: unit 2 then unit 3 over filler 0."""
    T = 40
    post = np.full((T, 5), 0.02)
    post[:, 0] = 0.9
    post[15:20, :] = 0.02
    post[15:20, 2] = 0.9
    post[20:25, :] = 0.02
    post[20:25, 3] = 0.9
    return post / post.sum(1, keepdims=True)


def test_spotter_matches_jax_on_its_apps_cases():
    post = _jax_apps_post()
    hits = assert_same_hits(post, {"hello": [2, 3]},
                            confidence_threshold=0.3)
    assert len(hits) == 1 and hits[0].confidence > 0.5
    assert assert_same_hits(np.tile(post[:5], (2, 1)), {"hello": [2, 3]},
                            confidence_threshold=0.3) == []


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode", ["one_minus", "max_filler"])
def test_spotter_matches_jax_on_random_posteriors(seed, mode):
    rs = np.random.RandomState(seed)
    post = rs.dirichlet(np.full(6, 0.3), size=60)
    keywords = {"k1": [1, 2, 3], "k2": [4, 5], "k3": [2, 2]}
    assert_same_hits(post, keywords, confidence_threshold=0.0,
                     filler_score_mode=mode)
    assert_same_hits(post, keywords, confidence_threshold=0.2,
                     filler_score_mode=mode)


@pytest.mark.parametrize("seed", range(3))
def test_spotter_matches_jax_with_ties_forced(seed):
    """Posteriors on a coarse grid, and equal columns, so that self-loop,
    advance and entry tie: JAX's ``max`` keeps the first (self-loop)."""
    rs = np.random.RandomState(seed)
    post = np.round(rs.rand(50, 4) * 2) / 4 + 0.25
    post[:, 2] = post[:, 1]
    post /= post.sum(1, keepdims=True)
    assert_same_hits(post, {"t": [1, 2, 1], "u": [2, 1]},
                     confidence_threshold=0.0)
    flat = np.full((30, 3), 1.0 / 3)
    hits = assert_same_hits(flat, {"f": [1, 2]}, confidence_threshold=0.0)
    assert len(hits) == 1


def test_spotter_takes_a_tensor():
    post = _jax_apps_post()
    spotter = TK.KeywordSpotter({"hello": [2, 3]})
    assert _hits(spotter.spot(torch.from_numpy(post))) == \
        _hits(spotter.spot(post))


@pytest.mark.parametrize("keywords", [
    {"niho": ["ee", "ii", "oo"]},
    {"hey": ["h", "ey"], "stop": ["s", "t", "aa", "p"]},
])
def test_text_fst_bytes_match_jax(keywords):
    assert t_text_fst(keywords) == j_text_fst(keywords)
    assert t_text_fst(keywords, sil="SIL", filler="<f>") == \
        j_text_fst(keywords, sil="SIL", filler="<f>")


def test_text_fst_refuses_one_phone_keywords():
    for fn in (t_text_fst, j_text_fst):
        with pytest.raises(ValueError):
            fn({"a": ["x"]})


def test_simulation_ali_matches_jax():
    clean = {"u1": [1, 1, 2], "u2": [3], "simulation_0_u1": [9]}
    keys = ["simulation_0_u1", "simulation_12_u2", "simulation_0_unknown",
            "plain_u1", "simulation_x_u1", "simulation_3_simulation_0_u1"]
    assert t_sim_ali(clean, keys) == j_sim_ali(clean, keys)
    assert t_sim_ali(clean, keys)["simulation_12_u2"] == [3]


def _tree_and_tm(pkg, split: bool):
    """A triphone tree over PHONES and its transition model, built by
    ``pkg`` (jax or torch) from the same statistics; ``split``: contexts
    differ (the tree splits on the left phone), else one leaf a phone
    and pdf class."""
    build_tree, Stats, Topo, Tm = pkg
    rs = np.random.RandomState(0)
    stats = {}
    ids = list(PHONES.values())
    for ph in ids:
        for pc in range(3):
            for left in (ids if split else [0]):
                frames = rs.randn(40, 2) + 3 * ph + pc + (
                    5.0 * (left % 2) if split else 0.0)
                stats[((left, ph, 0), pc)] = Stats.from_frames(frames)
    tree = build_tree(stats, ids, {p: 3 for p in ids},
                      min_gain=1.0 if split else 1e9)
    topo = Topo.default(ids)
    triples = sorted({(p, s, tree.compute((l, p, r), s))
                      for p in ids for s in range(3)
                      for l in [0] + ids for r in [0] + ids})
    return Tm(topo, triples=triples), tree


JAX = (j_build_tree, JStats, JTopo, JTm)
TORCH = (t_build_tree, TStats, TTopo, TTm)


@pytest.mark.parametrize("split", [False, True])
def test_gen_state_map_matches_jax(split, tmp_path):
    lexicon = [["ab", "a", "b"], ["aba", "a", "b", "a"],
               ["cab", "c", "a", "b"]]
    jsm = JK.gen_state_map(PHONES, lexicon, *_tree_and_tm(JAX, split))
    tm, tree = _tree_and_tm(TORCH, split)
    sm = TK.gen_state_map(PHONES, lexicon, tm, tree)
    np.testing.assert_array_equal(sm.tid_map, jsm.tid_map)
    assert sm.state_list == jsm.state_list
    assert sm.keyword_states == jsm.keyword_states
    JK.write_state_map(jsm, str(tmp_path / "j.map"), str(tmp_path / "j.txt"))
    TK.write_state_map(sm, str(tmp_path / "t.map"), str(tmp_path / "t.txt"))
    for a, b in (("j.map", "t.map"), ("j.txt", "t.txt")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()


def test_gen_state_map_later_state_wins_a_shared_pdf():
    """Without splits every context of phone a has one pdf a pdf class:
    "sil_a_b_s0" and "b_a_sil_s0" (keyword "aba") share one, and its
    transition ids map to the later state, as in JAX and the reference."""
    tm, tree = _tree_and_tm(TORCH, split=False)
    sm = TK.gen_state_map(PHONES, [["aba", "a", "b", "a"]], tm, tree)
    first = sm.state_list.index("sil_a_b_s0")
    later = sm.state_list.index("b_a_sil_s0")
    assert later > first
    pdf = tree.compute((1, 2, 3), 0)
    assert pdf == tree.compute((3, 2, 1), 0)
    tids = [t for t in range(1, tm.num_transition_ids + 1)
            if tm.tid_to_pdf(t) == pdf]
    assert tids and all(sm.tid_map[t] == later for t in tids)


def test_gen_state_map_errors_match_jax():
    jtm, jtree = _tree_and_tm(JAX, False)
    tm, tree = _tree_and_tm(TORCH, False)
    cases = [
        (PHONES, [["a", "a"]], {}, ValueError),
        (PHONES, [["ax", "a", "x"]], {}, KeyError),
        ({"a": 2, "b": 3}, [["ab", "a", "b"]], {}, ValueError),
        (PHONES, [["ab", "a", "b"]], {"silence": "q"}, ValueError),
    ]
    for syms, lex, kw, err in cases:
        with pytest.raises(err):
            JK.gen_state_map(syms, lex, jtm, jtree, **kw)
        with pytest.raises(err):
            TK.gen_state_map(syms, lex, tm, tree, **kw)
    tree.context_width = 1
    with pytest.raises(ValueError, match="triphone"):
        TK.gen_state_map(PHONES, [["ab", "a", "b"]], tm, tree)


@pytest.mark.parametrize("text,err", [
    ("1 1\n2\n", "bad phone-map line"),
    ("0 1\n", "bad phone-map entry"),
    ("2 -1\n", "bad phone-map entry"),
    ("\n\n", "empty phone map"),
    ("1 1\n1 2\n", "duplicate"),
])
def test_phone_map_errors_match_jax(tmp_path, text, err):
    path = tmp_path / "phone.map"
    path.write_text(text)
    for mod in (JK, TK):
        with pytest.raises(ValueError, match=err):
            mod.read_phone_map(str(path))


def test_convert_phone_ali_matches_jax(tmp_path):
    path = tmp_path / "phone.map"
    path.write_text("1 1\n2 1\n3 2\n5 2\n")
    lut = TK.read_phone_map(str(path))
    np.testing.assert_array_equal(lut, JK.read_phone_map(str(path)))
    ali = np.array([1, 2, 3, 5, 3, 4])
    np.testing.assert_array_equal(TK.convert_phone_ali(lut, ali),
                                  JK.convert_phone_ali(lut, ali))
    for mod in (JK, TK):
        with pytest.raises(ValueError, match="outside"):
            mod.convert_phone_ali(lut, np.array([6]))


@pytest.mark.parametrize("stride", [0.05, 0.1, 0.25, 0.3])
def test_roc_sweep_rows_match_jax(stride):
    rs = np.random.RandomState(3)
    keys = [f"u{i}" for i in range(25)]
    scores = {k: float(np.round(rs.rand(), 1)) for k in keys}
    scores["u0"], scores["u1"] = 0.15000000000000002, 0.15
    labels = {k: int(rs.rand() < 0.5) for k in keys[:-2]}
    labels["extra"] = 1
    rows = TK.roc_sweep(scores, labels, stride)
    assert rows == JK.roc_sweep(scores, labels, stride)
    assert all(isinstance(r[0], float) for r in rows)
    # thresholds accumulate: the repr roc.txt prints keeps the sum's bits
    if stride == 0.05:
        assert rows[3][0] == 0.15000000000000002


def test_roc_sweep_needs_common_keys():
    for mod in (JK, TK):
        with pytest.raises(ValueError):
            mod.roc_sweep({"a": 0.1}, {"b": 1})
