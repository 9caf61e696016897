"""The syllable-unit chain on the port (kaldi_aslp_tpu_torch/ops/
syllable.py, recipes/syllable.py and recipes/hkust_synth.py's tables)
against the JAX package on the CPU: everything here is integers and
text, so everything must be equal — the pinyin lexicon's text and the
phone parameters, the syllable grouping, table, counts, tone binding and
bound lexicon, the ``SyllableUnits`` (ids, bind map, table, lexicon,
topology), the per-frame alignment conversion, the errors raised, and
the syllable TLG's states and arcs; then tests/test_syllable.py's
checks on the port, its syllable decode included."""

import numpy as np
import pytest

from kaldi_aslp_tpu.fst.lang import (
    Lang as JaxLang,
    Lexicon as JaxLexicon,
    arpa_to_fst as jax_arpa_to_fst,
)
from kaldi_aslp_tpu.ops import syllable as jax_syl
from kaldi_aslp_tpu.recipes import hkust_synth as jax_hk
from kaldi_aslp_tpu.recipes import syllable as jax_rs
from kaldi_aslp_tpu_torch.decoder.viterbi import PackedGraph, ViterbiDecoder
from kaldi_aslp_tpu_torch.fst import ctc_lut
from kaldi_aslp_tpu_torch.fst.lang import (
    Lang,
    Lexicon,
    arpa_to_fst,
    make_unigram_grammar,
)
from kaldi_aslp_tpu_torch.ops import syllable as syl
from kaldi_aslp_tpu_torch.recipes import hkust_synth as hk
from kaldi_aslp_tpu_torch.recipes import syllable as rs
from kaldi_aslp_tpu_torch.recipes.hard_corpus import (
    HardCorpusOptions,
    SentenceModel,
    pruned_bigram_arpa,
)


def _lexicon_rows(text):
    return [ln.split() for ln in text.splitlines() if ln.split()]


def _transcripts(words, num, seed=5):
    model = SentenceModel(words, HardCorpusOptions(num_words=len(words)))
    return model.sample(num, seed=seed)


@pytest.mark.parametrize("num_words,seed", [(40, 4321), (300, 7)])
def test_pinyin_lexicon_and_phone_table_are_the_jax_ones(num_words, seed):
    assert hk.make_pinyin_lexicon(num_words, seed) == \
        jax_hk.make_pinyin_lexicon(num_words, seed)
    assert hk.phone_param_table() == jax_hk.phone_param_table()
    assert (hk.INITIALS, hk.FINALS, hk.TONES, hk.TONE_F0) == (
        jax_hk.INITIALS, jax_hk.FINALS, jax_hk.TONES, jax_hk.TONE_F0)


@pytest.mark.parametrize("thresh", [1, 6, 12, 50])
def test_syllable_ops_match_jax(thresh):
    rows = _lexicon_rows(hk.make_pinyin_lexicon(200))
    for row in rows:
        assert syl.phones_to_syllables(row[1:]) == \
            jax_syl.phones_to_syllables(row[1:])
    syl_rows, table = syl.lexicon_to_syllable(rows)
    assert (syl_rows, table) == jax_syl.lexicon_to_syllable(rows)
    words = [r[0] for r in rows if r[0] != "<SIL>"]
    texts = _transcripts(words, 80)
    counts = syl.syllable_counts(syl_rows, texts)
    assert counts == jax_syl.syllable_counts(syl_rows, texts)
    bind = syl.bind_syllables(counts, thresh)
    assert bind == jax_syl.bind_syllables(counts, thresh)
    bound = {**{s: s for row in syl_rows for s in row[1:]}, **bind}
    assert syl.bind_lexicon(syl_rows, bound) == \
        jax_syl.bind_lexicon(syl_rows, bound)


def test_syllable_ops_raise_as_jax():
    for mod in (syl, jax_syl):
        with pytest.raises(ValueError, match="initial consonant"):
            mod.phones_to_syllables(["zh", "a1", "b"])
        with pytest.raises(ValueError, match="inside initial"):
            mod.ali_to_syllable([1, 1], {1: "b"}, {"b": 1}, {})
        with pytest.raises(KeyError, match="not in syllable table"):
            mod.ali_to_syllable([1], {1: "a1"}, {"e2": 1}, {})


def _tiny_units(bind_thresh=3):
    """The port's and JAX's units from one tonal lexicon and one set of
    transcripts."""
    text = hk.make_pinyin_lexicon(60, seed=11)
    words = sorted(r[0] for r in _lexicon_rows(text) if r[0] != "<SIL>")
    texts = _transcripts(words, 120)
    port = rs.prepare_syllable_units(Lexicon.from_text(text), texts,
                                     bind_thresh=bind_thresh,
                                     keep_phones=("SIL",))
    jax = jax_rs.prepare_syllable_units(JaxLexicon.from_text(text), texts,
                                        bind_thresh=bind_thresh,
                                        keep_phones=("SIL",))
    return text, texts, port, jax


@pytest.mark.parametrize("bind_thresh", [1, 12, 30])
def test_syllable_units_match_jax(bind_thresh):
    _, _, units, units_j = _tiny_units(bind_thresh)
    assert units.syllable_ids == units_j.syllable_ids
    assert units.bind == units_j.bind
    assert units.syllable_table == units_j.syllable_table
    assert units.num_units == units_j.num_units
    assert units.lexicon.prons == units_j.lexicon.prons
    assert units.lexicon.sil_phone == units_j.lexicon.sil_phone
    assert units.topo.phones == units_j.topo.phones
    for ph in units.topo.phones:
        got, want = units.topo.entry(ph), units_j.topo.entry(ph)
        assert [(s.pdf_class, s.transitions) for s in got.states] == \
            [(s.pdf_class, s.transitions) for s in want.states]
    if bind_thresh > 1:
        assert any(k != v for k, v in units.bind.items())


def test_convert_alignments_match_jax():
    text, texts, units, units_j = _tiny_units()
    lang = Lang.build(Lexicon.from_text(text))
    rs_ = np.random.RandomState(3)
    alis = {}
    for i, sent in enumerate(texts[:30]):
        ali = [lang.phones.id("SIL")] * int(rs_.randint(1, 4))
        for w in sent:
            for p in lang.lexicon.prons[w][0]:
                ali += [lang.phones.id(p)] * int(rs_.randint(1, 5))
            ali += [lang.phones.id("SIL")] * int(rs_.randint(0, 3))
        alis[f"u{i:02d}"] = ali
    names = {i: lang.phones.sym(i) for i in range(1, len(lang.phones))}
    got = rs.convert_alignments(units, alis, names)
    assert got == jax_rs.convert_alignments(units_j, alis, names)
    assert all(len(got[u]) == len(a) for u, a in alis.items())


def test_syllable_tlg_matches_jax():
    """The syllable TLG over a bigram G from held-out sentences: JAX's
    states and arcs (the JAX composition's arc order is its native
    helper's, so the graphs are compared by size and by a decode)."""
    text, texts, units, units_j = _tiny_units()
    words = sorted(units.lexicon.prons)
    arpa = pruned_bigram_arpa(_transcripts(
        [w for w in words if w != "<SIL>"], 200, seed=9),
        [w for w in words if w != "<SIL>"])
    lang = Lang.build(units.lexicon)
    lang_j = JaxLang.build(units_j.lexicon)
    tlg = rs.make_syllable_ctc_graph(units, arpa_to_fst(arpa, lang.words))
    tlg_j = jax_rs.make_syllable_ctc_graph(
        units_j, jax_arpa_to_fst(arpa, lang_j.words))
    assert (tlg.num_states, tlg.num_arcs) == (tlg_j.num_states,
                                              tlg_j.num_arcs)
    assert tlg.start == tlg_j.start


# -- tests/test_syllable.py's checks on the port ---------------------------

def test_phones_to_syllables():
    assert syl.phones_to_syllables(["n", "i3", "h", "ao3"]) == \
        ["ni3", "hao3"]
    assert syl.phones_to_syllables(["SIL", "a1"]) == ["SIL", "a1"]
    assert syl.phones_to_syllables(["zh", "ong1", "g", "uo2"]) == \
        ["zhong1", "guo2"]
    with pytest.raises(ValueError):
        syl.phones_to_syllables(["n"])


def test_bind_syllables_tone_binding():
    counts = {"ma1": 100, "ma2": 10, "ma3": 60, "xx4": 5}
    bind = syl.bind_syllables(counts, thresh=50)
    assert (bind["ma1"], bind["ma3"], bind["ma2"], bind["xx4"]) == \
        ("ma1", "ma3", "ma1", "xx4")
    assert "zz9" not in syl.bind_syllables({"zz9": 1}, thresh=50)
    assert syl.bind_lexicon([["MA", "ma2", "ma3"]], bind) == \
        [["MA", "ma1", "ma3"]]


def test_prepare_syllable_units_end_to_end():
    lex = Lexicon.from_text(
        "NIHAO n i3 h ao3\nMA1 m a1\nMA2 m a2\n<SIL> SIL\n")
    transcripts = [["NIHAO", "MA1"]] * 60 + [["MA2"]]
    units = rs.prepare_syllable_units(lex, transcripts, bind_thresh=50)
    assert units.bind["ma2"] == "ma1"
    assert set(units.syllable_ids) == {"ni3", "hao3", "ma1", "SIL"}
    assert units.num_units == 5
    assert units.lexicon.prons["MA2"] == [["ma1"]]
    pid = {"n": 1, "i3": 2, "h": 3, "ao3": 4, "m": 5, "a2": 6, "SIL": 7}
    names = {v: k for k, v in pid.items()}
    out = rs.convert_alignments(units, {"utt1": [7, 5, 5, 6, 1, 2, 3, 4, 4]},
                                names)
    s = units.syllable_ids
    assert out["utt1"] == [s["SIL"]] + [s["ma1"]] * 3 + \
        [s["ni3"]] * 2 + [s["hao3"]] * 3


def test_syllable_ctc_decode():
    lex = Lexicon.from_text("NIHAO n i3 h ao3\nMA m a1\n<SIL> SIL\n")
    units = rs.prepare_syllable_units(lex, [["NIHAO", "MA"]] * 60,
                                      bind_thresh=50)
    lang = Lang.build(units.lexicon)
    G = make_unigram_grammar({"NIHAO": 0.5, "MA": 0.5}, lang.words)
    tlg = rs.make_syllable_ctc_graph(units, G)
    dec = ViterbiDecoder(PackedGraph.from_fst(tlg), ctc_lut(units.num_units),
                         acoustic_scale=1.0, device="cpu")
    s = units.syllable_ids
    seq = [0, s["ni3"], s["ni3"], 0, s["hao3"], 0, s["ma1"], 0]
    ll = np.full((len(seq), units.num_units), np.log(0.01), np.float32)
    for t, u in enumerate(seq):
        ll[t, u] = np.log(0.9)
    words, _, _ = dec.decode(ll)
    assert [lang.words.sym(w) for w in words] == ["NIHAO", "MA"]
