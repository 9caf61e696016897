"""Syllable-unit prep chain: phone system -> syllable CE/CTC targets.

Replaces (reference): aslp_scripts/syllable/prepare_syllable_ctc.sh and
prepare_syllable_ce.sh — derive a syllable lexicon from the phone
lexicon, tone-bind low-frequency syllables, convert per-frame phone
alignments to syllable alignments, and build the syllable-level CTC
decode graph (via aslp_scripts/ctc/make_ctc_graph.sh's role,
fst/ctc_graph.py here).

Port of kaldi_aslp_tpu/recipes/syllable.py on the port's fst/, hmm/ and
ops/syllable.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Sequence

from kaldi_aslp_tpu_torch.fst.ctc_graph import make_ctc_decode_graph
from kaldi_aslp_tpu_torch.fst.lang import Lang, Lexicon
from kaldi_aslp_tpu_torch.hmm.topology import HmmTopology
from kaldi_aslp_tpu_torch.ops.syllable import (
    ali_to_syllable,
    bind_lexicon,
    bind_syllables,
    lexicon_to_syllable,
    syllable_counts,
)


@dataclass
class SyllableUnits:
    """The syllable-unit system produced by ``prepare_syllable_units``."""

    lexicon: Lexicon                  # word -> (bound) syllable prons
    syllable_ids: Dict[str, int]      # syllable -> output id (1-based)
    bind: Dict[str, str]              # raw syllable -> bound syllable
    syllable_table: Dict[str, str]    # syllable -> phone decomposition
    topo: HmmTopology = field(default=None)  # fake 1-state CTC topo

    @property
    def num_units(self) -> int:
        # +1: CTC blank takes output index 0 (ali-minus-one convention)
        return len(self.syllable_ids) + 1


def prepare_syllable_units(
    phone_lexicon: Lexicon,
    transcripts: Iterable[Sequence[str]],
    bind_thresh: int = 50,
    keep_phones: Sequence[str] = (),
) -> SyllableUnits:
    """Derive the syllable unit system from a phone lexicon + training
    transcripts (prepare_syllable_ctc.sh's prep stages).

    ``keep_phones`` lists non-speech phones (SIL etc.) that pass
    through as their own units regardless of frequency."""
    rows = []
    for word, prons in sorted(phone_lexicon.prons.items()):
        for pron in prons:
            rows.append([word] + list(pron))
    syl_rows, syllable_table = lexicon_to_syllable(rows)

    counts = syllable_counts(syl_rows, transcripts)
    # ensure every lexicon syllable has a count entry so binding can
    # see zero-frequency syllables too
    for row in syl_rows:
        for s in row[1:]:
            counts.setdefault(s, 0)
    keep = set(keep_phones) | {phone_lexicon.sil_phone}
    for p in keep:
        counts[p] = max(counts.get(p, 0), bind_thresh)
    bind = bind_syllables(counts, thresh=bind_thresh)
    # syllables the reference prints as "Not bind" (no tone variant
    # above threshold) stay as themselves rather than being dropped —
    # dropping would leave words unpronounceable
    for s in counts:
        bind.setdefault(s, s)

    bound_rows = bind_lexicon(syl_rows, bind)
    lex_text = "\n".join(" ".join(r) for r in bound_rows)
    syl_lexicon = Lexicon.from_text(lex_text,
                                    sil_phone=phone_lexicon.sil_phone)

    units = sorted({s for row in bound_rows for s in row[1:]}
                   | {phone_lexicon.sil_phone})
    syllable_ids = {s: i + 1 for i, s in enumerate(units)}
    topo = HmmTopology.fake_ctc(sorted(syllable_ids.values()))
    return SyllableUnits(syl_lexicon, syllable_ids, bind,
                         syllable_table, topo)


def convert_alignments(
    units: SyllableUnits,
    phone_alis: Mapping[str, Sequence[int]],
    phone_names: Mapping[int, str],
) -> Dict[str, List[int]]:
    """Per-frame phone alignments -> per-frame syllable alignments
    (ali_to_syllable.py driven over a table, minus-one NOT applied —
    ids are 1-based; subtract one for CTC targets exactly like
    aslp-ali-minus-one does)."""
    return {
        utt: ali_to_syllable(ali, phone_names, units.syllable_ids,
                             units.bind)
        for utt, ali in phone_alis.items()
    }


def make_syllable_ctc_graph(units: SyllableUnits, G):
    """Syllable-level TLG (make_ctc_graph.sh --mono role)."""
    lang = Lang.build(units.lexicon)
    # lang phone ids are positions in the sorted unit set; map them to
    # the syllable output ids so net outputs line up with alignments
    id_map = {
        lang.phones.id(s): out_id
        for s, out_id in units.syllable_ids.items()
    }
    return make_ctc_decode_graph(lang, G,
                                 phone_to_output=lambda ph: id_map[ph])
