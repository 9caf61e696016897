"""Mandarin syllable modelling units.

Replaces (reference): aslp_scripts/syllable/ — the syllable-unit prep
chain used for syllable-CE / syllable-CTC training:
  - convert_lexicon_to_syllable.py:4-40 (initial+final -> syllable
    lexicon + syllable->phones table),
  - bind_syllable.py:13-31 (tone binding of low-frequency syllables),
  - bind_lexicon.py:14-22 (apply the bind map to a lexicon),
  - ali_to_syllable.py:28-57 (per-frame phone alignment -> per-frame
    syllable alignment).

The reference treats a Mandarin syllable as (optional initial
consonant) + final-with-tone; phone lexica list initials and finals as
separate phones, so a syllable inventory is derived mechanically by
pairing each initial with the following final.  Low-frequency tonal
syllables are bound to the highest-frequency tone variant of the same
base syllable so the output layer stays dense.

Port of kaldi_aslp_tpu/ops/syllable.py: plain Python, copied as it is.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

# Mandarin initials (shengmu), as in the reference scripts
# (convert_lexicon_to_syllable.py:4-5).
CONSONANTS = frozenset([
    "b", "c", "ch", "d", "f", "g", "h", "j", "k", "l", "m", "n",
    "p", "q", "r", "s", "sh", "t", "w", "x", "y", "z", "zh",
])


def phones_to_syllables(phones: Sequence[str]) -> List[str]:
    """Group a phone sequence into syllables: each initial consonant
    pairs with the following final; finals without an initial stand
    alone (so do silence/noise phones)."""
    out: List[str] = []
    i = 0
    while i < len(phones):
        if phones[i] in CONSONANTS:
            if i + 1 >= len(phones):
                raise ValueError(
                    "initial consonant %r at end of pronunciation %r"
                    % (phones[i], list(phones)))
            out.append(phones[i] + phones[i + 1])
            i += 2
        else:
            out.append(phones[i])
            i += 1
    return out


def lexicon_to_syllable(
    lexicon: Iterable[Sequence[str]],
) -> Tuple[List[List[str]], Dict[str, str]]:
    """Convert a phone lexicon to a syllable lexicon.

    ``lexicon`` yields ``[word, phone1, phone2, ...]`` rows.  Returns
    ``(syllable_lexicon_rows, syllable_table)`` where the table maps
    each syllable to its space-joined phone decomposition (the stdout
    side of convert_lexicon_to_syllable.py:36-39)."""
    table: Dict[str, str] = {}
    rows: List[List[str]] = []
    for entry in lexicon:
        word, phones = entry[0], list(entry[1:])
        sylls = phones_to_syllables(phones)
        i = 0
        for s in sylls:
            if phones[i] in CONSONANTS:
                table[s] = phones[i] + " " + phones[i + 1]
                i += 2
            else:
                table[s] = phones[i]
                i += 1
        rows.append([word] + sylls)
    return rows, dict(sorted(table.items()))


def bind_syllables(counts: Mapping[str, int],
                   thresh: int = 50) -> Dict[str, str]:
    """Bind low-frequency tonal syllables to the max-count tone variant
    of the same base syllable (bind_syllable.py:13-31).

    A syllable with count >= thresh maps to itself.  Below the
    threshold, the trailing tone digit is stripped and tones 1..5 are
    scanned for the highest-count variant; if none exists the syllable
    is left out of the map (the reference prints "Not bind")."""
    mapping: Dict[str, str] = {}
    for syll, count in counts.items():
        if count >= thresh:
            mapping[syll] = syll
            continue
        base = syll[:-1]
        best_count, best = 0, None
        for tone in range(1, 6):
            cand = base + str(tone)
            if cand in counts and counts[cand] > best_count:
                best_count, best = counts[cand], cand
        if best is not None:
            mapping[syll] = best
    return mapping


def bind_lexicon(lexicon: Iterable[Sequence[str]],
                 bind: Mapping[str, str]) -> List[List[str]]:
    """Apply a bind map to a syllable lexicon (bind_lexicon.py:14-22);
    every syllable must be covered by the map."""
    out: List[List[str]] = []
    for entry in lexicon:
        word, sylls = entry[0], entry[1:]
        out.append([word] + [bind[s] for s in sylls])
    return out


def syllable_counts(
    lexicon: Iterable[Sequence[str]],
    transcripts: Iterable[Sequence[str]],
) -> Dict[str, int]:
    """Count syllable occurrences over transcripts through a syllable
    lexicon (the count file consumed by bind_syllable.py)."""
    pron = {entry[0]: list(entry[1:]) for entry in lexicon}
    counts: Dict[str, int] = {}
    for words in transcripts:
        for w in words:
            for s in pron.get(w, ()):
                counts[s] = counts.get(s, 0) + 1
    return counts


def ali_to_syllable(
    phone_ali: Sequence[int],
    phone_names: Mapping[int, str],
    syllable_ids: Mapping[str, int],
    bind: Mapping[str, str],
) -> List[int]:
    """Convert a per-frame phone alignment to a per-frame syllable
    alignment (ali_to_syllable.py:28-57).

    Consecutive runs of one phone are one phone instance; a consonant
    instance merges with the following final instance into one syllable
    spanning both runs.  Every frame of the span gets the (bound)
    syllable id, so output length equals input length."""
    out: List[int] = []
    n = len(phone_ali)
    cur = 0
    while cur < n:
        start = cur
        phone = phone_names[phone_ali[cur]]
        while cur < n and phone_names[phone_ali[cur]] == phone:
            cur += 1
        if phone in CONSONANTS:
            if cur >= n:
                raise ValueError(
                    "alignment ends inside initial consonant %r" % phone)
            final = phone_names[phone_ali[cur]]
            while cur < n and phone_names[phone_ali[cur]] == final:
                cur += 1
            syllable = phone + final
        else:
            syllable = phone
        bound = bind.get(syllable, syllable)
        if bound not in syllable_ids:
            raise KeyError("syllable %r (bound %r) not in syllable table"
                           % (syllable, bound))
        out.extend([syllable_ids[bound]] * (cur - start))
    assert len(out) == len(phone_ali)
    return out
