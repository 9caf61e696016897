"""Keyword-filler graph construction and simulation-ali mapping.

Port of kaldi_aslp_tpu/kws/text_fst.py (reference:
aslp_scripts/kws/gen_text_fst.py:19-50, the keyword-filler phone FST in
OpenFst text form that aslp-kws-score consumes, and
generate_simulation_ali.py, which hands the clean alignments to the
perturbed copies of the same utterances).  Plain text: the FST's lines
are the JAX package's, byte for byte."""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Mapping, Sequence


def build_keyword_filler_text_fst(
    keywords: Mapping[str, Sequence[str]],
    sil: str = "sil",
    filler: str = "<gbg>",
) -> str:
    """Text-form keyword-filler FST: states 0 (start), 1 (silence),
    2 (filler), then one lane chain per keyword; the last keyword arc
    emits the keyword symbol (gen_text_fst.py:19-50 layout)."""
    out: List[str] = []
    # start/silence/filler core
    out.append("0 1 %s <eps>" % sil)
    out.append("0 2 %s <eps>" % filler)
    out.append("1 1 %s <eps>" % sil)
    out.append("1 2 %s <eps>" % filler)
    out.append("2 1 %s <eps>" % sil)
    out.append("2 2 %s <eps>" % filler)
    cur = 3
    for keyword, phones in keywords.items():
        phones = list(phones)
        if len(phones) < 2:
            raise ValueError("keyword %r needs >=2 phones" % keyword)
        for src in (0, 1, 2):
            out.append("%d %d %s <eps>" % (src, cur, phones[0]))
        for i in range(len(phones) - 1):
            out.append("%d %d %s <eps>" % (cur, cur, phones[i]))
            if i != len(phones) - 2:
                out.append("%d %d %s <eps>"
                           % (cur, cur + 1, phones[i + 1]))
            else:
                out.append("%d %d %s %s"
                           % (cur, cur + 1, phones[i + 1], keyword))
            cur += 1
        out.append("%d %d %s <eps>" % (cur, cur, phones[-1]))
        out.append("%d 1.0" % cur)
        cur += 1
    return "\n".join(out) + "\n"


_SIM_RE = re.compile(r"^simulation_[0-9]+_")


def simulation_ali(
    clean_ali: Mapping[str, Sequence[int]],
    sim_keys: Iterable[str],
) -> Dict[str, List[int]]:
    """Map ``simulation_<n>_<cleankey>`` utterance keys to the clean
    utterance's alignment (generate_simulation_ali.py)."""
    out: Dict[str, List[int]] = {}
    for key in sim_keys:
        m = _SIM_RE.search(key)
        if not m:
            continue
        clean_key = key[m.end():]
        if clean_key in clean_ali:
            out[key] = list(clean_ali[clean_key])
    return out
