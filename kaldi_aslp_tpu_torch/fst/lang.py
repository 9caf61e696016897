"""Lexicon (L) and grammar (G) construction.

The port's own copy of the parts of kaldi_aslp_tpu/fst/lang.py it uses
(``Lexicon``, ``Lang``, ``make_lexicon_fst``, ``make_unigram_grammar``;
reference: egs/wsj/s5/utils/prepare_lang.sh, make_lexicon_fst.pl).
Host-side; outputs the port's Fst type."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

from kaldi_aslp_tpu_torch.fst.fst import EPS, Arc, Fst, SymbolTable


@dataclass
class Lexicon:
    """word -> list of pronunciations (phone string lists)."""

    prons: Dict[str, List[List[str]]] = field(default_factory=dict)
    sil_phone: str = "SIL"

    @classmethod
    def from_text(cls, text: str, sil_phone: str = "SIL") -> "Lexicon":
        """Parse lexicon.txt lines: WORD ph1 ph2 ..."""
        lex = cls(sil_phone=sil_phone)
        for line in text.strip().splitlines():
            parts = line.split()
            if not parts:
                continue
            lex.prons.setdefault(parts[0], []).append(parts[1:])
        return lex

    def phone_set(self) -> List[str]:
        phones = {self.sil_phone}
        for prons in self.prons.values():
            for p in prons:
                phones.update(p)
        return sorted(phones)


@dataclass
class Lang:
    """The lang-dir equivalent: symbol tables + L (reference: data/lang)."""

    phones: SymbolTable
    words: SymbolTable
    lexicon: Lexicon
    sil_phone_id: int

    @classmethod
    def build(cls, lexicon: Lexicon) -> "Lang":
        phones = SymbolTable()
        for p in lexicon.phone_set():
            phones.add(p)
        words = SymbolTable()
        for w in sorted(lexicon.prons):
            words.add(w)
        return cls(phones, words, lexicon, phones.id(lexicon.sil_phone))


def make_lexicon_fst(lang: Lang, sil_prob: float = 0.5) -> Fst:
    """L: phone -> word transducer with optional silence
    (reference: utils/make_lexicon_fst.pl)."""
    L = Fst()
    start = L.add_state()
    loop = L.add_state()
    L.set_start(start)
    L.set_final(loop)
    no_sil_cost = -math.log(max(1.0 - sil_prob, 1e-10))
    sil_cost = -math.log(max(sil_prob, 1e-10))
    sil = lang.sil_phone_id

    def sil_or_loop(src: int) -> None:
        """From src: go to loop directly (no sil) or via silence."""
        L.add_arc(src, Arc(EPS, EPS, no_sil_cost, loop))
        mid = L.add_state()
        L.add_arc(src, Arc(sil, EPS, sil_cost, mid))
        L.add_arc(mid, Arc(EPS, EPS, 0.0, loop))

    sil_or_loop(start)
    for word, prons in lang.lexicon.prons.items():
        wid = lang.words.id(word)
        for pron in prons:
            if not pron:
                continue
            cur = loop
            for i, ph in enumerate(pron):
                nxt = L.add_state()
                L.add_arc(cur, Arc(lang.phones.id(ph),
                                   wid if i == 0 else EPS, 0.0, nxt))
                cur = nxt
            sil_or_loop(cur)
    return L


def make_unigram_grammar(word_probs: Dict[str, float],
                         words: SymbolTable) -> Fst:
    """G: unigram loop acceptor (the yesno task.arpabo equivalent)."""
    G = Fst()
    s = G.add_state()
    G.set_start(s)
    G.set_final(s)
    for w, p in word_probs.items():
        G.add_arc(s, Arc(words.id(w), words.id(w),
                         -math.log(max(p, 1e-10)), s))
    return G
