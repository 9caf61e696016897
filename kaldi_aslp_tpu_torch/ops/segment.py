"""Forward-maximum-match word segmentation.

Port of kaldi_aslp_tpu/ops/segment.py (reference:
src/aslp-segment/forward-max-match.{h,cc}, the aslp-segment binary
aslp-forward-max-match-segment.cc): greedy longest-prefix dictionary
segmentation for Chinese text scoring.  Plain Python."""

from __future__ import annotations

from typing import Iterable, List, Set


class ForwardMaxMatch:
    def __init__(self, vocabulary: Iterable[str], max_word_len: int = 0):
        self.vocab: Set[str] = set(vocabulary)
        self.max_len = max_word_len or max(
            (len(w) for w in self.vocab), default=1
        )

    def segment(self, text: str) -> List[str]:
        out: List[str] = []
        i = 0
        n = len(text)
        while i < n:
            matched = None
            for length in range(min(self.max_len, n - i), 0, -1):
                cand = text[i:i + length]
                if cand in self.vocab:
                    matched = cand
                    break
            if matched is None:
                matched = text[i]  # OOV: single character
            out.append(matched)
            i += len(matched)
        return out
