"""Levenshtein edit distance + WER/TER scoring (reference:
src/util/edit-distance-inl.h LevenshteinEditDistance, src/bin/compute-wer.cc,
token-error-rate use in src/aslp-nnet/ctc-loss.cc:385).

Copy of the numpy module kaldi_aslp_tpu/ops/edit_distance.py: the port
imports nothing of the JAX package."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Plain Levenshtein distance."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = np.arange(n + 1)
    cur = np.empty(n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        cur[0] = i
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev, cur = cur, prev
    return int(prev[n])


@dataclass
class ErrorStats:
    insertions: int = 0
    deletions: int = 0
    substitutions: int = 0
    ref_length: int = 0
    num_sentences: int = 0
    num_wrong_sentences: int = 0

    @property
    def errors(self) -> int:
        return self.insertions + self.deletions + self.substitutions

    @property
    def wer(self) -> float:
        return 100.0 * self.errors / max(self.ref_length, 1)

    @property
    def ser(self) -> float:
        return 100.0 * self.num_wrong_sentences / max(self.num_sentences, 1)

    def report(self) -> str:
        # format mirrors compute-wer output the scripts parse
        return (
            f"%WER {self.wer:.2f} [ {self.errors} / {self.ref_length}, "
            f"{self.insertions} ins, {self.deletions} del, "
            f"{self.substitutions} sub ]"
        )


def align_errors(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int]:
    """Return (ins, del, sub) from a full DP alignment
    (reference: edit-distance-inl.h with traceback)."""
    m, n = len(ref), len(hyp)
    dp = np.zeros((m + 1, n + 1), dtype=np.int64)
    dp[:, 0] = np.arange(m + 1)
    dp[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            dp[i, j] = min(dp[i - 1, j] + 1, dp[i, j - 1] + 1,
                           dp[i - 1, j - 1] + cost)
    ins = dels = subs = 0
    i, j = m, n
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] and \
                ref[i - 1] == hyp[j - 1]:
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + 1:
            subs += 1
            i, j = i - 1, j - 1
        elif j > 0 and dp[i, j] == dp[i, j - 1] + 1:
            ins += 1
            j -= 1
        else:
            dels += 1
            i -= 1
    return ins, dels, subs


def score_utterances(
    refs: Dict[str, List], hyps: Dict[str, List]
) -> ErrorStats:
    """Aggregate WER over keyed utterances (reference: compute-wer.cc)."""
    stats = ErrorStats()
    for key, ref in refs.items():
        hyp = hyps.get(key, [])
        ins, dels, subs = align_errors(ref, hyp)
        stats.insertions += ins
        stats.deletions += dels
        stats.substitutions += subs
        stats.ref_length += len(ref)
        stats.num_sentences += 1
        if ins + dels + subs > 0:
            stats.num_wrong_sentences += 1
    return stats
