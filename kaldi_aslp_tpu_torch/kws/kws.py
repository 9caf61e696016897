"""Keyword spotting: keyword-filler token passing over posteriors.

Port of kaldi_aslp_tpu/kws/kws.py (reference:
src/aslp-kws/keyword-spot.h:19-160 KeywordSpot, token passing over a
keyword-filler graph fed per-frame posteriors, confidence = best
keyword-path score; src/aslp-kws/fst.{h,cc}; aslp-kwsbin/aslp-kws-score.cc).

The posteriors come from the device once an utterance (a tensor is
copied to the host in one piece); the DP runs on the host in float64
numpy, as JAX's does.  It is a few lanes a keyword and one small step a
frame, so on the card it would be nothing but launches.  Its rules are
JAX's: every lane reads the previous frame's tokens (a synchronous
update); of self-loop, advance and enter the first maximum wins, so on a
tie the self-loop keeps its token; a keyword completes once its last
lane has seen at least as many frames as the keyword has units, and a
later completion replaces the best only with a strictly higher
confidence."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from kaldi_aslp_tpu_torch.utils.config import Config


@dataclasses.dataclass
class KwsOptions(Config):
    confidence_threshold: float = 0.5
    filler_score_mode: str = "one_minus"  # one_minus | max_filler


@dataclasses.dataclass
class KeywordResult:
    keyword: str
    confidence: float
    end_frame: int
    start_frame: int


NEG = -1e30


class KeywordSpotter:
    """Token passing for one or more keywords given unit posteriors.

    Each keyword is a sequence of posterior-column indices (e.g. phone
    or pdf ids).  A filler lane absorbs non-keyword frames; a keyword
    token advances through its unit lanes with self-loops.  Confidence
    of a completed keyword = exp(mean per-frame log posterior along its
    best path) (reference: keyword-spot.h confidence computation)."""

    def __init__(self, keywords: Dict[str, Sequence[int]],
                 opts: Optional[KwsOptions] = None):
        self.opts = opts or KwsOptions()
        self.keywords = {k: list(v) for k, v in keywords.items()}

    def _filler_logp(self, post: np.ndarray, kw_cols: List[int]
                     ) -> np.ndarray:
        if self.opts.filler_score_mode == "one_minus":
            p = 1.0 - post[:, kw_cols].sum(axis=1)
        else:
            mask = np.ones(post.shape[1], bool)
            mask[kw_cols] = False
            p = post[:, mask].max(axis=1)
        return np.log(np.maximum(p, 1e-10))

    def spot(self, posteriors) -> List[KeywordResult]:
        """[T, P] posteriors (array, or a tensor on any device) ->
        detections (the best hit a keyword)."""
        if torch.is_tensor(posteriors):
            posteriors = posteriors.detach().cpu().numpy()
        post = np.asarray(posteriors, np.float64)
        results = []
        for name, cols in self.keywords.items():
            best = self._spot_one(name, post, cols)
            if best is not None:
                results.append(best)
        return results

    def _spot_one(self, name: str, post: np.ndarray, cols: List[int]
                  ) -> Optional[KeywordResult]:
        filler = self._filler_logp(post, cols)
        n = len(cols)
        unit_lp = np.log(np.maximum(post[:, cols], 1e-10))  # [T, n]
        # per-lane token: (cumulative path score incl. filler prefix,
        # entry frame, filler score at entry, frames in keyword)
        score = np.full(n, NEG)
        entry = np.full(n, -1, np.int64)
        entry_fs = np.zeros(n)
        frames = np.zeros(n, np.int64)
        filler_score = 0.0
        best: Optional[KeywordResult] = None
        for t in range(len(post)):
            # the token each lane may take over instead of its own: lane
            # i - 1's from the previous frame, or for lane 0 a new entry
            prev_score = np.concatenate([[filler_score], score[:-1]])
            prev_entry = np.concatenate([[t], entry[:-1]])
            prev_fs = np.concatenate([[filler_score], entry_fs[:-1]])
            prev_frames = np.concatenate([[0], frames[:-1]])
            # max() keeps the first maximum: the self-loop wins a tie
            take = prev_score > score
            s = np.where(take, prev_score, score)
            alive = s > NEG
            score = np.where(alive, s + unit_lp[t], NEG)
            entry = np.where(alive, np.where(take, prev_entry, entry), -1)
            entry_fs = np.where(alive, np.where(take, prev_fs, entry_fs),
                                0.0)
            frames = np.where(alive, np.where(take, prev_frames, frames)
                              + 1, 0)
            # keyword completion: confidence = geometric-mean unit
            # posterior along the keyword segment (reference:
            # keyword-spot.h confidence)
            if score[-1] > NEG and frames[-1] >= n:
                kw_lp = score[-1] - entry_fs[-1]
                conf = float(np.exp(kw_lp / max(frames[-1], 1)))
                if conf >= self.opts.confidence_threshold and (
                    best is None or conf > best.confidence
                ):
                    best = KeywordResult(name, conf, t, int(entry[-1]))
            filler_score += filler[t]
        return best
