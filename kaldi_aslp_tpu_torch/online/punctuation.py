"""CRF punctuation restoration for final recognition results.

Port of kaldi_aslp_tpu/online/punctuation.py (reference:
src/aslp-online/punctuation-processor.{h,cc} - each token is tagged
N/D/J/G/W = none/comma/period/exclamation/question and the
corresponding mark is appended; the reference tags UTF-8 characters,
this processor tags whatever tokens the recognizer emits).  The model is
the linear-chain CRF of ops/crf.py.  The feature hash and the window
features are bit-equal copies of the JAX package's, and ``save`` /
``load`` read and write its pickle (a dict of the four parameter arrays
as numpy), so a model written by either package loads in the other."""

from __future__ import annotations

import pickle
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.ops.crf import (
    CrfParams,
    crf_params_from_jax,
    crf_tag,
    crf_train,
)

TAGS = ["N", "D", "J", "G", "W"]
MARKS = {"N": "", "D": "，", "J": "。", "G": "！", "W": "？"}
NUM_FEATURES = 1 << 15
FEATS_PER_TOKEN = 5


def _h(s: str) -> int:
    h = 2166136261
    for ch in s.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return h % NUM_FEATURES


def token_features(tokens: Sequence[str]) -> np.ndarray:
    """[T, 5] hashed window features: unigram, prev, next, and the two
    bigrams (the CRF++ template role)."""
    T = len(tokens)
    out = np.full((T, FEATS_PER_TOKEN), -1, np.int32)
    for t, tok in enumerate(tokens):
        prev = tokens[t - 1] if t > 0 else "<s>"
        nxt = tokens[t + 1] if t + 1 < T else "</s>"
        out[t, 0] = _h("u:" + tok)
        out[t, 1] = _h("p:" + prev)
        out[t, 2] = _h("n:" + nxt)
        out[t, 3] = _h("pb:" + prev + "|" + tok)
        out[t, 4] = _h("nb:" + tok + "|" + nxt)
    return out


class PunctuationProcessor:
    """process(text) -> punctuated text (reference:
    PunctuationProcessor::Process); tags on the device of ``params``."""

    def __init__(self, params: CrfParams):
        self.params = params

    @classmethod
    def train(cls, corpus: Sequence[Tuple[Sequence[str], Sequence[str]]],
              num_epochs: int = 30, learn_rate: float = 0.5,
              seed: int = 0, device: Union[str, torch.device] = "cuda"
              ) -> "PunctuationProcessor":
        """corpus: list of (tokens, tags) with tags from N/D/J/G/W."""
        tag_id = {t: i for i, t in enumerate(TAGS)}
        data = []
        for tokens, tags in corpus:
            if len(tokens) != len(tags):
                raise ValueError("tokens/tags length mismatch")
            data.append((token_features(list(tokens)),
                         np.array([tag_id[t] for t in tags], np.int32)))
        params = crf_train(data, NUM_FEATURES, len(TAGS),
                           num_epochs=num_epochs, learn_rate=learn_rate,
                           seed=seed, device=device)
        return cls(params)

    def tag(self, tokens: Sequence[str]) -> List[str]:
        if not tokens:
            return []
        ids = crf_tag(self.params, token_features(list(tokens)))
        return [TAGS[i] for i in ids]

    def process(self, text: str, joiner: str = " ") -> str:
        """(reference: ConvertToInput/ConvertToOutput - here on
        whitespace tokens rather than UTF-8 characters)."""
        tokens = text.split()
        if not tokens:
            return text
        tags = self.tag(tokens)
        return joiner.join(tok + MARKS.get(tg, "")
                           for tok, tg in zip(tokens, tags))

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.params.numpy(), f)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda"
             ) -> "PunctuationProcessor":
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(crf_params_from_jax(d, device))
