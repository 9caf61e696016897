"""Padded batches of whole utterances, as a sequence trainer or a batch
scorer takes them.  Features are standard normal (as after mean and
variance normalisation)."""

from __future__ import annotations

from typing import List

import numpy as np

from portbench.harness.traffic import Item, length_grid, round_up


def generate(p: dict, rng: np.random.Generator, feat_dim: int,
             num_targets: int) -> List[Item]:
    """``p["batches"]`` padded batches of ``p["streams"]`` utterances,
    longest first: feats [S, T, D] float32, mask [S, T], input_lengths
    [S] and, with ``frames_per_label``, labels [S, U] int32 (a length's
    floor over frames_per_label ids uniform in [label_min, num_targets))
    and label_lengths [S].  T and U are padded up to multiples of
    ``pad_time_to`` and ``pad_labels_to``."""
    S = p["streams"]
    lengths = np.sort(length_grid(S, p["length_min"], p["length_max"]))[::-1]
    T = round_up(int(lengths[0]), p["pad_time_to"])
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    out = []
    for _ in range(p["batches"]):
        feats = rng.standard_normal((S, T, feat_dim), dtype=np.float32)
        feats *= mask[:, :, None]
        item = {"feats": feats, "mask": mask.copy(),
                "input_lengths": lengths.astype(np.int32)}
        if "frames_per_label" in p:
            lab_lens = (lengths // p["frames_per_label"]).astype(np.int32)
            U = round_up(int(lab_lens.max()), p["pad_labels_to"])
            ids = rng.integers(p["label_min"], num_targets, (S, U),
                               dtype=np.int32)
            ids *= np.arange(U)[None, :] < lab_lens[:, None]
            item["labels"], item["label_lengths"] = ids, lab_lens
        out.append(item)
    return out
