"""Batched corpus feature extraction: one call per bucket of lengths.

Port of kaldi_aslp_tpu/feats/batch.py:30 ``compute_batched``: the
utterances are grouped by their length rounded up to whole seconds of
samples, each group is stacked into a zero-padded [B, samples] batch and
extracted by one ``extractor.compute`` call on its device, and each
utterance is trimmed to its own frame count.  The JAX version pads each
group to one program shape for XLA; here the batching only gives the
card enough work per call.  The JAX version's ``key`` is a
``torch.Generator``: without one nothing is dithered, with one each
utterance draws its noise from it in turn."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from kaldi_aslp_tpu_torch.feats.window import num_frames


def compute_batched(extractor, waves: Dict[str, np.ndarray],
                    batch_size: int = 64,
                    generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
    """{utt: [samples]} -> {utt: [frames, dim]} on ``extractor.device``,
    for any extractor with a batched ``compute(wav [..., samples],
    generator)`` (``Mfcc``, ``Fbank``); dithered only when ``generator``
    is given."""
    bucket = int(extractor.frame_opts.samp_freq)  # 1 s of samples
    groups: Dict[int, list] = {}
    for u, w in waves.items():
        padded = int(np.ceil(max(len(w), 1) / bucket)) * bucket
        groups.setdefault(padded, []).append(u)
    out: Dict[str, torch.Tensor] = {}
    for padded, utts in sorted(groups.items()):
        for i in range(0, len(utts), batch_size):
            chunk = utts[i:i + batch_size]
            arr = np.zeros((len(chunk), padded), np.float32)
            for j, u in enumerate(chunk):
                arr[j, :len(waves[u])] = waves[u]
            feats = extractor.compute(
                torch.from_numpy(arr).to(extractor.device), generator)
            for j, u in enumerate(chunk):
                out[u] = feats[j, :num_frames(len(waves[u]),
                                              extractor.frame_opts)]
    return out
