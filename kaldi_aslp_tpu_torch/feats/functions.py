"""Post-processing feature transforms: deltas, splicing, CMVN and
sliding-window CMN.

Port of kaldi_aslp_tpu/feats/functions.py (``DeltaFeaturesOptions``,
``delta_scales``, ``add_deltas``, ``splice_frames``, ``acc_cmvn_stats``,
``apply_cmvn``, ``SlidingWindowCmnOptions``, ``sliding_window_cmn``;
reference: src/feat/feature-functions.{h,cc} DeltaFeatures,
SpliceFrames and SlidingWindowCmn, src/transform/cmvn.{h,cc}).
Deltas are gathers and weighted sums over a fixed context on the
features' device; CMVN stats keep the reference's 2 x (dim+1)
accumulator layout in float64, on the features' device, with each
utterance's sums taken on the host in numpy's order, as JAX's are."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.utils.config import Config


@dataclasses.dataclass
class DeltaFeaturesOptions(Config):
    order: int = 2
    window: int = 2  # context half-width per order


def delta_scales(opts: DeltaFeaturesOptions) -> List[np.ndarray]:
    """Per-order regression coefficient vectors (reference:
    feature-functions.cc DeltaFeatures::DeltaFeatures — iterated
    autocorrelation-normalized linear slopes)."""
    scales = [np.array([1.0], dtype=np.float64)]
    for _ in range(opts.order):
        prev = scales[-1]
        window = opts.window
        if window == 0:
            raise ValueError("delta window must be > 0")
        prev_offset = (len(prev) - 1) // 2
        cur_offset = prev_offset + window
        cur = np.zeros(len(prev) + 2 * window, dtype=np.float64)
        normalizer = 0.0
        for j in range(-window, window + 1):
            normalizer += j * j
            for k in range(-prev_offset, prev_offset + 1):
                cur[j + k + cur_offset] += j * prev[k + prev_offset]
        cur /= normalizer
        scales.append(cur)
    return [s.astype(np.float32) for s in scales]


def add_deltas(feats: torch.Tensor,
               opts: Optional[DeltaFeaturesOptions] = None) -> torch.Tensor:
    """[T, D] -> [T, D * (order + 1)] with edge-replicated context, the
    terms summed in the order of the JAX and numpy versions."""
    opts = opts or DeltaFeaturesOptions()
    T = feats.shape[0]
    frames = torch.arange(T, device=feats.device)
    outputs = []
    for scale in delta_scales(opts):
        offset = (len(scale) - 1) // 2
        acc = torch.zeros_like(feats)
        for j in range(-offset, offset + 1):
            w = float(scale[j + offset])
            if w == 0.0:
                continue
            acc = acc + w * feats[torch.clamp(frames + j, 0, T - 1)]
        outputs.append(acc)
    return torch.cat(outputs, dim=-1)


def splice_frames(feats: torch.Tensor, left: int, right: int
                  ) -> torch.Tensor:
    """[T, D] -> [T, D * (left + 1 + right)] frame splicing, the context
    clamped at both edges (reference: feature-functions.cc SpliceFrames;
    also the Splice component, nnet-various.h:43)."""
    T = feats.shape[0]
    frames = torch.arange(T, device=feats.device)
    return torch.cat([feats[torch.clamp(frames + off, 0, T - 1)]
                      for off in range(-left, right + 1)], dim=-1)


def acc_cmvn_stats(feats: Union[torch.Tensor, np.ndarray],
                   stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Accumulate ``feats`` [T, D] into the Kaldi 2 x (D+1) float64 stats
    matrix on the features' device: row 0 [sum_x..., count], row 1
    [sum_x^2..., 0].  Each utterance's sums are taken as the JAX package
    takes them: in numpy, on the host, in the features' own precision,
    frame after frame.  The order matters: a float32 sum of c0^2 (c0
    about 15-21, variance about 1) carries a relative error near
    T * 6e-8, and E[x^2] - E[x]^2 amplifies it by E[x^2] / var, about
    300, so another summation order moves the normalized c0 by up to
    5e-4 where every other dim moves by 1e-6."""
    t = torch.as_tensor(feats)
    f = t.detach().cpu().numpy()
    dim = f.shape[1]
    if stats is None:
        stats = torch.zeros((2, dim + 1), dtype=torch.float64,
                            device=t.device)
    sums = np.stack([f.sum(axis=0), (f ** 2).sum(axis=0)]).astype(np.float64)
    stats[:, :dim] += torch.from_numpy(sums).to(stats.device)
    stats[0, dim] += f.shape[0]
    return stats


def apply_cmvn(feats: torch.Tensor, stats: torch.Tensor,
               norm_vars: bool = False) -> torch.Tensor:
    """(reference: transform/cmvn.cc ApplyCmvn)."""
    dim = stats.shape[1] - 1
    count = float(stats[0, dim])
    if count < 1.0:
        raise ValueError("no frames in CMVN stats")
    mean = stats[0, :dim] / count
    out = feats - mean.to(feats.dtype)
    if norm_vars:
        var = stats[1, :dim] / count - mean * mean
        out = out * (1.0 / torch.sqrt(torch.clamp(var, min=1e-20))
                     ).to(feats.dtype)
    return out


@dataclasses.dataclass
class SlidingWindowCmnOptions(Config):
    cmn_window: int = 600
    min_window: int = 100
    normalize_variance: bool = False
    center: bool = False


def sliding_window_cmn(feats: torch.Tensor,
                       opts: Optional[SlidingWindowCmnOptions] = None
                       ) -> torch.Tensor:
    """Sliding-window CMN (reference: feature-functions.cc:311) on the
    features' device: each frame's window [s, e) mean is a difference of
    prefix sums, as in the JAX package, not the reference's per-frame
    window loop."""
    opts = opts or SlidingWindowCmnOptions()
    T, D = feats.shape
    zero = feats.new_zeros((1, D))
    csum = torch.cumsum(torch.cat([zero, feats]), dim=0)
    t = torch.arange(T, device=feats.device)
    if opts.center:
        s = torch.clamp(t - opts.cmn_window // 2, min=0)
        e = torch.clamp(s + opts.cmn_window, max=T)
        s = torch.clamp(torch.minimum(s, e - opts.cmn_window), min=0)
    else:
        # trailing window, but at least min_window frames at the start
        s = torch.clamp(t + 1 - opts.cmn_window, min=0)
        e = torch.clamp(t + 1, min=min(opts.min_window, T))
    counts = (e - s).to(feats.dtype)[:, None]
    means = (csum[e] - csum[s]) / counts
    out = feats - means
    if opts.normalize_variance:
        csum2 = torch.cumsum(torch.cat([zero, feats ** 2]), dim=0)
        var = (csum2[e] - csum2[s]) / counts - means ** 2
        out = out / torch.sqrt(torch.clamp(var, min=1e-10))
    return out
