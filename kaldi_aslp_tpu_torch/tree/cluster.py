"""Gaussian clustering primitives for tree building.

A copy of kaldi_aslp_tpu/tree/cluster.py (numpy; the port imports
nothing of the JAX package).  Equivalent of the reference clustering
layer (reference:
src/tree/cluster-utils.{h,cc} — GaussClusterable, ClusterBottomUp,
ObjfGivenStats; src/tree/clusterable-classes.h).

A "clusterable" is the diagonal-Gaussian sufficient-statistics triple
(count, sum, sumsq); the objective is the expected log-likelihood of the
data under the ML Gaussian of the cluster.  Stats are tiny; numpy."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class GaussStats:
    """(reference: GaussClusterable)."""

    count: float
    sum: np.ndarray     # [D]
    sumsq: np.ndarray   # [D]

    @classmethod
    def zero(cls, dim: int) -> "GaussStats":
        return cls(0.0, np.zeros(dim), np.zeros(dim))

    @classmethod
    def from_frames(cls, frames: np.ndarray) -> "GaussStats":
        frames = np.asarray(frames, np.float64)
        return cls(float(len(frames)), frames.sum(0),
                   (frames ** 2).sum(0))

    def add(self, other: "GaussStats") -> "GaussStats":
        return GaussStats(self.count + other.count,
                          self.sum + other.sum,
                          self.sumsq + other.sumsq)

    def objf(self, var_floor: float = 0.01) -> float:
        """Expected loglike under the ML diagonal Gaussian
        (reference: cluster-utils.cc ObjfGivenStats / GaussClusterable::
        Objf)."""
        if self.count <= 0:
            return 0.0
        mean = self.sum / self.count
        var = np.maximum(self.sumsq / self.count - mean ** 2, var_floor)
        d = len(mean)
        return float(
            -0.5 * self.count
            * (d * (np.log(2 * np.pi) + 1.0) + np.log(var).sum())
        )


def merge_objf_loss(a: GaussStats, b: GaussStats) -> float:
    """Likelihood loss of merging two clusters (always >= 0)."""
    return a.objf() + b.objf() - a.add(b).objf()


def cluster_bottom_up(
    stats: List[GaussStats], num_clusters: int
) -> List[int]:
    """Agglomerative clustering to num_clusters
    (reference: cluster-utils.cc ClusterBottomUp).  Returns assignment
    list (index → cluster id in [0, num_clusters))."""
    n = len(stats)
    if num_clusters >= n:
        return list(range(n))
    clusters: Dict[int, GaussStats] = {i: stats[i] for i in range(n)}
    members: Dict[int, List[int]] = {i: [i] for i in range(n)}
    while len(clusters) > num_clusters:
        best = None
        keys = sorted(clusters)
        for i_pos, i in enumerate(keys):
            for j in keys[i_pos + 1:]:
                loss = merge_objf_loss(clusters[i], clusters[j])
                if best is None or loss < best[0]:
                    best = (loss, i, j)
        _, i, j = best
        clusters[i] = clusters[i].add(clusters.pop(j))
        members[i].extend(members.pop(j))
    out = [0] * n
    for cid, (key, mem) in enumerate(sorted(members.items())):
        for m in mem:
            out[m] = cid
    return out


def kmeans_cluster(
    vectors: np.ndarray, k: int, num_iters: int = 20, seed: int = 0
) -> np.ndarray:
    """Plain k-means (reference: the ASLP CD-phone k-means variants,
    aslp-bin/aslp-acc-tree-stats-cd-phone-kmeans.cc role)."""
    rng = np.random.RandomState(seed)
    vectors = np.asarray(vectors, np.float64)
    n = len(vectors)
    k = min(k, n)
    centers = vectors[rng.choice(n, k, replace=False)]
    assign = np.zeros(n, np.int64)
    for _ in range(num_iters):
        d = ((vectors[:, None, :] - centers[None]) ** 2).sum(-1)
        new_assign = d.argmin(1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for c in range(k):
            mask = assign == c
            if mask.any():
                centers[c] = vectors[mask].mean(0)
    return assign
