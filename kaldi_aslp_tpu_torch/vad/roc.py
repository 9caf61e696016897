"""ROC / AUC / EER evaluation.

Port of kaldi_aslp_tpu/vad/roc.py (reference: src/aslp-vad/roc.h,
roc-test.cc; aslp_scripts/vad/calc_auc.sh, calc_eer.sh).  Host numpy in
float64, as JAX's: ``roc_curve`` takes its thresholds from
``np.quantile`` (``torch.quantile`` rounds otherwise), ``auc`` is the
rank statistic with the ranks of ties averaged, ``eer`` the ROC point of
400 where miss and false-alarm rates meet."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class RocPoint:
    threshold: float
    tpr: float  # true positive rate (recall)
    fpr: float  # false alarm rate


def roc_curve(scores: np.ndarray, labels: np.ndarray,
              num_points: int = 100) -> List[RocPoint]:
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, bool)
    pos = labels.sum()
    neg = len(labels) - pos
    if pos == 0 or neg == 0:
        raise ValueError("need both positive and negative labels")
    thresholds = np.quantile(scores, np.linspace(0, 1, num_points))
    points = []
    for th in thresholds:
        pred = scores >= th
        tp = (pred & labels).sum()
        fp = (pred & ~labels).sum()
        points.append(RocPoint(float(th), tp / pos, fp / neg))
    return points


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Exact AUC by the rank statistic (Mann-Whitney), ties at their
    average rank."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, bool)
    order = np.argsort(scores)
    ranks = np.empty(len(scores), np.float64)
    sorted_scores = scores[order]
    i = 0
    r = 1
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == \
                sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = (r + r + (j - i)) / 2.0
        r += j - i + 1
        i = j + 1
    pos = labels.sum()
    neg = len(labels) - pos
    if pos == 0 or neg == 0:
        raise ValueError("need both classes")
    return float(
        (ranks[labels].sum() - pos * (pos + 1) / 2.0) / (pos * neg)
    )


def eer(scores: np.ndarray, labels: np.ndarray) -> float:
    """Equal error rate: where miss rate == false alarm rate."""
    pts = roc_curve(scores, labels, num_points=400)
    best = min(pts, key=lambda p: abs((1 - p.tpr) - p.fpr))
    return float(((1 - best.tpr) + best.fpr) / 2.0)
