"""Diagonal-covariance GMM acoustic models, batched over all pdfs.

Port of kaldi_aslp_tpu/gmm/diag_gmm.py:26-280 (reference:
src/gmm/diag-gmm.{h,cc}, am-diag-gmm.{h,cc}, mle-am-diag-gmm.{h,cc}).
The whole acoustic model (all pdfs) is one padded triple (weights
[P, M], means [P, M, D], vars [P, M, D]; a gaussian is live where its
weight is > 0), so the log-likelihoods of every pdf for a block of
frames are two matrix products and a logsumexp; the statistics of a
block are products with a one-hot of the aligned pdfs; the update
itself is host numpy.

What differs from the JAX module, and why:
  - the likelihoods, posteriors and statistics are computed in float64
    on the device and handed out in float32 (JAX's dtype).  The Viterbi
    DP on them is exact float32 adds and maxima, so scores that enter it
    with the same bits give the same alignments; float64 makes the card
    and the CPU round to the same float32 values (their exp, log and
    summation orders differ by far less than a float32 step), and the
    monophone chain then makes the same choices on both;
  - the statistics are one-hot products, not scatter-adds: an add of
    float values by ``index_add_`` on CUDA lands in a varying order, and
    ``mle_update``'s occupancy floor and ``split_gaussians``' argmax turn
    a flipped last bit into a different model.  A product has a fixed
    order, so two runs give the same bits;
  - the JAX module pads frame counts to 512-frame buckets
    (``gmm_loglikes_bucketed``) and 16,384-frame blocks to bound XLA's
    compiles; the port runs eagerly and does not pad.

``split_gaussians`` draws from ``np.random.RandomState(seed)``, as JAX
does, so both packages split alike."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.utils.device import resolve_device

LOG_2PI = float(np.log(2.0 * np.pi))
# frames a statistics product takes at once: bounds the [frames, P * M]
# one-hot operand (float64) to a few hundred MB at a thousand gaussians
STATS_BLOCK = 16384

Packed = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass
class AmDiagGmm:
    """All pdfs, gauss-padded to M_max (mask = weight > 0)."""

    weights: np.ndarray  # [P, M] (zero rows padded)
    means: np.ndarray    # [P, M, D]
    vars: np.ndarray     # [P, M, D] (padded entries = 1.0)

    @property
    def num_pdfs(self) -> int:
        return self.weights.shape[0]

    @property
    def max_gauss(self) -> int:
        return self.weights.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[2]

    @property
    def num_gauss_per_pdf(self) -> np.ndarray:
        return (self.weights > 0).sum(axis=1)

    @classmethod
    def flat_init(cls, num_pdfs: int, dim: int,
                  glob_mean: np.ndarray, glob_var: np.ndarray
                  ) -> "AmDiagGmm":
        """One gaussian per pdf at the global stats (reference:
        gmm-init-mono.cc flat start)."""
        return cls(
            weights=np.ones((num_pdfs, 1), np.float32),
            means=np.tile(glob_mean.astype(np.float32)[None, None],
                          (num_pdfs, 1, 1)),
            vars=np.tile(glob_var.astype(np.float32)[None, None],
                         (num_pdfs, 1, 1)),
        )

    def pack(self, device: Union[str, torch.device] = "cuda") -> Packed:
        """The model's tensors on ``device`` for scoring."""
        dev = resolve_device(device)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (self.weights, self.means, self.vars))


def _gconst(weights: torch.Tensor, means: torch.Tensor,
            variances: torch.Tensor) -> torch.Tensor:
    """[P, M] (float64): log weight - (D log 2 pi + sum log var +
    sum mean^2 / var) / 2."""
    w, mu, var = weights.double(), means.double(), variances.double()
    return (torch.log(torch.clamp(w, min=1e-37))
            - 0.5 * (mu.shape[-1] * LOG_2PI + torch.log(var).sum(-1)
                     + (mu * mu / var).sum(-1)))


def component_loglikes(feats: torch.Tensor, weights: torch.Tensor,
                       means: torch.Tensor, variances: torch.Tensor
                       ) -> torch.Tensor:
    """[T, D] -> [T, P, M] (float64): log weight + log N of every gaussian
    of every pdf, -1e30 on empty slots; two products over all P * M
    gaussians on the tensors' device."""
    P, M, D = means.shape
    x = feats.to(means.device, torch.float64)
    inv_var = 1.0 / variances.double()
    mean_iv = means.double() * inv_var
    quad = (x * x) @ inv_var.reshape(P * M, D).t()
    lin = x @ mean_iv.reshape(P * M, D).t()
    ll = (_gconst(weights, means, variances).reshape(1, P * M)
          - 0.5 * quad + lin).reshape(-1, P, M)
    return torch.where(weights[None] > 0, ll, torch.full_like(ll, -1e30))


def gmm_loglikes(feats: torch.Tensor, weights: torch.Tensor,
                 means: torch.Tensor, variances: torch.Tensor
                 ) -> torch.Tensor:
    """[T, D] -> [T, P] (float32): per-frame log-likelihood of every pdf
    (reference: DiagGmm::LogLikelihoods looped per pdf,
    decodable-am-diag-gmm.h per frame)."""
    return torch.logsumexp(
        component_loglikes(feats, weights, means, variances), dim=-1).float()


def corpus_loglikes(feats: Dict[str, np.ndarray], utts: Iterable[str],
                    packed: Packed, block_frames: int = 65536
                    ) -> Dict[str, np.ndarray]:
    """Per-utterance GMM loglikes over concatenated frame blocks, one
    upload and one read a block; returns utt -> [T, P] float32."""
    out: Dict[str, np.ndarray] = {}
    device = packed[0].device
    block, names = [], []
    n = 0

    def flush():
        if not names:
            return
        F = torch.from_numpy(np.concatenate(block).astype(np.float32))
        ll = gmm_loglikes(F.to(device), *packed).cpu().numpy()
        off = 0
        for u, t in names:
            out[u] = ll[off:off + t]
            off += t
        block.clear()
        names.clear()

    for u in utts:
        f = np.asarray(feats[u], np.float32)
        block.append(f)
        names.append((u, len(f)))
        n += len(f)
        if n >= block_frames:
            flush()
            n = 0
    flush()
    return out


def gmm_posteriors_for_alignment(feats: torch.Tensor, pdf_ids: torch.Tensor,
                                 weights: torch.Tensor, means: torch.Tensor,
                                 variances: torch.Tensor) -> torch.Tensor:
    """[T, D], [T] -> [T, M] (float64) gaussian posteriors within each
    frame's aligned pdf (reference: mle-am-diag-gmm.cc
    AccumulateForGmm)."""
    w = weights[pdf_ids].double()                 # [T, M]
    mu = means[pdf_ids].double()                  # [T, M, D]
    var = variances[pdf_ids].double()
    diff = feats.double()[:, None, :] - mu
    ll = (torch.log(torch.clamp(w, min=1e-37))
          - 0.5 * (mu.shape[-1] * LOG_2PI + torch.log(var).sum(-1))
          - 0.5 * (diff * diff / var).sum(-1))
    ll = torch.where(w > 0, ll, torch.full_like(ll, -1e30))
    return torch.softmax(ll, dim=-1)


def accumulate_gmm_stats(feats: torch.Tensor, pdf_ids: torch.Tensor,
                         frame_weights: torch.Tensor, weights: torch.Tensor,
                         means: torch.Tensor, variances: torch.Tensor,
                         occ: torch.Tensor, mean_acc: torch.Tensor,
                         var_acc: torch.Tensor) -> None:
    """Add the sufficient statistics of ``feats`` aligned to ``pdf_ids``
    into ``occ`` [P, M], ``mean_acc`` [P, M, D] and ``var_acc`` (float64
    accumulators, in place): per block of frames the posteriors, weighted
    by ``frame_weights`` [T], spread over a one-hot of the pdfs and
    contracted with the features and their squares."""
    P, M, D = means.shape
    for t0 in range(0, len(feats), STATS_BLOCK):
        f = feats[t0:t0 + STATS_BLOCK].double()
        ids = pdf_ids[t0:t0 + STATS_BLOCK].long()
        gamma = gmm_posteriors_for_alignment(f, ids, weights, means,
                                             variances)
        gamma = gamma * frame_weights[t0:t0 + STATS_BLOCK].double()[:, None]
        spread = torch.zeros((len(f), P, M), dtype=torch.float64,
                             device=f.device)
        spread[torch.arange(len(f), device=f.device), ids] = gamma
        spread = spread.reshape(len(f), P * M)
        occ += (spread.t() @ torch.ones((len(f), 1), dtype=torch.float64,
                                        device=f.device)).reshape(P, M)
        mean_acc += (spread.t() @ f).reshape(P, M, D)
        var_acc += (spread.t() @ (f * f)).reshape(P, M, D)


class GmmStats:
    """Float64 accumulators on the model's device."""

    def __init__(self, am: AmDiagGmm,
                 device: Union[str, torch.device] = "cuda"):
        P, M, D = am.num_pdfs, am.max_gauss, am.dim
        dev = resolve_device(device)
        self.occ = torch.zeros((P, M), dtype=torch.float64, device=dev)
        self.mean_acc = torch.zeros((P, M, D), dtype=torch.float64,
                                    device=dev)
        self.var_acc = torch.zeros((P, M, D), dtype=torch.float64,
                                   device=dev)

    def accumulate(self, am_packed: Packed, feats, pdf_ids,
                   frame_weights=None) -> None:
        dev = self.occ.device
        feats = torch.as_tensor(np.asarray(feats, np.float32)).to(dev)
        pdf_ids = torch.as_tensor(np.asarray(pdf_ids, np.int64)).to(dev)
        if frame_weights is None:
            frame_weights = torch.ones(len(pdf_ids), device=dev)
        else:
            frame_weights = torch.as_tensor(
                np.asarray(frame_weights, np.float32)).to(dev)
        accumulate_gmm_stats(feats, pdf_ids, frame_weights, *am_packed,
                             self.occ, self.mean_acc, self.var_acc)

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(occ, mean_acc, var_acc) in float32, JAX's dtype."""
        return tuple(t.float().cpu().numpy()
                     for t in (self.occ, self.mean_acc, self.var_acc))


def mle_update(
    am: AmDiagGmm,
    occ: np.ndarray,
    mean_acc: np.ndarray,
    var_acc: np.ndarray,
    min_gaussian_occupancy: float = 10.0,
    variance_floor: float = 1e-3,
    weight_floor: float = 1e-5,
) -> AmDiagGmm:
    """MLE re-estimation (reference: mle-diag-gmm.cc MleDiagGmmUpdate)."""
    new = AmDiagGmm(am.weights.copy(), am.means.copy(), am.vars.copy())
    for p in range(am.num_pdfs):
        active = am.weights[p] > 0
        tot = occ[p, active].sum()
        if tot < 1e-8:
            continue
        for m in np.where(active)[0]:
            if occ[p, m] < min_gaussian_occupancy:
                continue  # keep old params for starved gaussians
            mean = mean_acc[p, m] / occ[p, m]
            var = var_acc[p, m] / occ[p, m] - mean * mean
            new.means[p, m] = mean
            new.vars[p, m] = np.maximum(var, variance_floor)
        w = np.maximum(occ[p] * active, 0.0)
        w = np.maximum(w / max(w.sum(), 1e-8), weight_floor * active)
        new.weights[p] = (w / w.sum() * active).astype(np.float32)
    return new


def split_gaussians(am: AmDiagGmm, target_total: int,
                    occ: Optional[np.ndarray] = None,
                    perturb: float = 0.01,
                    seed: int = 0) -> AmDiagGmm:
    """Mix up toward target total gaussians by splitting the
    highest-occupancy components (reference: am-diag-gmm.cc
    SplitByCount / diag-gmm.cc Split)."""
    rng = np.random.RandomState(seed)
    P, M, D = am.num_pdfs, am.max_gauss, am.dim
    counts = (occ if occ is not None
              else am.weights.astype(np.float64)).copy()
    num_g = am.num_gauss_per_pdf.sum()
    n_splits = max(0, target_total - int(num_g))
    # grow padding if needed
    need_m = M
    per_pdf = am.num_gauss_per_pdf.astype(np.int64).copy()
    flat = []
    for _ in range(n_splits):
        p, m = np.unravel_index(np.argmax(counts), counts.shape)
        per_pdf[p] += 1
        need_m = max(need_m, int(per_pdf[p]))
        counts[p, m] /= 2.0
        flat.append((int(p), int(m)))
    new = AmDiagGmm(
        weights=np.zeros((P, need_m), np.float32),
        means=np.zeros((P, need_m, D), np.float32),
        vars=np.ones((P, need_m, D), np.float32),
    )
    new.weights[:, :M] = am.weights
    new.means[:, :M] = am.means
    new.vars[:, :M] = am.vars
    next_slot = am.num_gauss_per_pdf.astype(np.int64).copy()
    for (p, m) in flat:
        s = int(next_slot[p])
        next_slot[p] += 1
        std = np.sqrt(new.vars[p, m])
        delta = perturb * std * rng.randn(D).astype(np.float32)
        new.weights[p, s] = new.weights[p, m] / 2
        new.weights[p, m] /= 2
        new.means[p, s] = new.means[p, m] - delta
        new.means[p, m] = new.means[p, m] + delta
        new.vars[p, s] = new.vars[p, m]
    return new
