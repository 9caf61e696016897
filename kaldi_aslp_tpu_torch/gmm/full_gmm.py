"""Full-covariance GMMs.

Port of kaldi_aslp_tpu/gmm/full_gmm.py (reference: src/gmm/full-gmm.{h,cc},
mle-full-gmm.{h,cc}): the "full" half of "diagonal/full GMM + MLE/EBW".

The diagonal model's padded design: covariances are one [P, M, D, D]
array.  ``pack`` factors them on the host (Cholesky in float64, as JAX
does) and puts the model on the device (the card unless the caller asks
for the CPU); the log-likelihoods and the statistics run there in
float64 and are handed out in float32.

What differs from the JAX module, and why:
  - the log-likelihoods expand ||L^-1 (x - mu)||^2 into x' S x - 2 x' S mu
    + mu' S mu (S the precision) as products over all P * M gaussians,
    a block of frames at a time; JAX forms the [T, P, M, D] difference;
  - the statistics are one-hot products a block of frames at a time (a
    fixed summation order, the same bits run twice), where JAX loops
    over the pdfs on the host;
  - ``pack`` keeps float64 (JAX casts its factors to float32)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.gmm.diag_gmm import LOG_2PI, AmDiagGmm
from kaldi_aslp_tpu_torch.utils.device import resolve_device

FullPacked = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# elements of the largest float64 block operand ([T, P * M] or
# [T, M, D, D]): a few hundred MB
BLOCK_ELEMENTS = 1 << 25


@dataclass
class AmFullGmm:
    weights: np.ndarray  # [P, M]
    means: np.ndarray    # [P, M, D]
    covars: np.ndarray   # [P, M, D, D] (padded entries = I)

    @property
    def num_pdfs(self) -> int:
        return self.weights.shape[0]

    @property
    def dim(self) -> int:
        return self.means.shape[2]

    @classmethod
    def from_diag(cls, am: AmDiagGmm) -> "AmFullGmm":
        """(reference: full-gmm.cc CopyFromDiagGmm)."""
        P, M, D = am.num_pdfs, am.max_gauss, am.dim
        cov = np.zeros((P, M, D, D), np.float32)
        idx = np.arange(D)
        cov[:, :, idx, idx] = am.vars
        return cls(am.weights.copy(), am.means.copy(), cov)

    def to_diag(self) -> AmDiagGmm:
        idx = np.arange(self.dim)
        return AmDiagGmm(self.weights.copy(), self.means.copy(),
                         self.covars[:, :, idx, idx].copy())

    def pack(self, device: Union[str, torch.device] = "cuda") -> FullPacked:
        """(log w + gconst [P, M], means [P, M, D], inverse Cholesky
        factors [P, M, D, D], active [P, M]) on ``device``, float64."""
        D = self.dim
        chol = np.linalg.cholesky(self.covars + 1e-6 * np.eye(D))
        inv_chol = np.linalg.inv(chol)            # L^{-1}
        logdet = 2.0 * np.log(
            np.maximum(np.einsum("pmii->pmi", chol), 1e-20)).sum(-1)
        gconst = (np.log(np.maximum(self.weights, 1e-37))
                  - 0.5 * (D * LOG_2PI + logdet))
        dev = resolve_device(device)
        return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float64)
                                      ).to(dev)
                     for a in (gconst, self.means, inv_chol,
                               self.weights > 0))


def full_gmm_loglikes(feats, gconst: torch.Tensor, means: torch.Tensor,
                      inv_chol: torch.Tensor, active: torch.Tensor
                      ) -> torch.Tensor:
    """[T, D] -> [T, P] (float32) on the packed tensors' device
    (reference: full-gmm.cc LogLikelihoods):
    log N = gconst - ||L^-1 (x - mu)||^2 / 2."""
    P, M, D = means.shape
    dev = means.device
    x_all = torch.as_tensor(np.asarray(feats, np.float32)
                            if not torch.is_tensor(feats) else feats)
    prec = inv_chol.transpose(-1, -2) @ inv_chol          # [P, M, D, D]
    prec_mu = (prec @ means[..., None])[..., 0]           # [P, M, D]
    const = gconst - 0.5 * (means * prec_mu).sum(-1)      # [P, M]
    prec_flat = prec.reshape(P * M, D * D)
    block = max(1, BLOCK_ELEMENTS // max(P * M + D * D, 1))
    out = []
    for t0 in range(0, len(x_all), block):
        x = x_all[t0:t0 + block].to(dev, torch.float64)
        outer = (x[:, :, None] * x[:, None, :]).reshape(len(x), D * D)
        ll = (const.reshape(1, P * M) - 0.5 * outer @ prec_flat.t()
              + x @ prec_mu.reshape(P * M, D).t()).reshape(-1, P, M)
        ll = torch.where(active[None] > 0, ll, torch.full_like(ll, -1e30))
        out.append(torch.logsumexp(ll, dim=-1))
    return torch.cat(out).float()


def full_gmm_accumulate(am: AmFullGmm, feats: np.ndarray,
                        pdf_ids: np.ndarray,
                        device: Union[str, torch.device] = "cuda"
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """MLE stats (reference: mle-full-gmm.cc AccumulateFromFull):
    occ [P, M], mean acc [P, M, D], scatter acc [P, M, D, D] (float32),
    from gaussian posteriors within each frame's aligned pdf."""
    gconst, means, inv_chol, active = am.pack(device)
    dev = means.device
    P, M, D = means.shape
    x_all = torch.from_numpy(np.asarray(feats, np.float32)).to(dev)
    ids_all = torch.from_numpy(np.asarray(pdf_ids, np.int64)).to(dev)
    occ = torch.zeros(P * M, dtype=torch.float64, device=dev)
    macc = torch.zeros((P * M, D), dtype=torch.float64, device=dev)
    sacc = torch.zeros((P * M, D * D), dtype=torch.float64, device=dev)
    block = max(1, BLOCK_ELEMENTS // max(P * M + M * D * D, 1))
    for t0 in range(0, len(x_all), block):
        x = x_all[t0:t0 + block].double()
        ids = ids_all[t0:t0 + block]
        diff = x[:, None, :] - means[ids]                     # [T, M, D]
        z = (inv_chol[ids] @ diff[..., None])[..., 0]
        ll = gconst[ids] - 0.5 * (z * z).sum(-1)
        ll = torch.where(active[ids] > 0, ll, torch.full_like(ll, -1e30))
        gamma = torch.softmax(ll, dim=-1)                     # [T, M]
        spread = torch.zeros((len(x), P, M), dtype=torch.float64,
                             device=dev)
        spread[torch.arange(len(x), device=dev), ids] = gamma
        spread = spread.reshape(len(x), P * M)
        occ += spread.sum(0)
        macc += spread.t() @ x
        sacc += spread.t() @ (x[:, :, None] * x[:, None, :]).reshape(
            len(x), D * D)
    return (occ.reshape(P, M).float().cpu().numpy(),
            macc.reshape(P, M, D).float().cpu().numpy(),
            sacc.reshape(P, M, D, D).float().cpu().numpy())


def full_gmm_mle_update(
    am: AmFullGmm, occ, macc, sacc,
    min_occupancy: float = 10.0,
    covar_floor: float = 1e-3,
) -> AmFullGmm:
    """(reference: mle-full-gmm.cc MleFullGmmUpdate)."""
    new = AmFullGmm(am.weights.copy(), am.means.copy(), am.covars.copy())
    for p in range(am.num_pdfs):
        active = am.weights[p] > 0
        tot = occ[p, active].sum()
        if tot < 1e-8:
            continue
        for m in np.where(active)[0]:
            if occ[p, m] < min_occupancy:
                continue
            mean = macc[p, m] / occ[p, m]
            cov = sacc[p, m] / occ[p, m] - np.outer(mean, mean)
            # floor eigenvalues for positive-definiteness
            evals, evecs = np.linalg.eigh(cov)
            evals = np.maximum(evals, covar_floor)
            new.means[p, m] = mean
            new.covars[p, m] = (evecs * evals) @ evecs.T
        w = np.maximum(occ[p] * active, 0.0)
        if w.sum() > 0:
            new.weights[p] = (w / w.sum() * active).astype(np.float32)
    return new
