"""Feature-space transforms: LDA, MLLT (STC), fMLLR.

Port of kaldi_aslp_tpu/feats/transforms.py (reference:
src/transform/lda-estimate.{h,cc}, mllt.{h,cc} MlltAccs, fmllr-diag-gmm.
{h,cc} FmllrDiagGmmAccs, as steps/train_lda_mllt.sh and
steps/train_sat.sh / align_fmllr.sh use them).

The statistics and the eigenvalue and row-update solves are host numpy
in float64, as in JAX (``np.linalg.eigh`` / ``inv`` / ``det``).  On the
device (the card unless the caller asks for the CPU): ``apply_transform``
and the gaussian posteriors of ``gmm_gammas_for_alignment``, both in
float64 and handed out in float32, so the card and the CPU hand the
solves the same values.  The MLLT and fMLLR statistics are the JAX
module's three-operand ``einsum``s written as matrix products: the
same sums, in another order.

LDA's eigenvectors are defined up to sign (and order, for equal
eigenvalues): compare two LDA matrices by the scatter they project, or
by rows up to sign."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# LDA (reference: lda-estimate.cc LdaEstimate)
# ---------------------------------------------------------------------------

class LdaStats:
    """Per-class first/second order stats."""

    def __init__(self, num_classes: int, dim: int):
        self.counts = np.zeros(num_classes)
        self.first = np.zeros((num_classes, dim))
        self.total_second = np.zeros((dim, dim))

    def accumulate(self, feats: np.ndarray, classes: np.ndarray) -> None:
        feats = np.asarray(feats, np.float64)
        classes = np.asarray(classes)
        np.add.at(self.counts, classes, 1.0)
        np.add.at(self.first, classes, feats)
        self.total_second += feats.T @ feats


def estimate_lda(stats: LdaStats, target_dim: int,
                 within_class_factor: float = 1.0) -> np.ndarray:
    """Return the [target_dim, dim] LDA matrix (reference:
    lda-estimate.cc LdaEstimate::Estimate)."""
    total_count = stats.counts.sum()
    total_mean = stats.first.sum(0) / total_count
    # between-class scatter
    bc = np.zeros_like(stats.total_second)
    for c in range(len(stats.counts)):
        if stats.counts[c] == 0:
            continue
        mean_c = stats.first[c] / stats.counts[c]
        d = (mean_c - total_mean)[:, None]
        bc += stats.counts[c] * (d @ d.T)
    bc /= total_count
    total_cov = stats.total_second / total_count - np.outer(
        total_mean, total_mean
    )
    wc = total_cov - bc
    # solve generalized eigenproblem bc v = λ wc v via whitening
    w_eval, w_evec = np.linalg.eigh(wc)
    w_eval = np.maximum(w_eval, 1e-10)
    whiten = w_evec @ np.diag(w_eval ** -0.5) @ w_evec.T
    m = whiten @ bc @ whiten.T
    evals, evecs = np.linalg.eigh(m)
    order = np.argsort(evals)[::-1][:target_dim]
    proj = (evecs[:, order].T @ whiten) * within_class_factor
    return proj.astype(np.float32)


def apply_transform(feats, matrix: np.ndarray,
                    device: Union[str, torch.device, None] = "cuda"
                    ) -> torch.Tensor:
    """y = A x (+ b for an affine [D, D+1] matrix), on ``device`` (a
    tensor's own device when ``device`` is None), in float64; returns
    float32."""
    x = torch.as_tensor(np.asarray(feats) if not torch.is_tensor(feats)
                        else feats)
    dev = x.device if device is None else resolve_device(device)
    x = x.to(dev, torch.float64)
    m = torch.from_numpy(np.asarray(matrix, np.float64)).to(dev)
    in_dim = x.shape[-1]
    if m.shape[1] == in_dim + 1:
        y = x @ m[:, :in_dim].t() + m[:, in_dim]
    else:
        y = x @ m.t()
    return y.float()


# ---------------------------------------------------------------------------
# MLLT / STC (reference: transform/mllt.cc MlltAccs)
# ---------------------------------------------------------------------------

class MlltStats:
    """Per-class scatter in the current feature space, weighted by
    gaussian posteriors; classes here = gaussians of the current model."""

    def __init__(self, dim: int):
        self.dim = dim
        self.G: Optional[np.ndarray] = None  # [dim, dim, dim] G_i matrices
        self.beta = 0.0

    def accumulate(self, feats: np.ndarray, means: np.ndarray,
                   inv_vars: np.ndarray, gammas: np.ndarray) -> None:
        """feats [T, D]; means/inv_vars [T, M, D] for the aligned pdf's
        gaussians; gammas [T, M] posteriors."""
        feats = np.asarray(feats, np.float64)
        d = self.dim
        if self.G is None:
            self.G = np.zeros((d, d, d))
        # G_i += sum over t, m of gamma (x - mu)(x - mu)^T / var_i: a
        # [D, T M] x [T M, D] product for each i
        diff = (feats[:, None, :] - means).reshape(-1, d)
        w = (np.asarray(gammas, np.float64)[..., None]
             * inv_vars).reshape(-1, d)
        for i in range(d):
            self.G[i] += (diff * w[:, i, None]).T @ diff
        self.beta += gammas.sum()


def estimate_mllt(stats: MlltStats, num_iters: int = 20) -> np.ndarray:
    """Row-wise iterative update (reference: mllt.cc MlltAccs::Update)."""
    d = stats.dim
    A = np.eye(d)
    for _ in range(num_iters):
        for i in range(d):
            Ginv = np.linalg.inv(stats.G[i] + 1e-6 * np.eye(d))
            # cofactor vector c_i: A_j · c_i = δ_ij det(A) → inv(A)[:, i]
            cof = np.linalg.inv(A)[:, i]
            scale = np.sqrt(stats.beta / max(cof @ Ginv @ cof, 1e-20))
            A[i] = scale * (Ginv @ cof)
    # normalize determinant to 1 like the reference
    det = np.linalg.det(A)
    A *= np.sign(det) * abs(det) ** (-1.0 / d)
    return A.astype(np.float32)


# ---------------------------------------------------------------------------
# fMLLR (reference: transform/fmllr-diag-gmm.cc)
# ---------------------------------------------------------------------------

class FmllrStats:
    """Speaker-level K and G_i accumulators for the affine transform
    W = [A; b] maximizing the GMM likelihood."""

    def __init__(self, dim: int):
        self.dim = dim
        self.K = np.zeros((dim, dim + 1))
        self.G = np.zeros((dim, dim + 1, dim + 1))
        self.beta = 0.0

    def accumulate(self, feats: np.ndarray, means: np.ndarray,
                   inv_vars: np.ndarray, gammas: np.ndarray) -> None:
        feats = np.asarray(feats, np.float64)
        xplus = np.concatenate(
            [feats, np.ones((len(feats), 1))], axis=1
        )  # [T, D+1]
        # [T, M, D] = gamma / var
        w = np.asarray(gammas, np.float64)[..., None] * inv_vars
        # K[i] += sum gamma mu_i / var_i x+^T; G_i += sum gamma / var_i
        # x+ x+^T: the gaussians summed first, then a product for each i
        self.K += (w * means).sum(1).T @ xplus
        a = w.sum(1)
        for i in range(self.dim):
            self.G[i] += (xplus * a[:, i, None]).T @ xplus
        self.beta += gammas.sum()


def estimate_fmllr(stats: FmllrStats, num_iters: int = 20) -> np.ndarray:
    """Row-wise update of W=[A b] (reference: fmllr-diag-gmm.cc
    ComputeFmllrMatrixDiagGmmFull, iterative row optimization)."""
    d = stats.dim
    W = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
    for _ in range(num_iters):
        for i in range(d):
            Ginv = np.linalg.inv(stats.G[i] + 1e-6 * np.eye(d + 1))
            A = W[:, :d]
            cof = np.linalg.inv(A + 1e-10 * np.eye(d))[:, i]
            ext_cof = np.concatenate([cof, [0.0]])
            k = stats.K[i]
            # solve for row: w_i = Ginv (k + α ext_cof), α from quadratic
            a_coef = ext_cof @ Ginv @ ext_cof
            b_coef = ext_cof @ Ginv @ k
            # β/α relationship: α a + b = β/α... quadratic in α:
            # a α² + b α − β = 0
            disc = b_coef ** 2 + 4 * a_coef * stats.beta
            alpha = (-b_coef + np.sqrt(max(disc, 0.0))) / max(
                2 * a_coef, 1e-20
            )
            W[i] = Ginv @ (k + alpha * ext_cof)
    return W.astype(np.float32)


def gmm_gammas_for_alignment(am, feats: np.ndarray, pdf_ids: np.ndarray,
                             device: Union[str, torch.device] = "cuda"
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-frame gaussian posteriors within the aligned pdf (on
    ``device``, float64, handed out in float32) and the aligned pdf's
    gaussian means and inverse variances, [T, M], [T, M, D], [T, M, D],
    for the MLLT / fMLLR statistics."""
    from kaldi_aslp_tpu_torch.gmm.diag_gmm import (
        gmm_posteriors_for_alignment,
    )

    dev = resolve_device(device)
    pdf_ids = np.asarray(pdf_ids, np.int64)
    gammas = gmm_posteriors_for_alignment(
        torch.from_numpy(np.asarray(feats, np.float32)).to(dev),
        torch.from_numpy(pdf_ids).to(dev), *am.pack(dev))
    means = am.means[pdf_ids]
    inv_vars = 1.0 / am.vars[pdf_ids]
    return gammas.float().cpu().numpy(), means, inv_vars
