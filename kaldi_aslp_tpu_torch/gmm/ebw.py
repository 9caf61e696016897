"""Discriminative GMM re-estimation: Extended Baum-Welch (EBW/MMI).

Port of kaldi_aslp_tpu/gmm/ebw.py (reference: src/gmm/ebw-diag-gmm.{h,cc}:
numerator stats from forced alignment, denominator stats from
recognition posteriors, the per-gaussian D-smoothed update
mu = (num - den + D mu0) / (gamma_num - gamma_den + D) with D the larger
of E gamma_den and Dmin, doubled until the variances are positive).

Denominator occupancies come from frame-level pdf posteriors
(p(pdf | x) proportional to prior times likelihood over all pdfs, the
lattice-free MMI role).  Both statistics are computed on the device (the
card unless the caller asks for the CPU) in float64 by products
(gmm/diag_gmm.py) and handed out in float32, JAX's dtype; the update is
host numpy.  Where JAX computes the denominator one pdf at a time, the
port takes every pdf's gaussians at once, the pdf and the gaussian
posteriors from one set of gaussian log-likelihoods a block of frames."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.gmm.diag_gmm import (
    STATS_BLOCK,
    AmDiagGmm,
    GmmStats,
    component_loglikes,
)
from kaldi_aslp_tpu_torch.utils.config import Config
from kaldi_aslp_tpu_torch.utils.device import resolve_device

Stats = Tuple[np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass
class EbwOptions(Config):
    ebw_e: float = 2.0          # D = E * denominator occupancy
    min_d: float = 1.0
    variance_floor: float = 1e-3


def accumulate_denominator_stats(
    am: AmDiagGmm,
    feats: np.ndarray,
    pdf_log_priors: Optional[np.ndarray] = None,
    acoustic_scale: float = 1.0,
    device: Union[str, torch.device] = "cuda",
) -> Stats:
    """Frame-level denominator stats: the posterior over all pdfs times
    each pdf's gaussian posteriors (lattice-free MMI denominator).

    Returns (occ [P, M], mean_acc [P, M, D], var_acc [P, M, D])."""
    dev = resolve_device(device)
    w, mu, var = am.pack(dev)
    P, M, D = am.num_pdfs, am.max_gauss, am.dim
    x_all = torch.from_numpy(np.asarray(feats, np.float32)).to(dev)
    prior = (None if pdf_log_priors is None else torch.from_numpy(
        np.asarray(pdf_log_priors, np.float32)).to(dev).double())
    occ = torch.zeros(P * M, dtype=torch.float64, device=dev)
    mean_acc = torch.zeros((P * M, D), dtype=torch.float64, device=dev)
    var_acc = torch.zeros((P * M, D), dtype=torch.float64, device=dev)
    for t0 in range(0, len(x_all), STATS_BLOCK):
        x = x_all[t0:t0 + STATS_BLOCK].double()
        ll = component_loglikes(x, w, mu, var)           # [T, P, M]
        pdf_ll = torch.logsumexp(ll, dim=-1) * acoustic_scale
        if prior is not None:
            pdf_ll = pdf_ll + prior
        pdf_post = torch.softmax(pdf_ll, dim=-1)         # [T, P]
        gam = torch.softmax(ll, dim=-1) * pdf_post[..., None]
        gam = gam.reshape(len(x), P * M)
        occ += gam.sum(0)
        mean_acc += gam.t() @ x
        var_acc += gam.t() @ (x * x)
    return (occ.reshape(P, M).float().cpu().numpy(),
            mean_acc.reshape(P, M, D).float().cpu().numpy(),
            var_acc.reshape(P, M, D).float().cpu().numpy())


def ebw_update(
    am: AmDiagGmm,
    num: Tuple[np.ndarray, np.ndarray, np.ndarray],
    den: Tuple[np.ndarray, np.ndarray, np.ndarray],
    opts: Optional[EbwOptions] = None,
) -> AmDiagGmm:
    """(reference: ebw-diag-gmm.cc UpdateEbwDiagGmm)."""
    opts = opts or EbwOptions()
    n_occ, n_mean, n_var = num
    d_occ, d_mean, d_var = den
    new = AmDiagGmm(am.weights.copy(), am.means.copy(), am.vars.copy())
    for p in range(am.num_pdfs):
        for m in np.where(am.weights[p] > 0)[0]:
            D_s = max(opts.ebw_e * d_occ[p, m], opts.min_d)
            denom = n_occ[p, m] - d_occ[p, m] + D_s
            if denom <= 0:
                continue
            mu0 = am.means[p, m]
            var0 = am.vars[p, m]
            mu = (n_mean[p, m] - d_mean[p, m] + D_s * mu0) / denom
            var = ((n_var[p, m] - d_var[p, m]
                    + D_s * (var0 + mu0 ** 2)) / denom - mu ** 2)
            if (var <= opts.variance_floor).any():
                # grow D until variance is valid (reference doubling loop)
                ok = False
                for _ in range(10):
                    D_s *= 2.0
                    denom = n_occ[p, m] - d_occ[p, m] + D_s
                    mu = (n_mean[p, m] - d_mean[p, m] + D_s * mu0) / denom
                    var = ((n_var[p, m] - d_var[p, m]
                            + D_s * (var0 + mu0 ** 2)) / denom - mu ** 2)
                    if (var > opts.variance_floor).all():
                        ok = True
                        break
                if not ok:
                    continue
            new.means[p, m] = mu
            new.vars[p, m] = np.maximum(var, opts.variance_floor)
        # weights: EBW weight update (simplified single-iteration form)
        nw = n_occ[p] * (am.weights[p] > 0)
        dw = d_occ[p] * (am.weights[p] > 0)
        tot_n, tot_d = nw.sum(), dw.sum()
        if tot_n > 0:
            raw = am.weights[p] * np.maximum(
                1.0 + (nw / max(tot_n, 1e-8))
                - (dw / max(tot_d, 1e-8)), 0.1
            )
            raw *= (am.weights[p] > 0)
            new.weights[p] = (raw / raw.sum()).astype(np.float32)
    return new


def accumulate_numerator_stats(am: AmDiagGmm, feats: np.ndarray,
                               pdf_ids: np.ndarray,
                               device: Union[str, torch.device] = "cuda"
                               ) -> Stats:
    """Alignment (numerator) stats, the denominator's layout."""
    stats = GmmStats(am, device)
    stats.accumulate(am.pack(device), np.asarray(feats, np.float32),
                     np.asarray(pdf_ids, np.int64))
    return stats.to_numpy()
