"""Single "global" diagonal GMM: init-from-feats + EM.

Port of kaldi_aslp_tpu/gmm/global_gmm.py (reference:
src/gmmbin/gmm-global-init-from-feats.cc, random frame-mean init and EM
with progressive mixture growth, and the gmm-global-acc-stats /
gmm-global-est loop of aslp_scripts/vad/train_diag_gmm.sh:44-75): the
class-conditional GMMs behind the GMM VAD (run_gmm_vad.sh).

The E-step takes all gaussians at once, two products over a block of
frames, on the device (the card unless the caller asks for the CPU), in
float64 with the statistics as products (JAX: jitted float32
``logsumexp`` / ``dot``); the M-step, the mixing-up and the frame
subsampling are host numpy with JAX's ``RandomState`` draws, so both
packages grow the same mixture.  ``GlobalGmm.save`` / ``load`` write and
read JAX's file (``np.savez`` of ``weights``, ``means``, ``vars``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.gmm.diag_gmm import (  # noqa: F401 (LOG_2PI)
    LOG_2PI,
    component_loglikes,
)
from kaldi_aslp_tpu_torch.utils.device import resolve_device

# frames an E-step block: bounds its [frames, M] float64 operands
EM_BLOCK = 65536


@dataclass
class GlobalGmm:
    """weights [M], means [M, D], vars [M, D]."""

    weights: np.ndarray
    means: np.ndarray
    vars: np.ndarray

    @property
    def num_gauss(self) -> int:
        return len(self.weights)

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    def save(self, path: str) -> None:
        np.savez(path, weights=self.weights, means=self.means,
                 vars=self.vars)

    @classmethod
    def load(cls, path: str) -> "GlobalGmm":
        z = np.load(path)
        return cls(z["weights"], z["means"], z["vars"])

    def pack(self, device: Union[str, torch.device] = "cuda"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(weights, means, vars) on ``device``."""
        dev = resolve_device(device)
        return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)
                                      ).to(dev)
                     for a in (self.weights, self.means, self.vars))


def _component_loglikes(x: torch.Tensor, weights: torch.Tensor,
                        means: torch.Tensor, variances: torch.Tensor
                        ) -> torch.Tensor:
    """[T, D] -> [T, M] (float64): log w + log N, -1e30 on empty slots
    (the diagonal GMM's products, one pdf)."""
    return component_loglikes(x, weights[None], means[None],
                              variances[None])[:, 0]


def _frames(feats, device) -> torch.Tensor:
    if torch.is_tensor(feats):
        return feats.to(device)
    return torch.from_numpy(np.ascontiguousarray(feats, np.float32)
                            ).to(device)


def global_gmm_loglikes(feats, weights: torch.Tensor, means: torch.Tensor,
                        variances: torch.Tensor) -> torch.Tensor:
    """[T, D] -> [T] (float32) total log-likelihood a frame (logsumexp
    over the components), on the model tensors' device."""
    x_all = _frames(feats, means.device)
    out = [torch.logsumexp(_component_loglikes(
        x_all[t0:t0 + EM_BLOCK].double(), weights, means, variances), dim=-1)
        for t0 in range(0, len(x_all), EM_BLOCK)]
    return torch.cat(out).float()


def em_stats(feats, frame_weights, weights: torch.Tensor,
             means: torch.Tensor, variances: torch.Tensor
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """One E-step and its sufficient statistics on the model tensors'
    device: occ [M], mean_acc [M, D], var_acc [M, D] (float32) and the
    total log-likelihood."""
    dev = means.device
    x_all = _frames(feats, dev)
    fw_all = _frames(frame_weights, dev)
    M, D = means.shape
    occ = torch.zeros(M, dtype=torch.float64, device=dev)
    mean_acc = torch.zeros((M, D), dtype=torch.float64, device=dev)
    var_acc = torch.zeros((M, D), dtype=torch.float64, device=dev)
    loglike = torch.zeros((), dtype=torch.float64, device=dev)
    for t0 in range(0, len(x_all), EM_BLOCK):
        x = x_all[t0:t0 + EM_BLOCK].double()
        fw = fw_all[t0:t0 + EM_BLOCK].double()
        ll = _component_loglikes(x, weights, means, variances)
        tot = torch.logsumexp(ll, dim=-1)
        gamma = torch.exp(ll - tot[:, None]) * fw[:, None]
        occ += gamma.t() @ torch.ones(len(x), dtype=torch.float64,
                                      device=dev)
        mean_acc += gamma.t() @ x
        var_acc += gamma.t() @ (x * x)
        loglike += tot @ fw
    return (occ.float().cpu().numpy(), mean_acc.float().cpu().numpy(),
            var_acc.float().cpu().numpy(), float(loglike))


def em_update(gmm: GlobalGmm, occ, mean_acc, var_acc,
              min_gaussian_weight: float = 1e-4,
              var_floor: float = 1e-3,
              remove_low_count: bool = True) -> GlobalGmm:
    """M-step (reference: mle-diag-gmm.cc MleDiagGmmUpdate for the
    global model; low-count components dropped like
    remove-low-count-gaussians=true)."""
    occ = np.asarray(occ, np.float64)
    mean_acc = np.asarray(mean_acc, np.float64)
    var_acc = np.asarray(var_acc, np.float64)
    total = max(occ.sum(), 1e-10)
    w = occ / total
    keep = w > (min_gaussian_weight if remove_low_count else 0.0)
    if not keep.any():
        keep[np.argmax(w)] = True
    safe_occ = np.maximum(occ, 1e-10)[:, None]
    means = mean_acc / safe_occ
    variances = np.maximum(var_acc / safe_occ - means ** 2, var_floor)
    w = w[keep] / w[keep].sum()
    return GlobalGmm(w.astype(np.float32),
                     means[keep].astype(np.float32),
                     variances[keep].astype(np.float32))


def split_global(gmm: GlobalGmm, target: int, perturb: float = 0.01,
                 seed: int = 0) -> GlobalGmm:
    """Mix up by splitting highest-weight components
    (diag-gmm.cc Split)."""
    rng = np.random.RandomState(seed)
    w = list(gmm.weights.astype(np.float64))
    mu = list(gmm.means)
    var = list(gmm.vars)
    while len(w) < target:
        m = int(np.argmax(w))
        w[m] /= 2.0
        w.append(w[m])
        std = np.sqrt(var[m])
        delta = (perturb * std * rng.randn(gmm.dim)).astype(np.float32)
        mu.append(mu[m] + delta)
        mu[m] = mu[m] - delta
        var.append(var[m].copy())
    return GlobalGmm(np.asarray(w, np.float32), np.stack(mu),
                     np.stack(var))


def init_from_feats(
    feats: np.ndarray,
    num_gauss: int,
    num_iters: int = 20,
    num_gauss_init: int = 0,
    num_frames: int = 200000,
    min_gaussian_weight: float = 1e-4,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> GlobalGmm:
    """gmm-global-init-from-feats: subsample frames, seed means from
    random frames at half the target mixture count, EM while growing
    to num_gauss over the first half of the iterations."""
    rng = np.random.RandomState(seed)
    feats = np.asarray(feats, np.float32)
    if len(feats) > num_frames:
        feats = feats[rng.choice(len(feats), num_frames, replace=False)]
    if num_gauss_init <= 0:
        num_gauss_init = max(1, num_gauss // 2)
    num_gauss_init = min(num_gauss_init, len(feats), num_gauss)

    glob_var = np.maximum(feats.var(axis=0), 1e-3)
    pick = rng.choice(len(feats), num_gauss_init, replace=False)
    gmm = GlobalGmm(
        np.full(num_gauss_init, 1.0 / num_gauss_init, np.float32),
        feats[pick].copy(),
        np.tile(glob_var[None], (num_gauss_init, 1)).astype(np.float32))

    dev = resolve_device(device)
    dev_feats = torch.from_numpy(feats).to(dev)
    fw = torch.ones(len(feats), dtype=torch.float32, device=dev)
    grow_iters = max(1, num_iters // 2)
    for it in range(num_iters):
        occ, macc, vacc, _ = em_stats(dev_feats, fw, *gmm.pack(dev))
        gmm = em_update(gmm, occ, macc, vacc,
                        min_gaussian_weight=min_gaussian_weight)
        if it < grow_iters and gmm.num_gauss < num_gauss:
            frac = (it + 1) / grow_iters
            target = min(num_gauss, max(
                gmm.num_gauss,
                int(round(num_gauss_init
                          + frac * (num_gauss - num_gauss_init)))))
            gmm = split_global(gmm, target, seed=seed + it + 1)
    return gmm


def avg_loglike(gmm: GlobalGmm, feats: np.ndarray,
                device: Union[str, torch.device] = "cuda") -> float:
    """Mean per-frame log-likelihood of ``feats`` under ``gmm``."""
    return float(global_gmm_loglikes(feats, *gmm.pack(device)).double()
                 .mean())
