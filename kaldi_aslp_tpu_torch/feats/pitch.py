"""Pitch features: NCCF + Viterbi pitch tracking.

Port of kaldi_aslp_tpu/feats/pitch.py (reference:
src/feat/pitch-functions.{h,cc} compute-kaldi-pitch-feats, the
Ghahremani et al. 2014 algorithm): per-frame normalized cross-correlation
over the candidate lag range, Viterbi smoothing over lag trajectories
with an octave-jump penalty, and the standard 2-dim output (POV feature,
log-pitch) plus the post-processing the recipes use (mean-subtracted log
pitch, delta pitch).

Each function keeps the JAX function's own arithmetic, so that both
packages pick the same lags:
  - ``compute_pitch`` takes the NCCF by direct per-lag sums, with the
    ballast from the mean square of the whole wave, and builds
    log-pitch as ``log(samp_freq / lag)`` in float64 on the host;
  - ``compute_pitch_batched`` takes it by FFT cross-correlation, the
    energies from prefix sums and the ballast from the mean square over
    each utterance's true length; its waves are zero-padded to whole
    seconds and the lag-Viterbi runs over the padded frames, as JAX's
    does (the last real frames' lags depend on that padding); log-pitch
    is ``log(samp_freq)`` minus a float32 table of float64 logs.
The lag-Viterbi (:func:`lag_viterbi`) is one loop over frames of
[B, L, L] maxima on the features' device (``torch.max`` gives the first
index of a tie, as ``jnp.argmax``), its back-pointers kept as int16; the
backtrace runs on the host after one copy.  ``lag_viterbi.frames``
counts the frame loop's iterations over all calls."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.utils.config import Config
from kaldi_aslp_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PitchOptions(Config):
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    penalty_factor: float = 0.1     # octave-jump transition cost
    lag_penalty: float = 0.05       # short-lag preference (kills
    # subharmonic octave errors; the soft_min_f0 role in the reference)
    nccf_ballast: float = 7000.0


class _Geometry:
    """Samples of a frame shift and window, and the lag range."""

    def __init__(self, opts: PitchOptions):
        sr = opts.samp_freq
        self.shift = int(sr * opts.frame_shift_ms / 1000)
        self.window = int(sr * opts.frame_length_ms / 1000)
        self.min_lag = int(sr / opts.max_f0)
        self.max_lag = int(sr / opts.min_f0)
        self.lags = np.arange(self.min_lag, self.max_lag + 1)
        self.log_lags = np.log(self.lags.astype(np.float64))

    def num_frames(self, n: int) -> int:
        return max(0, 1 + (n - self.window - self.max_lag) // self.shift)


# elements of a [lags, frames, window] block in the direct NCCF
_NCCF_BLOCK = 1 << 24


def nccf_grid(wave: torch.Tensor, opts: PitchOptions
              ) -> Tuple[torch.Tensor, np.ndarray]:
    """[num_frames, num_lags] NCCF of a float32 wave by direct per-lag
    sums (the JAX ``_nccf_grid``), on the wave's device, and the lags."""
    g = _Geometry(opts)
    dev = wave.device
    T = g.num_frames(wave.shape[0])
    starts = torch.arange(T, device=dev) * g.shift
    win_idx = starts[:, None] + torch.arange(g.window, device=dev)[None, :]
    x1 = wave[win_idx]                                   # [T, W]
    e1 = torch.sum(x1 * x1, dim=1)                       # [T]
    mean_sq = torch.mean(wave * wave)
    ballast = opts.nccf_ballast * mean_sq * g.window
    lags = torch.from_numpy(g.lags).to(dev)
    step = max(1, _NCCF_BLOCK // max(1, T * g.window))
    cols = []
    for i in range(0, len(g.lags), step):
        x2 = wave[win_idx[None] + lags[i:i + step, None, None]]  # [l, T, W]
        num = torch.sum(x1[None] * x2, dim=2)
        e2 = torch.sum(x2 * x2, dim=2)
        cols.append(num / torch.sqrt(e1[None] * e2 + ballast + 1e-20))
    if not cols:
        return wave.new_zeros((T, len(g.lags))), g.lags
    return torch.cat(cols).T, g.lags


def lag_viterbi(local: torch.Tensor, cost_mat: torch.Tensor
                ) -> np.ndarray:
    """Smoothed best lag index per frame: maximize the sum of ``local``
    [B, T, L] less ``cost_mat`` [L_prev, L_new] at each transition.  The
    frame loop runs on ``local``'s device; its back-pointers come to the
    host once and the backtrace starts from the first best lag of the
    last frame.  Returns [B, T] int64 indices into the lag grid."""
    B, T, L = local.shape
    best = np.zeros((B, T), np.int64)
    if T == 0:
        return best
    bps = torch.empty((max(T - 1, 0), B, L), dtype=torch.int16,
                      device=local.device)
    score = local[:, 0]
    for t in range(1, T):
        best_prev, bp = torch.max(score[:, :, None] - cost_mat[None], dim=1)
        score = best_prev + local[:, t]
        bps[t - 1] = bp
    lag_viterbi.frames += T - 1
    best[:, -1] = torch.argmax(score, dim=1).cpu().numpy()
    bps_np = bps.cpu().numpy()
    rows = np.arange(B)
    for t in range(T - 2, -1, -1):
        best[:, t] = bps_np[t, rows, best[:, t + 1]]
    return best


lag_viterbi.frames = 0  # frame-loop iterations, summed over calls


def _local_score(nccf: torch.Tensor, g: _Geometry,
                 opts: PitchOptions) -> torch.Tensor:
    """NCCF less a mild long-lag penalty (subharmonics of a periodic
    signal score equal NCCF; prefer the fundamental)."""
    pen = torch.from_numpy(np.asarray(g.log_lags - g.log_lags[0],
                                      np.float32)).to(nccf.device)
    return nccf - opts.lag_penalty * pen


def compute_pitch(wave, opts: Optional[PitchOptions] = None,
                  device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """[n_samples] -> [T, 2] float32 features (POV/NCCF feature,
    log-pitch), the NCCF and the Viterbi on ``device``."""
    opts = opts or PitchOptions()
    dev = resolve_device(device)
    g = _Geometry(opts)
    wave = torch.from_numpy(np.array(wave, np.float32)).to(dev)
    nccf, lags = nccf_grid(wave, opts)
    T = nccf.shape[0]
    if T == 0:
        return np.zeros((0, 2), np.float32)
    # the JAX function's transition costs: float32 logs, float32 square
    log_lags = torch.from_numpy(g.log_lags.astype(np.float32)).to(dev)
    cost_mat = float(opts.penalty_factor) * (
        log_lags[:, None] - log_lags[None, :]) ** 2
    best = lag_viterbi(_local_score(nccf, g, opts)[None], cost_mat)[0]
    nccf_np = nccf.cpu().numpy()
    pitch = opts.samp_freq / lags[best]
    pov = nccf_np[np.arange(T), best]
    return np.stack([pov, np.log(pitch)], axis=1).astype(np.float32)


def batched_nccf(waves: torch.Tensor, true_lens: torch.Tensor,
                 opts: PitchOptions) -> torch.Tensor:
    """[B, n] zero-padded float32 waves -> [B, T_pad, L] NCCF by FFT
    cross-correlation (the JAX ``_batched_pitch_program``'s): no
    [L, T, W] block, energies from prefix sums, the ballast from the
    mean square over each utterance's true length."""
    g = _Geometry(opts)
    dev = waves.device
    T = g.num_frames(waves.shape[1])
    ext = g.window + g.max_lag
    starts = torch.arange(T, device=dev) * g.shift
    x2 = waves[:, starts[:, None] + torch.arange(ext, device=dev)[None, :]]
    x1 = x2[..., :g.window]
    # num[b,t,l] = sum_w x1[b,t,w] * x2[b,t,w+l]: a circular correlation
    # at N >= ext never wraps for l <= max_lag
    nfft = 1 << int(np.ceil(np.log2(ext)))
    f1 = torch.fft.rfft(x1, nfft)
    f2 = torch.fft.rfft(x2, nfft)
    corr = torch.fft.irfft(torch.conj(f1) * f2, nfft)    # [B, T, nfft]
    num = corr[..., g.min_lag:g.max_lag + 1]
    e1 = torch.sum(x1 * x1, dim=-1)                      # [B, T]
    cs = torch.cumsum(x2 * x2, dim=-1)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], dim=-1)
    # e2[b,t,l] = the sum of x2^2 over [l, l+window)
    e2 = cs[..., g.window + g.min_lag:g.window + g.max_lag + 1] \
        - cs[..., g.min_lag:g.max_lag + 1]
    mean_sq = torch.sum(waves * waves, dim=1) / torch.clamp(true_lens, min=1)
    ballast = opts.nccf_ballast * mean_sq * g.window     # [B]
    return num / torch.sqrt(e1[..., None] * e2 + ballast[:, None, None]
                            + 1e-20)


def batched_pitch(waves: torch.Tensor, true_lens: torch.Tensor,
                  opts: PitchOptions) -> torch.Tensor:
    """[B, n] padded waves -> [B, T_pad, 2] (pov, log-pitch) on their
    device: :func:`batched_nccf`, the lag-Viterbi over every padded
    frame, and JAX's output expression."""
    g = _Geometry(opts)
    nccf = batched_nccf(waves, true_lens, opts)
    dev = nccf.device
    # the JAX program's transition costs: float64 squares cast to float32
    cost_mat = opts.penalty_factor * torch.from_numpy(np.asarray(
        (g.log_lags[:, None] - g.log_lags[None, :]) ** 2, np.float32)
    ).to(dev)
    best = torch.from_numpy(
        lag_viterbi(_local_score(nccf, g, opts), cost_mat)).to(dev)
    pov = torch.gather(nccf, 2, best[..., None])[..., 0]
    log_lags = torch.from_numpy(g.log_lags.astype(np.float32)).to(dev)
    log_sr = torch.log(torch.tensor(opts.samp_freq, dtype=torch.float32,
                                    device=dev))
    return torch.stack([pov, log_sr - log_lags[best]], dim=-1)


def compute_pitch_batched(waves: Dict[str, np.ndarray],
                          opts: Optional[PitchOptions] = None,
                          batch_size: int = 32,
                          device: Union[str, torch.device] = "cuda"
                          ) -> Dict[str, torch.Tensor]:
    """{utt: [samples]} -> {utt: [T, 2]} raw pitch on ``device``, in
    batches of at most ``batch_size`` utterances of one 1 s length
    bucket (the JAX package's buckets), each utterance zero-padded to
    its bucket."""
    opts = opts or PitchOptions()
    dev = resolve_device(device)
    g = _Geometry(opts)
    bucket = int(opts.samp_freq)
    groups: Dict[int, list] = {}
    for u, w in waves.items():
        padded = int(np.ceil(max(len(w), 1) / bucket)) * bucket
        groups.setdefault(padded, []).append(u)
    out: Dict[str, torch.Tensor] = {}
    for padded, utts in sorted(groups.items()):
        for i in range(0, len(utts), batch_size):
            chunk = utts[i:i + batch_size]
            arr = np.zeros((len(chunk), padded), np.float32)
            lens = np.ones(len(chunk), np.float32)
            for j, u in enumerate(chunk):
                w = np.asarray(waves[u], np.float32)
                arr[j, :len(w)] = w
                lens[j] = len(w)
            feats = batched_pitch(torch.from_numpy(arr).to(dev),
                                  torch.from_numpy(lens).to(dev), opts)
            for j, u in enumerate(chunk):
                out[u] = feats[j, :g.num_frames(len(waves[u]))]
    return out


def postprocess_pitch(raw, cmn_window: int = 151) -> np.ndarray:
    """3-dim recipe features on the host, as in the JAX package
    (reference: process-kaldi-pitch-feats): (pov, mean-subtracted log
    pitch, delta log pitch)."""
    if isinstance(raw, torch.Tensor):
        raw = raw.cpu().numpy()
    pov = raw[:, 0]
    logp = raw[:, 1]
    T = len(raw)
    half = cmn_window // 2
    norm = np.empty_like(logp)
    for t in range(T):
        s, e = max(0, t - half), min(T, t + half + 1)
        norm[t] = logp[t] - logp[s:e].mean()
    delta = np.gradient(logp)
    return np.stack([pov, norm, delta], axis=1).astype(np.float32)
