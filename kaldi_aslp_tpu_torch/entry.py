"""The flagship's forward step on the card, counterpart of
``__graft_entry__.entry`` (__graft_entry__.py:14-31).

    forward, args = entry()
    log_probs = forward(*args)      # [8, 200, 72]

The flagship BLSTM-CTC (3 x BLSTMP, cell 512, projection 320 a
direction, 40 inputs, 72 targets) is built on ``device`` with parameters
drawn from a ``torch.Generator`` seeded ``seed`` (JAX draws from
``PRNGKey(0)``: the two start from different weights; carry JAX's over
with ``models/interop.py:params_from_jax``).  ``forward(net, feats,
mask)`` is the eval forward, each BLSTMP layer one ``blstmp_forward``
launch, then a log-softmax; its arguments are JAX's: the net where JAX
passes its params, [S, T, 40] features from ``RandomState(0)`` and an
all-ones mask.

``dryrun_multichip(n_workers, device)`` is the counterpart of
``__graft_entry__.dryrun_multichip`` (__graft_entry__.py:34-212) over
``n_workers`` spawned ranks (parallel/launch.py), with JAX's shapes and
steps: ``dryrun_steps``, one BSP train step of a small BLSTM-CTC and a
2 x n/2 BMUF block step of two inner steps, then
``dryrun_convergence``, the six strategies on the hard-corpus BLSTM
task for 300 rounds (MASGD again at server momentum 0.5) and the
affine task's 60 rounds, with JAX's assertions.  Each prints a JSON
line; a band check that cannot run says why, and a strategy whose group
failed every try is named with its error and fails the run."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch

from kaldi_aslp_tpu_torch.models.flagship import build_blstm_ctc
from kaldi_aslp_tpu_torch.models.nnet import Nnet
from kaldi_aslp_tpu_torch.utils.device import resolve_device


@torch.inference_mode()
def forward(net: Nnet, feats: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """[S, T, 40] features, [S, T] mask -> [S, T, 72] log-probabilities."""
    net.eval()
    logits, _ = net(feats, mask=mask)
    return torch.log_softmax(logits, dim=-1)


def entry(device: Union[str, torch.device] = "cuda", seed: int = 0,
          S: int = 8, T: int = 200) -> Tuple[Callable, tuple]:
    """(forward, (net, feats, mask)) on ``device``."""
    dev = resolve_device(device)
    net = build_blstm_ctc(input_dim=40, num_layers=3, proj_dim=320,
                          cell_dim=512, num_targets=72)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    net.to(dev).eval()
    rs = np.random.RandomState(0)
    feats = torch.from_numpy(rs.randn(S, T, 40).astype(np.float32)).to(dev)
    mask = torch.ones((S, T), dtype=torch.float32, device=dev)
    return forward, (net, feats, mask)


def dryrun_steps(n_workers: int, device: str = "cuda") -> List[dict]:
    """One BSP train step of a small BLSTM-CTC (2 x BLSTMP, C=24, P=16,
    8 inputs, 12 targets; S = 2 a rank, T=16, U=3; momentum 0.9, lr 0.01)
    and, from two ranks on, one BMUF block step over (2, n/2) with two
    inner steps on the same batch; every loss must be finite.  Returns
    rank 0's results (parallel/steps.py)."""
    from kaldi_aslp_tpu_torch.parallel.launch import RankContext, spawn
    from kaldi_aslp_tpu_torch.parallel.steps import train_ranks

    dev = resolve_device(device)
    net = build_blstm_ctc(input_dim=8, num_layers=2, proj_dim=16,
                          cell_dim=24, num_targets=12)
    net.reset_parameters(torch.Generator().manual_seed(0))
    S, T, U = 2 * n_workers, 16, 3
    rs = np.random.RandomState(0)
    batch = {"feats": rs.randn(S, T, 8).astype(np.float32),
             "labels": rs.randint(1, 12, (S, U)).astype(np.int64),
             "in_lens": np.full(S, T, np.int64),
             "lab_lens": np.full(S, U, np.int64),
             "mask": np.ones((S, T), np.float32)}
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "dryrun.zip")
        net.save(model)
        base = dict(model=model, batch=batch, learn_rate=0.01,
                    momentum=0.9, steps=1)
        jobs = [dict(base, strategy="bsp")]
        if n_workers >= 2:
            jobs.append(dict(base, strategy="bmuf", blocks=2,
                             inner_steps=2))
        if n_workers == 1:
            results = train_ranks(RankContext(0, 1, dev, "none"), jobs)
        else:
            results = spawn(train_ranks, n_workers, args=(jobs,),
                            device_type=dev.type)[0]
    for job, res in zip(jobs, results):
        if not np.isfinite(res["losses"]).all():
            raise AssertionError(f"{job['strategy']} step produced NaN: "
                                 f"{res['losses']}")
    print(json.dumps({"dryrun_steps": {
        j["strategy"]: r["losses"] for j, r in zip(jobs, results)},
        "ranks": n_workers, "device": dev.type}), flush=True)
    return results


def dryrun_convergence(n_workers: int,
                       device: str = "cuda") -> Dict[str, object]:
    """The multi-round convergence evidence of JAX's dryrun
    (__graft_entry__.py:106-212; the reference's "similar convergence as
    standard SGD", bmuf-worker.h:56-67) from two ranks on: the six
    strategies on the hard-corpus BLSTM task, one process group each,
    and MASGD again at server momentum 0.5; at least 5 that converge
    (below 0.55 of the initial loss) must lie within a 1.25x band, and
    the six with the tuned MASGD in place of the default one too.  Then
    the affine task: every strategy below 0.55 of the initial loss and
    within 2x of the others.  A strategy whose group failed every try
    (``strategies_missing``) fails the run.  Each task's JSON line is
    printed before its checks; returns what it printed."""
    from kaldi_aslp_tpu_torch.parallel.convergence import (
        blstm_band,
        run_convergence_comparison,
    )

    out: Dict[str, object] = {}
    if n_workers < 2:
        return out
    blstm = out["blstm"] = blstm_band(n_workers, device)
    print(json.dumps(blstm), flush=True)
    finals = blstm["convergence_blstm_hardcorpus_final_loss"]
    if blstm["strategies_missing"]:
        raise AssertionError("strategies whose group failed every try: "
                             f"{blstm['strategies_missing']}")
    band5 = blstm["best_5strategy_band"]
    band6 = blstm["best_6strategy_band_tuned_masgd"]
    if band5 is not None and band5 > 1.25:
        raise AssertionError(f"no 5-strategy band within 1.25x: {finals}")
    if band6 is not None and band6 > 1.25:
        raise AssertionError("no 6-strategy band within 1.25x (tuned "
                             f"masgd): {finals}")

    res = run_convergence_comparison(n_workers, n_rounds=60,
                                     learn_rate=1.5, per_device_batch=16,
                                     device=device)
    finals = {k: v[-1] for k, v in res.items()}
    init = res["bsp"][0]
    out["affine"] = {"convergence_60round_final_loss": finals,
                     "initial_loss": init,
                     "blstm_evidence_ran": band5 is not None}
    print(json.dumps(out["affine"]), flush=True)
    for name, traj in res.items():
        if not np.isfinite(np.asarray(traj)).all():
            raise AssertionError(f"{name} diverged (NaN/inf)")
        if traj[-1] >= 0.55 * init:
            raise AssertionError(f"{name} failed to converge: {init:.4f} "
                                 f"-> {traj[-1]:.4f}")
    lo, hi = min(finals.values()), max(finals.values())
    if hi > 2.0 * lo:
        raise AssertionError(f"strategies diverged from each other: "
                             f"{finals}")
    return out


def dryrun_multichip(n_workers: int, device: str = "cuda") -> None:
    """JAX's multi-chip dry run over ``n_workers`` ranks on ``device``:
    ``dryrun_steps`` then ``dryrun_convergence``."""
    dryrun_steps(n_workers, device)
    dryrun_convergence(n_workers, device)
