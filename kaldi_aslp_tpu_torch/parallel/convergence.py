"""Cross-strategy convergence on identical data.

Port of kaldi_aslp_tpu/parallel/convergence.py.  The reference's
strategies exist to keep one property: "BMUF ... can achieve similar
convergence as standard SGD" (src/aslp-parallel/bmuf-worker.h:56-67);
EASGD / ASGD / MASGD / SOD make the same claim.  This module runs N
rounds of each strategy over one process group of ``n_workers`` ranks,
every strategy on the same global batches from the same initial model,
and records the held-out loss of each strategy's consensus model after
every round (index 0: before training).

Two tasks, as JAX's:
  * ``affine``: a teacher-labelled linear frame task (fast);
  * ``hard_blstm``: a small BLSTM classifying hard-corpus frames into
    monophone-GMM-aligned pdf targets (``make_hard_frame_task``).

``run_comparison_groups`` is the counterpart of JAX's
``run_comparison_subprocess``: one process group a strategy, each retried
on failure and bounded in time.  A strategy that still fails is not
dropped silently: it is named, with its error, in the second value."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.multiprocessing as mp

from kaldi_aslp_tpu_torch.parallel.launch import RankContext, spawn
from kaldi_aslp_tpu_torch.utils.log import get_logger

logger = get_logger("convergence")

ALL_STRATEGIES = ("bsp", "bmuf", "easgd", "asgd", "masgd", "sod")

Task = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]


def make_hard_frame_task(chunk: int = 32, seed: int = 0,
                         device: str = "cuda") -> Task:
    """A micro hard-corpus frame-classification set: a tiny synthesized
    corpus (recipes/hard_corpus.py), a fast monophone GMM on ``device``,
    and fixed-length frame chunks with per-frame pdf targets from its
    alignments.  Returns (train_x [N, chunk, D], train_y [N, chunk],
    eval_x, eval_y, num_pdfs)."""
    from kaldi_aslp_tpu_torch.gmm import MonophoneTrainer, MonoTrainOptions
    from kaldi_aslp_tpu_torch.recipes.hard_corpus import (
        HardCorpusOptions,
        build_corpus,
    )

    c = build_corpus(
        HardCorpusOptions(num_words=30, num_train_speakers=4,
                          num_test_speakers=2, seed=1234 + seed),
        num_train=14, num_test=4, lm_pool_mult=2, device=device)
    mono = MonophoneTrainer(c["lang"], opts=MonoTrainOptions(
        num_iters=4, totgauss=200, realign_iters="1 2 3"), device=device)
    am, tm = mono.train(c["train_feats"], c["train_texts"])

    def chunked(feats, alis):
        xs, ys = [], []
        for u, a in sorted(alis.items()):
            f = np.asarray(feats[u], np.float32)
            pdf = tm.alignment_to_pdfs(a)
            n = min(len(f), len(pdf))
            for i in range(0, n - chunk + 1, chunk):
                xs.append(f[i:i + chunk])
                ys.append(pdf[i:i + chunk])
        return (np.stack(xs).astype(np.float32),
                np.stack(ys).astype(np.int64))

    tr = mono.align(am, c["train_feats"], c["train_texts"])
    te = mono.align(am, c["test_feats"], c["test_texts"])
    train_x, train_y = chunked(c["train_feats"], tr)
    eval_x, eval_y = chunked(c["test_feats"], te)
    return train_x, train_y, eval_x, eval_y, tm.num_pdfs


def _task_rounds(spec: dict):
    """The net, the rounds' global batches and the held-out set, the same
    on every rank (numpy seeds, JAX's draws)."""
    from kaldi_aslp_tpu_torch.models.nnet import Nnet
    from kaldi_aslp_tpu_torch.models.recurrent import BLstm
    from kaldi_aslp_tpu_torch.models.simple import AffineTransform, Sigmoid

    seed, B = spec["seed"], spec["per_device_batch"] * spec["n_workers"]
    rs = np.random.RandomState(seed)
    net = Nnet()
    if spec["task"] == "affine":
        D, H, V = 10, 16, 5
        net.add(AffineTransform(D, H))
        net.add(Sigmoid(H, H))
        net.add(AffineTransform(H, V))
        teacher = rs.randn(D, V).astype(np.float32)

        def make_xy(n, rstate):
            x = rstate.randn(n, D).astype(np.float32)
            logits = x @ teacher + 0.1 * rstate.randn(n, V).astype(
                np.float32)
            return x, np.argmax(logits, -1).astype(np.int64)

        rounds = [make_xy(B, rs) for _ in range(spec["n_rounds"])]
        x_eval, y_eval = make_xy(512, np.random.RandomState(seed + 1))
    elif spec["task"] == "hard_blstm":
        train_x, train_y, x_eval, y_eval, V = spec["task_data"]
        D = train_x.shape[-1]
        net.add(BLstm(D, 2 * 16))
        net.add(AffineTransform(2 * 16, V))
        pool = np.arange(len(train_x))
        rounds = []
        for _ in range(spec["n_rounds"]):
            sel = rs.choice(pool, size=B, replace=len(pool) < B)
            rounds.append((train_x[sel], train_y[sel]))
    else:
        raise ValueError(spec["task"])
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net, rounds, (x_eval, y_eval)


def convergence_rank(ctx: RankContext,
                     spec: dict) -> Optional[Dict[str, List[float]]]:
    """One rank of a comparison: every strategy of ``spec`` in turn over
    this group; rank 0 returns {strategy: held-out loss a round}."""
    from kaldi_aslp_tpu_torch.models.losses import xent_loss
    from kaldi_aslp_tpu_torch.parallel.optimizers import (
        OptimizerOptions,
        make_optimizer,
    )
    from kaldi_aslp_tpu_torch.parallel.ps import PsOptions
    from kaldi_aslp_tpu_torch.parallel.steps import make_strategy
    from kaldi_aslp_tpu_torch.train.sgd import (
        NnetTrainOptions,
        init_velocity,
        make_sgd_update,
    )

    W, dev = ctx.world_size, ctx.device
    net, rounds, (x_eval, y_eval) = _task_rounds(spec)
    net.to(dev)
    params = dict(net.named_parameters())
    params0 = {k: v.detach().clone() for k, v in params.items()}
    x_ev = torch.from_numpy(x_eval).to(dev)
    y_ev = torch.from_numpy(y_eval).to(dev)
    batches = [{"x": torch.from_numpy(x).to(dev),
                "y": torch.from_numpy(y).to(dev)} for x, y in rounds]
    lr0, halve = spec["learn_rate"], spec["lr_halve_at"]
    lrs = [lr0 * 0.5 ** sum(i >= h for h in halve)
           for i in range(len(rounds))]
    update = make_sgd_update(net, NnetTrainOptions())
    generator = ctx.generator(spec["seed"])

    def loss_fn(b):
        net.train()
        y, _ = net(b["x"], generator=generator)
        return xent_loss(y.reshape(-1, y.shape[-1]), b["y"].reshape(-1))

    @torch.no_grad()
    def eval_loss(weights) -> Optional[float]:
        if ctx.rank != 0:
            return None
        net.eval()
        y, _ = torch.func.functional_call(net, weights, (x_ev,))
        return float(xent_loss(y.reshape(-1, y.shape[-1]),
                               y_ev.reshape(-1))[0])

    def restart():
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(params0[k])
        return init_velocity(net)

    out: Dict[str, List[float]] = {}
    for strat in spec["strategies"]:
        vel = restart()
        run = make_strategy(
            strat, loss_fn, update, params, blocks=2 if W >= 2 else 1,
            ps=PsOptions(masgd_momentum=spec["masgd_momentum"]),
            sod_optimizer=make_optimizer(OptimizerOptions(
                optimizer="momentum", learn_rate=1.0, momentum=0.25)))
        traj = [eval_loss(params0)]
        for b, lr in zip(batches, lrs):
            vel, _, _ = run.step(vel, run.shard(b), lr)
            traj.append(eval_loss(run.model()))
        out[strat] = traj
    return out if ctx.rank == 0 else None


def run_convergence_comparison(
    n_workers: int,
    n_rounds: int = 50,
    seed: int = 0,
    per_device_batch: int = 8,
    learn_rate: float = 0.5,
    strategies: Sequence[str] = ("bsp", "bmuf", "easgd"),
    task: str = "affine",
    lr_halve_at: Sequence[int] = (),
    masgd_momentum: float = 0.9,
    device: str = "cuda",
    task_data: Optional[Task] = None,
    threads: Optional[int] = None,
    run_timeout_s: Optional[float] = None,
) -> Dict[str, List[float]]:
    """{strategy: held-out xent of the consensus model after each round},
    every strategy on identical data from an identical start, over one
    group of ``n_workers`` ranks on ``device`` (one rank: in this
    process).  ``task_data``: ``make_hard_frame_task``'s result for
    ``hard_blstm`` (built here when None)."""
    if task == "hard_blstm" and task_data is None:
        task_data = make_hard_frame_task(seed=seed, device=device)
    spec = dict(n_workers=n_workers, n_rounds=n_rounds, seed=seed,
                per_device_batch=per_device_batch, learn_rate=learn_rate,
                strategies=tuple(strategies), task=task,
                lr_halve_at=tuple(lr_halve_at),
                masgd_momentum=masgd_momentum, task_data=task_data)
    if n_workers == 1:
        from kaldi_aslp_tpu_torch.parallel.mesh import rank_device

        return convergence_rank(
            RankContext(0, 1, rank_device(device, 0), "none"), spec)
    return spawn(convergence_rank, n_workers, args=(spec,),
                 device_type=device, threads=threads,
                 run_timeout_s=run_timeout_s)[0]


def _best_band(finals: Dict[str, float], k: int = 5) -> float:
    """Smallest max/min ratio over any ``k``-subset of the final losses
    (the "similar convergence" band; one outlier among six strategies
    should not mask five agreeing ones)."""
    vals = sorted(finals.values())
    if len(vals) < k:
        return vals[-1] / max(vals[0], 1e-9)
    return min(vals[i + k - 1] / max(vals[i], 1e-9)
               for i in range(len(vals) - k + 1))


def run_comparison_groups(n_workers: int, rounds: int, lr: float,
                          strategies: Sequence[str] = ALL_STRATEGIES,
                          retries: int = 3, timeout_s: float = 1800,
                          masgd_momentum: float = 0.9, device: str = "cuda",
                          task_data: Optional[Task] = None,
                          threads: Optional[int] = None, seed: int = 0
                          ) -> Tuple[Dict[str, List[float]],
                                     Dict[str, str]]:
    """The ``hard_blstm`` comparison with one process group a strategy,
    each tried up to ``retries`` times within ``timeout_s``; returns
    (trajectories, {strategy: error} for each strategy whose group failed
    every try).  A group fails when a rank raises, dies or overruns; an
    error of this process (no card, a bad argument) is raised.  The task
    is built once and every group trains on the same rounds."""
    if task_data is None:
        task_data = make_hard_frame_task(seed=seed, device=device)
    out: Dict[str, List[float]] = {}
    missing: Dict[str, str] = {}
    for strat in strategies:
        error = None
        for attempt in range(retries):
            try:
                out.update(run_convergence_comparison(
                    n_workers, n_rounds=rounds, seed=seed, learn_rate=lr,
                    per_device_batch=8, strategies=(strat,),
                    task="hard_blstm", masgd_momentum=masgd_momentum,
                    device=device, task_data=task_data, threads=threads,
                    run_timeout_s=timeout_s))
                break
            except (mp.ProcessRaisedException, mp.ProcessExitedException,
                    TimeoutError) as e:
                error = f"{type(e).__name__}: {e}"
                logger.warning("%s attempt %d failed: %s", strat,
                               attempt + 1, error)
        else:
            missing[strat] = error
    return out, missing


def blstm_band(n_workers: int, device: str = "cuda", seed: int = 0,
               rounds: int = 300, threads: Optional[int] = None,
               task_data: Optional[Task] = None) -> Dict[str, object]:
    """JAX's dryrun evidence on the ``hard_blstm`` task
    (__graft_entry__.py:123-182): the six strategies and MASGD again at
    server momentum 0.5 for ``rounds`` rounds at lr 1.0, one group each;
    the finals, the best 5-strategy band of those that converge (below
    0.55 of the initial loss) and the 6-strategy band with the tuned MASGD
    in place of the default one.  A band that cannot be taken says why in
    ``band5_skipped`` / ``band6_skipped``; a strategy whose group failed
    is in ``strategies_missing`` with its error.  ``task_data``:
    ``make_hard_frame_task(seed=seed, device=device)`` when None."""
    data = (task_data if task_data is not None
            else make_hard_frame_task(seed=seed, device=device))
    res, missing = run_comparison_groups(n_workers, rounds, 1.0,
                                         device=device, task_data=data,
                                         threads=threads, seed=seed)
    tuned, missing_tuned = run_comparison_groups(
        n_workers, rounds, 1.0, strategies=("masgd",), masgd_momentum=0.5,
        device=device, task_data=data, threads=threads, seed=seed)
    finals = {k: v[-1] for k, v in res.items()}
    if tuned.get("masgd"):
        finals["masgd_tuned_m0.5"] = tuned["masgd"][-1]
    init = next(iter(res.values()))[0] if res else None
    conv = {k: v for k, v in finals.items()
            if init is not None and np.isfinite(v) and v < 0.55 * init}
    band5 = band6 = skipped5 = skipped6 = None
    if len(conv) >= 5:
        band5 = _best_band(conv, k=5)
    else:
        skipped5 = (f"{len(conv)} of {len(finals)} finals converged "
                    "below 0.55 of the initial loss; 5 needed")
    six = {k: v for k, v in conv.items() if k != "masgd"}
    if len(six) >= 6:
        band6 = _best_band(six, k=6)
    else:
        want6 = set(ALL_STRATEGIES) - {"masgd"} | {"masgd_tuned_m0.5"}
        skipped6 = ("6 needed with the tuned masgd in place of the "
                    f"default; not converged or missing: "
                    f"{sorted(want6 - set(six))}")
    return {"convergence_blstm_hardcorpus_final_loss": finals,
            "initial_loss": init, "seed": seed, "ranks": n_workers,
            "device": device, "best_5strategy_band": band5,
            "band5_skipped": skipped5,
            "best_6strategy_band_tuned_masgd": band6,
            "band6_skipped": skipped6,
            "strategies_missing": {**missing, **{
                f"{k}_tuned_m0.5": v for k, v in missing_tuned.items()}}}


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m kaldi_aslp_tpu_torch.parallel.convergence --ranks 8
    --device cuda --seeds 0 1 2``: one JSON line of ``blstm_band`` a seed,
    each with the task's targets and features set beside those built on
    the CPU (``task_vs_cpu``), so that a gap between the devices' bands
    can be told to come from the data or from rounding."""
    import argparse
    import json
    import time

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--threads", type=int, default=None)
    a = ap.parse_args(argv)
    for seed in a.seeds:
        t0 = time.perf_counter()
        task = make_hard_frame_task(seed=seed, device=a.device)
        line = blstm_band(a.ranks, a.device, seed, a.rounds, a.threads, task)
        if a.device != "cpu":
            cpu = make_hard_frame_task(seed=seed, device="cpu")
            pairs = list(zip(task[:4], cpu[:4]))
            if all(m.shape == c.shape for m, c in pairs):
                line["task_vs_cpu"] = {
                    "targets_equal_share": float(np.mean(np.concatenate(
                        [(m == c).ravel() for m, c in pairs[1::2]]))),
                    "feats_max_abs_diff": float(max(
                        np.abs(m - c).max() for m, c in pairs[0::2]))}
            else:
                line["task_vs_cpu"] = {"shapes": [
                    [m.shape, c.shape] for m, c in pairs]}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
