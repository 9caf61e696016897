"""The port's worker CLIs (kaldi_aslp_tpu_torch/cli/parallel_tools.py)
and convergence runs (parallel/convergence.py, entry.py) on the CPU.

The six worker types run on the JAX CLI test's frame task and flags
(tests/test_cli_round2.py:229-297) at 4 ranks (spawned gloo ranks, one
torch thread each) against JAX's CLI at ``--num-workers=4`` (4 of the 8
CPU mesh devices) from the same initial model: one epoch each, the saved
models within 1e-4 (float32 over 9 minibatches at lr 0.3, sums in
another order), and the port's model lowers the CV loss.  Also the
server tool's message, the registry equal to JAX's, a run in a process
where importing ``jax`` or any ``kaldi_aslp_tpu.`` module fails (its
ranks too), the dryrun's BSP and BMUF steps, and the affine convergence
at 8 rounds on all six strategies.  The hard-corpus BLSTM band (300
rounds at 8 ranks) is marked slow, as JAX's is."""

import functools
import io
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu.cli.__main__ import TOOLS as JAX_TOOLS
from kaldi_aslp_tpu.cli.__main__ import main as jax_main
from kaldi_aslp_tpu.io import int_vector_writer, matrix_writer
from kaldi_aslp_tpu_torch.cli.__main__ import TOOLS
from kaldi_aslp_tpu_torch.cli.__main__ import main

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# a bound on each spawned group: a group takes 3-10 s here, but its ranks
# each import torch and the port, which takes several times longer on a
# host that runs the whole suite in parallel; a hang still fails
RUN_TIMEOUT_S = 240
WORKER_CASES = [
    ("bsp", []),
    ("sod", ["--server-optimizer=adam"]),
    ("bmuf", ["--sync-period=512", "--bmuf-momentum=0.5"]),
    ("easgd", ["--sync-period=256", "--alpha=0.5"]),
    ("asgd", ["--sync-period=256"]),
    ("masgd", ["--sync-period=256", "--masgd-momentum=0.5",
               "--learn-rate=0.05"]),
]


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Spawned ranks at one torch thread (they read OMP_NUM_THREADS when
    they import torch), each group bounded to RUN_TIMEOUT_S (the CLI and
    the dryrun look ``spawn`` up when they are called)."""
    from kaldi_aslp_tpu_torch.parallel import launch

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(launch, "spawn", functools.partial(
        launch.spawn, run_timeout_s=RUN_TIMEOUT_S))


@pytest.fixture
def frame_task(tmp_path):
    rng = np.random.RandomState(1)
    w = rng.randn(6, 4)
    feats_path = tmp_path / "feats.ark"
    tgt_path = tmp_path / "targets.ark"
    with matrix_writer(f"ark:{feats_path}") as fw, \
            int_vector_writer(f"ark:{tgt_path}") as tw:
        for u in range(6):
            x = rng.randn(96, 6).astype(np.float32)
            y = (x @ w).argmax(1).astype(np.int32)
            fw[f"u{u}"] = x
            tw[f"u{u}"] = y
    proto = tmp_path / "nnet.proto"
    proto.write_text(
        "<AffineTransform> <InputDim> 6 <OutputDim> 16 "
        "<ParamStddev> 0.1\n"
        "<Sigmoid> <InputDim> 16 <OutputDim> 16\n"
        "<AffineTransform> <InputDim> 16 <OutputDim> 4 "
        "<ParamStddev> 0.1\n")
    model = tmp_path / "model.knet"
    assert jax_main(["aslp-nnet-init", str(proto), str(model)]) == 0
    return f"ark:{feats_path}", f"ark:{tgt_path}", str(model)


def _arrays(path):
    with zipfile.ZipFile(path) as z:
        npz = np.load(io.BytesIO(z.read("arrays.npz")))
        return {k: npz[k] for k in npz.files}


def _cv_loss(capsys, feats, targets, model):
    capsys.readouterr()
    assert main(["aslp-nnet-train-simple", "--device=cpu",
                 "--cross-validate=true", feats, targets, model]) == 0
    return float(capsys.readouterr().out.split("AvgLoss: ")[1].split()[0])


@pytest.mark.parametrize("worker_type,extra", WORKER_CASES)
def test_worker_cli_matches_jax(tmp_path, frame_task, capsys,
                                one_thread_ranks, worker_type, extra):
    feats, targets, model = frame_task
    args = [f"--worker-type={worker_type}", "--learn-rate=0.3",
            "--minibatch-size=64", "--num-workers=4", *extra]
    jout, pout = str(tmp_path / "jax.knet"), str(tmp_path / "port.knet")
    assert jax_main(["aslp-nnet-train-lstm-stream-worker", *args, feats,
                     targets, model, jout]) == 0
    assert main(["aslp-nnet-train-lstm-stream-worker", "--device=cpu",
                 *args, feats, targets, model, pout]) == 0
    assert "AvgLoss" in capsys.readouterr().out
    want, got = _arrays(jout), _arrays(pout)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **MODEL_TOL)
    loss0 = _cv_loss(capsys, feats, targets, model)
    loss1 = _cv_loss(capsys, feats, targets, pout)
    assert loss1 < loss0, (worker_type, loss0, loss1)


def test_server_cli_names_the_port_s_processes(capsys):
    assert main(["aslp-nnet-train-server"]) == 0
    err = capsys.readouterr().err
    assert "easgd" in err and "rank" in err and "TPU" not in err


def test_registry_equals_jax():
    assert set(TOOLS) == set(JAX_TOOLS) and len(TOOLS) == 103
    for name in ("aslp-nnet-train-frame-worker",
                 "aslp-nnet-train-lstm-stream-worker",
                 "aslp-nnet-train-lc-blstm-streams-worker",
                 "aslp-nnet-train-simple-mpi", "aslp-nnet-train-server"):
        assert TOOLS[name].__name__ == JAX_TOOLS[name].__name__, name


_BLOCKER = r'''
import importlib.abc, sys


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "kaldi_aslp_tpu"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, Block())
'''


def test_worker_cli_runs_with_jax_blocked(tmp_path, frame_task):
    """Two spawned ranks, each (and the parent) unable to import jax or
    kaldi_aslp_tpu: the blocker is a sitecustomize on PYTHONPATH, which
    every new interpreter runs."""
    feats, targets, model = frame_task
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_BLOCKER)
    out = str(tmp_path / "out.knet")
    env = dict(os.environ, PYTHONPATH=f"{site}{os.pathsep}{REPO}",
               OMP_NUM_THREADS="1")
    code = (
        "import sys\n"
        "from kaldi_aslp_tpu_torch.cli.__main__ import main\n"
        "rc = main(sys.argv[1:])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'kaldi_aslp_tpu')]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "aslp-nnet-train-frame-worker",
         "--device=cpu", "--num-workers=2", "--worker-type=bmuf",
         "--sync-period=128", "--learn-rate=0.3", "--minibatch-size=64",
         feats, targets, model, out],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "AvgLoss" in proc.stdout
    assert set(_arrays(out)) == set(_arrays(model))


def test_dryrun_steps_on_four_ranks(capsys, one_thread_ranks):
    from kaldi_aslp_tpu_torch.entry import dryrun_steps

    res = dryrun_steps(4, "cpu")
    assert [len(r["losses"]) for r in res] == [1, 1]
    assert '"bmuf"' in capsys.readouterr().out


def test_all_six_strategies_run_affine():
    """Every strategy records a finite trajectory from the same start
    (JAX's test_all_six_strategies_run_affine at 4 ranks)."""
    from kaldi_aslp_tpu_torch.parallel.convergence import (
        ALL_STRATEGIES,
        run_convergence_comparison,
    )

    res = run_convergence_comparison(4, n_rounds=8,
                                     strategies=ALL_STRATEGIES,
                                     device="cpu", threads=1,
                                     run_timeout_s=RUN_TIMEOUT_S)
    assert set(res) == set(ALL_STRATEGIES)
    for name, traj in res.items():
        assert len(traj) == 9
        assert np.isfinite(np.asarray(traj)).all(), name
    assert len({round(v[0], 6) for v in res.values()}) == 1


def test_failed_strategy_is_named(monkeypatch):
    """A strategy whose group fails every retry is named with its error,
    never dropped silently."""
    from kaldi_aslp_tpu_torch.parallel import convergence

    calls = []

    def fail(*a, **kw):
        calls.append(kw["device"])
        raise TimeoutError("2 ranks of convergence_rank still running")

    monkeypatch.setattr(convergence, "run_convergence_comparison", fail)
    res, missing = convergence.run_comparison_groups(
        2, 1, 1.0, strategies=("bsp",), device="cpu", task_data=object())
    assert res == {} and "still running" in missing["bsp"]
    assert calls == ["cpu"] * 3


def test_an_error_of_the_caller_is_not_retried(monkeypatch):
    """An error raised in the calling process (here: no card) propagates
    at once; only a failed group is retried."""
    from kaldi_aslp_tpu_torch.parallel import convergence

    calls = []

    def fail(*a, **kw):
        calls.append(1)
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")

    monkeypatch.setattr(convergence, "run_convergence_comparison", fail)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convergence.run_comparison_groups(
            2, 1, 1.0, strategies=("bsp",), task_data=object())
    assert calls == [1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal "
                    "on a host without a card")
@pytest.mark.parametrize("call", ["comparison", "groups", "task"])
def test_convergence_runs_on_the_card_unless_asked(call):
    """The convergence API's device is the card by default: without one
    it refuses, never trains CPU ranks unasked."""
    from kaldi_aslp_tpu_torch.parallel import convergence

    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "comparison":
            convergence.run_convergence_comparison(2, n_rounds=1)
        elif call == "groups":
            convergence.run_comparison_groups(2, 1, 1.0, task_data=object())
        else:
            convergence.make_hard_frame_task()


def test_dryrun_fails_when_a_strategy_is_missing(monkeypatch, capsys):
    """A strategy whose group failed every try fails the dryrun; it is
    printed with its error first."""
    from kaldi_aslp_tpu_torch import entry
    from kaldi_aslp_tpu_torch.parallel import convergence

    finals = dict(bsp=1.0, bmuf=1.0, easgd=1.0, asgd=1.0, sod=1.0)
    monkeypatch.setattr(convergence, "blstm_band", lambda n, device: {
        "convergence_blstm_hardcorpus_final_loss": finals,
        "best_5strategy_band": 1.0, "best_6strategy_band_tuned_masgd": None,
        "strategies_missing": {"masgd": "TimeoutError: ..."}})
    with pytest.raises(AssertionError, match="masgd"):
        entry.dryrun_convergence(2, "cpu")
    assert '"strategies_missing": {"masgd"' in capsys.readouterr().out


@pytest.mark.slow
def test_blstm_hardcorpus_six_strategy_band():
    """Six strategies on a small BLSTM over hard-corpus frames at 8 ranks,
    300 rounds: every group finishes, and at least 5 converge into a
    1.25x final-loss band (JAX's test of the same name)."""
    from kaldi_aslp_tpu_torch.parallel.convergence import (
        _best_band,
        run_comparison_groups,
    )

    res, missing = run_comparison_groups(8, 300, 1.0, device="cpu",
                                         threads=1)
    assert not missing, missing
    finals = {k: v[-1] for k, v in res.items()}
    init = next(iter(res.values()))[0]
    conv = {k: v for k, v in finals.items() if v < 0.55 * init}
    assert len(conv) >= 5, finals
    assert _best_band(conv, 5) <= 1.25, finals
