"""The port's CTC training path against the JAX package: the Kaldi table
copy (kaldi_aslp_tpu_torch/io/), ``CtcBatcher``, one ``CtcTrainer`` run
on a small flagship-shaped BLSTM-CTC, and the
``aslp-nnet-train-ctc-streams`` CLI end to end on the CPU.  Also the
inference path's gradient guard (the eval forward records no graph on
any device) and a run of the trainer CLI with ``jax`` blocked.

Tolerance for the trainer: max |port - JAX| / max |JAX| <= 1e-4 per
parameter and velocity tensor and on the loss.  The bf16 model rounds at
the same places on both sides (the JAX side runs its Pallas training
kernels in interpret mode, the port their plain versions); the float32
model compares the port's autograd through the plain recurrence with the
JAX scan."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.data.sequence import (
    CtcBatcher as JaxCtcBatcher,
    CtcBatcherOptions as JaxCtcBatcherOptions,
)
from kaldi_aslp_tpu.io import (
    int_vector_writer as jax_int_vector_writer,
    matrix_writer as jax_matrix_writer,
    random_access_int_vector_reader as jax_int_reader,
    sequential_matrix_reader as jax_matrix_reader,
)
from kaldi_aslp_tpu.models import Nnet as JaxNnet
from kaldi_aslp_tpu.models.recurrent import (
    BLstmProjectedStreams as JaxBLstm,
)
from kaldi_aslp_tpu.models.simple import AffineTransform as JaxAffine
from kaldi_aslp_tpu.train.sgd import (
    NnetTrainOptions as JaxNnetTrainOptions,
    init_velocity as jax_init_velocity,
)
from kaldi_aslp_tpu.train.trainer import CtcTrainer as JaxCtcTrainer
from kaldi_aslp_tpu_torch.cli.__main__ import main as cli_main
from kaldi_aslp_tpu_torch.data.sequence import (
    CtcBatcher,
    CtcBatcherOptions,
)
from kaldi_aslp_tpu_torch.io import (
    int_vector_writer,
    matrix_writer,
    random_access_int_vector_reader,
    sequential_matrix_reader,
)
from kaldi_aslp_tpu_torch.models import Nnet
from kaldi_aslp_tpu_torch.models.interop import params_to_jax
from kaldi_aslp_tpu_torch.models.recurrent import BLstmProjectedStreams
from kaldi_aslp_tpu_torch.ops.lstmp import refuse_autograd
from kaldi_aslp_tpu_torch.train import (
    CtcTrainer,
    NnetTrainOptions,
    init_velocity,
)
from kaldi_aslp_tpu_torch.train.trainer import upload

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, C, P, V = 40, 32, 16, 12
REL_TOL = 1e-4


def _corpus(n, seed, t_range=(7, 12), u_range=(1, 4)):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        T = rs.randint(*t_range)
        U = rs.randint(*u_range)
        out.append((f"utt{i:02d}", rs.randn(T, D).astype(np.float32),
                    rs.randint(1, V, U).astype(np.int32)))
    return out


# -- Kaldi tables --------------------------------------------------------------

def test_tables_match_jax_byte_for_byte(tmp_path):
    items = _corpus(4, seed=1)
    for name, writer in (("port", (matrix_writer, int_vector_writer)),
                         ("jax", (jax_matrix_writer,
                                  jax_int_vector_writer))):
        with writer[0](f"ark,scp:{tmp_path}/{name}.ark,"
                       f"{tmp_path}/{name}.scp") as fw, \
                writer[1](f"ark:{tmp_path}/{name}.lab") as lw, \
                writer[0](f"ark,t:{tmp_path}/{name}.txt") as tw:
            for key, feats, labels in items:
                fw[key] = feats
                lw[key] = labels
                tw[key] = feats[:2]
    for ext in ("ark", "lab", "txt"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes(), ext
    # each package reads what the other wrote, through ark, scp and a pipe
    for reader_pair in ((sequential_matrix_reader, jax_int_reader),
                        (jax_matrix_reader, random_access_int_vector_reader)):
        mats, labs = reader_pair
        for spec in (f"scp:{tmp_path}/jax.scp", f"ark:{tmp_path}/port.ark",
                     f"ark:cat {tmp_path}/jax.ark |"):
            got = list(mats(spec))
            assert [k for k, _ in got] == [k for k, _, _ in items]
            for (_, m), (_, feats, _) in zip(got, items):
                np.testing.assert_array_equal(m, feats)
        lab = labs(f"ark:{tmp_path}/port.lab")
        for key, _, labels in items:
            np.testing.assert_array_equal(lab[key], labels)
    text = dict(sequential_matrix_reader(f"ark,t:{tmp_path}/jax.txt"))
    for key, feats, _ in items:
        np.testing.assert_allclose(text[key], feats[:2], rtol=1e-6)


# -- CtcBatcher ----------------------------------------------------------------

@pytest.mark.parametrize("opts", [
    dict(num_streams=3, bucket_time=4, bucket_labels=4),
    dict(num_streams=8, frame_limit=30, skip_width=2, drop_len=11),
    dict(sort_by_length=False)])
def test_ctc_batcher_matches_jax(opts):
    items = _corpus(11, seed=2, t_range=(2, 14))
    got = list(CtcBatcher(items, CtcBatcherOptions(**opts)))
    want = list(JaxCtcBatcher(items, JaxCtcBatcherOptions(**opts)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys == w.keys
        for field in ("feats", "labels", "input_lengths", "label_lengths",
                      "frame_mask"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)


# -- the trainer ---------------------------------------------------------------

def _jax_model(path, **attrs):
    net = JaxNnet()
    dim = D
    for _ in range(2):
        net.add(JaxBLstm(dim, 2 * P, cell_dim=C, **attrs))
        dim = 2 * P
    net.add(JaxAffine(dim, V, param_stddev=0.3, bias_mean=0.0,
                      bias_range=0.0, learn_rate_coef=0.5, max_norm=1.2))
    params = net.init(jax.random.PRNGKey(3))
    net.save(path, params)
    return net, params


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("attrs", [dict(bf16=True, pallas=True),
                                   dict(pallas=False)],
                         ids=["bf16-fused", "f32-scan"])
def test_ctc_trainer_steps_match_jax(tmp_path, attrs):
    """Two momentum steps on one batch; JAX with pallas=True runs the
    x-fused training kernels in interpret mode."""
    net_j, params_j = _jax_model(str(tmp_path / "m.zip"), **attrs)
    opts = dict(learn_rate=0.05, momentum=0.9, l2_penalty=1e-3)
    batch = next(iter(CtcBatcher(_corpus(4, seed=4),
                                 CtcBatcherOptions(bucket_time=4,
                                                   bucket_labels=4))))
    trainer_j = JaxCtcTrainer(net_j, JaxNnetTrainOptions(**opts))
    vel_j = jax_init_velocity(params_j)
    dev_j = [jnp.asarray(a) for a in (batch.feats, batch.labels,
                                      batch.input_lengths,
                                      batch.label_lengths, batch.frame_mask)]
    net, _ = Nnet.load(str(tmp_path / "m.zip"), "cpu")
    trainer = CtcTrainer(net, NnetTrainOptions(**opts))
    vel = init_velocity(net)
    for step in range(2):
        params_j, vel_j, loss_j, _ = trainer_j._step(
            params_j, vel_j, *dev_j, jnp.float32(0.05),
            jax.random.PRNGKey(step))
        loss, aux = trainer.step(vel, upload(batch, torch.device("cpu")),
                                 0.05)
        assert abs(float(loss) - float(loss_j)) <= REL_TOL * abs(
            float(loss_j)), (step, float(loss), float(loss_j))
        assert float(aux["frames"]) == batch.input_lengths.sum()
    want_p, want_v = _flat(params_j), _flat(vel_j)
    got_p = params_to_jax(net.state_dict())
    got_v = params_to_jax(vel)
    assert sorted(_flat(got_p)) == sorted(want_p)
    for name, w in want_p.items():
        assert _rel(_flat(got_p)[name], w) <= REL_TOL, name
        assert _rel(_flat(got_v)[name], want_v[name]) <= REL_TOL, name
        assert np.abs(want_v[name]).max() > 0, name
    # max_norm clipped the output layer's rows
    assert np.sqrt((_flat(got_p)["2.w"] ** 2).sum(1)).max() <= 1.2 + 1e-5


def _write_corpus(tmp_path, items):
    feats = f"ark,scp:{tmp_path}/feats.ark,{tmp_path}/feats.scp"
    with matrix_writer(feats) as fw, \
            int_vector_writer(f"ark:{tmp_path}/labels.ark") as lw:
        for key, f, l in items:
            fw[key] = f
            lw[key] = l
    return f"scp:{tmp_path}/feats.scp", f"ark:{tmp_path}/labels.ark"


def test_cli_trains_on_cpu_and_jax_loads_the_model(tmp_path, capsys):
    _, params_j = _jax_model(str(tmp_path / "m.zip"), bf16=True)
    feats, labels = _write_corpus(tmp_path, _corpus(7, seed=5))
    out = str(tmp_path / "out.zip")
    assert cli_main(["aslp-nnet-train-ctc-streams", "--device=cpu",
                     "--learn-rate=0.05", "--momentum=0.9",
                     "--num-streams=3", "--bucket-time=4", feats, labels,
                     str(tmp_path / "m.zip"), out]) == 0
    report = capsys.readouterr().out
    assert "AvgLoss:" in report and "(ctc)" in report
    frames = int(report.split("[frames ")[1].split("]")[0])
    assert frames == sum(len(f) for _, f, _ in _corpus(7, seed=5))
    net, params, _ = JaxNnet.load(out)
    assert [n.comp.token for n in net.nodes] == [
        "<BLstmProjectedStreams>"] * 2 + ["<AffineTransform>"]
    before, after = _flat(params_j), _flat(params)
    assert sorted(before) == sorted(after)
    assert all(np.isfinite(v).all() for v in after.values())
    assert max(np.abs(after[k] - before[k]).max() for k in before) > 0
    # cross-validation only reports the loss and writes nothing
    assert cli_main(["aslp-nnet-train-ctc-streams", "--device=cpu",
                     "--cross-validate", feats, labels, out]) == 0
    assert "(ctc-cv)" in capsys.readouterr().out


def test_cli_cuda_device_never_drops_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for one without")
    _jax_model(str(tmp_path / "m.zip"), bf16=True)
    feats, labels = _write_corpus(tmp_path, _corpus(2, seed=6))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["aslp-nnet-train-ctc-streams", feats, labels,
                  str(tmp_path / "m.zip")])


# -- the inference path's gradients (a fault the trainer would have hit) -------

def test_eval_forward_records_no_graph_on_any_device():
    """The inference kernel has no backward, so on the card its outputs
    carried no gradient while the CPU's plain version carried one.  The
    eval path now runs under no_grad everywhere, and the kernel's wrapper
    refuses a call that autograd would record."""
    comp = BLstmProjectedStreams(D, 2 * P, cell_dim=C)
    comp.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 5, D)
                         .astype(np.float32))
    comp.eval()
    with torch.enable_grad():
        ys, _ = comp(x)
    assert not ys.requires_grad and ys.grad_fn is None
    w = comp.fwd.w_gifo_r
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_autograd(x, w)
    with torch.no_grad():
        refuse_autograd(x, w)
    comp.train()
    ys, _ = comp(x)
    ys.sum().backward()
    assert float(comp.fwd.w_gifo_r.grad.abs().sum()) > 0
    # float32 training goes through the training core's kernels, which
    # exist for CUDA only: on any other device it raises, never falling
    # back to the plain version
    comp.to("meta")
    with pytest.raises(ValueError, match="no LSTMP training kernel"):
        comp(x.to("meta"))


_NO_JAX_TRAIN = r"""
import importlib.abc, sys


class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, BlockJax())
import kaldi_aslp_tpu_torch.ops.bilstmp_train
import kaldi_aslp_tpu_torch.ops.bilstmp_xg_train
import kaldi_aslp_tpu_torch.ops.ctc
from kaldi_aslp_tpu_torch.cli.__main__ import main
rc = main(["aslp-nnet-train-ctc-streams", "--device=cpu", "--num-streams=2",
           "--bucket-time=4"] + sys.argv[1:])
shared = sorted({m.split(".")[1] for m in sys.modules
                 if m.startswith("kaldi_aslp_tpu.")})
print("RESULT", rc, "jax" in sys.modules, shared)
"""


def test_trainer_cli_runs_with_jax_blocked(tmp_path):
    _jax_model(str(tmp_path / "m.zip"), bf16=True)
    feats, labels = _write_corpus(tmp_path, _corpus(3, seed=8))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_TRAIN, feats, labels,
         str(tmp_path / "m.zip"), str(tmp_path / "out.zip")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RESULT 0 False []" in proc.stdout, proc.stdout[-2000:]
    assert (tmp_path / "out.zip").exists()


@pytest.mark.parametrize("switch", ["KALDI_ASLP_LSTM_NO_XFUSE",
                                    "KALDI_ASLP_LSTM_MXU_FP32",
                                    "KALDI_ASLP_LSTM_SPLIT_BWD"])
def test_trainer_cli_runs_with_jax_blocked_under_switch(tmp_path, switch):
    """The same run under each of the JAX package's LSTM switches, which
    route the bf16 BLSTMP to the xg-fed core or the split backward: no
    module of kaldi_aslp_tpu is loaded either."""
    _jax_model(str(tmp_path / "m.zip"), bf16=True)
    feats, labels = _write_corpus(tmp_path, _corpus(3, seed=9))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("KALDI_ASLP_LSTM_")}
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_TRAIN, feats, labels,
         str(tmp_path / "m.zip"), str(tmp_path / "out.zip")],
        cwd=REPO, env=dict(env, PYTHONPATH=REPO, **{switch: "1"}),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RESULT 0 False []" in proc.stdout, proc.stdout[-2000:]
    assert (tmp_path / "out.zip").exists()
