"""The port's truncated-BPTT training slice against the JAX package:
``SequenceDataReader``, ``xent_loss`` and the ``LossReporter`` accuracy
line, the weight carry-over of ``build_lstm_hybrid``, ``LstmStreamsTrainer``
chunk by chunk against the JAX BPTT CLI's step (rebuilt here from JAX's
``net.apply``, ``xent_loss`` and ``make_sgd_update``, as
kaldi_aslp_tpu/cli/train_tools.py:301-321 defines it), and the
``aslp-nnet-train-lstm-streams`` CLI end to end on the CPU.

Tolerance: max |port - JAX| / max |JAX| <= 1e-4 per parameter, velocity
and chunk loss, and per carried state in float32 (the same float32 math
summed in another order over three chunks and two layers).  The bf16
model's carried state is bf16-valued (it comes from the stored streams):
2e-2, and no more than 1% of its elements may differ from JAX's at all,
since a value rounds the other way only on a rounding boundary.  A plain
version that skipped the bf16 rounding of the product operands misses
these limits by 4e-6 in the loss, 4e-3 in the velocity and 0.5% of a
bf16 step in the state.  Loss reports and chunks are compared exactly."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.cli.__main__ import TOOLS as JAX_TOOLS
from kaldi_aslp_tpu.data.sequence import (
    SequenceDataReader as JaxSequenceDataReader,
    SequenceReaderOptions as JaxSequenceReaderOptions,
)
from kaldi_aslp_tpu.models import Nnet as JaxNnet
from kaldi_aslp_tpu.models.flagship import (
    build_lstm_hybrid as jax_build_lstm_hybrid,
)
from kaldi_aslp_tpu.models.losses import (
    LossReporter as JaxLossReporter,
    xent_loss as jax_xent_loss,
)
from kaldi_aslp_tpu.models.recurrent import LstmProjectedStreams as JaxLstm
from kaldi_aslp_tpu.models.simple import AffineTransform as JaxAffine
from kaldi_aslp_tpu.train.sgd import (
    NnetTrainOptions as JaxNnetTrainOptions,
    init_velocity as jax_init_velocity,
    make_sgd_update as jax_make_sgd_update,
)
from kaldi_aslp_tpu_torch.cli import train_tools
from kaldi_aslp_tpu_torch.cli.__main__ import TOOLS, main as cli_main
from kaldi_aslp_tpu_torch.data.sequence import (
    SequenceDataReader,
    SequenceReaderOptions,
)
from kaldi_aslp_tpu_torch.io import int_vector_writer, matrix_writer
from kaldi_aslp_tpu_torch.models import Nnet
from kaldi_aslp_tpu_torch.models.flagship import build_lstm_hybrid
from kaldi_aslp_tpu_torch.models.interop import params_from_jax, params_to_jax
from kaldi_aslp_tpu_torch.models.losses import LossReporter, xent_loss
from kaldi_aslp_tpu_torch.train import (
    LstmStreamsTrainer,
    NnetTrainOptions,
    init_velocity,
)
from kaldi_aslp_tpu_torch.train.trainer import upload_chunk

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, C, P, V = 20, 32, 16, 12
F32_TOL, BF16_TOL, BF16_SHARE = 1e-4, 2e-2, 1e-2
SOPTS = dict(num_streams=3, batch_size=4, targets_delay=2)
LSTM_TOOLS = ["aslp-nnet-train-lstm-streams",
              "aslp-nnet-train-lstm-streams-skip",
              "aslp-nnet-train-blstm-streams",
              "aslp-nnet-train-blstm-streams-lc",
              "aslp-nnet-train-blstm-parallel", "aslp-nnet-train-perutt"]


def _corpus(lengths, seed, cut=0):
    """Utterances whose targets are a function of the features (so a model
    can learn them); every other one has ``cut`` targets fewer than
    frames, which the trainer's source cuts away."""
    rs = np.random.RandomState(seed)
    proj = rs.randn(D, V)
    out = []
    for i, n in enumerate(lengths):
        feats = rs.randn(n, D).astype(np.float32)
        targets = np.argmax(feats @ proj, axis=1).astype(np.int32)
        out.append((f"utt{i:02d}", feats,
                    targets[:n - cut] if i % 2 else targets))
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# -- the data reader -----------------------------------------------------------

@pytest.mark.parametrize("opts", [
    dict(num_streams=3, batch_size=4),
    dict(num_streams=2, batch_size=5, targets_delay=2, skip_width=2,
         skip_offset=1),
    dict(num_streams=3, batch_size=3, targets_delay=0, drop_len=8)],
    ids=["defaults", "delay-skip", "drop-len"])
def test_sequence_reader_matches_jax(opts):
    items = _corpus([5, 9, 3, 12, 7, 1, 8], seed=1, cut=2)
    reader = SequenceDataReader(items, SequenceReaderOptions(**opts))
    reader_j = JaxSequenceDataReader(items, JaxSequenceReaderOptions(**opts))
    got, want = list(reader), list(reader_j)
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        for field in ("feats", "targets", "frame_mask", "new_utt_flags"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert reader.num_dropped == reader_j.num_dropped
    assert sum(int(c.new_utt_flags.sum()) for c in got) > opts["num_streams"]


# -- the loss ------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [True, False],
                         ids=["mask-weights", "no-weights"])
def test_xent_loss_and_report_match_jax(weighted):
    rs = np.random.RandomState(2)
    rep, rep_j = LossReporter("xent"), JaxLossReporter("xent")
    for _ in range(3):
        logits = rs.randn(3, 6, V).astype(np.float32)
        logits[0, 0, :2] = 5.0          # a tie: the first maximum wins
        targets = rs.randint(0, V, (3, 6)).astype(np.int32)
        targets[0, 0] = 0
        weights = (rs.rand(3, 6) > 0.3).astype(np.float32) if weighted \
            else None
        loss, aux = xent_loss(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if weights is None else torch.from_numpy(weights))
        loss_j, aux_j = jax_xent_loss(
            jnp.asarray(logits), jnp.asarray(targets),
            None if weights is None else jnp.asarray(weights))
        assert abs(float(loss) - float(loss_j)) <= 1e-6 * abs(float(loss_j))
        assert sorted(aux) == sorted(aux_j)
        for k in aux:
            assert abs(float(aux[k]) - float(aux_j[k])) <= 1e-5 * max(
                abs(float(aux_j[k])), 1.0), k
        rep.update(aux)
        rep_j.update(aux_j)
    assert rep.report() == rep_j.report()
    assert "FRAME_ACCURACY >> " in rep.report()


# -- the model ---------------------------------------------------------------

def test_lstm_hybrid_weights_carry_over_both_ways(tmp_path):
    net_j = jax_build_lstm_hybrid(D, 2, P, C, V)
    params = net_j.init(jax.random.PRNGKey(4))
    net_j.save(str(tmp_path / "jax.zip"), params)
    net, _ = Nnet.load(str(tmp_path / "jax.zip"), "cpu")
    built = build_lstm_hybrid(D, 2, P, C, V)
    assert [type(n) for n in net.nodes] == [type(n) for n in built.nodes]
    assert {k: v.shape for k, v in net.state_dict().items()} == {
        k: v.shape for k, v in built.state_dict().items()}
    built.load_state_dict(params_from_jax(params), strict=True)
    want = _flat(params)
    for tree in (params_to_jax(net.state_dict()),
                 params_to_jax(built.state_dict())):
        got = _flat(tree)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    net.save(str(tmp_path / "port.zip"))
    _, params_back, _ = JaxNnet.load(str(tmp_path / "port.zip"))
    back = _flat(params_back)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    # the carried state: one {c, r} per LSTMP node, on either side
    st, st_j = net.init_state(3), net_j.init_state(3)
    assert jax.tree_util.tree_map(np.shape, st_j) == {
        k: {kk: tuple(vv.shape) for kk, vv in v.items()}
        for k, v in st.items()}


def _jax_hybrid(path, **attrs):
    net = JaxNnet()
    dim = D
    for _ in range(2):
        net.add(JaxLstm(dim, P, cell_dim=C, **attrs))
        dim = P
    net.add(JaxAffine(dim, V, param_stddev=0.3, bias_mean=0.0,
                      bias_range=0.0, learn_rate_coef=0.5, max_norm=1.5))
    params = net.init(jax.random.PRNGKey(5))
    net.save(path, params)
    return net, params


def _jax_bptt_step(net, update):
    """The step of the JAX BPTT CLI (kaldi_aslp_tpu/cli/train_tools.py:
    301-321), rebuilt from its parts."""
    def step(params, velocity, states, feats, targets, mask, flags, lr):
        def reset(s):
            return jax.tree_util.tree_map(
                lambda v: v * (1.0 - flags)[:, None] if v.ndim == 2 else v,
                s)
        states = {k: reset(v) for k, v in states.items()}

        def loss_fn(p):
            y, new_states = net.apply(p, feats, states=states, train=True,
                                      mask=mask)
            loss, aux = jax_xent_loss(y, targets, mask)
            return loss, (aux, new_states)
        (loss, (_, new_states)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        params, velocity = update(params, grads, velocity, lr)
        return params, velocity, new_states, loss
    return step


@pytest.mark.parametrize("attrs", [dict(), dict(bf16=True, pallas=True)],
                         ids=["f32", "bf16"])
def test_bptt_chunks_match_jax_step(tmp_path, attrs):
    """Three chunks with the state carried across them and reset where a
    stream starts a new utterance (chunk 3), momentum and l2."""
    net_j, params = _jax_hybrid(str(tmp_path / "m.zip"), **attrs)
    opts = dict(learn_rate=0.05, momentum=0.9, l2_penalty=1e-3)
    step_j = _jax_bptt_step(
        net_j, jax_make_sgd_update(net_j, JaxNnetTrainOptions(**opts)))
    chunks = list(SequenceDataReader(
        _corpus([5, 9, 3, 6, 8], seed=6), SequenceReaderOptions(**SOPTS)))
    assert len(chunks) >= 3 and chunks[2].new_utt_flags.sum() > 0
    net, _ = Nnet.load(str(tmp_path / "m.zip"), "cpu")
    trainer = LstmStreamsTrainer(net, NnetTrainOptions(**opts))
    vel, vel_j = init_velocity(net), jax_init_velocity(params)
    states, states_j = trainer.init_state(3), net_j.init_state(3)
    for chunk in chunks[:3]:
        states, loss, aux = trainer.step(
            vel, states, upload_chunk(chunk, torch.device("cpu")), 0.05)
        params, vel_j, states_j, loss_j = step_j(
            params, vel_j, states_j, jnp.asarray(chunk.feats),
            jnp.asarray(chunk.targets), jnp.asarray(chunk.frame_mask),
            jnp.asarray(chunk.new_utt_flags, jnp.float32), 0.05)
        assert _rel(float(loss), float(loss_j)) <= F32_TOL
        assert float(aux["frames"]) == chunk.frame_mask.sum()
        assert not any(v.requires_grad for s in states.values()
                       for v in s.values())
    want_p, got_p = _flat(params), _flat(params_to_jax(net.state_dict()))
    want_v, got_v = _flat(vel_j), _flat(params_to_jax(vel))
    assert sorted(got_p) == sorted(want_p)
    for name in want_p:
        assert _rel(got_p[name], want_p[name]) <= F32_TOL, name
        assert _rel(got_v[name], want_v[name]) <= F32_TOL, name
    want_s = _flat(states_j)
    got_s = _flat({k: {kk: vv.numpy() for kk, vv in v.items()}
                   for k, v in states.items()})
    assert sorted(got_s) == sorted(want_s)
    for name in want_s:
        got, want = got_s[name], np.asarray(want_s[name], np.float32)
        if attrs.get("bf16"):
            assert _rel(got, want) <= BF16_TOL, name
            assert (got != want).mean() <= BF16_SHARE, name
        else:
            assert _rel(got, want) <= F32_TOL, name


# -- the CLI -----------------------------------------------------------------

def _write_corpus(tmp_path, items):
    with matrix_writer(f"ark,scp:{tmp_path}/feats.ark,"
                       f"{tmp_path}/feats.scp") as fw, \
            int_vector_writer(f"ark:{tmp_path}/ali.ark") as tw:
        for key, feats, targets in items:
            fw[key] = feats
            tw[key] = targets
    return f"scp:{tmp_path}/feats.scp", f"ark:{tmp_path}/ali.ark"


def test_cli_trains_on_cpu_and_jax_loads_the_model(tmp_path, capsys):
    _, params = _jax_hybrid(str(tmp_path / "m.zip"))
    items = _corpus([11, 7, 14, 9, 6, 10], seed=7, cut=2)
    feats, targets = _write_corpus(tmp_path, items)
    out = str(tmp_path / "out.zip")
    assert cli_main(["aslp-nnet-train-lstm-streams", "--device=cpu",
                     "--learn-rate=0.05", "--momentum=0.9",
                     "--l2-penalty=1e-4", "--num-streams=3",
                     "--batch-size=4", "--targets-delay=2", feats, targets,
                     str(tmp_path / "m.zip"), out]) == 0
    report = capsys.readouterr().out
    assert "AvgLoss:" in report and "(xent)" in report
    assert "FRAME_ACCURACY >> " in report
    frames = int(report.split("[frames ")[1].split("]")[0])
    assert frames == sum(len(t) + 2 for _, _, t in items)
    net, params_out, _ = JaxNnet.load(out)
    assert [n.comp.token for n in net.nodes] == [
        "<LstmProjectedStreams>"] * 2 + ["<AffineTransform>"]
    before, after = _flat(params), _flat(params_out)
    assert sorted(before) == sorted(after)
    assert all(np.isfinite(v).all() for v in after.values())
    assert min(np.abs(after[k] - before[k]).max() for k in before) > 0


def test_cross_validation_evaluates_without_an_update(tmp_path, capsys):
    """CV runs in eval() with the state carried and reset as in training:
    the parameters do not move, and its loss and accuracy are those of
    JAX's eval forward over the same chunks (the JAX CLI's own CV applies
    the update, a fault the port does not copy)."""
    net_j, params = _jax_hybrid(str(tmp_path / "m.zip"))
    items = _corpus([11, 7, 14, 9, 6, 10], seed=8)
    sopts = SequenceReaderOptions(**SOPTS)
    net, _ = Nnet.load(str(tmp_path / "m.zip"), "cpu")
    before = {k: v.clone() for k, v in net.state_dict().items()}
    rep = LstmStreamsTrainer(net).evaluate(SequenceDataReader(items, sopts),
                                           sopts.num_streams)
    for k, v in net.state_dict().items():
        assert torch.equal(v, before[k]), k
    rep_j = JaxLossReporter("xent")
    states = net_j.init_state(sopts.num_streams)
    for ch in SequenceDataReader(items, sopts):
        keep = 1.0 - jnp.asarray(ch.new_utt_flags, jnp.float32)[:, None]
        states = jax.tree_util.tree_map(lambda v: v * keep, states)
        y, states = net_j.apply(params, jnp.asarray(ch.feats), states=states,
                                train=False, mask=jnp.asarray(ch.frame_mask))
        rep_j.update(jax_xent_loss(y, jnp.asarray(ch.targets),
                                   jnp.asarray(ch.frame_mask))[1])
    assert rep.frames == rep_j.frames
    assert abs(rep.avg_loss - rep_j.avg_loss) <= 1e-5 * rep_j.avg_loss
    assert abs(rep.frame_accuracy - rep_j.frame_accuracy) <= 1e-4
    # through the CLI: the report, and no model written
    feats, targets = _write_corpus(tmp_path, items)
    out = tmp_path / "cv.zip"
    assert cli_main(["aslp-nnet-train-lstm-streams", "--device=cpu",
                     "--cross-validate=true", "--num-streams=3",
                     "--batch-size=4", "--targets-delay=2", feats, targets,
                     str(tmp_path / "m.zip"), str(out)]) == 0
    assert capsys.readouterr().out.strip() == rep.report()
    assert not out.exists()


def test_cli_names_map_to_the_bptt_trainer_as_in_jax():
    for name in LSTM_TOOLS:
        assert TOOLS[name] is train_tools.nnet_train_lstm_streams, name
        assert JAX_TOOLS[name].__name__ == "nnet_train_lstm_streams", name


def test_cli_refuses_a_model_with_a_component_the_port_lacks(tmp_path):
    import json
    import zipfile

    from kaldi_aslp_tpu.models.simple import Tanh
    # every JAX token is ported, so the model file names one neither
    # package registers in place of the Tanh
    net_j = JaxNnet()
    net_j.add(JaxAffine(D, 8))
    net_j.add(Tanh(8, 8))
    net_j.add(JaxAffine(8, V))
    net_j.save(str(tmp_path / "tanh.zip"), net_j.init(jax.random.PRNGKey(0)))
    with zipfile.ZipFile(tmp_path / "tanh.zip") as z:
        topo = json.loads(z.read("topology.json"))
        arrays = z.read("arrays.npz")
    topo["nodes"][1]["token"] = "<NoSuchComponent>"
    with zipfile.ZipFile(tmp_path / "dnn.zip", "w") as z:
        z.writestr("topology.json", json.dumps(topo))
        z.writestr("arrays.npz", arrays)
    feats, targets = _write_corpus(tmp_path, _corpus([5], seed=9))
    with pytest.raises(ValueError, match="unknown component token"):
        cli_main(["aslp-nnet-train-lstm-streams", "--device=cpu", feats,
                  targets, str(tmp_path / "dnn.zip")])


def test_cli_cuda_device_never_drops_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for one without")
    _jax_hybrid(str(tmp_path / "m.zip"))
    feats, targets = _write_corpus(tmp_path, _corpus([5], seed=10))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["aslp-nnet-train-lstm-streams", feats, targets,
                  str(tmp_path / "m.zip")])


_NO_JAX_BPTT = r"""
import importlib.abc, sys


class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, BlockJax())
from kaldi_aslp_tpu_torch.cli.__main__ import main
rc = main(["aslp-nnet-train-lstm-streams", "--device=cpu", "--num-streams=2",
           "--batch-size=4"] + sys.argv[1:])
print("RESULT", rc, "jax" in sys.modules,
      any(m.startswith("kaldi_aslp_tpu.") for m in sys.modules))
"""


def test_bptt_cli_runs_with_jax_blocked(tmp_path):
    _jax_hybrid(str(tmp_path / "m.zip"), bf16=True)
    feats, targets = _write_corpus(tmp_path, _corpus([6, 9, 4], seed=11))
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_BPTT, feats, targets,
         str(tmp_path / "m.zip"), str(tmp_path / "out.zip")],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RESULT 0 False False" in proc.stdout, proc.stdout[-2000:]
    assert "FRAME_ACCURACY" in proc.stdout
    assert (tmp_path / "out.zip").exists()
