"""``Dropout`` through the port's trainers, and the one rule of when a
frame trainer hands the net streams of one frame.

Every trainer (``FrameTrainer``, which both ``aslp-nnet-train-simple``
and ``aslp-nnet-train-frame-mimo`` run, ``CtcTrainer`` and
``LstmStreamsTrainer``) draws a ``Dropout`` mask a step from its own
generator in training, and none in ``eval()`` mode, where the component
is the identity.  The JAX frame and CTC trainers drop out in training
too (they pass ``rng``); the JAX BPTT tool passes no key, so its
``Dropout`` drops nothing (ROADMAP queue 3): the test shows it writes
the same model at retention 0.5 as at 1.0, where the port's differ.

The kept share of a mask of 4096 draws at retention 0.7 is held within
0.05 of 0.7 (about six standard deviations)."""

import numpy as np
import pytest
import torch

import jax

import kaldi_aslp_tpu.models as J
from kaldi_aslp_tpu.cli.__main__ import main as jax_main
import kaldi_aslp_tpu_torch.models as M
from kaldi_aslp_tpu_torch.cli.__main__ import main
from kaldi_aslp_tpu_torch.io import int_vector_writer, matrix_writer
from kaldi_aslp_tpu_torch.models import simple as port_simple
from kaldi_aslp_tpu_torch.train import (
    CtcTrainer,
    FrameTrainer,
    LstmStreamsTrainer,
    NnetTrainOptions,
    init_velocity,
)

torch.set_num_threads(1)

D, H, V = 6, 16, 4
RETENTION = 0.7
CPU = "--device=cpu"


def _dropout_net(retention=RETENTION, dims=(D, H, V)):
    net = M.Nnet()
    net.add(M.AffineTransform(dims[0], dims[1]))
    net.add(M.Dropout(dims[1], dims[1], dropout_retention=retention))
    net.add(M.AffineTransform(dims[1], dims[2]))
    net.reset_parameters(torch.Generator().manual_seed(0))
    return net


class _Seen:
    """The Dropout node's inputs and outputs, and the masks drawn."""

    def __init__(self, net=None):
        self.io, self.draws = [], 0
        if net is not None:
            net.nodes[1].register_forward_hook(
                lambda mod, args, out: self.io.append((args[0].detach(),
                                                       out[0].detach())))

    def __enter__(self):
        self._orig = port_simple.dropout_keep

        def keep(*args):
            self.draws += 1
            return self._orig(*args)
        port_simple.dropout_keep = keep
        return self

    def __exit__(self, *exc):
        port_simple.dropout_keep = self._orig

    def kept_share(self):
        x, y = self.io[-1]
        kept = y != 0
        assert torch.allclose(y[kept], x[kept] / RETENTION)
        return float(kept.float().mean())


def test_frame_trainer_drops_out_in_training_only():
    net = _dropout_net()
    trainer = FrameTrainer(net, NnetTrainOptions(learn_rate=0.1))
    rs = np.random.RandomState(0)
    N = 256
    batch = (torch.from_numpy(rs.randn(N, D).astype(np.float32)),
             torch.from_numpy(rs.randint(0, V, N)), torch.ones(N))
    with _Seen(net) as seen:
        velocity = init_velocity(net)
        trainer.step(velocity, batch, 0.1)
        first = seen.io[-1][1] != 0
        assert abs(seen.kept_share() - RETENTION) < 0.05
        trainer.step(velocity, batch, 0.1)
        assert not torch.equal(seen.io[-1][1] != 0, first)
        assert seen.draws == 2
        rep = trainer.evaluate([tuple(a.numpy() for a in batch)])
        x, y = seen.io[-1]
        assert torch.equal(x, y) and seen.draws == 2
    assert rep.frames == N


def _frame_corpus(tmp_path, n_utts=4, T=64, seed=1):
    rs = np.random.RandomState(seed)
    feats, ali = (str(tmp_path / n) for n in ("feats.ark", "ali.ark"))
    with matrix_writer(f"ark:{feats}") as wf, \
            int_vector_writer(f"ark:{ali}") as wa:
        for u in range(n_utts):
            wf[f"u{u}"] = rs.randn(T, D).astype(np.float32)
            wa[f"u{u}"] = rs.randint(0, V, T).astype(np.int32)
    return f"ark:{feats}", f"ark:{ali}"


def test_train_simple_and_mimo_cli_draw_masks_and_cv_does_not(tmp_path,
                                                              capsys):
    feats, ali = _frame_corpus(tmp_path)
    model = str(tmp_path / "m.zip")
    _dropout_net().save(model)
    args = ["--minibatch-size=64", "--randomizer-size=256"]
    for tool, extra in (("aslp-nnet-train-simple", []),
                        ("aslp-nnet-train-frame-mimo",
                         ["--objective-function=xent"])):
        with _Seen() as seen:
            assert main([tool, CPU, *args, *extra, feats, ali, model,
                         str(tmp_path / "out.zip")]) == 0
            assert seen.draws == 4     # 256 frames, 64 a minibatch
            assert main([tool, CPU, "--cross-validate=true", *args, *extra,
                         feats, ali, model]) == 0
            assert seen.draws == 4
        reports = [ln for ln in capsys.readouterr().out.splitlines()
                   if "AvgLoss" in ln]
        assert len(reports) == 2


def test_ctc_and_bptt_trainers_draw_masks_in_training():
    rs = np.random.RandomState(2)
    S, T = 8, 32
    net = _dropout_net(dims=(D, H, V + 1))
    trainer = CtcTrainer(net, NnetTrainOptions())
    batch = (torch.from_numpy(rs.randn(S, T, D).astype(np.float32)),
             torch.from_numpy(rs.randint(1, V + 1, (S, 5))),
             torch.full((S,), T), torch.full((S,), 5), torch.ones(S, T))
    with _Seen(net) as seen:
        trainer.step(init_velocity(net), batch, 0.01)
        assert seen.draws == 1
        assert abs(seen.kept_share() - RETENTION) < 0.05
    net = _dropout_net()
    trainer = LstmStreamsTrainer(net, NnetTrainOptions())
    chunk = (torch.from_numpy(rs.randn(S, T, D).astype(np.float32)),
             torch.from_numpy(rs.randint(0, V, (S, T))), torch.ones(S, T),
             torch.zeros(S))
    with _Seen(net) as seen:
        trainer.step(init_velocity(net), trainer.init_state(S), chunk, 0.01)
        assert seen.draws == 1
        assert abs(seen.kept_share() - RETENTION) < 0.05


def _jax_dropout_net(path, retention):
    jnet = J.Nnet()
    jnet.add(J.AffineTransform(D, H))
    jnet.add(J.Dropout(H, H, dropout_retention=retention))
    jnet.add(J.AffineTransform(H, V))
    jnet.save(path, jnet.init(jax.random.PRNGKey(0)))


def _params(path):
    return {k: v.numpy() for k, v in M.Nnet.load(path, "cpu")[0]
            .state_dict().items()}


def test_jax_bptt_tool_drops_nothing_and_the_port_drops_out(tmp_path):
    feats, ali = _frame_corpus(tmp_path, T=24)
    tool = "aslp-nnet-train-lstm-streams"
    flags = ["--num-streams=2", "--batch-size=8", "--learn-rate=0.1"]
    out = {}
    for retention in (0.5, 1.0):
        model = str(tmp_path / f"m{retention}.zip")
        _jax_dropout_net(model, retention)
        for pkg, run, dev in (("jax", jax_main, []), ("port", main, [CPU])):
            path = str(tmp_path / f"{pkg}{retention}.zip")
            assert run([tool, *dev, *flags, feats, ali, model, path]) == 0
            out[pkg, retention] = _params(path)
    for k, v in out["jax", 1.0].items():
        np.testing.assert_array_equal(out["jax", 0.5][k], v)
        np.testing.assert_allclose(out["port", 1.0][k], v, rtol=0,
                                   atol=1e-4 * np.abs(v).max())
    assert any(not np.allclose(out["port", 0.5][k], v, atol=1e-3)
               for k, v in out["port", 1.0].items())


# (component, whether a frame trainer gives it streams of one frame)
RULE = [("Splice", False), ("Lstm", True), ("CompactFsmn", True),
        ("RowConvolution", True), ("BatchNormalization", True),
        ("AffineTransform", False)]


@pytest.mark.parametrize("name,per_frame", RULE, ids=[r[0] for r in RULE])
def test_frame_trainer_one_frame_rule(name, per_frame):
    """A net with a component that takes the frame mask sees a shuffled
    minibatch as N streams of one frame; ``Splice`` takes the rows as its
    time axis, as the JAX trainers and the reference do."""
    width = 3 * D if name == "Splice" else D
    attrs = {"build_vector": "-1:1"} if name == "Splice" else {}
    net = M.Nnet()
    net.add(M.component_from_token(f"<{name}>")(D, width, **attrs))
    net.add(M.AffineTransform(width, V))
    net.reset_parameters(torch.Generator().manual_seed(3))
    net.eval()
    x = torch.randn(9, D, generator=torch.Generator().manual_seed(4))
    want = net(x[:, None])[0][:, 0] if per_frame else net(x)[0]
    for objective in ("xent", "mse"):
        got = FrameTrainer(net, NnetTrainOptions(), objective).forward(x)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    if name == "Splice":
        # as streams of one frame it would splice each row with itself
        assert not torch.allclose(got, net(x[:, None])[0][:, 0])
    if name == "BatchNormalization":
        torch.testing.assert_close(got, net(x)[0])
