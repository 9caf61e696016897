"""The port's frame-level training path against the JAX package on the
CPU: ``FrameRandomizer`` (kaldi_aslp_tpu_torch/data/randomizer.py),
``FrameTrainer`` and ``mse_loss`` (train/trainer.py, models/losses.py),
``splice_frames`` (feats/functions.py), ``build_dnn_hybrid``
(models/flagship.py) and the layer-wise pretraining of train/pretrain.py.

Tolerances: the randomizer's minibatches are equal bit for bit (the same
numpy draws); one training step's loss within 1e-5 relative and each
parameter gradient, updated parameter and velocity within 1e-4 of the
tensor's largest magnitude against ``jax.grad`` / JAX's jitted step from
the same parameters (float32 sums in different orders)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.data.randomizer import (
    FrameRandomizer as JaxRandomizer,
    RandomizerOptions as JaxRandomizerOptions,
)
from kaldi_aslp_tpu.feats.functions import splice_frames as jax_splice
from kaldi_aslp_tpu.models import AffineTransform as JaxAffine
from kaldi_aslp_tpu.models import Sigmoid as JaxSigmoid
from kaldi_aslp_tpu.models.flagship import build_dnn_hybrid as jax_dnn
from kaldi_aslp_tpu.models.losses import mse_loss as jax_mse
from kaldi_aslp_tpu.models.nnet import Nnet as JaxNnet
from kaldi_aslp_tpu.train import FrameTrainer as JaxFrameTrainer
from kaldi_aslp_tpu.train import NnetTrainOptions as JaxTrainOptions
from kaldi_aslp_tpu.train import init_velocity as jax_velocity
from kaldi_aslp_tpu_torch.data.randomizer import (
    FrameRandomizer,
    RandomizerOptions,
)
from kaldi_aslp_tpu_torch.feats.functions import splice_frames
from kaldi_aslp_tpu_torch.models import (
    AffineTransform,
    Lstm,
    Nnet,
    Sigmoid,
    Softmax,
)
from kaldi_aslp_tpu_torch.models.flagship import build_dnn_hybrid
from kaldi_aslp_tpu_torch.models.interop import params_from_jax
from kaldi_aslp_tpu_torch.models.losses import mse_loss
from kaldi_aslp_tpu_torch.train import (
    FrameTrainer,
    NnetTrainOptions,
    init_velocity,
    insert_components,
    last_updatable_index,
    pretrain_layerwise,
)

torch.set_num_threads(1)

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def _close(got, want, tol=GRAD_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def _feed(randomizer, utts):
    out = []
    for f, t in utts:
        randomizer.feed(f, t)
        if randomizer.full():
            out.extend(randomizer.iterate_minibatches())
    out.extend(randomizer.flush())
    return out


@pytest.mark.parametrize("randomize", [True, False])
@pytest.mark.parametrize("pool,mb", [(100, 32), (32768, 256)])
def test_randomizer_minibatches_equal_jax(randomize, pool, mb):
    rs = np.random.RandomState(0)
    utts = [(rs.randn(n, 5).astype(np.float32),
             rs.randint(0, 9, n).astype(np.int32))
            for n in rs.randint(20, 90, 12)]
    kw = dict(randomizer_size=pool, minibatch_size=mb, randomizer_seed=5,
              randomize=randomize)
    got = _feed(FrameRandomizer(RandomizerOptions(**kw)), utts)
    want = _feed(JaxRandomizer(JaxRandomizerOptions(**kw)), utts)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="frame count"):
        FrameRandomizer().feed(np.zeros((3, 2)), np.zeros(4))


@pytest.mark.parametrize("left,right", [(0, 0), (2, 2), (4, 1)])
def test_splice_frames_clamps_like_jax(left, right):
    x = np.random.RandomState(1).randn(7, 3).astype(np.float32)
    got = splice_frames(torch.from_numpy(x), left, right).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jax_splice(jnp.asarray(x), left, right)))
    assert got.shape == (7, 3 * (left + 1 + right))
    np.testing.assert_array_equal(got[0, :3], x[0])   # clamped left edge


def test_mse_loss_matches_jax():
    rs = np.random.RandomState(2)
    y, t = rs.randn(2, 9, 4), rs.randn(2, 9, 4)
    w = rs.rand(2, 9)
    for weights in (None, w):
        got = mse_loss(torch.tensor(y), torch.tensor(t),
                       None if weights is None else torch.tensor(weights))
        want = jax_mse(jnp.asarray(y), jnp.asarray(t),
                       None if weights is None else jnp.asarray(weights))
        assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-6)
        for k in ("frames", "loss_sum"):
            assert float(got[1][k]) == pytest.approx(float(want[1][k]),
                                                     rel=1e-6)


def _dnn_pair(D=12, H=16, V=6, layers=2):
    """The same random DNN in both packages (JAX's init, carried over)."""
    jnet = JaxNnet()
    net = Nnet()
    dim = D
    for _ in range(layers):
        jnet.add(JaxAffine(dim, H, param_stddev=0.3))
        jnet.add(JaxSigmoid(H, H))
        net.add(AffineTransform(dim, H, param_stddev=0.3))
        net.add(Sigmoid(H, H))
        dim = H
    jnet.add(JaxAffine(dim, V, param_stddev=0.3))
    net.add(AffineTransform(dim, V, param_stddev=0.3))
    params = jnet.init(jax.random.PRNGKey(3))
    net.load_state_dict(params_from_jax(params))
    return net, jnet, params


def _batch(objective, N=40, D=12, V=6, seed=4):
    rs = np.random.RandomState(seed)
    feats = rs.randn(N, D).astype(np.float32)
    weights = (rs.rand(N) > 0.2).astype(np.float32)
    if objective == "xent":
        return feats, rs.randint(0, V, N).astype(np.int32), weights
    return feats, rs.randn(N, V).astype(np.float32), weights


@pytest.mark.parametrize("objective", ["xent", "mse"])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_frame_step_matches_jax(objective, momentum):
    net, jnet, params = _dnn_pair()
    feats, targets, weights = _batch(objective)
    opts = dict(momentum=momentum, l2_penalty=1e-3)
    trainer = FrameTrainer(net, NnetTrainOptions(**opts), objective)
    jtrainer = JaxFrameTrainer(jnet, JaxTrainOptions(**opts), objective)

    def jloss(p):
        y, _ = jnet.apply(p, jnp.asarray(feats), train=True)
        return jtrainer._loss(y, jnp.asarray(targets), jnp.asarray(weights))

    (jl, _), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    jvel = jax_velocity(params)
    for leaf in jax.tree_util.tree_leaves(jvel):
        assert not leaf.any()
    velocity = init_velocity(net)
    # two steps, so a nonzero velocity enters the second
    for it in range(2):
        batch = tuple(torch.from_numpy(a) for a in (
            feats, targets.astype(np.int64) if objective == "xent"
            else targets, weights))
        loss, aux = trainer.step(velocity, batch, 0.5)
        params, jvel, jloss_v, jaux = jtrainer._step(
            params, jvel, jnp.asarray(feats), jnp.asarray(targets),
            jnp.asarray(weights), jnp.asarray(0.5, jnp.float32),
            jax.random.PRNGKey(0))
        assert float(loss) == pytest.approx(float(jloss_v), rel=LOSS_RTOL)
        if it == 0:
            assert float(loss) == pytest.approx(float(jl), rel=LOSS_RTOL)
            got_grads = {k: p.grad.numpy()
                         for k, p in net.named_parameters()}
            for k, g in params_from_jax(jgrads).items():
                _close(got_grads[k], g)
        for k in ("frames", "loss_sum") + (("accuracy",)
                                           if objective == "xent" else ()):
            assert float(aux[k]) == pytest.approx(float(jaux[k]),
                                                  rel=LOSS_RTOL)
    for k, p in params_from_jax(params).items():
        _close(net.state_dict()[k], p)
    for k, v in params_from_jax(jvel).items():
        _close(velocity[k], v)


@pytest.mark.parametrize("objective", ["xent", "mse"])
def test_train_epoch_and_evaluate_report_like_jax(objective):
    """A randomized epoch through ``train_epoch`` from the same batches,
    then ``evaluate``: the same frames, losses and frame accuracy, and
    the JAX report's lines.  mse takes pdf ids as one-hot rows on the
    port (the JAX trainer is handed the one-hot rows)."""
    net, jnet, params = _dnn_pair()
    rs = np.random.RandomState(6)
    utts = [(rs.randn(n, 12).astype(np.float32),
             rs.randint(0, 6, n).astype(np.int32))
            for n in rs.randint(30, 80, 8)]
    ropts = dict(randomizer_size=128, minibatch_size=32)
    batches = _feed(FrameRandomizer(RandomizerOptions(**ropts)), utts)
    jbatches = [(f, t if objective == "xent"
                 else np.eye(6, dtype=np.float32)[t]) for f, t in batches]
    opts = dict(momentum=0.9)
    trainer = FrameTrainer(net, NnetTrainOptions(**opts), objective)
    jtrainer = JaxFrameTrainer(jnet, JaxTrainOptions(**opts), objective)
    _, rep = trainer.train_epoch(init_velocity(net), iter(batches), 0.3)
    params, _, jrep = jtrainer.train_epoch(params, jax_velocity(params),
                                           iter(jbatches), 0.3)
    cv = trainer.evaluate(iter(batches[:3]))
    jcv = jtrainer.evaluate(params, iter(jbatches[:3]))
    for got, want in ((rep, jrep), (cv, jcv)):
        assert got.name == want.name
        assert got.frames == want.frames
        assert got.avg_loss == pytest.approx(want.avg_loss, rel=1e-4)
        assert got.frame_accuracy == pytest.approx(want.frame_accuracy,
                                                   abs=1e-6)
        assert got.report().split("(")[1] == want.report().split("(")[1]
    assert ("FRAME_ACCURACY" in cv.report()) == (objective == "xent")
    assert net.training is False   # evaluate ran in eval() mode


def test_lstm_sees_one_frame_streams():
    """A net with an LSTM takes a frame minibatch as N streams of one
    frame: its outputs are those of the [N, 1, D] forward."""
    net = Nnet()
    net.add(Lstm(5, 8))
    net.add(AffineTransform(8, 3))
    net.reset_parameters(torch.Generator().manual_seed(1))
    trainer = FrameTrainer(net, NnetTrainOptions(), "xent")
    x = torch.randn(7, 5, generator=torch.Generator().manual_seed(2))
    want = net(x[:, None])[0][:, 0]
    torch.testing.assert_close(trainer.forward(x), want, rtol=0, atol=0)
    batch = (x, torch.randint(0, 3, (7,)), torch.ones(7))
    loss0, _ = trainer.step(init_velocity(net), batch, 0.0)
    assert torch.isfinite(loss0)


def test_build_dnn_hybrid_matches_jax():
    net, jnet = build_dnn_hybrid(), jax_dnn()
    assert [c.token for c in net.nodes] == [n.comp.token for n in jnet.nodes]
    assert [(c.input_dim, c.output_dim, c.attrs) for c in net.nodes] == \
        [(n.comp.input_dim, n.comp.output_dim, n.comp.attrs)
         for n in jnet.nodes]
    assert (net.nodes[0].input_dim, net.output_dim) == (440, 3019)


def _chain(*comps):
    net = Nnet()
    for c in comps:
        net.add(c)
    return net


def _hidden(in_dim, out_dim):
    return [AffineTransform(in_dim, out_dim, param_stddev=0.1,
                            bias_mean=0.0, bias_range=0.0),
            Sigmoid(out_dim, out_dim)]


def _drawn(net, seed):
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net


def test_last_updatable_index():
    """tests/test_pretrain.py's case."""
    net = _chain(*_hidden(4, 8), AffineTransform(8, 3), Softmax(3, 3))
    assert last_updatable_index(net) == 2


def test_insert_before_last_updatable_and_randomize():
    """tests/test_pretrain.py's case: Affine Sigmoid [Affine Sigmoid]
    Affine, the inserted and leading parameters kept, the output affine
    redrawn with stddev 0.1 / sqrt(8), the inputs unchanged."""
    base = _drawn(_chain(*_hidden(4, 8), AffineTransform(8, 3)), 1)
    ins = _drawn(_chain(*_hidden(8, 8)), 2)
    base_w = base.nodes[2].w.detach().clone()
    out = insert_components(base, ins,
                            generator=torch.Generator().manual_seed(3))
    assert [c.token for c in out.nodes] == [
        "<AffineTransform>", "<Sigmoid>", "<AffineTransform>", "<Sigmoid>",
        "<AffineTransform>"]
    torch.testing.assert_close(out.nodes[2].w, ins.nodes[0].w)
    torch.testing.assert_close(out.nodes[0].w, base.nodes[0].w)
    w = out.nodes[4].w.detach()
    assert not torch.equal(w, base_w)
    assert abs(float(w.std()) - 0.1 / np.sqrt(8)) < 0.02
    torch.testing.assert_close(base.nodes[2].w, base_w)
    assert out.nodes[0] is not base.nodes[0]
    y, _ = out(torch.ones(2, 5, 4))
    assert y.shape == (2, 5, 3)


def test_insert_no_randomize_keeps_params():
    base = _drawn(_chain(*_hidden(4, 8), AffineTransform(8, 3)), 1)
    ins = _drawn(_chain(*_hidden(8, 8)), 2)
    out = insert_components(base, ins, randomize_next=False)
    torch.testing.assert_close(out.nodes[4].w, base.nodes[2].w)


def test_insert_rejects_non_affine_next():
    base = _chain(*_hidden(4, 8), Softmax(8, 8))
    ins = _chain(Softmax(8, 8))
    with pytest.raises(ValueError):
        insert_components(base, ins, insert_at=1)


def test_pretrain_layerwise_grows_and_learns():
    """tests/test_pretrain.py's case: pretrain a 3-hidden-layer DNN on a
    separable toy frame task; each depth trains to a sane loss."""
    rs = np.random.RandomState(0)
    D, V, N = 10, 4, 2048
    centers = rs.randn(V, D) * 2.0
    targets = rs.randint(0, V, N)
    feats = centers[targets] + rs.randn(N, D) * 0.5

    def batches():
        for i in range(0, N, 256):
            yield (feats[i:i + 256].astype(np.float32),
                   targets[i:i + 256].astype(np.int32))

    losses = {}

    def train_fn(net, depth):
        trainer = FrameTrainer(net, NnetTrainOptions(momentum=0.5))
        velocity = init_velocity(net)
        for _ in range(6):
            velocity, rep = trainer.train_epoch(velocity, batches(), 1.0)
        losses[depth] = rep.avg_loss
        return net

    initial = _chain(*_hidden(D, 16),
                     AffineTransform(16, V, param_stddev=0.04,
                                     bias_mean=0.0, bias_range=0.0))
    net = pretrain_layerwise(initial, lambda d: _chain(*_hidden(16, 16)),
                             3, train_fn,
                             generator=torch.Generator().manual_seed(0))
    assert len(net.nodes) == 3 * 2 + 1
    assert sorted(losses) == [1, 2, 3]
    assert losses[3] < 0.3
    ev = FrameTrainer(net, NnetTrainOptions()).evaluate(batches())
    assert ev.frame_accuracy > 80.0
