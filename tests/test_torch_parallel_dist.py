"""The port's distributed steps over spawned gloo process groups of 4 CPU
ranks, held against the JAX package's on 4 of the 8 CPU mesh devices
(tests/conftest.py): the BSP step (and the port's one-rank step on the
whole batch), the 2 x 2 BMUF block step with two inner steps over
scanned batches, the parameter-server round with its sync for EASGD,
ASGD, LMASGD and GMASGD, and BatchNormalization with ``axis_name``
(outputs and gradients against JAX's BN under ``shard_map``).

One group runs every job (kaldi_aslp_tpu_torch/parallel/steps.py) in one
spawn, torch at one thread a rank.  Both sides start from the same model
file (written by the JAX package, read by the port) and the same
numpy-seeded batches.  Float32 throughout, the gradient sums in another
order: held to 1e-5 absolute and relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from kaldi_aslp_tpu import parallel as jp
from kaldi_aslp_tpu.models import Nnet as JNnet, xent_loss
from kaldi_aslp_tpu.models.batchnorm import BatchNormalization as JBn
from kaldi_aslp_tpu.models.simple import AffineTransform, Sigmoid
from kaldi_aslp_tpu.train import (
    NnetTrainOptions,
    init_velocity,
    make_sgd_update,
)
from kaldi_aslp_tpu_torch.parallel.launch import RankContext, spawn
from kaldi_aslp_tpu_torch.parallel.steps import train_rank, train_ranks

torch.set_num_threads(1)
W = 4
TOL = dict(rtol=1e-5, atol=1e-5)
PROTO = """<AffineTransform> <InputDim> 8 <OutputDim> 16 <ParamStddev> 0.1
<Sigmoid> <InputDim> 16 <OutputDim> 16
<AffineTransform> <InputDim> 16 <OutputDim> 4 <ParamStddev> 0.1"""
LR, MOMENTUM = 0.1, 0.9
PS_CASES = [("easgd", "local", 0.5), ("asgd", "local", 1.0),
            ("masgd", "local", 1.0), ("masgd", "global", 1.0)]


def _data(rs, *lead, dim=8, classes=4):
    x = rs.randn(*lead, dim).astype(np.float32)
    w = np.random.RandomState(99).randn(dim, classes)
    return x, (x @ w).argmax(-1).astype(np.int32)


def _bn_net(axis_name="data"):
    net = JNnet()
    net.add(AffineTransform(8, 16, param_stddev=0.3))
    net.add(JBn(16, 16, axis_name=axis_name))
    net.add(Sigmoid(16, 16))
    net.add(AffineTransform(16, 4, param_stddev=0.3))
    return net


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX models, the batches, and every rank's results of one
    spawned group."""
    d = tmp_path_factory.mktemp("dist")
    rs = np.random.RandomState(4)
    net = JNnet.from_proto(PROTO)
    params = net.init(jax.random.PRNGKey(3))
    net.save(str(d / "m.zip"), params)
    bn_net = _bn_net()
    bn_params = bn_net.init(jax.random.PRNGKey(5))
    bn_net.save(str(d / "bn.zip"), bn_params)
    x, y = _data(rs, 32)
    xs, ys = _data(rs, 2, 16)
    bx, by = _data(rs, 24)
    base = dict(model=str(d / "m.zip"), learn_rate=LR, momentum=MOMENTUM,
                steps=2)
    jobs = {
        "bsp": dict(base, strategy="bsp", batch={"x": x, "y": y}),
        "bmuf": dict(base, strategy="bmuf", blocks=2, inner_steps=2,
                     scan_batches=True, batch={"x": xs, "y": ys},
                     bmuf={"bmuf_momentum": 0.8}),
        "bn": dict(base, model=str(d / "bn.zip"), strategy="bsp", steps=1,
                   batch={"x": bx, "y": by}),
    }
    for mode, mtype, alpha in PS_CASES:
        jobs[f"{mode}-{mtype}"] = dict(
            base, strategy=mode, inner_steps=2, alpha=alpha,
            masgd_momentum=0.5, masgd_type=mtype, batch={"x": x, "y": y})
    names = list(jobs)
    ranks = spawn(train_ranks, W, args=([jobs[n] for n in names],),
                  device_type="cpu", threads=1, run_timeout_s=240)
    results = {n: [r[i] for r in ranks] for i, n in enumerate(names)}
    return dict(net=net, params=params, bn_net=bn_net, bn_params=bn_params,
                jobs=jobs, results=results)


def _loss_fn(net):
    def loss_fn(p, batch):
        out, _ = net.apply(p, batch["x"], train=True)
        return xent_loss(out.reshape(-1, out.shape[-1]),
                         batch["y"].reshape(-1))
    return loss_fn


def _flat(tree):
    """JAX params {'0': {'w': ...}} -> {'nodes.0.w': array}."""
    return {f"nodes.{c}.{k}": np.asarray(v) for c, sub in tree.items()
            for k, v in sub.items()}


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def _devices():
    return jax.devices()[:W]


def test_bsp_matches_jax_and_one_rank(case):
    net, params = case["net"], case["params"]
    update = make_sgd_update(net, NnetTrainOptions(momentum=MOMENTUM))
    mesh = jp.make_mesh(("data",), devices=_devices())
    step = jp.make_bsp_train_step(_loss_fn(net), update, mesh)
    batch = {k: jnp.asarray(v) for k, v in case["jobs"]["bsp"]["batch"]
             .items()}
    p, vel = params, init_velocity(params)
    want = []
    for _ in range(2):
        p, vel, _, _ = step(p, vel, jp.shard_batch(batch, mesh),
                            jnp.float32(LR))
        want.append(_flat(p))
    ranks = case["results"]["bsp"]
    one = train_rank(RankContext(0, 1, torch.device("cpu"), "none"),
                     case["jobs"]["bsp"])
    for i in range(2):
        for r in ranks:
            _close(r["params"][i], want[i])
            for k, v in ranks[0]["params"][i].items():
                assert np.array_equal(r["params"][i][k], v), k
        _close(one["params"][i], ranks[0]["params"][i])


def test_bmuf_block_step_matches_jax(case):
    net, params = case["net"], case["params"]
    update = make_sgd_update(net, NnetTrainOptions(momentum=MOMENTUM))
    mesh = jp.make_mesh(("block", "data"), devices=_devices(),
                        shape=(2, 2))
    step = jp.make_bmuf_block_step(
        _loss_fn(net), update, mesh, jp.BmufOptions(bmuf_momentum=0.8),
        inner_steps=2, scan_batches=True)
    sharding = NamedSharding(mesh, P(None, ("block", "data")))
    batch = {k: jax.device_put(jnp.asarray(v), sharding)
             for k, v in case["jobs"]["bmuf"]["batch"].items()}
    w, w_prev = params, params
    delta = jax.tree_util.tree_map(jnp.zeros_like, params)
    opt = jp.stack_block_states(init_velocity(params), 2)
    for i in range(2):
        w, w_prev, delta, opt, loss = step(w, w_prev, delta, opt, batch,
                                           jnp.float32(LR))
        for r in case["results"]["bmuf"]:
            _close(r["params"][i], _flat(w))
            np.testing.assert_allclose(r["losses"][i], float(loss), **TOL)


@pytest.mark.parametrize("mode,mtype,alpha", PS_CASES)
def test_ps_round_matches_jax(case, mode, mtype, alpha):
    net, params = case["net"], case["params"]
    update = make_sgd_update(net, NnetTrainOptions(momentum=MOMENTUM))
    mesh = jp.make_mesh(("worker",), devices=_devices())
    opts = jp.PsOptions(mode=mode, alpha=alpha, masgd_momentum=0.5,
                        masgd_type=mtype)
    step = jp.make_ps_round_step(_loss_fn(net), update, mesh, opts,
                                 inner_steps=2)
    job = case["jobs"][f"{mode}-{mtype}"]
    batch = {k: jnp.asarray(v) for k, v in job["batch"].items()}
    state = jp.PsState(params, W, opts)
    opt_w = jp.stack_worker_states(init_velocity(params), W)
    ranks = case["results"][f"{mode}-{mtype}"]
    for i in range(2):
        state.workers, opt_w, _ = step(state.workers, opt_w, batch,
                                       jnp.float32(LR))
        state = jp.ps_sync_round(state)
        for r, res in enumerate(ranks):
            _close(res["params"][i], _flat(jax.tree_util.tree_map(
                lambda v: v[r], state.workers)))
    for res in ranks:
        _close(res["server"], _flat(state.server))


def test_bn_axis_name_matches_jax_shard_map(case):
    """Each rank's outputs on its rows and the averaged gradients against
    JAX's BN psum-ing its statistics over the 'data' axis."""
    from jax import shard_map

    net, params = case["bn_net"], case["bn_params"]

    def shard_fn(p, batch):
        def global_loss(pp):
            out, _ = net.apply(pp, batch["x"], train=True)
            loss, _ = xent_loss(out, batch["y"])
            return jax.lax.pmean(loss, "data"), out
        (_, out), g = jax.value_and_grad(global_loss, has_aux=True)(p)
        return out, g

    mesh = jp.make_mesh(("data",), devices=_devices())
    fn = jax.jit(shard_map(shard_fn, mesh=mesh,
                           in_specs=(P(), P("data")),
                           out_specs=(P("data"), P())))
    batch = {k: jnp.asarray(v) for k, v in case["jobs"]["bn"]["batch"]
             .items()}
    out, grads = fn(params, jp.shard_batch(batch, mesh))
    ranks = case["results"]["bn"]
    got = np.concatenate([r["outputs"] for r in ranks])
    np.testing.assert_allclose(got, np.asarray(out), **TOL)
    for r in ranks:
        _close(r["grads"], _flat(grads))
    # the batch statistics are the whole batch's: not one shard's
    one = np.asarray(_bn_net(None).apply(params, batch["x"][:6],
                                         train=True)[0])
    assert np.abs(one - got[:6]).max() > 1e-3
