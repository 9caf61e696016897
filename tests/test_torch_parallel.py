"""The port's distributed-training math (kaldi_aslp_tpu_torch/parallel/)
against the JAX package's in one process: the six server optimizers
against optax, the BMUF filter, the parameter-server pair syncs and sync
rounds on [W]-stacked trees in any arrival order, SOD and model
averaging.  The same numpy-seeded inputs go to both; every comparison is
float32 arithmetic in the same order, held to 1e-6 (absolute and
relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_aslp_tpu import parallel as jp
from kaldi_aslp_tpu_torch import parallel as tp
from kaldi_aslp_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"w": (4, 3), "b": (3,)}


def _tree(rs, scale=1.0):
    return {k: (scale * rs.randn(*s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adagrad", "rmsprop",
                                  "adadelta", "adam"])
def test_optimizer_matches_optax(name):
    import optax

    rs = np.random.RandomState(3)
    kw = dict(optimizer=name, learn_rate=0.05)
    opt_j = jp.make_optimizer(jp.OptimizerOptions(**kw))
    opt_t = tp.make_optimizer(tp.OptimizerOptions(**kw))
    p_j = {k: jnp.asarray(v) for k, v in _tree(rs).items()}
    p_t = _t(p_j)
    s_j, s_t = opt_j.init(p_j), opt_t.init(p_t)
    for _ in range(5):
        g = _tree(rs, 0.5)
        u_j, s_j = opt_j.update({k: jnp.asarray(v) for k, v in g.items()},
                                s_j, p_j)
        p_j = optax.apply_updates(p_j, u_j)
        u_t, s_t = opt_t.update(_t(g), s_t)
        p_t = tp.apply_updates(p_t, u_t)
        _close(u_t, u_j)
        _close(p_t, p_j)


def test_optimizer_unknown_raises():
    with pytest.raises(ValueError, match="bogus"):
        tp.make_optimizer(tp.OptimizerOptions(optimizer="bogus"))


@pytest.mark.parametrize("nesterov", [True, False])
def test_bmuf_sync_matches_jax(nesterov):
    rs = np.random.RandomState(5)
    p0 = _tree(rs)
    opts = dict(bmuf_momentum=0.7, bmuf_learn_rate=0.9, nesterov=nesterov)
    st_j = jp.BmufState({k: jnp.asarray(v) for k, v in p0.items()})
    st_t = tp.BmufState(_t(p0))
    for _ in range(3):
        avg = _tree(rs)
        w_j, st_j = jp.bmuf_sync(st_j, {k: jnp.asarray(v)
                                        for k, v in avg.items()},
                                 jp.BmufOptions(**opts))
        w_t, st_t = tp.bmuf_sync(st_t, _t(avg), tp.BmufOptions(**opts))
        _close(w_t, w_j)
        _close(st_t.w_prev, st_j.w_prev)
        _close(st_t.delta, st_j.delta)


def test_pair_syncs_match_jax():
    rs = np.random.RandomState(7)
    s, w, p, d = (_tree(rs) for _ in range(4))
    j = lambda t: {k: jnp.asarray(v) for k, v in t.items()}
    for got, want in zip(tp.easgd_pair_sync(_t(s), _t(w), 0.3),
                         jp.easgd_pair_sync(j(s), j(w), 0.3)):
        _close(got, want)
    for got, want in zip(tp.asgd_pair_sync(_t(s), _t(w), _t(p), 0.8),
                         jp.asgd_pair_sync(j(s), j(w), j(p), 0.8)):
        _close(got, want)
    for got, want in zip(
            tp.masgd_pair_sync(_t(s), _t(w), _t(p), _t(d), 0.9),
            jp.masgd_pair_sync(j(s), j(w), j(p), j(d), 0.9)):
        _close(got, want)


@pytest.mark.parametrize("order", [None, [2, 0, 3, 1]])
@pytest.mark.parametrize("mode,mtype", [("easgd", "local"),
                                        ("asgd", "local"),
                                        ("masgd", "local"),
                                        ("masgd", "global")])
def test_ps_sync_round_matches_jax(mode, mtype, order):
    """Two rounds on [W]-stacked trees, the workers moved apart between
    them, in the default and a permuted arrival order."""
    W = 4
    rs = np.random.RandomState(11)
    p0 = _tree(rs)
    opts = dict(mode=mode, alpha=0.6, masgd_momentum=0.8, masgd_type=mtype)
    st_j = jp.PsState({k: jnp.asarray(v) for k, v in p0.items()}, W,
                      jp.PsOptions(**opts))
    st_t = tp.PsState(_t(p0), W, tp.PsOptions(**opts))
    for _ in range(2):
        drift = {k: rs.randn(W, *s).astype(np.float32)
                 for k, s in SHAPES.items()}
        st_j.workers = {k: st_j.workers[k] + drift[k] for k in drift}
        st_t.workers = {k: st_t.workers[k] + torch.from_numpy(drift[k])
                        for k in drift}
        st_j = jp.ps_sync_round(
            st_j, None if order is None else np.asarray(order))
        st_t = tp.ps_sync_round(st_t, order)
        _close(st_t.server, st_j.server)
        _close(st_t.workers, st_j.workers)
        if mode != "easgd":
            _close(st_t.prev, st_j.prev)
        if mode == "masgd":
            _close(st_t.diffs, st_j.diffs)


def test_ps_sync_round_leaves_state():
    W = 3
    st = tp.PsState(_t(_tree(np.random.RandomState(0))), W,
                    tp.PsOptions(mode="masgd"))
    st.workers = {k: v + 1.0 for k, v in st.workers.items()}
    before = {k: v.clone() for k, v in st.workers.items()}
    tp.ps_sync_round(st)
    _close(st.workers, before)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adagrad", "rmsprop",
                                  "adadelta", "adam"])
def test_sod_sync_matches_jax(name):
    rs = np.random.RandomState(13)
    p0 = _tree(rs)
    kw = dict(optimizer=name, learn_rate=0.5, momentum=0.5)
    st_j = jp.SodState({k: jnp.asarray(v) for k, v in p0.items()},
                       jp.make_optimizer(jp.OptimizerOptions(**kw)))
    st_t = tp.SodState(_t(p0), tp.make_optimizer(tp.OptimizerOptions(**kw)))
    for _ in range(3):
        avg = {k: v + 0.3 * rs.randn(*v.shape).astype(np.float32)
               for k, v in p0.items()}
        w_j, st_j = jp.sod_sync(st_j, {k: jnp.asarray(v)
                                       for k, v in avg.items()})
        w_t, st_t = tp.sod_sync(st_t, _t(avg))
        _close(w_t, w_j)


def test_model_average_matches_jax():
    rs = np.random.RandomState(17)
    trees = [_tree(rs) for _ in range(3)]
    want = jp.model_average_sync(
        [{k: jnp.asarray(v) for k, v in t.items()} for t in trees])
    _close(tp.model_average_sync([_t(t) for t in trees]), want)


def test_one_rank_mesh_is_identity():
    """Without a process group every axis has one rank: its collectives
    are the identity and a batch's shard is the whole batch."""
    m = tp.make_mesh(("block", "data"))
    assert m.shape == (1, 1) and m.group("data") is None
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(tp.shard_batch({"x": x}, m)["x"], x)
    assert torch.equal(tmesh.gather_rows(x[0], m, "data"), x[:1])
    assert tp.axis_group("data") is None


def test_mesh_layout_and_shard():
    """A (2, 3) mesh's coordinates and shard index, row-major as JAX's
    device array, checked without a group."""
    m = tmesh.Mesh(("block", "data"), (2, 3), {"block": 1, "data": 2},
                   {"block": None, "data": None})
    assert m.index(("block", "data")) == 5 and m.index("data") == 2
    assert m.size(("block", "data")) == 6
    x = torch.arange(12.0)
    assert tp.shard_batch(x, m, ("block", "data")).tolist() == [10.0, 11.0]
    with pytest.raises(ValueError, match="does not split"):
        tp.shard_batch(torch.zeros(7), m, ("block", "data"))


@pytest.mark.parametrize("kind,cards,want", [("cuda", 4, "nccl"),
                                             ("cuda", 1, "gloo"),
                                             ("cpu", 0, "gloo")])
def test_backend_rule(kind, cards, want):
    """nccl only when each of the 2..4 ranks has a card of its own."""
    assert tmesh.choose_backend(kind, 4 if cards != 1 else 2, cards) == want


def test_bn_axis_without_mesh_raises():
    from kaldi_aslp_tpu_torch.models.batchnorm import BatchNormalization

    bn = BatchNormalization(3, 3, axis_name="no_such_axis")
    bn.train()
    with pytest.raises(ValueError, match="axis_name='no_such_axis'"):
        bn(torch.zeros(4, 3))
    bn.eval()
    y, _ = bn(torch.zeros(4, 3))     # eval ignores the attr
    assert y.shape == (4, 3)
