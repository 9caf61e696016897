"""The CTC recipe's cells, ``Lstm`` and ``BLstm``
(kaldi_aslp_tpu_torch/models/recurrent.py), against the JAX package's
(kaldi_aslp_tpu/models/recurrent.py:228-290, :517-522): values, final
state and every gradient (input, initial state, all parameters, through
random cotangents) against ``jax.grad``, with ragged masks, a nonzero
initial state and a cell clip small enough to act; an ``Nnet`` zip with
both cells through JAX's ``Nnet.load`` and back; and one ``CtcTrainer``
epoch of a small BLSTM-CTC net against the JAX trainer.

Tolerances, as max |port - JAX| / max |JAX| per tensor: 1e-5 for values
and final states, 1e-4 for gradients and for the trainer's losses and
parameters (the same float32 math, summed in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.data.sequence import (
    CtcBatcher as JaxCtcBatcher,
    CtcBatcherOptions as JaxCtcBatcherOptions,
)
from kaldi_aslp_tpu.models import Nnet as JaxNnet
from kaldi_aslp_tpu.models.recurrent import (
    BLstm as JaxBLstm,
    Lstm as JaxLstm,
)
from kaldi_aslp_tpu.models.simple import AffineTransform as JaxAffine
from kaldi_aslp_tpu.train.sgd import (
    NnetTrainOptions as JaxNnetTrainOptions,
    init_velocity as jax_init_velocity,
)
from kaldi_aslp_tpu.train.trainer import CtcTrainer as JaxCtcTrainer
from kaldi_aslp_tpu_torch.data.sequence import (
    CtcBatcher,
    CtcBatcherOptions,
)
from kaldi_aslp_tpu_torch.models import AffineTransform, BLstm, Lstm, Nnet
from kaldi_aslp_tpu_torch.models.interop import params_from_jax
from kaldi_aslp_tpu_torch.models.losses import LossReporter
from kaldi_aslp_tpu_torch.train import (
    CtcTrainer,
    NnetTrainOptions,
    init_velocity,
)

torch.set_num_threads(1)

S, T, D, C = 4, 11, 6, 8
VALUE_TOL, GRAD_TOL = 1e-5, 1e-4


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _flat(tree, prefix=""):
    """Nested dict -> {dotted name: numpy array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _ragged_mask(rs, S, T):
    lens = rs.randint(T // 2, T + 1, S)
    lens[0] = T
    return (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)


CASES = [("lstm", 0.5), ("lstm", 50.0), ("blstm", 0.5), ("blstm", 50.0)]


@pytest.mark.parametrize("kind,clip", CASES,
                         ids=[f"{k}-clip{c:g}" for k, c in CASES])
def test_cell_matches_jax_values_and_every_gradient(kind, clip):
    rs = np.random.RandomState(11)
    if kind == "lstm":
        jc, pc = JaxLstm(D, C, cell_clip=clip), Lstm(D, C, cell_clip=clip)
    else:
        jc = JaxBLstm(D, 2 * C, cell_clip=clip)
        pc = BLstm(D, 2 * C, cell_clip=clip)
    # three times the init's range: the clip at 0.5 acts on many cells,
    # and no gate saturates to exactly 0 or 1, where a cell would sit on
    # the clip exactly and its gradient (half of it there, as jnp.clip
    # gives) would hang on the last bit of c
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(3.0 * np.asarray(p)),
        jc.init_params(jax.random.PRNGKey(3)))
    x = rs.randn(S, T, D).astype(np.float32)
    mask = _ragged_mask(rs, S, T)
    c0, r0 = (0.5 * rs.randn(S, C).astype(np.float32) for _ in range(2))
    out_dim = C if kind == "lstm" else 2 * C
    cot_y = rs.randn(S, T, out_dim).astype(np.float32)
    cot_c, cot_r = (rs.randn(S, C).astype(np.float32) for _ in range(2))

    def wrap(st):
        return st if kind == "lstm" else {"fwd": st}

    def final(st):
        return st if kind == "lstm" else st["fwd"]

    def jax_objective(p, x, c0, r0):
        ys, st = jc.apply(p, x, wrap({"c": c0, "r": r0}), train=True,
                          mask=jnp.asarray(mask))
        st = final(st)
        obj = (jnp.sum(ys * cot_y) + jnp.sum(st["c"] * cot_c)
               + jnp.sum(st["r"] * cot_r))
        return obj, (ys, st)

    (_, (ys_j, st_j)), grads_j = jax.value_and_grad(
        jax_objective, argnums=(0, 1, 2, 3), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(c0), jnp.asarray(r0))

    pc.load_state_dict({k: torch.from_numpy(v.copy())
                        for k, v in _flat(params).items()})
    pc.train()
    xt, c0t, r0t = (torch.from_numpy(a.copy()).requires_grad_()
                    for a in (x, c0, r0))
    ys, st = pc(xt, wrap({"c": c0t, "r": r0t}), mask=torch.from_numpy(mask))
    st = final(st)
    obj = ((ys * torch.from_numpy(cot_y)).sum()
           + (st["c"] * torch.from_numpy(cot_c)).sum()
           + (st["r"] * torch.from_numpy(cot_r)).sum())
    obj.backward()

    assert _rel(ys.detach(), ys_j) <= VALUE_TOL
    assert _rel(st["c"].detach(), st_j["c"]) <= VALUE_TOL
    assert _rel(st["r"].detach(), st_j["r"]) <= VALUE_TOL
    # masked frames output exactly 0, as in JAX
    pad = mask == 0
    assert np.all(ys.detach().numpy()[pad] == 0.0)
    if clip == 0.5:   # the clip is exercised: it changes the outputs
        unclipped = (JaxLstm(D, C, cell_clip=0.0) if kind == "lstm"
                     else JaxBLstm(D, 2 * C, cell_clip=0.0))
        ys_free, _ = unclipped.apply(params, jnp.asarray(x),
                                     wrap({"c": c0, "r": r0}),
                                     mask=jnp.asarray(mask))
        assert _rel(ys_free, ys_j) > 0.05
    got = {f"param.{k}": p.grad for k, p in pc.named_parameters()}
    want = {f"param.{k}": v for k, v in _flat(grads_j[0]).items()}
    assert sorted(got) == sorted(want)
    got.update(x=xt.grad, c0=c0t.grad, r0=r0t.grad)
    want.update(x=grads_j[1], c0=grads_j[2], r0=grads_j[3])
    errs = {k: _rel(got[k], want[k]) for k in want}
    assert max(errs.values()) <= GRAD_TOL, errs


def test_eval_mode_and_no_mask_give_the_training_function():
    """The cell has one code path: eval mode changes nothing, and a mask
    of ones is the default."""
    pc = BLstm(D, 2 * C)
    pc.reset_parameters(torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.RandomState(4).randn(S, T, D)
                         .astype(np.float32))
    pc.train()
    want, _ = pc(x, mask=torch.ones(S, T))
    pc.eval()
    with torch.no_grad():
        got, _ = pc(x)
    assert torch.equal(got, want.detach())


def test_default_init_draws_within_the_param_scale():
    pc = Lstm(D, C, param_scale=0.05)
    pc.reset_parameters(torch.Generator().manual_seed(0))
    for p in pc.parameters():
        top = float(p.detach().abs().max())
        assert 0.03 < top <= 0.05


def _jax_net(seed=5, V=7):
    net = JaxNnet()
    net.add(JaxBLstm(D, 2 * C, cell_clip=20.0))
    net.add(JaxLstm(2 * C, C))
    net.add(JaxAffine(C, V, param_stddev=0.04, bias_mean=0.0,
                      bias_range=0.0))
    return net, net.init(jax.random.PRNGKey(seed))


def test_nnet_zip_with_the_cells_round_trips_through_jax(tmp_path):
    """port save -> JAX load -> JAX save -> port load: equal arrays,
    attrs and forward outputs."""
    jnet, jparams = _jax_net()
    port = Nnet()
    port.add(BLstm(D, 2 * C, cell_clip=20.0))
    port.add(Lstm(2 * C, C))
    port.add(AffineTransform(C, 7, param_stddev=0.04, bias_mean=0.0,
                             bias_range=0.0))
    port.load_state_dict(params_from_jax(jparams))
    port.save(str(tmp_path / "port.zip"))
    jnet2, jparams2, _ = JaxNnet.load(str(tmp_path / "port.zip"))
    assert [type(n.comp).__name__ for n in jnet2.nodes] == [
        "BLstm", "Lstm", "AffineTransform"]
    assert jnet2.nodes[0].comp.fwd.cell_clip == 20.0
    want = _flat(jparams)
    got = _flat(jparams2)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    jnet2.save(str(tmp_path / "jax.zip"), jparams2)
    back, _ = Nnet.load(str(tmp_path / "jax.zip"), "cpu")
    for (name, a), b in zip(back.state_dict().items(),
                            port.state_dict().values()):
        assert torch.equal(a, b), name
    rs = np.random.RandomState(9)
    x = rs.randn(2, T, D).astype(np.float32)
    mask = _ragged_mask(rs, 2, T)
    y_j, _ = jnet.apply(jparams, jnp.asarray(x), mask=jnp.asarray(mask))
    back.eval()
    with torch.no_grad():
        y_p, _ = back(torch.from_numpy(x), mask=torch.from_numpy(mask))
    assert _rel(y_p, y_j) <= VALUE_TOL


def _corpus(n, seed, V):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        Tn = rs.randint(8, 15)
        U = rs.randint(1, 4)
        out.append((f"u{i:02d}", rs.randn(Tn, D).astype(np.float32),
                    rs.randint(1, V, U).astype(np.int32)))
    return out


def test_ctc_trainer_epoch_on_blstm_matches_jax():
    """One epoch of momentum SGD on a BLSTM + LSTM + affine net: every
    batch's loss, the epoch's average, and the parameters and velocity
    after it."""
    V = 7
    jnet, jparams = _jax_net(seed=8, V=V)
    corpus = _corpus(9, seed=3, V=V)
    opts = dict(num_streams=3, bucket_time=4, bucket_labels=2)
    jbatches = list(JaxCtcBatcher(iter(corpus),
                                  JaxCtcBatcherOptions(**opts)))
    batches = list(CtcBatcher(iter(corpus), CtcBatcherOptions(**opts)))
    assert len(batches) == len(jbatches) == 3
    lr = 0.05

    jtrainer = JaxCtcTrainer(jnet, JaxNnetTrainOptions(momentum=0.9))
    jlosses = []
    orig_step = jtrainer._step

    def step(*args):
        out = orig_step(*args)
        jlosses.append(float(out[2]))
        return out
    jtrainer._step = step
    p_j, v_j, rep_j = jtrainer.train_epoch(
        jparams, jax_init_velocity(jparams), iter(jbatches), lr)

    port = Nnet()
    port.add(BLstm(D, 2 * C, cell_clip=20.0))
    port.add(Lstm(2 * C, C))
    port.add(AffineTransform(C, V, param_stddev=0.04, bias_mean=0.0,
                             bias_range=0.0))
    port.load_state_dict(params_from_jax(jparams))
    trainer = CtcTrainer(port, NnetTrainOptions(momentum=0.9))
    velocity = init_velocity(port)
    losses = []
    orig = trainer.step

    def pstep(velocity, batch, learn_rate):
        loss, aux = orig(velocity, batch, learn_rate)
        losses.append(float(loss))
        return loss, aux
    trainer.step = pstep
    velocity, rep = trainer.train_epoch(velocity, iter(batches), lr,
                                        LossReporter("ctc"))
    assert len(losses) == len(jlosses) == 3
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= GRAD_TOL * abs(want)
    assert abs(rep.avg_loss - rep_j.avg_loss) <= GRAD_TOL * rep_j.avg_loss
    want_p = params_from_jax(p_j)
    want_v = params_from_jax(v_j)
    for name, p in port.state_dict().items():
        assert _rel(p, want_p[name]) <= GRAD_TOL, name
        assert _rel(velocity[name], want_v[name]) <= GRAD_TOL, name
