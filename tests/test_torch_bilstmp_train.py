"""The port's bidirectional LSTMP training core
(kaldi_aslp_tpu_torch/ops/bilstmp_train.py, plain versions on the CPU)
against the JAX package's x-fused core ``bilstmp_xfused_train_core``,
whose Pallas kernels ``_bixfused_fwd_kernel`` / ``_bixfused_bwd_kernel``
run here in interpret mode, as tests/test_lstm_pallas.py runs them.
Inputs come from numpy seeds fed to both packages; the masks are ragged
as tests/test_lstm_pallas.py builds them, and the initial state and the
final-state cotangents are nonzero.

Tolerance: max |port - JAX| / max |JAX| <= 5e-3 for the outputs and for
every gradient (weights, dx, initial state).  Both sides round to bf16 at
the same places; they sum the products in another order, so a bf16
rounding now and then falls the other way (one bf16 step is 2^-8 of a
value)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.ops.lstm_pallas import bilstmp_xfused_train_core
from kaldi_aslp_tpu_torch.ops.bilstmp_train import BiLstmpTrainCore

torch.set_num_threads(1)

S, T, C, P = 6, 9, 32, 16
REL_TOL = 5e-3
NAMES = ["wf_gifo_x", "wb_gifo_x", "wf_gifo_r", "wf_r_m", "peep_f",
         "wb_gifo_r", "wb_r_m", "peep_b", "bias_f", "bias_b"]


def _inputs(D, seed):
    rs = np.random.RandomState(seed)

    def u(*shape):
        return (0.1 * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32)
    params = {"wf_gifo_x": u(4 * C, D), "wb_gifo_x": u(4 * C, D),
              "wf_gifo_r": u(4 * C, P), "wf_r_m": u(P, C),
              "peep_f": u(3, C), "wb_gifo_r": u(4 * C, P),
              "wb_r_m": u(P, C), "peep_b": u(3, C),
              "bias_f": u(4 * C), "bias_b": u(4 * C)}
    x = rs.randn(S, T, D).astype(np.float32)
    mask = np.ones((S, T), np.float32)
    mask[2, 6:] = 0
    mask[4, 3:] = 0
    mask[5, 1:] = 0
    state = {"c": (0.5 * rs.randn(S, C)).astype(np.float32),
             "r": (0.5 * rs.randn(S, P)).astype(np.float32)}
    cots = {"ys": rs.randn(S, T, 2 * P).astype(np.float32),
            "c": rs.randn(S, C).astype(np.float32),
            "r": rs.randn(S, P).astype(np.float32)}
    return params, x, mask, state, cots


def _jax(params, x, mask, state, cots):
    def loss(p, x, c0, r0):
        ysf, ysb, fc, fr = bilstmp_xfused_train_core(
            x, jnp.asarray(mask), *[p[n] for n in NAMES], c0, r0,
            interpret=True)
        ys = jnp.concatenate([ysf, ysb], axis=-1).astype(jnp.float32)
        return (jnp.sum(ys * cots["ys"]) + jnp.sum(fc * cots["c"])
                + jnp.sum(fr * cots["r"])), (ys, fc, fr)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    (_, outs), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                          has_aux=True)(
        p, jnp.asarray(x), jnp.asarray(state["c"]), jnp.asarray(state["r"]))
    gp, gx, gc, gr = grads
    return ([np.asarray(o) for o in outs],
            {**{k: np.asarray(v) for k, v in gp.items()},
             "x": np.asarray(gx), "init_c": np.asarray(gc),
             "init_r": np.asarray(gr)})


def _port(params, x, mask, state, cots):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    c0 = torch.tensor(state["c"], requires_grad=True)
    r0 = torch.tensor(state["r"], requires_grad=True)
    ys, fc, fr = BiLstmpTrainCore.apply(
        xt, torch.from_numpy(mask), *[p[n] for n in NAMES], c0, r0, 50.0)
    assert ys.dtype == torch.bfloat16 and fc.dtype == torch.float32
    ys = ys.float()
    loss = ((ys * torch.from_numpy(cots["ys"])).sum()
            + (fc * torch.from_numpy(cots["c"])).sum()
            + (fr * torch.from_numpy(cots["r"])).sum())
    loss.backward()
    grads = {k: v.grad for k, v in p.items()}
    for k, g in grads.items():
        # the gradients of float32 parameters stay float32, unrounded
        assert g.dtype == torch.float32, k
    grads.update(x=xt.grad, init_c=c0.grad, init_r=r0.grad)
    return ([o.detach().numpy() for o in (ys, fc, fr)],
            {k: v.numpy() for k, v in grads.items()})


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("D", [40, 128])
def test_fused_core_matches_jax(D):
    args = _inputs(D, seed=D)
    want_out, want_grads = _jax(*args)
    got_out, got_grads = _port(*args)
    for name, g, w in zip(("ys", "c_T", "r_T"), got_out, want_out):
        assert g.shape == w.shape, name
        assert _rel(g, w) <= REL_TOL, (name, _rel(g, w))
    assert sorted(got_grads) == sorted(want_grads)
    for name in want_grads:
        g, w = got_grads[name], want_grads[name]
        assert g.shape == w.shape, name
        assert np.abs(w).max() > 0, name
        assert _rel(g, w) <= REL_TOL, (name, _rel(g, w))


def test_masked_frames_output_zero_and_get_no_gradient():
    params, x, mask, state, cots = _inputs(40, seed=3)
    _, grads = _port(params, x, mask, state, cots)
    ys, _, _ = BiLstmpTrainCore.apply(
        torch.from_numpy(x), torch.from_numpy(mask),
        *[torch.from_numpy(params[n]) for n in NAMES],
        torch.from_numpy(state["c"]), torch.from_numpy(state["r"]), 50.0)
    dead = mask == 0
    assert (ys.float().numpy()[dead] == 0).all()
    assert (grads["x"][dead] == 0).all()
    assert np.abs(grads["x"][~dead]).max() > 0
