"""The port's LSTMP recurrence (kaldi_aslp_tpu_torch/ops/lstmp.py) against
the JAX package: the Pallas inference kernel ``_lstmp_kernel`` (run in
interpret mode on the CPU, as tests/test_lstm_pallas.py runs it) and the
``lax.scan`` path.  Inputs come from numpy seeds fed to both packages.

Tolerance rtol=1e-5, atol=1e-6: float32 on both sides with the same
equations; only the summation order of the two recurrent products
differs.  The CUDA kernel itself is held against the plain version on
the card by tests/test_torch_lstmp_cuda.py and by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kaldi_aslp_tpu.models.recurrent import (
    LstmProjectedStreams as JaxLstmProjectedStreams,
)
from kaldi_aslp_tpu.ops.lstm_pallas import lstmp_forward_pallas_from_params
from kaldi_aslp_tpu_torch.models.interop import params_from_jax
from kaldi_aslp_tpu_torch.models.recurrent import LstmProjectedStreams
from kaldi_aslp_tpu_torch.ops import lstmp as lstmp_ops
from kaldi_aslp_tpu_torch.ops.lstmp import (
    lstmp_forward,
    lstmp_forward_reference,
)

torch.set_num_threads(1)

C, P = 32, 16
TOL = dict(rtol=1e-5, atol=1e-6)


def _params(rs, D):
    def u(*shape):
        return (0.1 * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32)
    return {"w_gifo_x": u(4 * C, D), "w_gifo_r": u(4 * C, P),
            "bias": u(4 * C), "peephole_i_c": u(C), "peephole_f_c": u(C),
            "peephole_o_c": u(C), "w_r_m": u(P, C)}


def _inputs(rs, S, T, D):
    x = rs.randn(S, T, D).astype(np.float32)
    lens = np.full(S, T)
    if S > 1:
        lens = rs.randint(1, T + 1, size=S)
        lens[0] = T
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    state = {"c": (0.5 * rs.randn(S, C)).astype(np.float32),
             "r": (0.5 * rs.randn(S, P)).astype(np.float32)}
    return x, mask, state


def _port_cell(params, D):
    cell = LstmProjectedStreams(D, P, cell_dim=C)
    cell.load_state_dict(
        {k.split(".", 1)[1]: v for k, v in params_from_jax(params).items()})
    return cell


def _port(cell, x, mask, state):
    with torch.no_grad():
        ys, st = cell(torch.from_numpy(x), {k: torch.from_numpy(v)
                                            for k, v in state.items()},
                      mask=torch.from_numpy(mask))
    return ys.numpy(), st["c"].numpy(), st["r"].numpy()


def _jax_tree(a):
    return {k: jnp.asarray(v) for k, v in a.items()}


def _assert_close(port, ref):
    for got, want in zip(port, ref):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("D", [16, 40])
@pytest.mark.parametrize("T", [7, 12])
@pytest.mark.parametrize("S", [1, 8])
def test_lstmp_matches_jax_pallas_kernel(S, T, D):
    rs = np.random.RandomState(100 * S + 10 * T + D)
    params = _params(rs, D)
    x, mask, state = _inputs(rs, S, T, D)
    ys, st = lstmp_forward_pallas_from_params(
        _jax_tree(params), jnp.asarray(x), jnp.asarray(mask),
        _jax_tree(state))
    _assert_close(_port(_port_cell(params, D), x, mask, state),
                  (ys, st["c"], st["r"]))


@pytest.mark.parametrize("D", [16, 40])
@pytest.mark.parametrize("T", [7, 12])
@pytest.mark.parametrize("S", [1, 8])
def test_lstmp_matches_jax_scan(S, T, D):
    rs = np.random.RandomState(200 * S + 10 * T + D)
    params = _params(rs, D)
    x, mask, state = _inputs(rs, S, T, D)
    cell = JaxLstmProjectedStreams(D, P, cell_dim=C, pallas=False)
    ys, st = cell.apply(_jax_tree(params), jnp.asarray(x),
                        _jax_tree(state), mask=jnp.asarray(mask))
    _assert_close(_port(_port_cell(params, D), x, mask, state),
                  (ys, st["c"], st["r"]))


@pytest.mark.parametrize("S", [1, 8])
def test_lstmp_chunked_state_carry(S):
    """Streaming in chunks with the carried state gives the same outputs
    as one pass, and both match the JAX kernel on the whole sequence."""
    T, D = 12, 16
    rs = np.random.RandomState(7 + S)
    params = _params(rs, D)
    x, mask, state = _inputs(rs, S, T, D)
    cell = _port_cell(params, D)
    ys1, c1, r1 = _port(cell, x[:, :5], mask[:, :5], state)
    ys2, c2, r2 = _port(cell, x[:, 5:], mask[:, 5:], {"c": c1, "r": r1})
    ys, st = lstmp_forward_pallas_from_params(
        _jax_tree(params), jnp.asarray(x), jnp.asarray(mask),
        _jax_tree(state))
    _assert_close((np.concatenate([ys1, ys2], axis=1), c2, r2),
                  (ys, st["c"], st["r"]))


def test_lstmp_zero_length_returns_initial_state():
    rs = np.random.RandomState(3)
    S = 2
    c0 = torch.from_numpy(rs.randn(S, C).astype(np.float32))
    r0 = torch.from_numpy(rs.randn(S, P).astype(np.float32))
    before = lstmp_ops.lstmp_forward.launches
    ys, c, r = lstmp_forward(torch.zeros(S, 0, 4 * C), torch.zeros(S, 0),
                             torch.zeros(4 * C, P), torch.zeros(P, C),
                             torch.zeros(3, C), c0, r0)
    assert ys.shape == (S, 0, P)
    assert torch.equal(c, c0) and torch.equal(r, r0)
    assert lstmp_ops.lstmp_forward.launches == before


def _valid_args(S=2, T=3):
    return [torch.zeros(S, T, 4 * C), torch.ones(S, T),
            torch.zeros(4 * C, P), torch.zeros(P, C), torch.zeros(3, C),
            torch.zeros(S, C), torch.zeros(S, P)]


@pytest.mark.parametrize("which,bad,err", [
    (1, torch.ones(2, 4), ValueError),                        # mask shape
    (2, torch.zeros(4 * C, P, dtype=torch.float64), TypeError),
    (3, torch.zeros(C, P).t(), ValueError),                   # not contiguous
    (4, torch.zeros(2, C), ValueError),                       # peep shape
])
def test_lstmp_wrapper_rejects_bad_inputs(which, bad, err):
    args = _valid_args()
    args[which] = bad
    with pytest.raises(err):
        lstmp_forward(*args)


def test_lstmp_wrapper_never_falls_back_for_other_devices():
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel or raises."""
    args = [a.to("meta") for a in _valid_args()]
    with pytest.raises(ValueError, match="no LSTMP kernel"):
        lstmp_forward(*args)


def test_cpu_dispatch_is_the_plain_version():
    rs = np.random.RandomState(11)
    S, T = 3, 5
    args = [torch.from_numpy(a) for a in (
        rs.randn(S, T, 4 * C).astype(np.float32),
        np.ones((S, T), np.float32),
        (0.1 * rs.randn(4 * C, P)).astype(np.float32),
        (0.1 * rs.randn(P, C)).astype(np.float32),
        (0.1 * rs.randn(3, C)).astype(np.float32),
        rs.randn(S, C).astype(np.float32),
        rs.randn(S, P).astype(np.float32))]
    for got, want in zip(lstmp_forward(*args, cell_clip=0.5),
                         lstmp_forward_reference(*args, cell_clip=0.5)):
        assert torch.equal(got, want)
