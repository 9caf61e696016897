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
    BLstmProjectedStreams as JaxBLstmProjectedStreams,
    LstmProjectedStreams as JaxLstmProjectedStreams,
)
from kaldi_aslp_tpu.ops.lstm_pallas import (
    lstmp_forward_pallas,
    lstmp_forward_pallas_from_params,
)
from kaldi_aslp_tpu_torch.models.interop import params_from_jax
from kaldi_aslp_tpu_torch.models.recurrent import (
    BLstmProjectedStreams,
    LstmProjectedStreams,
)
from kaldi_aslp_tpu_torch.ops import lstmp as lstmp_ops
from kaldi_aslp_tpu_torch.ops.lstmp import (
    blstmp_forward,
    blstmp_forward_reference,
    lstmp_forward,
    lstmp_forward_reference,
    refuse_autograd,
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


# -- both directions of a BLSTMP layer in one call -----------------------------
#
# Tolerance 1e-5 absolute against the JAX package: float32 on both sides,
# the same equations, outputs of magnitude below 1.

BI_ATOL = 1e-5


def _bi_args(rs, S, T):
    """(xg_f, xg_b, mask, weights_f, weights_b, c0, r0) as numpy arrays,
    ragged masks where there is more than one stream."""
    def u(*shape):
        return (0.1 * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32)
    lens = np.full(S, T)
    if S > 1:
        lens = rs.randint(1, T + 1, size=S)
        lens[0] = T
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    xgs = [rs.randn(S, T, 4 * C).astype(np.float32) for _ in range(2)]
    weights = [(u(4 * C, P), u(P, C), u(3, C)) for _ in range(2)]
    return (*xgs, mask, *weights, (0.5 * rs.randn(S, C)).astype(np.float32),
            (0.5 * rs.randn(S, P)).astype(np.float32))


def _torch_args(args):
    return [tuple(torch.from_numpy(w) for w in a) if isinstance(a, tuple)
            else torch.from_numpy(a) for a in args]


@pytest.mark.parametrize("T", [1, 9])
@pytest.mark.parametrize("S", [1, 8])
def test_blstmp_plain_version_is_two_lstmp_runs_and_the_flips(S, T):
    rs = np.random.RandomState(31 * S + T)
    xg_f, xg_b, mask, w_f, w_b, c0, r0 = _torch_args(_bi_args(rs, S, T))
    ys, c, r = blstmp_forward_reference(xg_f, xg_b, mask, w_f, w_b, c0, r0)
    y_f, c_f, r_f = lstmp_forward_reference(xg_f, mask, *w_f, c0, r0)
    y_b, _, _ = lstmp_forward_reference(
        torch.flip(xg_b, (1,)), torch.flip(mask, (1,)), *w_b,
        torch.zeros_like(c0), torch.zeros_like(r0))
    assert ys.shape == (S, T, 2 * P)
    assert torch.equal(ys[..., :P], y_f)
    assert torch.equal(ys[..., P:], torch.flip(y_b, (1,)))
    assert torch.equal(c, c_f) and torch.equal(r, r_f)
    # a CPU tensor takes the plain version
    for got, want in zip(blstmp_forward(xg_f, xg_b, mask, w_f, w_b, c0, r0),
                         (ys, c, r)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("T", [7, 12])
@pytest.mark.parametrize("S", [1, 8])
def test_blstmp_matches_jax_pallas_kernel_per_direction(S, T):
    """Direction f against the Pallas kernel on the frames as they are,
    direction b against it on the flipped frames from a zero state."""
    rs = np.random.RandomState(400 * S + T)
    args = _bi_args(rs, S, T)
    xg_f, xg_b, mask, w_f, w_b, c0, r0 = args
    ys, c, r = blstmp_forward(*_torch_args(args))
    y_f, c_f, r_f = lstmp_forward_pallas(
        *(jnp.asarray(a) for a in (xg_f, mask, *w_f, c0, r0)),
        interpret=True)
    y_b, _, _ = lstmp_forward_pallas(
        *(jnp.asarray(a) for a in (xg_b[:, ::-1], mask[:, ::-1], *w_b,
                                   np.zeros_like(c0), np.zeros_like(r0))),
        interpret=True)
    want = np.concatenate([np.asarray(y_f), np.asarray(y_b)[:, ::-1]], -1)
    np.testing.assert_allclose(ys.numpy(), want, rtol=0, atol=BI_ATOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_f), rtol=0,
                               atol=BI_ATOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_f), rtol=0,
                               atol=BI_ATOL)


@pytest.mark.parametrize("D", [16, 40])
@pytest.mark.parametrize("S", [1, 8])
def test_blstmp_module_matches_jax_eval(S, D):
    """BLstmProjectedStreams in eval() (one blstmp_forward call) against
    the JAX package's apply(train=False), ragged masks, a carried state."""
    T = 11
    rs = np.random.RandomState(500 * S + D)
    params = {"fwd": _params(rs, D), "bwd": _params(rs, D)}
    x, mask, state = _inputs(rs, S, T, D)
    jax_comp = JaxBLstmProjectedStreams(D, 2 * P, cell_dim=C, pallas=False)
    want, want_state = jax_comp.apply(
        {k: _jax_tree(v) for k, v in params.items()}, jnp.asarray(x),
        {"fwd": _jax_tree(state)}, train=False, mask=jnp.asarray(mask))
    comp = BLstmProjectedStreams(D, 2 * P, cell_dim=C)
    comp.load_state_dict(
        {k.split(".", 1)[1]: v for k, v in params_from_jax(params).items()})
    comp.eval()
    before = (lstmp_ops.lstmp_forward.launches,
              lstmp_ops.blstmp_forward.launches)
    ys, st = comp(torch.from_numpy(x),
                  {"fwd": {k: torch.from_numpy(v) for k, v in state.items()}},
                  mask=torch.from_numpy(mask))
    assert not ys.requires_grad
    np.testing.assert_allclose(ys.numpy(), np.asarray(want), rtol=0,
                               atol=BI_ATOL)
    for k in ("c", "r"):
        np.testing.assert_allclose(st["fwd"][k].numpy(),
                                   np.asarray(want_state["fwd"][k]), rtol=0,
                                   atol=BI_ATOL)
    # the counters count kernel launches: none on the CPU
    assert before == (lstmp_ops.lstmp_forward.launches,
                      lstmp_ops.blstmp_forward.launches)


@pytest.mark.parametrize("S", [1, 8])
def test_blstmp_chunks_of_16_carry_direction_f(S):
    """A server's chunks: direction f over chunks of 16 frames with the
    carried state equals one long call (direction b restarts per chunk and
    is compared within each)."""
    T = 48
    rs = np.random.RandomState(9 + S)
    xg_f, xg_b, mask, w_f, w_b, c0, r0 = _torch_args(_bi_args(rs, S, T))
    whole, c_w, r_w = blstmp_forward(xg_f, xg_b, mask, w_f, w_b, c0, r0)
    c, r, parts = c0, r0, []
    for t0 in range(0, T, 16):
        sl = slice(t0, t0 + 16)
        ys, c, r = blstmp_forward(
            xg_f[:, sl].contiguous(), xg_b[:, sl].contiguous(),
            mask[:, sl].contiguous(), w_f, w_b, c, r)
        parts.append(ys)
        want_b, _, _ = lstmp_forward_reference(
            torch.flip(xg_b[:, sl], (1,)), torch.flip(mask[:, sl], (1,)),
            *w_b, torch.zeros_like(c0), torch.zeros_like(r0))
        assert torch.equal(ys[..., P:], torch.flip(want_b, (1,)))
    chunked = torch.cat(parts, dim=1)
    assert torch.equal(chunked[..., :P], whole[..., :P])
    assert torch.equal(c, c_w) and torch.equal(r, r_w)


def _valid_bi_args(S=2, T=3):
    w = (torch.zeros(4 * C, P), torch.zeros(P, C), torch.zeros(3, C))
    return [torch.zeros(S, T, 4 * C), torch.zeros(S, T, 4 * C),
            torch.ones(S, T), w, w, torch.zeros(S, C), torch.zeros(S, P)]


def test_blstmp_zero_length_returns_initial_state():
    S = 2
    args = _valid_bi_args(S, 0)
    args[5], args[6] = torch.ones(S, C), torch.ones(S, P)
    before = lstmp_ops.blstmp_forward.launches
    ys, c, r = blstmp_forward(*args)
    assert ys.shape == (S, 0, 2 * P)
    assert torch.equal(c, args[5]) and torch.equal(r, args[6])
    assert lstmp_ops.blstmp_forward.launches == before


@pytest.mark.parametrize("which,bad,err,match", [
    (1, torch.zeros(2, 3, 4 * C + 4), ValueError, "xg_b"),
    (2, torch.ones(2, 4), ValueError, "mask"),
    (3, (torch.zeros(4 * C, P, dtype=torch.float64), torch.zeros(P, C),
         torch.zeros(3, C)), TypeError, "w_gifo_r_f"),
    (4, (torch.zeros(4 * C, P), torch.zeros(C, P).t(), torch.zeros(3, C)),
     ValueError, "w_r_m_b must be contiguous"),
    (4, (torch.zeros(4 * C, P), torch.zeros(P, C), torch.zeros(2, C)),
     ValueError, "peep_b"),
    (5, torch.zeros(3, C), ValueError, "c0"),
    (6, torch.zeros(2, P, dtype=torch.float16), TypeError, "r0"),
])
def test_blstmp_wrapper_rejects_bad_inputs(which, bad, err, match):
    args = _valid_bi_args()
    args[which] = bad
    with pytest.raises(err, match=match):
        blstmp_forward(*args)


def test_blstmp_wrapper_never_falls_back_for_other_devices():
    args = [tuple(w.to("meta") for w in a) if isinstance(a, tuple)
            else a.to("meta") for a in _valid_bi_args()]
    with pytest.raises(ValueError, match="no LSTMP kernel"):
        blstmp_forward(*args)
    # tensors on two devices are refused before any dispatch
    args = _valid_bi_args()
    args[1] = args[1].to("meta")
    with pytest.raises(ValueError, match="xg_b is on meta"):
        blstmp_forward(*args)


def test_the_cuda_route_refuses_autograd():
    """The kernels have no backward: where autograd would record a graph,
    the CUDA route raises before it launches (refuse_autograd is its first
    step); under no_grad it does not."""
    args = _valid_bi_args()
    args[0].requires_grad_()
    flat = [a for a in args if not isinstance(a, tuple)]
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_autograd(*flat)
    with torch.no_grad():
        refuse_autograd(*flat)
    # the route itself: refused on a device it has no kernel for before
    # autograd is looked at, so the check cannot be skipped by a device
    with pytest.raises(ValueError, match="no LSTMP kernel"):
        lstmp_ops._forward(lstmp_ops.blstmp_forward, [a.to("meta") for a in
                                                      args[:2]],
                           args[2].to("meta"), [args[3], args[4]], args[5],
                           args[6], 50.0)
