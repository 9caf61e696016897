"""The latency-controlled BLSTMP, CIFG-LSTMP and GRU
(kaldi_aslp_tpu_torch/models/recurrent.py) against the JAX package's
(kaldi_aslp_tpu/models/recurrent.py:292-395, :525-567), with ragged
masks and a nonzero carried state: values, final state and, in training,
every gradient (input, initial state, every parameter) against
``jax.grad``.  The JAX LSTMP runs its scan on the CPU; the port runs its
kernels' plain versions (``lstmp_forward_reference`` in eval,
``LstmpTrainCore``'s plain path in training).  The LC layer at T a
multiple of the chunk, not a multiple and below it, and its backward
direction blind past a chunk boundary.

Tolerances, as max |port - JAX| / max |JAX| per tensor: 1e-5 for values
and final states, 1e-4 for gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import kaldi_aslp_tpu.models as J
import kaldi_aslp_tpu_torch.models as M
from kaldi_aslp_tpu_torch.ops import lstmp, lstmp_train

torch.set_num_threads(1)

S, D = 3, 5
VALUE_TOL, GRAD_TOL = 1e-5, 1e-4


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _ragged_mask(rs, T):
    lens = rs.randint(max(T // 2, 1), T + 1, S)
    lens[0] = T
    return (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)


def _state(kind, rs, C, P):
    if kind == "gru":
        return {"h": 0.5 * rs.randn(S, P).astype(np.float32)}
    st = {"c": 0.5 * rs.randn(S, C).astype(np.float32),
          "r": 0.5 * rs.randn(S, P).astype(np.float32)}
    return {"fwd": st} if kind == "lc" else st


def _build(kind, chunk, clip):
    if kind == "lc":
        args, kw = (D, 8), dict(cell_dim=6, chunk_size=chunk,
                                cell_clip=clip)
        return J.BLstmProjectedStreamsLC(*args, **kw), 6, 4, 8
    if kind == "cifg":
        return (J.LstmCifgProjectedStreams(D, 4, cell_dim=6, cell_clip=clip),
                6, 4, 4)
    return J.GruStreams(D, 5), 5, 5, 5


# (kind, T, chunk, clip): LC at T a multiple of the chunk, not a
# multiple, below it and at one frame a chunk
CASES = [("lc", 12, 4, 50.0), ("lc", 11, 4, 50.0), ("lc", 3, 8, 50.0),
         ("lc", 7, 1, 50.0), ("lc", 10, 3, 0.4), ("cifg", 9, 0, 50.0),
         ("cifg", 9, 0, 0.4), ("gru", 9, 0, 0.0)]


@pytest.mark.parametrize("kind,T,chunk,clip", CASES, ids=[
    f"{k}-T{t}" + (f"-chunk{c}" if c else "") + f"-clip{cl:g}"
    for k, t, c, cl in CASES])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_cell_matches_jax(kind, T, chunk, clip, train):
    rs = np.random.RandomState(13 + T + chunk)
    jc, C, P, out_dim = _build(kind, chunk, clip)
    # three times the init's range, so the small clips act
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(3.0 * np.asarray(p)),
        jc.init_params(jax.random.PRNGKey(5)))
    x = rs.randn(S, T, D).astype(np.float32)
    mask = _ragged_mask(rs, T)
    state = _state(kind, rs, C, P)
    cot_y = rs.randn(S, T, out_dim).astype(np.float32)
    cot_s = {k: rs.randn(*v.shape).astype(np.float32)
             for k, v in _flat(state).items()}

    def jax_objective(p, xx, st):
        ys, new = jc.apply(p, xx, st, train=train, mask=jnp.asarray(mask))
        obj = jnp.sum(ys * cot_y) + sum(
            jnp.sum(v * cot_s[k]) for k, v in _flat_j(new).items())
        return obj, (ys, new)

    (_, (ys_j, st_j)), grads_j = jax.value_and_grad(
        jax_objective, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, state))

    comp = M.component_from_token(jc.token)(jc.input_dim, jc.output_dim,
                                            **jc.attrs)
    comp.load_state_dict({k: torch.from_numpy(v.copy())
                          for k, v in _flat(params).items()})
    comp.train(train)
    xt = torch.from_numpy(x).requires_grad_(train)
    st = _torch_tree(state, train)
    ys, new = comp(xt, st, mask=torch.from_numpy(mask))
    assert ys.shape == (S, T, out_dim)
    assert _rel(ys.detach(), ys_j) <= VALUE_TOL
    for k, v in _flat(jax.tree_util.tree_map(np.asarray, st_j)).items():
        assert _rel(_flat_t(new)[k].detach(), v) <= VALUE_TOL, k
    # padded frames output 0 in both directions, as in JAX
    assert np.all(ys.detach().numpy()[mask == 0] == 0.0)
    if not train:
        return
    obj = (ys * torch.from_numpy(cot_y)).sum() + sum(
        (v * torch.from_numpy(cot_s[k])).sum()
        for k, v in _flat_t(new).items())
    obj.backward()
    got = {f"param.{k}": p.grad for k, p in comp.named_parameters()}
    want = {f"param.{k}": v for k, v in _flat(grads_j[0]).items()}
    assert sorted(got) == sorted(want)
    if kind == "cifg":
        # peephole_i_c is kept (the reference's layout) and unused
        assert got.pop("param.peephole_i_c") is None
        assert not np.any(want.pop("param.peephole_i_c"))
    got["x"], want["x"] = xt.grad, grads_j[1]
    for k, v in _flat(grads_j[2]).items():
        got["state." + k], want["state." + k] = _flat_t(st)[k].grad, v
    errs = {k: _rel(got[k], want[k]) for k in want}
    assert max(errs.values()) <= GRAD_TOL, errs


def _flat_j(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_j(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


_flat_t = _flat_j


def _torch_tree(tree, grad):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, grad) for k, v in tree.items()}
    return torch.from_numpy(tree.copy()).requires_grad_(grad)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_lc_backward_direction_stops_at_the_chunk_boundary(train):
    """(tests/test_components.py:198): frames past a chunk move no
    backward output before it; the forward direction still sees the
    past."""
    comp = M.BLstmProjectedStreamsLC(3, 8, cell_dim=6, chunk_size=4)
    comp.reset_parameters(torch.Generator().manual_seed(0))
    comp.train(train)
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(1, 8, 3).astype(np.float32))
    half = 4
    y, _ = comp(x)
    x2 = x.clone()
    x2[0, 4:] += 5.0
    y2, _ = comp(x2)
    assert torch.allclose(y[0, :4, half:], y2[0, :4, half:], rtol=1e-5,
                          atol=1e-6)
    assert (y[0, 4:, half:] - y2[0, 4:, half:]).abs().max() > 1e-3
    x3 = x.clone()
    x3[0, 0] += 5.0
    y3, _ = comp(x3)
    assert (y3[0, 5, :half] - y[0, 5, :half]).abs().max() > 1e-6


def test_lc_runs_two_lstmp_calls_a_layer(monkeypatch):
    """Eval: two one-direction inference calls, the backward one at S * n
    streams of chunk_size frames (T padded to the chunk); training: two
    training-core calls."""
    calls = []
    inner = lstmp.lstmp_forward

    def counting(xg, mask, *args, **kw):
        calls.append(tuple(xg.shape))
        return inner(xg, mask, *args, **kw)

    monkeypatch.setattr("kaldi_aslp_tpu_torch.models.recurrent."
                        "lstmp_forward", counting)
    comp = M.BLstmProjectedStreamsLC(3, 8, cell_dim=6, chunk_size=8)
    comp.reset_parameters(torch.Generator().manual_seed(0))
    comp.eval()
    comp(torch.randn(2, 20, 3))
    assert calls == [(2, 20, 24), (6, 8, 24)]
    cores = []
    inner_core = lstmp_train.LstmpTrainCore.apply

    def counting_core(xg, *args):
        cores.append(tuple(xg.shape))
        return inner_core(xg, *args)

    monkeypatch.setattr(lstmp_train.LstmpTrainCore, "apply", counting_core)
    comp.train()
    comp(torch.randn(2, 5, 3))
    assert cores == [(2, 5, 24), (2, 8, 24)]


def test_lc_default_chunk_and_state():
    comp = M.BLstmProjectedStreamsLC(4, 6, cell_dim=5)
    jcomp = J.BLstmProjectedStreamsLC(4, 6, cell_dim=5)
    assert comp.chunk_size == jcomp.chunk_size == 64
    st = comp.init_state(3, torch.device("cpu"))
    assert sorted(st) == ["fwd"] and st["fwd"]["c"].shape == (3, 5)


def test_gru_and_cifg_defaults():
    gru = M.GruStreams(4, 3)
    gru.reset_parameters(torch.Generator().manual_seed(0))
    assert max(float(p.detach().abs().max()) for p in gru.parameters()) <= 0.1
    assert sorted(gru.init_state(2, "cpu")) == ["h"]
    cifg = M.LstmCifgProjectedStreams(4, 3, cell_dim=5)
    assert isinstance(cifg, M.LstmProjectedStreams)
    assert cifg.token == "<LstmCifgProjectedStreams>"
