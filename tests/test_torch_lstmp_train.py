"""The port's unidirectional LSTMP training core
(kaldi_aslp_tpu_torch/ops/lstmp_train.py, plain versions on the CPU)
against the JAX package: the plain forward and backward against
``_lstmp_train_fwd`` / ``_lstmp_train_bwd``, whose Pallas kernels
``_lstmp_fwd_train_kernel`` / ``_lstmp_bwd_kernel`` run here in interpret
mode, as tests/test_lstm_pallas.py runs them; ``LstmpTrainCore`` against
``lstmp_train_core(interpret=True)``; and the ``LstmProjectedStreams`` /
``BLstmProjectedStreams`` modules in ``train()`` against JAX
``apply(train=True)`` on its scan path and on its Pallas path.

Inputs come from numpy seeds fed to both packages; masks are ragged, the
initial state and the final-state cotangents nonzero.  The port runs the
TPU kernels' three (store_bf16, mxu_bf16) modes: float32 (F, F), bf16
(T, T) and, under KALDI_ASLP_LSTM_MXU_FP32, bf16 storage with float32
products (T, F).

Tolerance, as max |port - JAX| / max |JAX| per output or gradient:
1e-5 for every output computed in float32, in both modes (the same
float32 math summed in another order); 2e-2 for a bf16 value (one bf16
step is 2^-8 of it), and no more than BF16_SHARE of its elements may
differ from JAX's at all: both sides round at the same places, so a
value rounds the other way only when it lands on a rounding boundary.
These two limits are what tell the bf16 rounding rules apart:
test_bf16_checks_tell_the_product_modes_apart shows that JAX's (T, F)
mode fails them against its (T, T) mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.models.recurrent import (
    BLstmProjectedStreams as JaxBLstm,
    LstmProjectedStreams as JaxLstm,
)
from kaldi_aslp_tpu.ops.lstm_pallas import (
    _lstmp_train_bwd,
    _lstmp_train_fwd,
    lstmp_train_core,
)
from kaldi_aslp_tpu_torch.models.recurrent import (
    BLstmProjectedStreams,
    LstmProjectedStreams,
)
from kaldi_aslp_tpu_torch.ops.lstmp_train import (
    LstmpTrainCore,
    lstmp_train_bwd,
    lstmp_train_fwd,
)

torch.set_num_threads(1)

S, T, D, C, P = 5, 9, 24, 32, 16
F32_TOL, BF16_TOL = 1e-5, 2e-2
BF16_SHARE = 1e-2    # share of a bf16 output's elements that may differ
MODES = [False, True]
MODE_IDS = ["f32", "bf16"]
NAMES = ["xg", "w_gifo_r", "w_r_m", "peep", "init_c", "init_r"]
FWD_NAMES = ("gates", "cs", "rs")
BWD_NAMES = ("dxg", "d_init_c", "d_init_r", "d_w_gifo_r", "d_w_r_m", "dpeep")
CORE_NAMES = ("ys", "final_c", "final_r")
# what bf16 mode rounds to bf16: the stored streams, dxg, ys and the final
# state taken from the stored streams, and xg's gradient (dxg)
BF16_VALUED = {"gates", "cs", "rs", "dxg", "ys", "final_c", "final_r", "xg"}


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _share(got, want):
    """The share of elements that differ at all."""
    return float((np.asarray(got, np.float32)
                  != np.asarray(want, np.float32)).mean())


def _misses(names, got, want, store_bf16):
    """{name: reading} of every output outside its tolerance (module
    docstring); empty when all hold."""
    out = {}
    for name, g, w in zip(names, got, want):
        if store_bf16 and name in BF16_VALUED:
            if _rel(g, w) > BF16_TOL or _share(g, w) > BF16_SHARE:
                out[name] = (_rel(g, w), _share(g, w))
        elif _rel(g, w) > F32_TOL:
            out[name] = _rel(g, w)
    return out


def _jax_kernels(a, mask, cots, store_bf16, mxu_bf16, streams=None):
    """JAX's training forward and its backward (fed ``streams``, by
    default the forward's own), in the port's layouts."""
    jst = jnp.bfloat16 if store_bf16 else jnp.float32
    flags = dict(cell_clip=50.0, interpret=True, store_bf16=store_bf16,
                 mxu_bf16=mxu_bf16)
    w_r_t, w_rm_t = jnp.asarray(a["w_gifo_r"].T), jnp.asarray(a["w_r_m"].T)
    fwd = _lstmp_train_fwd(
        jnp.asarray(a["xg"]), jnp.asarray(mask), w_r_t, w_rm_t,
        jnp.asarray(a["peep"]), jnp.asarray(a["init_c"]),
        jnp.asarray(a["init_r"]), **flags)
    gj, cj, rj = streams or fwd
    c_prev = jnp.concatenate(
        [jnp.asarray(a["init_c"]).astype(jst)[None], cj[:-1]])
    r_prev = jnp.concatenate(
        [jnp.asarray(a["init_r"]).astype(jst)[None], rj[:-1]])
    bwd = list(_lstmp_train_bwd(
        jnp.asarray(cots["ys"]).astype(jst), jnp.asarray(mask), gj, cj,
        c_prev, r_prev, w_r_t, w_rm_t, jnp.asarray(a["peep"]),
        jnp.asarray(cots["c"]), jnp.asarray(cots["r"]), **flags))
    bwd[3], bwd[4] = np.asarray(bwd[3]).T, np.asarray(bwd[4]).T
    return fwd, bwd


def _t(a, dtype=torch.float32):
    """numpy or JAX array (bf16 included) -> torch tensor of ``dtype``."""
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _inputs(seed):
    rs = np.random.RandomState(seed)

    def u(*shape):
        return (0.1 * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32)
    lens = np.array([T, 6, 3, 1, T - 2])
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    args = {"xg": (0.5 * rs.randn(S, T, 4 * C)).astype(np.float32),
            "w_gifo_r": u(4 * C, P), "w_r_m": u(P, C), "peep": u(3, C),
            "init_c": (0.5 * rs.randn(S, C)).astype(np.float32),
            "init_r": (0.5 * rs.randn(S, P)).astype(np.float32)}
    cots = {"ys": rs.randn(S, T, P).astype(np.float32),
            "c": rs.randn(S, C).astype(np.float32),
            "r": rs.randn(S, P).astype(np.float32)}
    return args, mask, cots


@pytest.mark.parametrize("store_bf16", MODES, ids=MODE_IDS)
def test_plain_versions_match_jax_kernels(store_bf16):
    """lstmp_train_fwd / lstmp_train_bwd on CPU tensors (the plain
    versions) against the TPU kernels in interpret mode; the backward of
    both is fed JAX's stored streams."""
    a, mask, cots = _inputs(seed=11)
    st = torch.bfloat16 if store_bf16 else torch.float32
    (gj, cj, rj), want = _jax_kernels(a, mask, cots, store_bf16, store_bf16)
    got = lstmp_train_fwd(_t(a["xg"], st), _t(mask), _t(a["w_gifo_r"]),
                          _t(a["w_r_m"]), _t(a["peep"]), _t(a["init_c"]),
                          _t(a["init_r"]), 50.0)
    for name, g, w in zip(FWD_NAMES, got, (gj, cj, rj)):
        assert g.dtype == st and tuple(g.shape) == w.shape, name
    assert not _misses(FWD_NAMES, [g.float() for g in got], (gj, cj, rj),
                       store_bf16)

    got = lstmp_train_bwd(
        _t(cots["ys"], st), _t(mask), _t(gj, st), _t(cj, st), _t(rj, st),
        _t(a["w_gifo_r"]), _t(a["w_r_m"]), _t(a["peep"]), _t(a["init_c"]),
        _t(a["init_r"]), _t(cots["c"]), _t(cots["r"]), 50.0)
    for name, g, w in zip(BWD_NAMES, got, want):
        assert tuple(g.shape) == w.shape, name
        assert np.abs(np.asarray(w, np.float32)).max() > 0, name
    assert not _misses(BWD_NAMES, [g.float() for g in got], want,
                       store_bf16)
    assert got[0].dtype == st
    assert all(g.dtype == torch.float32 for g in got[1:])


def _jax_core(a, mask, cots, store_bf16, mxu_bf16):
    def loss(xg, w_r, w_rm, peep, c0, r0):
        ys, fc, fr = lstmp_train_core(
            xg, jnp.asarray(mask), w_r, w_rm, peep, c0, r0,
            interpret=True, store_bf16=store_bf16, mxu_bf16=mxu_bf16)
        ys = ys.astype(jnp.float32)
        return (jnp.sum(ys * cots["ys"]) + jnp.sum(fc * cots["c"])
                + jnp.sum(fr * cots["r"])), (ys, fc, fr)
    (_, outs), grads = jax.value_and_grad(
        loss, argnums=tuple(range(6)), has_aux=True)(
        *[jnp.asarray(a[n]) for n in NAMES])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_core(a, mask, cots, store_bf16, mxu_bf16=None):
    leaves = [torch.tensor(a[n], requires_grad=True) for n in NAMES]
    xg, w_r, w_rm, peep, c0, r0 = leaves
    ys, fc, fr = LstmpTrainCore.apply(xg, torch.from_numpy(mask), w_r, w_rm,
                                      peep, c0, r0, 50.0, store_bf16,
                                      store_bf16 if mxu_bf16 is None
                                      else mxu_bf16)
    assert ys.dtype == (torch.bfloat16 if store_bf16 else torch.float32)
    assert fc.dtype == fr.dtype == torch.float32
    ys = ys.float()
    ((ys * torch.from_numpy(cots["ys"])).sum()
     + (fc * torch.from_numpy(cots["c"])).sum()
     + (fr * torch.from_numpy(cots["r"])).sum()).backward()
    for n, t in zip(NAMES, leaves):
        assert t.grad.dtype == torch.float32, n
    return ([o.detach().numpy() for o in (ys, fc, fr)],
            [t.grad.numpy() for t in leaves])


def test_float32_products_with_bf16_storage_match_jax():
    """The (T, F) mode: the plain versions against the TPU kernels, and
    LstmpTrainCore against lstmp_train_core, on JAX's own streams."""
    a, mask, cots = _inputs(seed=14)
    bf = torch.bfloat16
    (gj, cj, rj), want = _jax_kernels(a, mask, cots, True, False)
    got = lstmp_train_fwd(_t(a["xg"], bf), _t(mask), _t(a["w_gifo_r"]),
                          _t(a["w_r_m"]), _t(a["peep"]), _t(a["init_c"]),
                          _t(a["init_r"]), 50.0, False)
    assert not _misses(FWD_NAMES, [g.float() for g in got], (gj, cj, rj),
                       True)
    got = lstmp_train_bwd(
        _t(cots["ys"], bf), _t(mask), _t(gj, bf), _t(cj, bf), _t(rj, bf),
        _t(a["w_gifo_r"]), _t(a["w_r_m"]), _t(a["peep"]), _t(a["init_c"]),
        _t(a["init_r"]), _t(cots["c"]), _t(cots["r"]), 50.0, False)
    assert not _misses(BWD_NAMES, [g.float() for g in got], want, True)
    want_out, want_grads = _jax_core(a, mask, cots, True, False)
    got_out, got_grads = _port_core(a, mask, cots, True, mxu_bf16=False)
    assert not _misses(CORE_NAMES, got_out, want_out, True)
    assert not _misses(NAMES, got_grads, want_grads, True)


@pytest.mark.parametrize("store_bf16", MODES, ids=MODE_IDS)
def test_core_values_and_gradients_match_jax_core(store_bf16):
    a, mask, cots = _inputs(seed=12)
    want_out, want_grads = _jax_core(a, mask, cots, store_bf16, store_bf16)
    got_out, got_grads = _port_core(a, mask, cots, store_bf16)
    for name, g, w in zip(CORE_NAMES, got_out, want_out):
        assert g.shape == w.shape, name
    for name, g, w in zip(NAMES, got_grads, want_grads):
        assert g.shape == w.shape and np.abs(w).max() > 0, name
    assert not _misses(CORE_NAMES, got_out, want_out, store_bf16)
    assert not _misses(NAMES, got_grads, want_grads, store_bf16)
    # masked frames output zero and pass no gradient to xg
    dead = mask == 0
    assert (got_out[0][dead] == 0).all()
    assert (got_grads[0][dead] == 0).all()


@pytest.mark.parametrize("level", ["kernels", "core"])
def test_bf16_checks_tell_the_product_modes_apart(level):
    """The bf16 checks above catch a plain version that broke the
    rounding rules: JAX's (T, F) mode, which skips the bf16 rounding of
    the product operands, misses them against its (T, T) mode on the
    same inputs, in the float32 outputs and in the share of bf16 values
    that differ."""
    a, mask, cots = _inputs(seed=11 if level == "kernels" else 12)
    if level == "kernels":
        fwd, bwd = _jax_kernels(a, mask, cots, True, True)
        fwd_f, bwd_f = _jax_kernels(a, mask, cots, True, False, streams=fwd)
        misses = {**_misses(FWD_NAMES, fwd_f, fwd, True),
                  **_misses(BWD_NAMES, bwd_f, bwd, True)}
        f32_outputs = BWD_NAMES[1:]
    else:
        (out, grads), (out_f, grads_f) = (
            _jax_core(a, mask, cots, True, mxu) for mxu in (True, False))
        misses = {**_misses(CORE_NAMES, out_f, out, True),
                  **_misses(NAMES, grads_f, grads, True)}
        f32_outputs = NAMES[1:]
    assert set(f32_outputs) <= set(misses), misses
    assert any(isinstance(misses[n], tuple) and misses[n][1] > BF16_SHARE
               for n in misses), misses


# -- the modules -------------------------------------------------------------

def _module_case(jax_cls, port_cls, out_dim, attrs, seed):
    rs = np.random.RandomState(seed)
    comp_j = jax_cls(D, out_dim, cell_dim=C, **attrs)
    params = jax.tree_util.tree_map(
        np.asarray, comp_j.init_params(jax.random.PRNGKey(seed)))
    comp = port_cls(D, out_dim, cell_dim=C, **attrs)
    comp.load_state_dict({
        name: torch.from_numpy(np.array(
            params[name.split(".")[0]][name.split(".")[1]]
            if "." in name else params[name]))
        for name, _ in comp.named_parameters()})
    x = rs.randn(S, T, D).astype(np.float32)
    lens = np.array([T, 4, 7, 2, T - 1])
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    c0 = (0.5 * rs.randn(S, C)).astype(np.float32)
    r0 = (0.5 * rs.randn(S, P)).astype(np.float32)
    cots = (rs.randn(S, T, out_dim).astype(np.float32),
            rs.randn(S, C).astype(np.float32),
            rs.randn(S, P).astype(np.float32))
    return comp_j, params, comp, x, mask, c0, r0, cots


def _state(tree, c0, r0, bidirectional):
    state = {"c": c0, "r": r0}
    return {"fwd": state} if bidirectional else state


def _module_grads_jax(comp_j, params, x, mask, c0, r0, cots, bidir):
    def loss(p, x, c0, r0):
        ys, st = comp_j.apply(p, x, _state(None, c0, r0, bidir), train=True,
                              mask=jnp.asarray(mask))
        st = st["fwd"] if bidir else st
        ys = ys.astype(jnp.float32)
        return (jnp.sum(ys * cots[0]) + jnp.sum(st["c"] * cots[1])
                + jnp.sum(st["r"] * cots[2])), ys
    (_, ys), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                        has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(c0), jnp.asarray(r0))
    gp, gx, gc, gr = grads
    flat = {}
    for k, v in gp.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            flat[k] = np.asarray(v)
    return np.asarray(ys), {**flat, "x": np.asarray(gx),
                            "init_c": np.asarray(gc),
                            "init_r": np.asarray(gr)}


def _module_grads_port(comp, x, mask, c0, r0, cots, bidir):
    comp.train()
    xt = torch.tensor(x, requires_grad=True)
    ct = torch.tensor(c0, requires_grad=True)
    rt = torch.tensor(r0, requires_grad=True)
    ys, st = comp(xt, _state(None, ct, rt, bidir), mask=torch.tensor(mask))
    st = st["fwd"] if bidir else st
    ys = ys.float()
    ((ys * torch.from_numpy(cots[0])).sum()
     + (st["c"] * torch.from_numpy(cots[1])).sum()
     + (st["r"] * torch.from_numpy(cots[2])).sum()).backward()
    grads = {n: p.grad.numpy() for n, p in comp.named_parameters()}
    return ys.detach().numpy(), {**grads, "x": xt.grad.numpy(),
                                 "init_c": ct.grad.numpy(),
                                 "init_r": rt.grad.numpy()}


def _hold(got, want, store_bf16):
    (ys, grads), (ys_j, grads_j) = got, want
    assert ys.shape == ys_j.shape
    assert sorted(grads) == sorted(grads_j)
    for name, w in grads_j.items():
        assert grads[name].dtype == np.float32, name
        assert np.abs(w).max() > 0, name
    names = sorted(grads_j)
    assert not _misses(["ys", *names], [ys, *(grads[n] for n in names)],
                       [ys_j, *(grads_j[n] for n in names)], store_bf16)


@pytest.mark.parametrize("attrs", [
    dict(pallas=False), dict(pallas=True), dict(bf16=True, pallas=True)],
    ids=["f32-vs-scan", "f32-vs-pallas", "bf16-vs-pallas"])
def test_lstmp_module_training_matches_jax(attrs):
    """LstmProjectedStreams in train() through LstmpTrainCore, against the
    JAX module's scan path and its Pallas branch (interpret mode).  The
    bf16 case is the fault the port had: it raised on the CPU for a bf16
    LSTMP, which the JAX package trains."""
    comp_j, params, comp, x, mask, c0, r0, cots = _module_case(
        JaxLstm, LstmProjectedStreams, P, attrs, seed=21)
    _hold(_module_grads_port(comp, x, mask, c0, r0, cots, False),
          _module_grads_jax(comp_j, params, x, mask, c0, r0, cots, False),
          attrs.get("bf16", False))


@pytest.mark.parametrize("attrs", [dict(pallas=False), dict(pallas=True)],
                         ids=["vs-scan", "vs-pallas"])
def test_float32_blstmp_training_matches_jax(attrs):
    """A float32 BLSTMP trains each direction through LstmpTrainCore (JAX:
    each direction's ``apply(train=True)``, recurrent.py:499-504)."""
    comp_j, params, comp, x, mask, c0, r0, cots = _module_case(
        JaxBLstm, BLstmProjectedStreams, 2 * P, attrs, seed=22)
    _hold(_module_grads_port(comp, x, mask, c0, r0, cots, True),
          _module_grads_jax(comp_j, params, x, mask, c0, r0, cots, True),
          False)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a, mask, cots = _inputs(seed=13)
    args = [_t(a[n]) for n in NAMES]
    xg, w_r, w_rm, peep, c0, r0 = args
    with pytest.raises(ValueError, match="float32 or bf16"):
        lstmp_train_fwd(xg.double(), _t(mask), w_r, w_rm, peep, c0, r0)
    with pytest.raises(ValueError, match="w_gifo_r must be"):
        lstmp_train_fwd(xg, _t(mask), w_r[:-1], w_rm, peep, c0, r0)
    with pytest.raises(ValueError, match="contiguous"):
        lstmp_train_fwd(xg, _t(mask), w_r, w_rm, peep, c0,
                        torch.zeros(P, S).t())
    with pytest.raises(ValueError, match="dys must be"):
        lstmp_train_bwd(_t(cots["ys"], torch.bfloat16), _t(mask),
                        *lstmp_train_fwd(xg, _t(mask), w_r, w_rm, peep, c0,
                                         r0),
                        w_r, w_rm, peep, c0, r0, _t(cots["c"]),
                        _t(cots["r"]))
    # neither the CPU nor CUDA: no kernel and no silent plain version
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no LSTMP training kernel"):
        lstmp_train_fwd(meta[0], _t(mask).to("meta"), *meta[1:])
