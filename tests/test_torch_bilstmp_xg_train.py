"""The port's xg-fed bidirectional LSTMP training core and the JAX
package's LSTM switches (kaldi_aslp_tpu_torch/ops/bilstmp_xg_train.py,
ops/bilstmp_train.py's per-direction backward, ops/switches.py and the
routing in models/recurrent.py), plain versions on the CPU, against the
JAX package: ``bilstmp_train_core`` (``_bilstmp_fwd_kernel`` /
``_bilstmp_bwd_kernel``) and the x-fused core's split backward
(``_xfused_bwd_kernel``), whose Pallas kernels run here in interpret mode
as tests/test_lstm_pallas.py runs them.  Inputs come from numpy seeds fed
to both packages; the masks are ragged, the initial state and the
final-state cotangents nonzero.

Tolerance, as max |port - JAX| / max |JAX| per output or gradient:
  - bf16 products (``mxu_bf16``), and the x-fused core: 5e-3.  Both
    sides round to bf16 at the same places but sum the products in
    another order, so now and then a bf16 operand or stored value rounds
    the other way (one bf16 step is 2^-8 of a value), and the recurrence
    carries it;
  - float32 products (``KALDI_ASLP_LSTM_MXU_FP32``): 1e-4.  Only the
    stored gates, c and r and the emitted streams round to bf16 there;
    a float32 sum in another order moves a value by about 1e-7 of
    itself, so a stored value rounds the other way only when it lies
    that close to a rounding boundary, about one value in 10^4;
  - the split backward against the fused one, both the port's: 1e-6 on
    the float32 gradients and equal bf16 dx (the same arithmetic)."""

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
    bilstmp_train_core,
    bilstmp_xfused_train_core,
)
from kaldi_aslp_tpu_torch.models import recurrent as rec
from kaldi_aslp_tpu_torch.models.interop import params_from_jax
from kaldi_aslp_tpu_torch.ops import bilstmp_train as bt
from kaldi_aslp_tpu_torch.ops.bilstmp_train import BiLstmpTrainCore
from kaldi_aslp_tpu_torch.ops.bilstmp_xg_train import (
    BiLstmpXgTrainCore,
    bilstmp_xg_train_bwd,
    bilstmp_xg_train_fwd,
)
from kaldi_aslp_tpu_torch.ops.switches import lstm_switches

torch.set_num_threads(1)

S, T, C, P = 6, 9, 32, 16
BF16_PRODUCTS_TOL, F32_PRODUCTS_TOL, SPLIT_TOL = 5e-3, 1e-4, 1e-6
SWITCHES = ["KALDI_ASLP_LSTM_NO_XFUSE", "KALDI_ASLP_LSTM_MXU_FP32",
            "KALDI_ASLP_LSTM_SPLIT_BWD"]
XG_NAMES = ["wf_gifo_r", "wf_r_m", "peep_f", "wb_gifo_r", "wb_r_m",
            "peep_b", "bias_f", "bias_b"]
XF_NAMES = ["wf_gifo_x", "wb_gifo_x", *XG_NAMES[:3], *XG_NAMES[3:]]


@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _mask():
    mask = np.ones((S, T), np.float32)
    mask[2, 6:] = 0
    mask[4, 3:] = 0
    mask[5, 1:] = 0
    return mask


def _params(rs, D=None):
    def u(*shape):
        return (0.1 * (2.0 * rs.rand(*shape) - 1.0)).astype(np.float32)
    p = {"wf_gifo_r": u(4 * C, P), "wf_r_m": u(P, C), "peep_f": u(3, C),
         "wb_gifo_r": u(4 * C, P), "wb_r_m": u(P, C), "peep_b": u(3, C),
         "bias_f": u(4 * C), "bias_b": u(4 * C)}
    if D is not None:
        p.update(wf_gifo_x=u(4 * C, D), wb_gifo_x=u(4 * C, D))
    return p


def _state_and_cots(rs):
    state = ((0.5 * rs.randn(S, C)).astype(np.float32),
             (0.5 * rs.randn(S, P)).astype(np.float32))
    cots = (rs.randn(S, T, 2 * P).astype(np.float32),
            rs.randn(S, C).astype(np.float32),
            rs.randn(S, P).astype(np.float32))
    return state, cots


def _bf16(a):
    """numpy float32 rounded to bf16, back in float32 (both packages then
    see the same bf16 values)."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
        jnp.float32))


def _jax_loss(core_fn, cots):
    def loss(*args):
        ysf, ysb, fc, fr = core_fn(*args)
        ys = jnp.concatenate([ysf, ysb], axis=-1).astype(jnp.float32)
        return (jnp.sum(ys * cots[0]) + jnp.sum(fc * cots[1])
                + jnp.sum(fr * cots[2])), (ys, fc, fr)
    return loss


# -- the xg-fed core ---------------------------------------------------------

def _xg_case(seed):
    rs = np.random.RandomState(seed)
    params = _params(rs)
    xgf = _bf16(rs.randn(S, T, 4 * C))
    xgb = _bf16(rs.randn(S, T, 4 * C))
    (c0, r0), cots = _state_and_cots(rs)
    return params, xgf, xgb, c0, r0, cots


def _xg_jax(params, xgf, xgb, mask, c0, r0, cots, mxu_bf16):
    def core(xgf, xgb, *rest):
        *ws, c0, r0 = rest
        return bilstmp_train_core(xgf, xgb, jnp.asarray(mask), *ws, c0, r0,
                                  interpret=True, store_bf16=True,
                                  mxu_bf16=mxu_bf16)
    args = [jnp.asarray(xgf).astype(jnp.bfloat16),
            jnp.asarray(xgb).astype(jnp.bfloat16),
            *[jnp.asarray(params[n]) for n in XG_NAMES],
            jnp.asarray(c0), jnp.asarray(r0)]
    (_, outs), grads = jax.value_and_grad(
        _jax_loss(core, cots), argnums=tuple(range(len(args))),
        has_aux=True)(*args)
    return ([np.asarray(o) for o in outs],
            [np.asarray(g, np.float32) for g in grads])


def _xg_port(params, xgf, xgb, mask, c0, r0, cots, mxu_bf16):
    leaves = [torch.tensor(xgf).to(torch.bfloat16).requires_grad_(),
              torch.tensor(xgb).to(torch.bfloat16).requires_grad_()]
    ws = [torch.tensor(params[n], requires_grad=True) for n in XG_NAMES]
    st = [torch.tensor(c0, requires_grad=True),
          torch.tensor(r0, requires_grad=True)]
    ys, fc, fr = BiLstmpXgTrainCore.apply(
        *leaves, torch.from_numpy(mask), *ws, *st, 50.0, mxu_bf16)
    assert ys.dtype == torch.bfloat16 and fc.dtype == torch.float32
    ys = ys.float()
    ((ys * torch.from_numpy(cots[0])).sum()
     + (fc * torch.from_numpy(cots[1])).sum()
     + (fr * torch.from_numpy(cots[2])).sum()).backward()
    assert leaves[0].grad.dtype == torch.bfloat16
    for t in ws + st:
        assert t.grad.dtype == torch.float32
    return ([o.detach().numpy() for o in (ys, fc, fr)],
            [t.grad.float().numpy() for t in leaves + ws + st])


@pytest.mark.parametrize("mxu_bf16", [True, False],
                         ids=["bf16-products", "f32-products"])
def test_xg_core_matches_jax(mxu_bf16):
    """BiLstmpXgTrainCore against bilstmp_train_core(interpret=True,
    store_bf16=True, mxu_bf16=...): outputs, final state and every
    gradient (xgf, xgb, weights, peepholes, biases, initial state)."""
    params, xgf, xgb, c0, r0, cots = _xg_case(seed=31 + mxu_bf16)
    mask = _mask()
    want_out, want_grads = _xg_jax(params, xgf, xgb, mask, c0, r0, cots,
                                   mxu_bf16)
    got_out, got_grads = _xg_port(params, xgf, xgb, mask, c0, r0, cots,
                                  mxu_bf16)
    tol = BF16_PRODUCTS_TOL if mxu_bf16 else F32_PRODUCTS_TOL
    names = ["xgf", "xgb", *XG_NAMES, "init_c", "init_r"]
    for name, g, w in zip(["ys", "c_T", "r_T"] + names,
                          got_out + got_grads, want_out + want_grads):
        assert g.shape == w.shape, name
        assert np.abs(w).max() > 0, name
        assert _rel(g, w) <= tol, (name, _rel(g, w))
    # masked frames output zero and pass no gradient to xg
    dead = mask == 0
    assert (got_out[0][dead] == 0).all()
    assert (got_grads[0][dead] == 0).all() and (got_grads[1][dead] == 0).all()


def test_xg_product_modes_differ_beyond_the_float32_bound():
    """The float32-products bound sees the rounding rule: the port's core
    in bf16-products mode misses it against JAX's float32-products mode
    on the same inputs."""
    params, xgf, xgb, c0, r0, cots = _xg_case(seed=32)
    mask = _mask()
    want_out, want_grads = _xg_jax(params, xgf, xgb, mask, c0, r0, cots,
                                   False)
    got_out, got_grads = _xg_port(params, xgf, xgb, mask, c0, r0, cots, True)
    worst = max(_rel(g, w) for g, w in zip(got_out + got_grads,
                                           want_out + want_grads))
    assert worst > 10 * F32_PRODUCTS_TOL, worst


def test_xg_wrappers_refuse_what_the_kernels_do_not_take():
    params, xgf, xgb, c0, r0, cots = _xg_case(seed=33)
    bf = torch.bfloat16
    wr = torch.from_numpy(np.stack([params["wf_gifo_r"],
                                    params["wb_gifo_r"]]))
    wrm = torch.from_numpy(np.stack([params["wf_r_m"], params["wb_r_m"]]))
    peep = torch.from_numpy(np.stack([params["peep_f"], params["peep_b"]]))
    bias = torch.from_numpy(np.stack([params["bias_f"], params["bias_b"]]))
    args = [torch.from_numpy(xgf).to(bf), torch.from_numpy(xgb).to(bf),
            torch.from_numpy(_mask()), wr, wrm, peep, bias,
            torch.from_numpy(c0), torch.from_numpy(r0)]
    with pytest.raises(ValueError, match="xgf must be"):
        bilstmp_xg_train_fwd(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        bilstmp_xg_train_fwd(*args[:7], torch.zeros(C, S).t(), args[8])
    ys, gates, cs, rprev, _, _ = bilstmp_xg_train_fwd(*args)
    with pytest.raises(ValueError, match="dy must be"):
        bilstmp_xg_train_bwd(ys.float(), args[2], gates, cs, rprev, wr, wrm,
                             peep, args[7], args[7], args[8])
    # neither the CPU nor CUDA: no kernel and no silent plain version
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="no BLSTMP xg training kernel"):
        bilstmp_xg_train_fwd(*meta)


# -- the split backward --------------------------------------------------------

def _xf_case(D, seed):
    rs = np.random.RandomState(seed)
    params = _params(rs, D)
    x = rs.randn(S, T, D).astype(np.float32)
    (c0, r0), cots = _state_and_cots(rs)
    return params, x, c0, r0, cots


def _xf_jax(params, x, mask, c0, r0, cots):
    def core(x, *rest):
        *ws, c0, r0 = rest
        return bilstmp_xfused_train_core(x, jnp.asarray(mask), *ws, c0, r0,
                                         interpret=True)
    args = [jnp.asarray(x), *[jnp.asarray(params[n]) for n in XF_NAMES],
            jnp.asarray(c0), jnp.asarray(r0)]
    (_, outs), grads = jax.value_and_grad(
        _jax_loss(core, cots), argnums=tuple(range(len(args))),
        has_aux=True)(*args)
    return ([np.asarray(o) for o in outs],
            [np.asarray(g, np.float32) for g in grads])


def _xf_port(params, x, mask, c0, r0, cots):
    leaves = [torch.tensor(x, requires_grad=True),
              *[torch.tensor(params[n], requires_grad=True)
                for n in XF_NAMES],
              torch.tensor(c0, requires_grad=True),
              torch.tensor(r0, requires_grad=True)]
    ys, fc, fr = BiLstmpTrainCore.apply(leaves[0], torch.from_numpy(mask),
                                        *leaves[1:], 50.0)
    ys = ys.float()
    ((ys * torch.from_numpy(cots[0])).sum()
     + (fc * torch.from_numpy(cots[1])).sum()
     + (fr * torch.from_numpy(cots[2])).sum()).backward()
    return ([o.detach().numpy() for o in (ys, fc, fr)],
            [t.grad.numpy() for t in leaves])


@pytest.mark.parametrize("D", [40, 128])
def test_split_backward_matches_jax(D, monkeypatch):
    """Under KALDI_ASLP_LSTM_SPLIT_BWD, BiLstmpTrainCore's backward (one
    direction at a time) against the JAX x-fused core's split backward
    (``_xfused_bwd_kernel`` per direction; JAX pads D = 40 to 128, the
    port does not): every gradient."""
    monkeypatch.setenv("KALDI_ASLP_LSTM_SPLIT_BWD", "1")
    params, x, c0, r0, cots = _xf_case(D, seed=D + 1)
    mask = _mask()
    want_out, want_grads = _xf_jax(params, x, mask, c0, r0, cots)
    got_out, got_grads = _xf_port(params, x, mask, c0, r0, cots)
    for name, g, w in zip(["ys", "c_T", "r_T", "x", *XF_NAMES, "init_c",
                           "init_r"], got_out + got_grads,
                          want_out + want_grads):
        assert g.shape == w.shape, name
        assert np.abs(w).max() > 0, name
        assert _rel(g, w) <= BF16_PRODUCTS_TOL, (name, _rel(g, w))


@pytest.mark.parametrize("D", [40, 128])
def test_split_backward_equals_the_fused_one(D, monkeypatch):
    """The port's two backwards on the CPU: the per-direction one twice
    against the fused one, through the autograd core."""
    params, x, c0, r0, cots = _xf_case(D, seed=D + 2)
    mask = _mask()
    fused_out, fused = _xf_port(params, x, mask, c0, r0, cots)
    monkeypatch.setenv("KALDI_ASLP_LSTM_SPLIT_BWD", "1")
    split_out, split = _xf_port(params, x, mask, c0, r0, cots)
    for g, w in zip(split_out, fused_out):
        np.testing.assert_array_equal(g, w)
    # dx: the same bf16 values (float32 here because x is float32)
    np.testing.assert_array_equal(split[0], fused[0])
    for name, g, w in zip(XF_NAMES + ["init_c", "init_r"], split[1:],
                          fused[1:]):
        assert _rel(g, w) <= SPLIT_TOL, (name, _rel(g, w))


def test_bwd_dir_wrapper_checks_its_direction():
    params, x, c0, r0, cots = _xf_case(40, seed=3)
    with pytest.raises(ValueError, match="direction 2"):
        bt.bilstmp_train_bwd_dir(2, *[None] * 13)


# -- the switches and the routing ----------------------------------------------

def test_switches_read_the_environment_at_call_time(monkeypatch):
    assert lstm_switches() == (False, False, False)
    monkeypatch.setenv("KALDI_ASLP_LSTM_MXU_FP32", "1")
    assert lstm_switches().mxu_fp32 and not lstm_switches().no_xfuse
    # any non-empty value sets a switch, as os.environ.get does in JAX
    monkeypatch.setenv("KALDI_ASLP_LSTM_SPLIT_BWD", "0")
    assert lstm_switches().split_bwd
    monkeypatch.setenv("KALDI_ASLP_LSTM_NO_XFUSE", "")
    assert not lstm_switches().no_xfuse


def _record(monkeypatch, calls):
    """Wrap the two bidirectional cores, the unidirectional one and the
    per-direction backward to record which ran, and with what products."""
    for name in ("BiLstmpTrainCore", "BiLstmpXgTrainCore", "LstmpTrainCore"):
        cls = getattr(rec, name)
        inner = cls.apply

        def apply(*args, _inner=inner, _name=name):
            mxu = args[-1] if _name != "BiLstmpTrainCore" else True
            calls.append((_name, mxu))
            return _inner(*args)
        monkeypatch.setattr(rec, name, type(name, (cls,), {
            "apply": staticmethod(apply)}))
    inner_dir = bt.bilstmp_train_bwd_dir

    def bwd_dir(d, *args, **kw):
        calls.append(("bwd_dir", d))
        return inner_dir(d, *args, **kw)
    monkeypatch.setattr(bt, "bilstmp_train_bwd_dir", bwd_dir)


@pytest.mark.parametrize("D", [40, 128])
@pytest.mark.parametrize("switch,want", [
    (None, [("BiLstmpTrainCore", True)]),
    ("KALDI_ASLP_LSTM_NO_XFUSE", [("BiLstmpXgTrainCore", True)]),
    ("KALDI_ASLP_LSTM_MXU_FP32", [("BiLstmpXgTrainCore", False)]),
    ("KALDI_ASLP_LSTM_SPLIT_BWD", [("BiLstmpTrainCore", True),
                                   ("bwd_dir", 0), ("bwd_dir", 1)])],
    ids=["default", "no-xfuse", "mxu-fp32", "split-bwd"])
def test_each_switch_picks_the_core_jax_picks(D, switch, want, monkeypatch):
    """The counterpart of tests/test_lstm_pallas.py:269-314: a bf16
    BLSTMP in training takes the x-fused core for any input width, and
    the xg-fed core under NO_XFUSE or MXU_FP32 (float32 products under
    the latter); SPLIT_BWD runs the backward once per direction."""
    if switch:
        monkeypatch.setenv(switch, "1")
    calls = []
    _record(monkeypatch, calls)
    comp = rec.BLstmProjectedStreams(D, 2 * 16, cell_dim=32, bf16=True)
    comp.reset_parameters(torch.Generator().manual_seed(1))
    comp.train()
    x = torch.from_numpy(np.random.RandomState(D).randn(4, 6, D)
                         .astype(np.float32))
    ys, _ = comp(x)
    ys.float().sum().backward()
    assert calls == want, calls
    calls.clear()
    # a bf16 LSTMP: bf16 products unless MXU_FP32 is set; a float32 one
    # has float32 products whatever the switches say
    lstm = rec.LstmProjectedStreams(D, 16, cell_dim=32, bf16=True)
    lstm.train()
    lstm(x)[0].float().sum().backward()
    rec.LstmProjectedStreams(D, 16, cell_dim=32).train()(x)
    assert calls == [("LstmpTrainCore",
                      switch != "KALDI_ASLP_LSTM_MXU_FP32"),
                     ("LstmpTrainCore", False)], calls


# -- the modules under each switch --------------------------------------------

def _component_params(tree):
    """A component's JAX parameter tree as its state dict, through
    params_from_jax (which names an Nnet's parameters)."""
    return {name.split(".", 1)[1]: t
            for name, t in params_from_jax(tree).items()}


def _module_case(jax_cls, port_cls, out_dim, D, seed):
    rs = np.random.RandomState(seed)
    comp_j = jax_cls(D, out_dim, cell_dim=C, pallas=True, bf16=True)
    params = jax.tree_util.tree_map(
        np.asarray, comp_j.init_params(jax.random.PRNGKey(seed)))
    comp = port_cls(D, out_dim, cell_dim=C, bf16=True)
    comp.load_state_dict(_component_params(params))
    x = rs.randn(S, T, D).astype(np.float32)
    (c0, r0), _ = _state_and_cots(rs)
    cots = (rs.randn(S, T, out_dim).astype(np.float32),
            rs.randn(S, C).astype(np.float32),
            rs.randn(S, P).astype(np.float32))
    return comp_j, params, comp, x, c0, r0, cots


def _module_jax(comp_j, params, x, mask, c0, r0, cots, bidir):
    def loss(p, x, c0, r0):
        st = {"c": c0, "r": r0}
        ys, st = comp_j.apply(p, x, {"fwd": st} if bidir else st,
                              train=True, mask=jnp.asarray(mask))
        st = st["fwd"] if bidir else st
        ys = ys.astype(jnp.float32)
        return (jnp.sum(ys * cots[0]) + jnp.sum(st["c"] * cots[1])
                + jnp.sum(st["r"] * cots[2])), ys
    (_, ys), grads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3),
                                        has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(c0), jnp.asarray(r0))
    gp, gx, gc, gr = grads
    flat = _component_params(jax.tree_util.tree_map(np.asarray, gp))
    return np.asarray(ys), {**{k: v.numpy() for k, v in flat.items()},
                            "x": np.asarray(gx), "init_c": np.asarray(gc),
                            "init_r": np.asarray(gr)}


def _module_port(comp, x, mask, c0, r0, cots, bidir):
    comp.train()
    xt = torch.tensor(x, requires_grad=True)
    ct = torch.tensor(c0, requires_grad=True)
    rt = torch.tensor(r0, requires_grad=True)
    st = {"c": ct, "r": rt}
    ys, st = comp(xt, {"fwd": st} if bidir else st, mask=torch.tensor(mask))
    st = st["fwd"] if bidir else st
    ys = ys.float()
    ((ys * torch.from_numpy(cots[0])).sum()
     + (st["c"] * torch.from_numpy(cots[1])).sum()
     + (st["r"] * torch.from_numpy(cots[2])).sum()).backward()
    grads = {n: p.grad.numpy() for n, p in comp.named_parameters()}
    return ys.detach().numpy(), {**grads, "x": xt.grad.numpy(),
                                 "init_c": ct.grad.numpy(),
                                 "init_r": rt.grad.numpy()}


@pytest.mark.parametrize("switch,D", [
    ("KALDI_ASLP_LSTM_NO_XFUSE", 40), ("KALDI_ASLP_LSTM_MXU_FP32", 128),
    ("KALDI_ASLP_LSTM_SPLIT_BWD", 40), ("KALDI_ASLP_LSTM_SPLIT_BWD", 128)],
    ids=["no-xfuse-40", "mxu-fp32-128", "split-bwd-40", "split-bwd-128"])
def test_blstmp_module_under_switch_matches_jax(switch, D, monkeypatch):
    """BLstmProjectedStreams(bf16=True) in train() against the JAX
    module's ``apply(train=True)`` with the pallas attr, the same switch
    set for both: values and every parameter gradient, the weights
    carried across by params_from_jax."""
    monkeypatch.setenv(switch, "1")
    comp_j, params, comp, x, c0, r0, cots = _module_case(
        JaxBLstm, rec.BLstmProjectedStreams, 2 * P, D, seed=D + 7)
    mask = _mask()
    ys_j, want = _module_jax(comp_j, params, x, mask, c0, r0, cots, True)
    ys, got = _module_port(comp, x, mask, c0, r0, cots, True)
    tol = F32_PRODUCTS_TOL if switch.endswith("MXU_FP32") \
        else BF16_PRODUCTS_TOL
    assert sorted(got) == sorted(want)
    for name, g, w in [("ys", ys, ys_j)] + [(n, got[n], want[n])
                                            for n in sorted(want)]:
        assert g.shape == w.shape, name
        assert np.abs(w).max() > 0, name
        assert _rel(g, w) <= tol, (name, _rel(g, w))


def test_bf16_lstmp_module_under_mxu_fp32_matches_jax(monkeypatch):
    """A bf16 LstmProjectedStreams under KALDI_ASLP_LSTM_MXU_FP32: bf16
    storage with float32 products on both sides (JAX:
    ``lstmp_train_core(store_bf16=True, mxu_bf16=False)``)."""
    monkeypatch.setenv("KALDI_ASLP_LSTM_MXU_FP32", "1")
    comp_j, params, comp, x, c0, r0, cots = _module_case(
        JaxLstm, rec.LstmProjectedStreams, P, 40, seed=17)
    mask = _mask()
    ys_j, want = _module_jax(comp_j, params, x, mask, c0, r0, cots, False)
    ys, got = _module_port(comp, x, mask, c0, r0, cots, False)
    assert sorted(got) == sorted(want)
    for name, g, w in [("ys", ys, ys_j)] + [(n, got[n], want[n])
                                            for n in sorted(want)]:
        assert np.abs(w).max() > 0, name
        assert _rel(g, w) <= F32_PRODUCTS_TOL, (name, _rel(g, w))
