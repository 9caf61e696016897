"""The rest of the nnet zoo (kaldi_aslp_tpu_torch/models/) against the
JAX package (kaldi_aslp_tpu/models/): every frame-level, convolutional,
FSMN and normalization component's values and gradients (input and
every parameter, through a random cotangent) on the same parameters,
carried across by models/interop.py; proto parsing and the token
registry; ``Dropout`` in eval, refusing to train without a generator,
and with JAX's own Bernoulli mask put in place of the draws;
``BatchNormalization`` in training and eval, its state through both packages' ``save`` / ``load`` and
``merge_bn_stats``; DAG add and splice junctions, MIMO nets and the mask
rule of ``Nnet.forward``; ``info`` and ``to_dot`` text; the multitask
loss and the greedy CTC decode.

Tolerances, as max |port - JAX| / max |JAX| per tensor: 1e-5 for values,
1e-4 for gradients (the same float32 math, summed in another order)."""

import zipfile
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import kaldi_aslp_tpu.models as J
from kaldi_aslp_tpu.models.losses import (
    MultiTaskSpec as JaxMultiTaskSpec,
    multitask_loss as jax_multitask_loss,
)
from kaldi_aslp_tpu.ops.ctc import (
    collapse_ctc_path as jax_collapse,
    ctc_greedy_decode as jax_greedy,
)
import kaldi_aslp_tpu_torch.models as M
from kaldi_aslp_tpu_torch.models import simple as port_simple
from kaldi_aslp_tpu_torch.models.interop import (
    params_from_jax,
    params_to_jax,
    states_from_jax,
    states_to_jax,
)
from kaldi_aslp_tpu_torch.models.losses import MultiTaskSpec, multitask_loss
from kaldi_aslp_tpu_torch.ops.ctc import collapse_ctc_path, ctc_greedy_decode

torch.set_num_threads(1)

VALUE_TOL, GRAD_TOL = 1e-5, 1e-4
S, T = 3, 7


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


def port_component(jc, params):
    """The port's component of JAX component ``jc`` holding ``params``."""
    comp = M.component_from_token(jc.token)(jc.input_dim, jc.output_dim,
                                            **jc.attrs)
    comp.load_state_dict({k: torch.from_numpy(v.copy())
                          for k, v in _flat(params).items()}, strict=True)
    return comp


def port_net(jnet, params):
    """The port's ``Nnet`` of JAX net ``jnet`` with ``params``."""
    net = M.Nnet(num_inputs=jnet.num_inputs, output_ids=jnet._output_ids)
    for node in jnet.nodes:
        c = node.comp
        net.add(M.component_from_token(c.token)(c.input_dim, c.output_dim,
                                                **c.attrs),
                [tuple(e) for e in node.inputs])
    net.load_state_dict(params_from_jax(params), strict=True)
    return net


# (JAX class name, input dim, output dim, attrs); every input is
# [S, T, D], which frame-level components take as [..., D]
CASES = [
    ("AffineTransform", 6, 5, {"param_stddev": 0.3, "bias_mean": 0.1}),
    ("LinearTransform", 6, 5, {"param_stddev": 0.3}),
    ("Sigmoid", 6, 6, {}),
    ("Tanh", 6, 6, {}),
    ("ReLU", 6, 6, {}),
    ("Softmax", 6, 6, {}),
    ("BlockSoftmax", 6, 6, {"block_dims": "2:4"}),
    ("Dropout", 6, 6, {"dropout_retention": 0.7}),
    ("Pnorm", 6, 3, {"p": 2.0}),
    ("Pnorm", 6, 2, {"p": 3.0}),
    ("Maxout", 6, 3, {}),
    ("LengthNorm", 6, 6, {}),
    ("AddShift", 6, 6, {}),
    ("Rescale", 6, 6, {}),
    ("CopyComponent", 6, 8, {"build_vector": "0:3 5 5 1 0"}),
    ("Transmit", 6, 6, {}),
    ("Splice", 6, 18, {"build_vector": "-2 0 3"}),
    ("Splice", 6, 30, {"build_vector": "-2:2"}),
    ("ConvolutionalComponent", 12, 12,
     {"patch_dim": 3, "patch_step": 2, "patch_stride": 6,
      "param_stddev": 0.3}),
    ("MaxPoolingComponent", 12, 10,
     {"pool_size": 2, "pool_step": 1, "pool_stride": 2}),
    ("MaxPoolingComponent", 12, 6,
     {"pool_size": 2, "pool_step": 2, "pool_stride": 2}),
    ("CompactFsmn", 6, 6, {"l_order": 3, "r_order": 2, "l_stride": 2,
                           "r_stride": 1, "param_scale": 0.3}),
    ("CompactFsmn", 6, 6, {"lorder": 9, "rorder": 8}),
    ("RowConvolution", 6, 6, {"future_ctx": 3, "param_scale": 0.3}),
    ("RowConvolution", 6, 6, {"future_ctx": 9}),
    ("BatchNormalization", 6, 6, {"epsilon": 1e-3}),
]


def _case_id(case):
    return f"{case[0]}-{case[1]}x{case[2]}-" + "-".join(
        f"{k}{v}" for k, v in case[3].items()).replace(" ", "_")


def _ragged_mask(rs):
    lens = rs.randint(2, T + 1, size=S)
    lens[0] = T
    return (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)


MASKED = ("BatchNormalization", "CompactFsmn", "RowConvolution")
# the masked components also with a ragged mask
RUNS = [(c, False) for c in CASES] + [(c, True) for c in CASES
                                      if c[0] in MASKED]


@pytest.mark.parametrize("case,masked", RUNS, ids=[
    _case_id(c) + ("-mask" if m else "") for c, m in RUNS])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_component_matches_jax(case, masked, train):
    name, din, dout, attrs = case
    rs = np.random.RandomState(zlib.crc32(_case_id(case).encode()))
    jc = getattr(J, name)(din, dout, **attrs)
    params = jc.init_params(jax.random.PRNGKey(3))
    # non-trivial values where the init is constant (shift 0, scale 1,
    # gamma 1, beta 0, conv bias 0)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.3 * jnp.asarray(rs.randn(*p.shape), jnp.float32),
        params)
    x = (2.0 * rs.randn(S, T, din)).astype(np.float32)
    mask = _ragged_mask(rs) if masked else None
    cot = rs.randn(S, T, dout).astype(np.float32)
    takes_mask = name in MASKED
    state = None
    if name == "BatchNormalization":
        state = {"sum": jnp.asarray(rs.randn(din), jnp.float32),
                 "sumsq": jnp.asarray(10.0 + rs.rand(din), jnp.float32),
                 "count": jnp.asarray(5.0, jnp.float32)}

    # Dropout in training: JAX's Bernoulli mask in place of the draws
    key = jax.random.PRNGKey(5)
    drops = name == "Dropout" and train

    def jax_fn(p, xx):
        kw = {"mask": None if mask is None else jnp.asarray(mask)} \
            if takes_mask else {}
        if drops:
            kw["rng"] = key
        y, s = jc.apply(p, xx, state, train=train, **kw)
        return jnp.sum(y * cot), (y, s)

    (_, (y_j, s_j)), (g_p, g_x) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    comp = port_component(jc, params)
    comp.train(train)
    xt = torch.from_numpy(x).requires_grad_(True)
    kw = {"mask": None if mask is None else torch.from_numpy(mask)} \
        if takes_mask else {}
    st = None if state is None else states_from_jax(
        jax.tree_util.tree_map(np.asarray, state), torch.device("cpu"))
    if drops:
        keep = torch.from_numpy(np.array(jax.random.bernoulli(
            key, attrs["dropout_retention"], x.shape)))
        kw["generator"] = torch.Generator()
        orig = port_simple.dropout_keep
        port_simple.dropout_keep = lambda shape, ret, gen, dev: keep
        try:
            y, s = comp(xt, st, **kw)
        finally:
            port_simple.dropout_keep = orig
        assert 0 < float(keep.float().mean()) < 1
    else:
        y, s = comp(xt, st, **kw)
    (y * torch.from_numpy(cot)).sum().backward()
    assert y.shape == tuple(y_j.shape)
    assert _rel(y.detach(), y_j) <= VALUE_TOL, name
    assert _rel(xt.grad, g_x) <= GRAD_TOL
    got = {n: p.grad for n, p in comp.named_parameters()}
    for key, want in _flat(g_p).items():
        assert _rel(got[key], want) <= GRAD_TOL, key
    if s_j is not None:
        for key, want in _flat(s_j).items():
            assert _rel(states_to_jax(s)[key], want) <= VALUE_TOL, key


def test_block_softmax_takes_one_block_as_an_int():
    """A proto's ``<BlockDims> 5`` parses to the int 5: JAX's
    ``BlockSoftmax`` fails on it (``list(5)``), the port's takes one block
    (ROADMAP queue 3)."""
    line = "<BlockSoftmax> <InputDim> 5 <OutputDim> 5 <BlockDims> 5"
    with pytest.raises(TypeError):
        J.build_component(line)
    comp = M.build_component(line)
    assert comp.block_dims == [5]
    x = torch.randn(2, 5)
    assert torch.allclose(comp(x)[0], torch.softmax(x, dim=-1))


def test_known_tokens_equal_jax():
    assert M.known_tokens() == J.known_tokens()
    for tok in J.known_tokens():
        assert M.component_from_token(tok.lower()).token == tok


PROTO_LINES = [
    "<AffineTransform> <InputDim> 40 <OutputDim> 64 <ParamStddev> 0.05 "
    "<BiasMean> -1.5 <BiasRange> 0.5 <LearnRateCoef> 2 <MaxNorm> 1.5",
    "<LinearTransform> <InputDim> 64 <OutputDim> 16",
    "<Splice> <InputDim> 16 <OutputDim> 80 <BuildVector> -2:2",
    "<Copy> <InputDim> 6 <OutputDim> 4 <BuildVector> \"0 2 4 5\"",
    "<BlockSoftmax> <InputDim> 10 <OutputDim> 10 <BlockDims> 4:6",
    "<Dropout> <InputDim> 8 <OutputDim> 8 <DropoutRetention> 0.8",
    "<Pnorm> <InputDim> 8 <OutputDim> 4 <P> 2.5",
    "<LstmProjectedStreams> <InputDim> 8 <OutputDim> 4 <CellDim> 12 "
    "<CellClip> 5 <Bf16>",
    "<BLstmProjectedStreamsLC> <InputDim> 8 <OutputDim> 8 <CellDim> 6 "
    "<ChunkSize> 16",
    "<LstmCifgProjectedStreams> <InputDim> 8 <OutputDim> 4 <CellDim> 6",
    "<GruStreams> <InputDim> 8 <OutputDim> 5 <ParamScale> 0.2",
    "<ConvolutionalComponent> <InputDim> 24 <OutputDim> 20 <PatchDim> 3 "
    "<PatchStep> 2 <PatchStride> 12",
    "<MaxPoolingComponent> <InputDim> 20 <OutputDim> 8 <PoolSize> 2 "
    "<PoolStep> 2 <PoolStride> 4",
    "<CompactFsmn> <InputDim> 8 <OutputDim> 8 <LOrder> 3 <ROrder> 2",
    "<RowConvolution> <InputDim> 8 <OutputDim> 8 <FutureCtx> 3",
    "<BatchNormalization> <InputDim> 8 <OutputDim> 8 <Epsilon> 1e-3",
    "<sigmoid> <InputDim> 8 <OutputDim> 8",
]


@pytest.mark.parametrize("line", PROTO_LINES,
                         ids=[ln.split()[0].strip("<>") for ln in
                              PROTO_LINES])
def test_proto_line_matches_jax(line):
    cls, attrs = M.parse_proto_line(line)
    jcls, jattrs = J.parse_proto_line(line)
    assert cls.token == jcls.token and attrs == jattrs
    comp, jcomp = M.build_component(line), J.build_component(line)
    assert (comp.input_dim, comp.output_dim, comp.attrs) == (
        jcomp.input_dim, jcomp.output_dim, jcomp.attrs)
    # the port's parameters have the JAX init's names and shapes
    jp = _flat(jcomp.init_params(jax.random.PRNGKey(0)))
    assert {k: tuple(v.shape) for k, v in comp.state_dict().items()} == {
        k: v.shape for k, v in jp.items()}


@pytest.mark.parametrize("name", ["InputDim", "LearnRateCoef", "LOrder",
                                  "Bf16", "BuildVector", "PNorm"])
def test_key_case_helpers_match_jax(name):
    from kaldi_aslp_tpu.models import component as jc
    from kaldi_aslp_tpu_torch.models import component as pc

    assert pc._snake(name) == jc._snake(name)
    assert pc._camel(pc._snake(name)) == jc._camel(jc._snake(name))
    for value in ("3", "-2.5", "1e-3", "true", "False", "-1:1", "a b"):
        got, want = pc._auto(value), jc._auto(value)
        assert got == want and type(got) is type(want)


def test_every_token_round_trips_a_zip(tmp_path):
    """A net of every registered token, built by JAX from proto lines,
    saved and loaded in both packages: the same topology and arrays."""
    lines = {}
    for line in PROTO_LINES:
        lines[J.parse_proto_line(line)[0].token] = line
    extra = {"<Softmax>", "<ReLU>", "<Tanh>", "<Maxout>",
             "<LengthNormComponent>", "<AddShift>", "<Rescale>",
             "<Transmit>", "<Lstm>", "<BLstm>", "<BLstmProjectedStreams>"}
    for tok in extra:
        lines[tok] = f"{tok} <InputDim> 8 <OutputDim> " + (
            "4" if tok == "<Maxout>" else "8")
    assert set(lines) == set(J.known_tokens())
    for tok, line in sorted(lines.items()):
        jnet = J.Nnet.from_proto(line)
        params = jnet.init(jax.random.PRNGKey(1))
        path = str(tmp_path / "j.zip")
        jnet.save(path, params, jnet.init_state(2))
        net, states = M.Nnet.load(path, "cpu")
        assert [c.token for c in net.nodes] == [tok]
        out = str(tmp_path / "p.zip")
        net.save(out, states)
        jnet2, params2, states2 = J.Nnet.load(out)
        for key, want in _flat(params).items():
            assert np.array_equal(_flat(params2)[key], want), (tok, key)
        assert sorted(_flat(states2)) == sorted(_flat(jnet.init_state(2)))
        with zipfile.ZipFile(path) as a, zipfile.ZipFile(out) as b:
            assert a.read("topology.json") == b.read("topology.json")


def test_from_proto_matches_jax():
    proto = "<NnetProto>\n" + "\n".join([
        "<Splice> <InputDim> 5 <OutputDim> 15 <BuildVector> -1:1",
        "<AffineTransform> <InputDim> 15 <OutputDim> 8",
        "<BatchNormalization> <InputDim> 8 <OutputDim> 8",
        "<ReLU> <InputDim> 8 <OutputDim> 8",
        "<AffineTransform> <InputDim> 8 <OutputDim> 4",
        "<Softmax> <InputDim> 4 <OutputDim> 4"]) + "\n</NnetProto>\n"
    net, jnet = M.Nnet.from_proto(proto), J.Nnet.from_proto(proto)
    assert net.num_components() == jnet.num_components() == 6
    assert (net.input_dim, net.output_dim) == (jnet.input_dim,
                                               jnet.output_dim)
    assert net.info() == jnet.info()
    net.reset_parameters(torch.Generator().manual_seed(0))
    params = jnet.init(jax.random.PRNGKey(0))
    assert net.num_params() == jnet.num_params(params)
    assert net.info(with_params=True) == jnet.info(params)
    assert net.to_dot() == jnet.to_dot()


def _dag_net():
    """2 inputs (5 and 4 wide) spliced into a hidden layer, an add
    junction of two branches (a cFSMN over a projection, and a GRU), a
    masked BN, and 2 heads."""
    jnet = J.Nnet(num_inputs=2)
    h = jnet.add(J.AffineTransform(9, 8), inputs=[("in:0", 0), ("in:1", 5)])
    p = jnet.add(J.LinearTransform(8, 6), inputs=[(h, 0)])
    f = jnet.add(J.CompactFsmn(6, 6, l_order=2, r_order=1), inputs=[(p, 0)])
    g = jnet.add(J.GruStreams(8, 6), inputs=[(h, 0)])
    b = jnet.add(J.BatchNormalization(6, 6), inputs=[(f, 0), (g, 0)])
    r = jnet.add(J.RowConvolution(6, 6, future_ctx=2), inputs=[(b, 0)])
    jnet.add(J.AffineTransform(6, 3), inputs=[(r, 0)])
    jnet.add(J.AffineTransform(14, 2), inputs=[(b, 0), (h, 6)])
    return jnet


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dag_mimo_net_matches_jax(train):
    rs = np.random.RandomState(5)
    jnet = _dag_net()
    params = jnet.init(jax.random.PRNGKey(2))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.2 * jnp.asarray(rs.randn(*p.shape), jnp.float32),
        params)
    xs = [rs.randn(S, T, 5).astype(np.float32),
          rs.randn(S, T, 4).astype(np.float32)]
    mask = _ragged_mask(rs)
    cots = [rs.randn(S, T, 3).astype(np.float32),
            rs.randn(S, T, 2).astype(np.float32)]
    states = jnet.init_state(S)
    states["4"] = {
        "sum": jnp.asarray(rs.randn(6), jnp.float32),
        "sumsq": jnp.asarray(8 + rs.rand(6), jnp.float32),
        "count": jnp.asarray(4.0)}
    states["3"] = {"h": jnp.asarray(rs.randn(S, 6), jnp.float32)}

    def jax_fn(p, x0, x1):
        ys, new = jnet.apply(p, [x0, x1], states, train=train,
                             mask=jnp.asarray(mask))
        return sum(jnp.sum(y * c) for y, c in zip(ys, cots)), (ys, new)

    (_, (ys_j, new_j)), grads = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2), has_aux=True)(
            params, *map(jnp.asarray, xs))
    net = port_net(jnet, params)
    net.train(train)
    xt = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    st = states_from_jax(jax.tree_util.tree_map(np.asarray, states),
                         torch.device("cpu"))
    ys, new = net(xt, st, mask=torch.from_numpy(mask))
    assert isinstance(ys, list) and len(ys) == 2
    sum((y * torch.from_numpy(c)).sum() for y, c in zip(ys, cots)).backward()
    for y, yj in zip(ys, ys_j):
        assert _rel(y.detach(), yj) <= VALUE_TOL
    for x, g in zip(xt, grads[1:]):
        assert _rel(x.grad, g) <= GRAD_TOL
    got = {n: p.grad for n, p in net.named_parameters()}
    for key, want in _flat(grads[0]).items():
        assert _rel(got["nodes." + key], want) <= GRAD_TOL, key
    for key, want in _flat(new_j).items():
        assert _rel(_flat(states_to_jax(new))[key], want) <= VALUE_TOL, key
    assert net.info(with_params=True) == jnet.info(params)
    assert net.to_dot() == jnet.to_dot()
    assert net.output_ids() == jnet.output_ids()


def test_mask_rule_reaches_fsmn_bn_rowconv():
    """Padded frames change a masked component's output only through the
    mask: with the mask, garbage in the padding moves no valid frame."""
    rs = np.random.RandomState(6)
    jnet = J.Nnet()
    jnet.add(J.CompactFsmn(4, 4, l_order=2, r_order=2))
    jnet.add(J.RowConvolution(4, 4, future_ctx=2))
    jnet.add(J.BatchNormalization(4, 4))
    params = jnet.init(jax.random.PRNGKey(0))
    net = port_net(jnet, params).train()
    x = rs.randn(2, 6, 4).astype(np.float32)
    mask = np.ones((2, 6), np.float32)
    mask[1, 3:] = 0
    noisy = x.copy()
    noisy[1, 3:] += 100.0
    m = torch.from_numpy(mask)
    a, _ = net(torch.from_numpy(x), mask=m)
    b, _ = net(torch.from_numpy(noisy), mask=m)
    assert torch.equal(a[mask > 0], b[mask > 0])
    want, _ = jnet.apply(params, jnp.asarray(noisy), train=True,
                         mask=jnp.asarray(mask))
    assert _rel(b.detach(), want) <= VALUE_TOL


def test_dropout_without_generator_is_identity_and_with_jax_mask():
    rs = np.random.RandomState(7)
    jc = J.Dropout(6, 6, dropout_retention=0.6)
    comp = port_component(jc, {})
    x = rs.randn(S, T, 6).astype(np.float32)
    xt = torch.from_numpy(x)
    key = jax.random.PRNGKey(11)
    # eval, with or without a generator: the identity, as JAX's
    comp.eval()
    assert torch.equal(comp(xt)[0], xt)
    assert torch.equal(comp(xt, generator=torch.Generator())[0], xt)
    assert np.array_equal(np.asarray(jc.apply({}, jnp.asarray(x),
                                              train=False, rng=key)[0]), x)
    # training with no generator: JAX's is the identity without rng,
    # which trains another model in silence; the port's refuses
    # (ROADMAP queue 3)
    comp.train()
    assert np.array_equal(np.asarray(jc.apply({}, jnp.asarray(x),
                                              train=True)[0]), x)
    with pytest.raises(ValueError, match="generator"):
        comp(xt)
    want = np.asarray(jc.apply({}, jnp.asarray(x), train=True, rng=key)[0])
    keep = np.array(jax.random.bernoulli(key, 0.6, x.shape))
    orig = port_simple.dropout_keep
    port_simple.dropout_keep = lambda shape, ret, gen, dev: (
        torch.from_numpy(keep))
    try:
        got, _ = comp(xt, generator=torch.Generator())
    finally:
        port_simple.dropout_keep = orig
    assert _rel(got, want) <= VALUE_TOL
    # the port's own draws: a mask of about the retention, scaled
    got, _ = comp(xt, generator=torch.Generator().manual_seed(0))
    kept = (got != 0)
    assert 0.4 < float(kept.float().mean()) < 0.8
    assert torch.allclose(got[kept], xt[kept] / 0.6)


def test_dropout_draws_come_from_the_net_generator():
    jnet = J.Nnet.from_proto(
        "<Dropout> <InputDim> 5 <OutputDim> 5 <DropoutRetention> 0.5\n"
        "<Dropout> <InputDim> 5 <OutputDim> 5 <DropoutRetention> 0.5")
    net = port_net(jnet, jnet.init(jax.random.PRNGKey(0))).train()
    x = torch.ones(4, 5)
    a, _ = net(x, generator=torch.Generator().manual_seed(3))
    b, _ = net(x, generator=torch.Generator().manual_seed(3))
    c, _ = net(x, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        net(x)
    assert torch.equal(net.eval()(x)[0], x)


def test_batchnorm_state_round_trips_and_merges(tmp_path):
    rs = np.random.RandomState(8)
    jnet = J.Nnet()
    jnet.add(J.AffineTransform(4, 5))
    jnet.add(J.BatchNormalization(5, 5))
    params = jnet.init(jax.random.PRNGKey(0))
    x = rs.randn(2, 6, 4).astype(np.float32)
    mask = np.ones((2, 6), np.float32)
    mask[0, 4:] = 0
    _, s_j = jnet.apply(params, jnp.asarray(x), jnet.init_state(2),
                        train=True, mask=jnp.asarray(mask))
    net = port_net(jnet, params).train()
    _, s = net(torch.from_numpy(x), net.init_state(2),
               mask=torch.from_numpy(mask))
    assert float(s["1"]["count"]) == float(s_j["1"]["count"]) == 10.0
    for k in ("sum", "sumsq"):
        assert _rel(s["1"][k], s_j["1"][k]) <= VALUE_TOL
    # JAX writes, the port reads and writes, JAX reads
    path, back = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    jnet.save(path, params, s_j)
    net2, s2 = M.Nnet.load(path, "cpu")
    assert set(s2) == {"1"} and s2["1"]["count"].dim() == 0
    net2.save(back, s2)
    _, _, s3 = J.Nnet.load(back)
    for k in ("sum", "sumsq", "count"):
        assert np.array_equal(np.asarray(s3["1"][k]),
                              np.asarray(s_j["1"][k]))
    # eval normalizes by the loaded statistics, in both packages
    net2.eval()
    y, s_eval = net2(torch.from_numpy(x), s2)
    y_j, _ = jnet.apply(params, jnp.asarray(x), s_j, train=False)
    assert _rel(y.detach(), y_j) <= VALUE_TOL
    assert s_eval["1"] is s2["1"]
    merged = M.merge_bn_stats([s2, s2, s_eval])
    merged_j = J.merge_bn_stats([s_j, s_j, s_j])
    for k in ("sum", "sumsq", "count"):
        assert _rel(merged["1"][k], merged_j["1"][k]) <= VALUE_TOL


def test_batchnorm_refuses_axis_name_in_training():
    """Training refuses an axis_name that no mesh registered (distributed
    training registers one: parallel/mesh.py:make_mesh); the error names
    the attr.  Eval ignores the attr."""
    comp = M.BatchNormalization(3, 3, axis_name="unregistered_axis")
    x = torch.randn(2, 4, 3)
    comp.eval()
    comp(x)   # eval uses the accumulated statistics only
    comp.train()
    with pytest.raises(ValueError, match="axis_name='unregistered_axis'"):
        comp(x)


def test_interop_carries_lc_and_bn_trees():
    jnet = J.Nnet()
    jnet.add(J.BLstmProjectedStreamsLC(4, 6, cell_dim=5, chunk_size=3))
    jnet.add(J.BatchNormalization(6, 6))
    params = jnet.init(jax.random.PRNGKey(4))
    net = port_net(jnet, params)
    tree = params_to_jax(net.state_dict())
    assert sorted(_flat(tree)) == sorted(_flat(params))
    assert sorted(tree["0"]) == ["bwd", "fwd"]
    states = jnet.init_state(3)
    st = states_from_jax(jax.tree_util.tree_map(np.asarray, states), "cpu")
    assert sorted(_flat(states_to_jax(st))) == sorted(_flat(states))
    assert sorted(_flat(states_to_jax(net.init_state(3)))) == sorted(
        _flat(states))


def test_multitask_loss_labels_match_jax():
    """Two xent tasks: integer targets [N, K], task k reading column k."""
    rs = np.random.RandomState(9)
    text = "multitask,xent,4,1.0,xent,5,0.5"
    spec, jspec = MultiTaskSpec.parse(text), JaxMultiTaskSpec.parse(text)
    assert (spec.kinds, spec.dims, spec.scales) == (
        jspec.kinds, jspec.dims, jspec.scales) == (
        ["xent", "xent"], [4, 5], [1.0, 0.5])
    logits = rs.randn(6, 9).astype(np.float32)
    tgt = np.stack([rs.randint(0, 4, 6), rs.randint(0, 5, 6)], 1).astype(
        np.int32)
    w = rs.rand(6).astype(np.float32)
    (loss_j, aux_j), g_j = jax.value_and_grad(
        lambda lg: jax_multitask_loss(jspec, lg, jnp.asarray(tgt),
                                      jnp.asarray(w)),
        has_aux=True)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss, aux = multitask_loss(spec, lt, torch.from_numpy(tgt).long(),
                               torch.from_numpy(w))
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(loss_j)) <= VALUE_TOL * abs(float(loss_j))
    assert sorted(aux) == sorted(aux_j) == [
        "task0_acc", "task0_loss", "task1_acc", "task1_loss"]
    for k in aux:
        assert abs(float(aux[k]) - float(aux_j[k])) <= 1e-5
    assert _rel(lt.grad, g_j) <= GRAD_TOL


def test_multitask_loss_mse_block_matches_jax():
    rs = np.random.RandomState(10)
    spec = MultiTaskSpec.parse("multitask,mse,3,0.5,mse,2,2.0")
    jspec = JaxMultiTaskSpec.parse("multitask,mse,3,0.5,mse,2,2.0")
    logits = rs.randn(2, 4, 5).astype(np.float32)
    tgt = rs.randn(2, 4, 5).astype(np.float32)
    (loss_j, _), g_j = jax.value_and_grad(
        lambda lg: jax_multitask_loss(jspec, lg, jnp.asarray(tgt)),
        has_aux=True)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss, _ = multitask_loss(spec, lt, torch.from_numpy(tgt))
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(loss_j)) <= VALUE_TOL * abs(float(loss_j))
    assert _rel(lt.grad, g_j) <= GRAD_TOL
    with pytest.raises(ValueError):
        MultiTaskSpec.parse("xent,3,1.0")
    with pytest.raises(ValueError):
        multitask_loss(MultiTaskSpec.parse("multitask,ctc,5,1.0"), lt,
                       torch.from_numpy(tgt))


def test_ctc_greedy_decode_matches_jax():
    rs = np.random.RandomState(12)
    logits = rs.randn(4, 15, 6).astype(np.float32)
    logits[:, ::3, 0] += 3.0        # blanks between repeats
    logits[1, 4:7, 2] += 9.0        # a repeat run
    lens = np.array([15, 9, 1, 0])
    frames = ctc_greedy_decode(torch.from_numpy(logits),
                               torch.from_numpy(lens))
    want = np.asarray(jax_greedy(jnp.asarray(logits), jnp.asarray(lens)))
    assert np.array_equal(frames.numpy(), want)
    for blank in (0, 2):
        for s in range(4):
            assert collapse_ctc_path(frames[s], lens[s], blank) == \
                jax_collapse(want[s], lens[s], blank)
    assert collapse_ctc_path([1, 1, 0, 1, 2, 2, 0, 0, 3], 9) == [1, 1, 2, 3]
