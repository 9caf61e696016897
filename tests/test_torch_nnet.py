"""The port's Nnet (kaldi_aslp_tpu_torch/models/) against the JAX
package's: the zip model format in both directions, parameter interop,
and ``nnet_forward`` on a small flagship-shaped BLSTM-CTC net, with the
JAX side on its Pallas inference kernel (interpret mode) and on its scan
path.  Tolerance atol=1e-4 on log-posteriors: float32 through two
bidirectional layers and a log-softmax."""

import io
import json
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kaldi_aslp_tpu.decoder.decodable import (
    NnetForwardOptions as JaxNnetForwardOptions,
    PdfPrior as JaxPdfPrior,
    nnet_forward as jax_nnet_forward,
)
from kaldi_aslp_tpu.models import Nnet as JaxNnet
from kaldi_aslp_tpu.models.recurrent import (
    BLstmProjectedStreams as JaxBLstm,
)
from kaldi_aslp_tpu.models.simple import AffineTransform as JaxAffine
from kaldi_aslp_tpu_torch.decoder.decodable import (
    NnetForwardOptions,
    PdfPrior,
    nnet_forward,
)
from kaldi_aslp_tpu_torch.models import AffineTransform, Nnet
from kaldi_aslp_tpu_torch.models.flagship import build_blstm_ctc
from kaldi_aslp_tpu_torch.models.interop import (
    params_from_jax,
    params_to_jax,
)

torch.set_num_threads(1)

D, C, P, V = 40, 24, 16, 12


def _jax_flagship(**attrs):
    """2 BLSTMP layers (C=24, P=16) + affine to 12 targets, as the JAX
    flagship builder lays them out."""
    net = JaxNnet()
    dim = D
    for _ in range(2):
        net.add(JaxBLstm(dim, 2 * P, cell_dim=C, **attrs))
        dim = 2 * P
    net.add(JaxAffine(dim, V, param_stddev=0.04, bias_mean=0.0,
                      bias_range=0.0))
    return net, net.init(jax.random.PRNGKey(0))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _zip_contents(path):
    with zipfile.ZipFile(path) as z:
        topo = json.loads(z.read("topology.json"))
        npz = np.load(io.BytesIO(z.read("arrays.npz")))
        return topo, {k: npz[k] for k in npz.files}


def test_jax_saved_model_loads_in_port_and_back(tmp_path):
    net, params = _jax_flagship(pallas=True, bf16=True, param_scale=0.08)
    net.save(str(tmp_path / "jax.zip"), params)
    port, states = Nnet.load(str(tmp_path / "jax.zip"), "cpu")
    assert states == {}
    port.save(str(tmp_path / "port.zip"))
    topo_a, arrays_a = _zip_contents(tmp_path / "jax.zip")
    topo_b, arrays_b = _zip_contents(tmp_path / "port.zip")
    assert topo_a == topo_b
    assert sorted(arrays_a) == sorted(arrays_b)
    for k in arrays_a:
        np.testing.assert_array_equal(arrays_a[k], arrays_b[k], err_msg=k)
    _, params_back, _ = JaxNnet.load(str(tmp_path / "port.zip"))
    assert _flat(params_back).keys() == _flat(params).keys()
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(params_back)[k], v)


def test_port_saved_model_loads_in_jax(tmp_path):
    port = build_blstm_ctc(input_dim=D, num_layers=2, proj_dim=P,
                           cell_dim=C, num_targets=V)
    port.reset_parameters(torch.Generator().manual_seed(5))
    port.save(str(tmp_path / "port.zip"))
    net, params, states = JaxNnet.load(str(tmp_path / "port.zip"))
    assert states == {}
    assert [n.comp.token for n in net.nodes] == [
        "<BLstmProjectedStreams>"] * 2 + ["<AffineTransform>"]
    assert net.nodes[0].comp.fwd.cell_dim == C
    want = {k: v.numpy() for k, v in port.state_dict().items()}
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_params_from_jax_round_trips():
    net, params = _jax_flagship()
    tree = jax.tree_util.tree_map(np.asarray, params)
    sd = params_from_jax(tree)
    port = build_blstm_ctc(input_dim=D, num_layers=2, proj_dim=P,
                           cell_dim=C, num_targets=V)
    assert sorted(sd) == sorted(port.state_dict())
    assert "nodes.0.fwd.w_gifo_x" in sd
    np.testing.assert_array_equal(sd["nodes.0.fwd.w_gifo_x"].numpy(),
                                  tree["0"]["fwd"]["w_gifo_x"])
    back = params_to_jax(sd)
    assert _flat(back).keys() == _flat(tree).keys()
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(_flat(back)[k], v)


def test_loader_keeps_unused_attrs(tmp_path):
    net, params = _jax_flagship(pallas=True, bf16=True, param_scale=0.08)
    net.save(str(tmp_path / "m.zip"), params)
    port, _ = Nnet.load(str(tmp_path / "m.zip"), "cpu")
    assert port.nodes[0].attrs == {"cell_dim": C, "pallas": True,
                                   "bf16": True, "param_scale": 0.08}
    assert port.nodes[2].attrs == {"param_stddev": 0.04, "bias_mean": 0.0,
                                   "bias_range": 0.0}


def test_unknown_token_is_an_error(tmp_path):
    from kaldi_aslp_tpu.models.simple import Tanh
    net = JaxNnet()
    net.add(JaxAffine(4, 4))
    net.add(Tanh(4, 4))
    net.save(str(tmp_path / "tanh.zip"), net.init(jax.random.PRNGKey(0)))
    # every JAX token is ported, so the file names one neither package
    # registers in place of the Tanh
    with zipfile.ZipFile(tmp_path / "tanh.zip") as z:
        topo = json.loads(z.read("topology.json"))
        arrays = z.read("arrays.npz")
    topo["nodes"][1]["token"] = "<NoSuchComponent>"
    with zipfile.ZipFile(tmp_path / "m.zip", "w") as z:
        z.writestr("topology.json", json.dumps(topo))
        z.writestr("arrays.npz", arrays)
    with pytest.raises(ValueError, match="<NoSuchComponent>"):
        Nnet.load(str(tmp_path / "m.zip"), "cpu")
    assert type(Nnet.load(str(tmp_path / "tanh.zip"), "cpu")[0].nodes[1]
                ).__name__ == "Tanh"


@pytest.mark.parametrize("pallas", [True, False])
def test_nnet_forward_matches_jax(tmp_path, pallas):
    """JAX with pallas=True runs _lstmp_kernel in interpret mode; with
    pallas=False its scan.  The bf16 attr is carried: the TPU's inference
    kernel computes in float32 whatever it says, and so does the port."""
    net, params = _jax_flagship(pallas=pallas, bf16=pallas)
    net.save(str(tmp_path / "m.zip"), params)
    port, _ = Nnet.load(str(tmp_path / "m.zip"), "cpu")
    rs = np.random.RandomState(1)
    feats = rs.randn(23, D).astype(np.float32)
    counts = rs.randint(0, 50, size=V).astype(np.float64)
    counts[3] = 0
    want = jax_nnet_forward(net, params, feats,
                            JaxNnetForwardOptions(acoustic_scale=1.0),
                            prior=JaxPdfPrior(counts))
    got = nnet_forward(port, feats, NnetForwardOptions(),
                       prior=PdfPrior(counts))
    assert got.shape == (23, V) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("opts", [
    dict(skip_width=3), dict(time_shift=2), dict(blank_scale=0.5),
    dict(no_softmax=True, apply_log=False)])
def test_nnet_forward_options_match_jax(tmp_path, opts):
    net, params = _jax_flagship(pallas=False)
    net.save(str(tmp_path / "m.zip"), params)
    port, _ = Nnet.load(str(tmp_path / "m.zip"), "cpu")
    feats = np.random.RandomState(2).randn(10, D).astype(np.float32)
    want = jax_nnet_forward(net, params, feats, JaxNnetForwardOptions(**opts))
    got = nnet_forward(port, feats, NnetForwardOptions(**opts))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_dag_junctions_match_jax(tmp_path):
    """Splice (disjoint offsets) and add (same offset) junctions and two
    outputs, as the reference's multi-io Propagate sums them."""
    net = JaxNnet()
    net.add(JaxAffine(6, 4))
    net.add(JaxAffine(6, 4), [("in:0", 0)])
    net.add(JaxAffine(8, 3), [(0, 0), (1, 4)])
    net.add(JaxAffine(4, 2), [(0, 0), (1, 0)])
    params = net.init(jax.random.PRNGKey(3))
    net.save(str(tmp_path / "m.zip"), params)
    port, _ = Nnet.load(str(tmp_path / "m.zip"), "cpu")
    assert port.output_ids() == [2, 3] and port.output_dim == 5
    x = np.random.RandomState(4).randn(2, 5, 6).astype(np.float32)
    want, _ = net.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got, _ = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_affine_init_uses_the_generator():
    a, b = AffineTransform(5, 3), AffineTransform(5, 3)
    a.reset_parameters(torch.Generator().manual_seed(9))
    b.reset_parameters(torch.Generator().manual_seed(9))
    assert torch.equal(a.w, b.w) and torch.equal(a.b, b.b)
    assert float(a.w.detach().abs().sum()) > 0
