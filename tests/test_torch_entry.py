"""The port's ``entry()`` (kaldi_aslp_tpu_torch/entry.py) on the CPU:
the flagship's shapes and arguments, and its forward against JAX's
``__graft_entry__.entry`` forward on JAX's parameters carried across
(models/interop.py), over the first frames of JAX's own inputs (T cut
to keep the CPU run short; the plain LSTMP version runs frame by
frame)."""

import numpy as np
import torch

from __graft_entry__ import entry as jax_entry
from kaldi_aslp_tpu_torch.entry import entry, forward
from kaldi_aslp_tpu_torch.models import BLstmProjectedStreams
from kaldi_aslp_tpu_torch.models.interop import params_from_jax

torch.set_num_threads(1)

T_CUT = 6


def test_entry_builds_the_flagship_with_jax_s_arguments():
    fwd, (net, feats, mask) = entry(device="cpu", T=T_CUT)
    assert fwd is forward
    layers = [c for c in net.nodes if isinstance(c, BLstmProjectedStreams)]
    assert len(layers) == 3 and net.output_dim == 72
    assert [(c.input_dim, c.output_dim) for c in layers] == [
        (40, 640), (640, 640), (640, 640)]
    assert feats.shape == (8, T_CUT, 40) and mask.shape == (8, T_CUT)
    assert feats.device.type == "cpu" and not net.training
    out = fwd(net, feats, mask)
    assert out.shape == (8, T_CUT, 72) and torch.isfinite(out).all()
    # log-probabilities
    np.testing.assert_allclose(out.exp().sum(-1).numpy(), 1.0, rtol=1e-5)
    # the seed draws the parameters
    _, (again, _, _) = entry(device="cpu", T=1)
    _, (other, _, _) = entry(device="cpu", seed=1, T=1)
    w = "nodes.0.fwd.w_gifo_x"
    assert torch.equal(net.state_dict()[w], again.state_dict()[w])
    assert not torch.equal(net.state_dict()[w], other.state_dict()[w])


def test_entry_forward_matches_jax_entry():
    jax_fwd, (params, feats, mask) = jax_entry()
    _, (net, port_feats, port_mask) = entry(device="cpu")
    # the same RandomState(0) inputs as JAX's, at S, T = 8, 200
    np.testing.assert_array_equal(port_feats.numpy(), np.asarray(feats))
    np.testing.assert_array_equal(port_mask.numpy(), np.asarray(mask))
    x = np.array(feats)[:, :T_CUT]
    net.load_state_dict(params_from_jax(params), strict=True)
    m = np.array(mask)[:, :T_CUT]
    want = np.asarray(jax_fwd(params, x, m))
    got = forward(net, torch.from_numpy(x), torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
