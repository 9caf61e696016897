"""JAX's initial parameters for the convergence dryrun, shipped as data
with the port (kaldi_aslp_tpu_torch/parallel/jax_initial_params.npz).

On the card the dryrun cannot call JAX, so the port carries the JAX
package's ``Nnet.init(PRNGKey(s))`` draws: the ``hard_blstm`` net
(``BLstm(39, 32)`` then ``AffineTransform(32, V)``, V the seed's pdf
count) at seeds 0, 1 and 2, and the ``affine`` net (10-16-5) at seed 0,
as JAX's ``run_convergence_comparison`` builds them
(kaldi_aslp_tpu/parallel/convergence.py:491-524).  The file was written
by this module on a host with JAX:

    JAX_PLATFORMS=cpu python tests/test_torch_convergence_init.py

which takes each seed's V from the port's ``make_hard_frame_task(seed,
device="cpu")`` (JAX's task gives the same targets) and stores every
array under ``<task>/seed<s>/<node>/<key>``.  The test regenerates each
draw from JAX at the stored shapes and holds the file to it bit for bit,
then checks that the port's loader gives the nested dict JAX's layout
has, that the net takes it, and that a missing file or seed raises."""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.abspath(os.path.dirname(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from kaldi_aslp_tpu_torch.parallel import convergence  # noqa: E402

HARD_SEEDS = (0, 1, 2)


def jax_draw(task, seed, D=39, V=None):
    """JAX's ``net.init(PRNGKey(seed))`` for ``task``'s net, as numpy."""
    import jax

    from kaldi_aslp_tpu.models.nnet import Nnet
    from kaldi_aslp_tpu.models.recurrent import BLstm
    from kaldi_aslp_tpu.models.simple import AffineTransform, Sigmoid

    net = Nnet()
    if task == "hard_blstm":
        net.add(BLstm(D, 2 * 16))
        net.add(AffineTransform(2 * 16, V))
    else:
        net.add(AffineTransform(10, 16))
        net.add(Sigmoid(16, 16))
        net.add(AffineTransform(16, 5))
    return jax.tree_util.tree_map(np.asarray,
                                  net.init(jax.random.PRNGKey(seed)))


def flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def write_init_file(path=convergence.INIT_FILE):
    arrays = {}
    for seed in HARD_SEEDS:
        train_x, _, _, _, V = convergence.make_hard_frame_task(
            seed=seed, device="cpu")
        arrays.update(flat(jax_draw("hard_blstm", seed, train_x.shape[-1],
                                    V), f"hard_blstm/seed{seed}/"))
    arrays.update(flat(jax_draw("affine", 0), "affine/seed0/"))
    np.savez_compressed(path, **arrays)


@pytest.mark.parametrize("task,seed", [("hard_blstm", s) for s in HARD_SEEDS]
                         + [("affine", 0)])
def test_shipped_draw_is_jax_init_bit_for_bit(task, seed):
    shipped = convergence.jax_initial_params(task, seed)
    kw = {}
    if task == "hard_blstm":
        D = shipped["0"]["fwd"]["w_gifo_x"].shape[1]
        kw = dict(D=D, V=shipped["1"]["w"].shape[0])
    got, want = flat(shipped, ""), flat(jax_draw(task, seed, **kw), "")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_hard_blstm_pdf_counts_and_net_take_the_draw():
    """Seeds 0-2 give 112, 115 and 118 pdfs (the tasks' ``num_pdfs``),
    and the port's net loads each draw through ``params_from_jax``."""
    assert [convergence.jax_initial_params("hard_blstm", s)["1"]["w"]
            .shape for s in HARD_SEEDS] == [(112, 32), (115, 32), (118, 32)]
    train_x = np.zeros((2, 4, 39), np.float32)
    task = (train_x, np.zeros((2, 4), np.int64), train_x,
            np.zeros((2, 4), np.int64), 112)
    spec = dict(seed=0, per_device_batch=1, n_workers=1, task="hard_blstm",
                n_rounds=1, task_data=task,
                init_params=convergence.jax_initial_params())
    net, _, _ = convergence._task_rounds(spec)
    w = dict(net.named_parameters())["nodes.0.bwd.w_gifo_r"]
    np.testing.assert_array_equal(
        w.detach().numpy(),
        spec["init_params"]["0"]["bwd"]["w_gifo_r"])


def test_resolve_init_choices():
    assert convergence.resolve_init("torch", "hard_blstm", 0) == "torch"
    given = {"0": {"w": np.zeros(1, np.float32)}}
    assert convergence.resolve_init(given, "hard_blstm", 0) is given
    assert set(convergence.resolve_init("jax", "hard_blstm", 0)) == {"0",
                                                                     "1"}
    with pytest.raises(ValueError, match="init_params"):
        convergence.resolve_init("numpy", "hard_blstm", 0)


def test_missing_file_or_seed_raises(monkeypatch, tmp_path):
    """No quiet fallback to the torch draw: a seed the file lacks, or no
    file, raises before any rank starts."""
    with pytest.raises(KeyError, match="seed 7"):
        convergence.blstm_band(2, device="cpu", seed=7,
                               task_data=object())
    monkeypatch.setattr(convergence, "INIT_FILE",
                        str(tmp_path / "absent.npz"))
    with pytest.raises(FileNotFoundError, match="absent.npz"):
        convergence.blstm_band(2, device="cpu", task_data=object())
    with pytest.raises(FileNotFoundError):
        convergence.run_convergence_comparison(2, n_rounds=1, device="cpu",
                                               init_params="jax")


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(4)
    write_init_file()
    print(convergence.INIT_FILE)
