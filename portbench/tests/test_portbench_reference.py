"""The plain references against the port on the CPU at tiny sizes: the
eval scores, the CTC and cross-entropy losses, and the first training
steps (float32 layers, where both compute the same products; bf16
layers within bf16's rounding)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kaldi_aslp_tpu_torch.decoder import decodable
from kaldi_aslp_tpu_torch.models.losses import ctc_batch_loss
from portbench.harness import compare, model, traffic, weights
from portbench.reference import blstm_ctc, common
from portbench.tests import tiny

CPU = torch.device("cpu")


def _setup(name, seed=11, **cfg_changes):
    found = tiny.found(name)
    cfg = dict(found["config"], **cfg_changes)
    driver = found["driver"].Driver(cfg, found["cell"], seed, CPU)
    return driver


def test_eval_scores_match_the_port():
    driver = _setup("blstm_ctc.posteriors")
    driver.setup()
    item = driver.items[0]
    port = decodable.nnet_forward_batched(driver.net, item["feats"],
                                          item["mask"], prior=driver.prior)
    ref = driver.reference_scores(item).numpy()
    valid = item["mask"] > 0
    assert np.abs(port - ref)[valid].max() < 1e-5


def test_ctc_loss_matches_the_port():
    cell = tiny.found("blstm_ctc.train")["cell"]
    item = traffic.generate(cell["traffic_params"], 3, 6, 12)[0]
    logits = torch.randn(4, item["feats"].shape[1], 12,
                         generator=torch.Generator().manual_seed(0))
    args = [torch.from_numpy(item[k]) for k in
            ("labels", "input_lengths", "label_lengths")]
    port, _ = ctc_batch_loss(logits, *args)
    ref = blstm_ctc.ctc_loss(logits, *args, blank=0)
    assert float(port) == pytest.approx(float(ref), rel=1e-5)


@pytest.mark.parametrize("name,dtype,tol", [
    ("blstm_ctc.train", "float32", 1e-4),
    ("blstm_ctc.train_long", "float32", 1e-4),
    ("blstm_ctc.train", "bfloat16", 2e-2)])
def test_training_steps_match_the_port(name, dtype, tol):
    driver = _setup(name, dtype=dtype)
    driver.setup()
    driver.release()
    numbers = driver.numbers()
    assert all(v < tol for v in numbers.values()), numbers


def test_weights_reach_the_port_under_their_names():
    cfg = tiny.found("blstm_ctc.train")["config"]
    w = weights.draw(cfg, 5, CPU)
    net = model.build(cfg, w, CPU)
    params = dict(net.named_parameters())
    for leaf, value in w.items():
        assert torch.equal(params[model.port_name(cfg, leaf)], value)
    again = weights.draw(cfg, 5, CPU)
    assert all(torch.equal(w[k], again[k]) for k in w)


def test_rounding_keeps_the_stated_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 3.0 + 2.0 ** -13])
    assert common.round_operand(x, "float32") is x
    with pytest.raises(ValueError):
        common.round_operand(x, "tf32")
    fp8 = common.round_operand(torch.tensor([448.0, 1.0, 0.3]), "fp8")
    assert fp8.tolist() == pytest.approx([448.0, 1.0, 0.3], rel=0.07)
    assert fp8[2] != 0.3


def test_norm_gap_takes_the_worst_leaf_over_the_median():
    ref = {"a": torch.ones(4), "b": torch.full((4,), 1e-6),
           "c": torch.full((4,), 2.0)}
    prog = {"a": torch.ones(4) * 1.01, "b": torch.full((4,), 2e-6),
            "c": torch.full((4,), 2.0)}
    # b's gap is measured over the median leaf's norm, not its own
    assert compare.norm_gap(prog, ref) == pytest.approx(0.01)
    assert compare.moving_leaves(ref) == ["a", "c"]
