"""The FLOP counters and roofline arithmetic against hand arithmetic."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import cells, flops, traffic


def test_flagship_training_frame():
    # per direction: 2 (40*2048 + 320*2048 + 512*320) for layer 1 and
    # 2 (640*2048 + 320*2048 + 512*320) for layers 2-3, two directions,
    # then 2 * 640 * 72; three times for training
    layer1 = 2 * (40 * 2048 + 320 * 2048 + 512 * 320)
    later = 2 * (640 * 2048 + 320 * 2048 + 512 * 320)
    forward = 2 * (layer1 + 2 * later) + 2 * 640 * 72
    cfg = cells.load_config("blstm_ctc")
    assert flops.forward_flops_per_frame(cfg) == forward == 20_736_000
    assert flops.train_flops_per_frame(cfg) == 62_208_000


def test_the_frame_count_comes_from_the_architecture_by_name():
    cfg = dict(cells.load_config("blstm_ctc"), architecture="no_such_arch")
    with pytest.raises(ModuleNotFoundError):
        flops.forward_flops_per_frame(cfg)
    with pytest.raises(ValueError):
        flops.forward_flops_per_frame(dict(cfg, architecture="../x"))


def test_roofline_and_mfu():
    cfg = {"peak_flops_per_s": 1e12, "peak_hbm_bytes_per_s": 1e9}
    # 1e9 FLOP take 1 ms; 2e6 bytes take 2 ms: bytes bind
    assert flops.least_seconds(1e9, 2e6, cfg) == pytest.approx(2e-3)
    assert flops.roofline_pct([(1e9, 2e6)], 4000.0, cfg) == pytest.approx(50)
    assert flops.roofline_pct([(1e9, 2e6)], 0.0, cfg) is None
    assert flops.mfu_pct(1e6, 1000, 2.0, cfg) == pytest.approx(0.05)


def test_roofline_readers_count_valid_frames():
    fwd = cells.load_metric("roofline_pct.bilstmp_train_fwd")
    shapes = [(128, 448, 640), None, None, (2, 2048, 320), (2, 320, 512)]
    full, _ = fwd.work(shapes, 128 * 448)
    half, _ = fwd.work(shapes, 64 * 448)
    assert full == 2 * half == 2 * 2 * 128 * 448 * (
        2048 * 640 + 2048 * 320 + 320 * 512)
    ctc = cells.load_metric("roofline_pct.ctc_pair")
    ops, nbytes = ctc.work([10, 5], [2, 1])
    assert ops == 12 * (2 * 9 * 5 + 2 * 4 * 3)
    assert nbytes == 4 * (3 * (10 * 5 + 5 * 3) + 8 + 4)


def test_length_grids_are_fixed_for_every_seed():
    grid = traffic.length_grid(128, 250, 448)
    assert grid.min() >= 250 and grid.max() <= 448
    assert abs(float(np.mean(grid)) - 349) < 1
    item = traffic.generate({"kind": "utterance_batches", "streams": 8,
                             "length_min": 20, "length_max": 40,
                             "pad_time_to": 8, "batches": 1}, 5, 3, 4)[0]
    again = traffic.generate({"kind": "utterance_batches", "streams": 8,
                              "length_min": 20, "length_max": 40,
                              "pad_time_to": 8, "batches": 1}, 6, 3, 4)[0]
    assert np.array_equal(item["input_lengths"], again["input_lengths"])
    assert not np.array_equal(item["feats"], again["feats"])
