"""The whole training step's share of the configuration's peak: model
FLOPs of the traced window's valid frames (the forward products, three
times for training) over the window's seconds, over the peak of the
configuration's dtype."""

from portbench.harness import flops


def read(records):
    window, cfg = records["window"], records["config"]
    return flops.mfu_pct(flops.train_flops_per_frame(cfg),
                         window["valid_frames"], window["seconds"], cfg)
