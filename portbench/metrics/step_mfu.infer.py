"""The whole posteriors call's share of the configuration's peak: the
forward FLOPs of the traced window's valid frames over the window's
seconds, over the peak of the configuration's dtype."""

from portbench.harness import flops


def read(records):
    window, cfg = records["window"], records["config"]
    return flops.mfu_pct(flops.forward_flops_per_frame(cfg),
                         window["valid_frames"], window["seconds"], cfg)
