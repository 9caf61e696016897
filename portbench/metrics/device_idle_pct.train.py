"""Share of the profiled sub-window in which no kernel, copy or fill ran
on the device (one minus the union of their intervals over the window),
from the device trace."""


def read(records):
    profile = records["profile"]
    if profile["window_us"] <= 0 or not profile["kernels"]:
        return None
    return 100.0 * (1.0 - profile["busy_us"] / profile["window_us"])
