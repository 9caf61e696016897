"""Share of the spans pass's profiled window in which the host was inside
``aslp.train.feed`` and the device, once it had run its first kernel
there, ran no kernel, copy or fill: the device's idle time that falls
within the batch feed (harness/spans.py).  The first feed, which the
window's drained device waits for, counts under ``startup_idle_pct``."""

from portbench.harness import spans


def read(records):
    return spans.idle_pct(records, "aslp.train.feed")
