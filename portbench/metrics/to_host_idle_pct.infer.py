"""Share of the spans pass's profiled window in which the host was inside
``aslp.infer.to_host`` and the device, once it had run its first
kernel there, ran no kernel, copy or fill: the device's idle time
that falls within the scores' trip to the host (harness/spans.py)."""

from portbench.harness import spans


def read(records):
    return spans.idle_pct(records, "aslp.infer.to_host")
