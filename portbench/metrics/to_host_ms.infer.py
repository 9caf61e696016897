"""Host milliseconds a posteriors call in ``aslp.infer.to_host``, the
scores' copy into host memory after the call has waited for the device,
over the spans pass's calls (harness/spans.py)."""

from portbench.harness import spans


def read(records):
    return spans.per_step_ms(records, "aslp.infer.to_host")
