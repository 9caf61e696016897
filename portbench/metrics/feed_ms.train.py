"""Host milliseconds a step in ``aslp.train.feed``, the batch's send in
``device_batches`` (``from_numpy``, ``pin_memory`` and the non-blocking
copy), over the spans pass's steps (harness/spans.py)."""

from portbench.harness import spans


def read(records):
    return spans.per_step_ms(records, "aslp.train.feed")
