"""Mean milliseconds a step of ``aslp.train.update``, the momentum SGD update
inside the program's own ``CtcTrainer.step``, between the span's CUDA
events, over the spans pass's steps (harness/spans.py)."""

from portbench.harness import spans


def read(records):
    return spans.part_ms(records, "aslp.train.update")
