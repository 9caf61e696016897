"""Mean host milliseconds of ``aslp.train.step``, each step issued to a
drained device: the host's time to issue one ``CtcTrainer.step`` (and
any wait for the device inside it).  Within an epoch the host runs
ahead until the device's command buffer is full and then waits in the
step's launches, so there the step's host time is the device's
(harness/spans.py)."""

from portbench.harness import spans


def read(records):
    return spans.issue_ms(records, "aslp.train.step")
