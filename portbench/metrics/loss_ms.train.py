"""Mean milliseconds a step of the loss (the driver's loss call, such as
ctc_batch_loss), from CUDA events around the benchmark's call of it in
every step of the traced window."""


def read(records):
    parts = records["window"].get("parts_ms")
    return parts["loss"] if parts and records["window"]["steps"] else None
