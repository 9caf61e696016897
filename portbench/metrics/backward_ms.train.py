"""Mean milliseconds a step of loss.backward(), from CUDA events around the
benchmark's call of it in every step of the traced window."""


def read(records):
    parts = records["window"].get("parts_ms")
    return parts["backward"] if parts and records["window"]["steps"] else None
