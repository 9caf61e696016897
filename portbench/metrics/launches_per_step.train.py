"""Kernels launched a step (copies and fills not counted), from the
profiled sub-window's device trace."""


def read(records):
    profile = records["profile"]
    if not profile["steps"] or not profile["kernels"]:
        return None
    return len(profile["kernels"]) / profile["steps"]
