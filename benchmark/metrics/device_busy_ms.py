"""device_busy_ms: ms a unit in which an operation ran on the card (the
union of the profiler's device events over the traced units, a unit): the
device's own work, which the host's speed does not move."""


def read(trace):
    if trace["busy_s"] <= 0.0:
        return None
    return trace["busy_s"] / trace["units"] * 1e3
