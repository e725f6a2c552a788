"""device_idle: the share of a unit's time, in %, in which no operation ran
on the card: 1 - (device busy seconds a unit: the union of the profiler's
device events over the traced units) / (seconds a unit of the run's
untraced window). The profiler's own host overhead stretches the traced
window, so the untraced unit is the base; ``device.busy_s`` and
``device.window_s`` of the result line give the traced window's share."""


def read(trace):
    if trace["busy_s"] <= 0.0 or trace["unit_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["units"] / trace["unit_s"])
