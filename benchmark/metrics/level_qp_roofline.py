"""level_qp_roofline: the level kernel's share of its roofline, in %: the
least time one H100 needs for the unit's level solves (``accounting.py``'s
frozen ``level_qp_cost`` at the shapes the reference's cascade solves,
over the published peaks) over the device time of the kernels named
``level_qp_kernel`` in the profiler's trace, both a unit. Nothing where
no such kernel ran."""

# the level kernel's launches: device kernels whose names hold this
LEVEL_KERNEL = "level_qp_kernel"


def read(trace):
    kernel_s = sum(s for name, s in trace["kernel_s"].items()
                   if LEVEL_KERNEL in name)
    if kernel_s <= 0.0 or not trace["level_bounds_ms"]:
        return None
    return 100.0 * trace["level_bounds_ms"] * 1e-3 / (kernel_s / trace["units"])
