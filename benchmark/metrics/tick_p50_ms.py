"""tick_p50_ms: the median tick latency of the traced run's untraced
window (the loop mode's timing, host clock to a synchronize), reported
beside the bounded 95th percentile: between runs it spreads too widely for
a bound (PERF.md, section 2)."""


def read(trace):
    return trace["window"].get("tick_p50_ms")
