"""launch_calls: CUDA kernel-launch API calls a unit (host dispatch), from
torch.profiler's CPU-side runtime events over the traced units. A count,
so it repeats exactly where the program's path does."""


def read(trace):
    if not trace["launches"]:
        return None
    return trace["launches"] / trace["units"]
