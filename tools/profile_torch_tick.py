"""Where the time of the port's batched ForceAcc tick goes, on one GPU.

    python3 tools/profile_torch_tick.py

Builds chip_smoke.py's main path (humanoid, RT profile, B = 1024, the CUDA
level kernel) and prints:
- the median host-clock time of the whole tick over synchronized runs;
- the same for each stage run alone (model update, stack build, cascade,
  contact Jacobians, torque reconstruction);
- torch.profiler over PROFILED_TICKS ticks: device busy time per tick (the
  sum of the device-side kernel and copy events), device events per tick,
  the operators with the most device time, and
  the device's idle share against the unprofiled median tick (the
  profiler's own host overhead stretches the profiled wall, so that wall is
  not used).
"""
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

REPS = 10
PROFILED_TICKS = 3


def median_ms(torch, fn, reps=REPS):
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_torch_tick: no CUDA device")
    dev = torch.device("cuda", 0)
    from qppvm_tpu_torch.model import dynamics
    from qppvm_tpu_torch.opt import hierarchy

    card = chip_smoke.card_line()
    plugins, states, refs, warm = chip_smoke.main_path_inputs(torch, dev)
    plugin = plugins["kernel"]
    model = plugin.model
    data = dynamics.compute_model_data(model, states)
    stack = plugin.stack.build(model, data, states, refs, nx=plugin.opt.size,
                               dtype=plugin.dtype)
    opts = dict(plugin.solver_opts)
    x, _, _ = hierarchy.solve(stack, warm, eps=plugin.eps,
                              iters=plugin.iters, **opts)
    qddot = plugin.qddot.value(x)

    stages = {
        "whole tick (_step_impl)":
            lambda: plugin._step_impl(states, refs, warm),
        "compute_model_data":
            lambda: dynamics.compute_model_data(model, states),
        "stack.build":
            lambda: plugin.stack.build(model, data, states, refs,
                                       nx=plugin.opt.size, dtype=plugin.dtype),
        "hierarchy.solve":
            lambda: hierarchy.solve(stack, warm, eps=plugin.eps,
                                    iters=plugin.iters, **opts),
        "frame_data (contacts)":
            lambda: [dynamics.frame_data(model, data, c)
                     for c in plugin.contact_links],
        "rnea":
            lambda: dynamics.rnea(model, states, qddot, gravity=True,
                                  kin=data.kin),
    }
    print(f"[{card}] B={chip_smoke.B}, CUDA level kernel: median "
          f"host-clock ms over {REPS} synchronized runs")
    times = {name: median_ms(torch, fn) for name, fn in stages.items()}
    for name, ms in times.items():
        print(f"  {name:28s} {ms:9.3f}")
    tick_ms = times["whole tick (_step_impl)"]

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_TICKS):
            plugin._step_impl(states, refs, warm)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    # device-side events (kernels, copies); the host operators that launched
    # them carry the same time again, so they are listed but not summed
    device = [e for e in rows if e.device_type != DeviceType.CPU
              and not e.is_user_annotation]
    busy_ms = (sum(e.self_device_time_total for e in device) / 1e3
               / PROFILED_TICKS)
    n_events = sum(e.count for e in device) / PROFILED_TICKS
    print(f"[{card}] torch.profiler over {PROFILED_TICKS} ticks: device busy "
          f"{busy_ms:.3f} ms per tick, {n_events:.0f} device events per "
          f"tick; idle share against the unprofiled {tick_ms:.3f} ms tick "
          f"{1.0 - busy_ms / tick_ms:.3f}")
    ops = sorted((e for e in rows if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    for e in ops[:10]:
        ms = e.self_device_time_total / 1e3 / PROFILED_TICKS
        print(f"  {e.key[:60]:60s} {ms:8.3f} ms/tick "
              f"{e.count / PROFILED_TICKS:6.0f} calls/tick "
              f"{ms / busy_ms:6.1%}")


if __name__ == "__main__":
    main()
