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

Then the same busy time and idle share for one unit of chip_smoke.py's
footstep-recovery paths: a tick of the capture plugin's closed loop (B 1,
from the standing state: the plugin's tick and the plant's 2 substeps), a
step of the capture plan's candidate rollouts (K 4, 8 substeps) and a
step-recovery MPPI plan (512 samples x 12 steps); and for one centroidal
DDP plan (chip_smoke.py's phase 15: the quadruped at the test's config,
the quadruped and the humanoid at the default one), with the NS kernel's
share of the busy time.
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
    from qppvm_tpu_torch.model import dynamics, zoo
    from qppvm_tpu_torch.opt import hierarchy

    card = chip_smoke.card_line()
    plugins, states, refs, warm = chip_smoke.main_path_inputs(
        torch, dev, zoo.humanoid(device=dev), chip_smoke.CONTACTS)
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
    rows, busy_ms, n_events = device_busy(
        torch, lambda: plugin._step_impl(states, refs, warm), PROFILED_TICKS)
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
    footstep_paths(torch, dev, card)
    ddp_plans(torch, dev, card)


def device_busy(torch, fn, runs):
    """torch.profiler over ``runs`` calls of ``fn``: (key_averages rows,
    device busy ms per call, device events per call). Device-side events
    are kernels and copies; the host operators that launched them carry the
    same time again, so they are not summed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    device = [e for e in rows if e.device_type != DeviceType.CPU
              and not e.is_user_annotation]
    return (rows, sum(e.self_device_time_total for e in device) / 1e3 / runs,
            sum(e.count for e in device) / runs)


def footstep_paths(torch, dev, card):
    """Busy time and idle share of one unit of each footstep-recovery
    path, at chip_smoke.py's phase 9 and 10 configurations."""
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.mpc import rollout as ro
    from qppvm_tpu_torch.mpc.sampling import (MPPIConfig, SamplingMPC,
                                              expand_batch)
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
    from qppvm_tpu_torch.runtime import robot_interface as ri
    from qppvm_tpu_torch.runtime.rt_loop import FOOT_PATCH

    cs = chip_smoke
    model = zoo.humanoid(device=dev)
    plugin = ForceAccPlugin(model, **cs.CAPTURE_PLUGIN)
    offsets = {c: FOOT_PATCH for c in cs.CONTACTS}
    robot = ri.SimRobot(model, state=ri.standing_state(model, cs.CONTACTS),
                        dt=1e-3, substeps=2, contact_links=cs.CONTACTS,
                        contact_offsets=offsets)
    refs, warm, _ = plugin.on_start(robot.state)
    loop = {"warm": warm}

    def loop_tick():
        st = robot.state
        tau, loop["warm"], _ = plugin.control_loop(st, refs, loop["warm"])
        robot.set_reference(tau_ref=tau, q_ref=st.q)
        robot.move()

    swing, init_theta = ro.make_swing_primitive(
        plugin, span_s=cs.CAPTURE_ROLLOUT["horizon"]
        * cs.CAPTURE_ROLLOUT["dt"])
    names, thetas = cs.capture_candidates(torch, dev, init_theta)
    roll = ro.make_rollout_fn(
        plugin, ro.RolloutConfig(**cs.CAPTURE_ROLLOUT, qp_backend="kernel"),
        ro.default_cost, swing=swing, contact_offsets=offsets)
    K = len(names)
    carry = roll.init_carry(*expand_batch(cs.shoved(robot.state), refs, warm,
                                          K), None, thetas)
    zero = torch.zeros((K, 3), device=dev)
    t_frac = torch.tensor(0.3, device=dev)
    plan_step = lambda: roll.one_step(  # noqa: E731
        carry, (zero, zero, None, t_frac))

    quad = zoo.quadruped(device=dev)
    qplugin = ForceAccPlugin(quad, **cs.QUAD_MPC_PLUGIN)
    qst = ro.standing_state(quad, cs.FEET)
    qrefs, qwarm, _ = qplugin.on_start(qst)
    mpc = SamplingMPC(qplugin, MPPIConfig(**cs.STEP_MPPI),
                      ro.RolloutConfig(**cs.STEP_ROLLOUT, qp_backend="kernel"))
    g = torch.Generator(device=dev).manual_seed(0)
    U, theta = mpc.init_plan(), mpc.init_theta()
    mppi = lambda: mpc.plan_step(g, qst, qrefs, qwarm, U, theta)  # noqa

    for label, fn, runs in (("capture loop tick, B 1", loop_tick, 5),
                            ("capture plan step, K 4 x 8 substeps",
                             plan_step, 3),
                            ("step-recovery MPPI plan, 512 x 12", mppi, 2)):
        ms = median_ms(torch, fn, reps=runs)
        _, busy, events = device_busy(torch, fn, runs)
        print(f"[{card}] {label}: median {ms:.3f} ms (host clock), device "
              f"busy {busy:.3f} ms, {events:.0f} device events; idle share "
              f"{1.0 - busy / ms:.3f}")


def ddp_plans(torch, dev, card):
    """Busy time, idle share and the NS kernel's device time of one DDP
    plan, warm-started from the previous plan, at chip_smoke.py's phase 15
    configurations."""
    from torch.autograd import DeviceType
    from qppvm_tpu_torch.model import zoo

    cs = chip_smoke
    for robot, contacts, cfg, label in (
            ("quadruped", cs.FEET, cs.DDP_TEST, "test config"),
            ("quadruped", cs.FEET, {}, "default config"),
            ("humanoid", cs.CONTACTS, {}, "default config")):
        mpc, st, p_ref = cs.ddp_planner(
            torch, getattr(zoo, robot)(device=dev), contacts, cfg)
        U = mpc.init_plan(st)
        plan = lambda: mpc.plan(st, p_ref, U)  # noqa: E731
        ms = median_ms(torch, plan, reps=3)
        rows, busy, events = device_busy(torch, plan, 2)
        ns_ms = sum(e.self_device_time_total for e in rows
                    if e.device_type != DeviceType.CPU
                    and "ns_inverse_kernel" in e.key) / 1e3 / 2
        print(f"[{card}] ddp plan, {robot}, {label} (horizon "
              f"{mpc.cfg.horizon}, {mpc.cfg.iterations} iterations): median "
              f"{ms:.3f} ms (host clock), device busy {busy:.3f} ms, "
              f"{events:.0f} device events; idle share {1.0 - busy / ms:.3f};"
              f" NS kernel {ns_ms:.3f} ms of the busy time")


if __name__ == "__main__":
    main()
