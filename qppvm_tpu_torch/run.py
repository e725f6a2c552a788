"""Scenario runner: ``python -m qppvm_tpu_torch.run --config configs/<x>.yaml``
(port of qppvm_tpu/run.py).

Loads a ScenarioConfig, builds (model, plugin, simulated robot) and runs
either a closed-loop control session (ControlLoop at the scenario's dt) or,
for an MPC scenario, sampling-MPC plan steps. Runs on the CUDA card, or on
the CPU with ``--cpu``; prints one JSON line, which names the device.

Under ``torchrun --nproc_per_node N`` the N processes join one process
group (NCCL with a card each, gloo otherwise) and an MPC scenario shards
its samples over a 1-D mesh on ``mpc.mesh_axis``; rank 0 prints the line,
whose ``devices`` is the number of ranks.

``mpc.type: ilqr`` raises TypeError at ``init_plan``, as the reference's
runner does: it drives every planner with the sampling planner's calls,
and ``CentroidalMPC.init_plan`` needs the state.
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True, help="scenario YAML path")
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="closed-loop sim duration")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    ap.add_argument("--trace", default=None,
                    help="TraceBuffer output path (.npz/.mat)")
    ap.add_argument("--mpc-steps", type=int, default=1,
                    help="planning steps for MPC scenarios")
    ap.add_argument("--samples", type=int, default=None,
                    help="override mpc.n_samples")
    ap.add_argument("--horizon", type=int, default=None,
                    help="override mpc.horizon")
    args = ap.parse_args(argv)

    import os

    import torch.distributed as dist

    from qppvm_tpu_torch import config as cfgmod
    from qppvm_tpu_torch import device as devices
    from qppvm_tpu_torch.parallel import mesh as meshlib

    world = int(os.environ.get("WORLD_SIZE", "1"))   # set by torchrun
    if world > 1:
        meshlib.initialize_distributed(None, world,
                                       int(os.environ["RANK"]))
    try:
        out = _run(args, cfgmod, devices)
    finally:
        if world > 1:
            dist.destroy_process_group()
    return out


def _run(args, cfgmod, devices):
    import torch
    import torch.distributed as dist

    dev = devices.resolve("cpu" if args.cpu else devices.DEFAULT)
    cfg = cfgmod.load_scenario(args.config)
    if args.samples is not None:
        cfg.mpc.n_samples = args.samples
    if args.horizon is not None:
        cfg.mpc.horizon = args.horizon
    print(f"[{cfg.name}] {cfg.description}")
    model = cfgmod.build_model(cfg, dev)
    plugin = cfgmod.build_plugin(cfg, model)
    run = _run_mpc if cfg.mpc.enabled else _run_loop
    out = run(cfg, cfgmod, model, plugin, args)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(out))
    return out


def _run_loop(cfg, cfgmod, model, plugin, args):
    import torch

    from qppvm_tpu_torch.runtime.logger import TraceBuffer
    from qppvm_tpu_torch.runtime.plugin import ControlLoop
    from qppvm_tpu_torch.runtime.trajectory import qppvm_sinusoid

    robot = cfgmod.build_sim(cfg, model)
    trace = TraceBuffer(args.trace, capacity=30000) if args.trace else None

    ref_gen = None
    if cfg.plugin.type == "qppvm" and cfg.plugin.sine_ref:
        def ref_gen(t, ctx):
            refs = dict(ctx["refs"])
            start = ctx["start"]
            refs["LEFT_ARM"] = {"R": start["R"],
                                "p": qppvm_sinusoid(start["p"], t),
                                "v": start["v"]}
            return refs
    elif cfg.plugin.type == "force_acc":
        def ref_gen(t, ctx):
            # squat: the waist reference descends 0.1 m
            return plugin.squat_refs(ctx["refs"], ctx["start"],
                                     depth=min(0.1, 0.1 * t))

    loop = ControlLoop(plugin, robot, period=cfg.sim.dt, trace=trace,
                       ref_generator=ref_gen)
    stats = loop.run(args.seconds)
    out = {
        "scenario": cfg.name,
        "seconds": args.seconds,
        "p50_ms": round(stats.p50_ms, 3),
        "p99_ms": round(stats.p99_ms, 3),
        "deadline_misses": stats.deadline_misses(cfg.sim.dt),
        "final_q_norm": round(float(torch.linalg.norm(robot.state.q[0])), 4),
    }
    if model.floating:
        out["final_base_z"] = round(float(robot.state.base_pos[0, 2]), 4)
    if trace is not None:
        out["trace"] = trace.path + ".npz"
    return out


def _run_mpc(cfg, cfgmod, model, plugin, args):
    import torch
    import torch.distributed as dist

    from qppvm_tpu_torch.parallel import mesh as meshlib

    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = meshlib.make_mesh(world, cfg.mpc.mesh_axis) if world > 1 else None
    mpc = cfgmod.build_mpc(cfg, plugin, mesh=mesh)
    state = model.home_state()
    refs, warm, _ = plugin.on_start(state)
    U = mpc.init_plan()     # TypeError for a CentroidalMPC, as the reference

    gen = torch.Generator(device=model.device).manual_seed(0)
    for _ in range(args.mpc_steps):
        U, _ = mpc.plan(gen, state, refs, warm, U)
    return {
        "scenario": cfg.name,
        "mpc_steps": args.mpc_steps,
        "n_samples": cfg.mpc.n_samples,
        "horizon": cfg.mpc.horizon,
        "devices": world,
        "plan_norm": round(float(torch.linalg.norm(U)), 4),
    }


if __name__ == "__main__":
    main()
