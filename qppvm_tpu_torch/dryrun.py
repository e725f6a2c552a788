"""Multi-rank dryrun of the sampling-MPC plan step (the port's counterpart
of __graft_entry__.py::dryrun_multichip).

``dryrun_multichip(n)`` starts n ranks of one process group
(parallel/mesh.py::run_ranks) and plans one MPPI step of the humanoid
(l_sole / r_sole, waist pelvis, iters 30, from its standing state) with 64
samples a rank at horizon 8, domain randomization on (pushes 20 N, mass
scale 0.05, friction scale 0.2), rollouts at qp_iters 10 through the level
kernel: on a 1-D ``rollout`` mesh, and on a 2-D ``(host, rollout)`` mesh
of (2, n / 2) when n >= 4 is even. Each plan must be healthy
(solver_fail_frac 0, a finite cost) and hold the same U_new on every rank.

On one card the ranks are gloo ranks that all compute on it (NCCL refuses
two ranks on one card); the costs, health and boundary carries cross
through host memory. The kernels are built before the ranks start.

    python -m qppvm_tpu_torch.dryrun --ranks 4        # the card
    python -m qppvm_tpu_torch.dryrun --ranks 4 --cpu  # the CPU
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from qppvm_tpu_torch import device as devices

CONTACTS = ("l_sole", "r_sole")
SAMPLES_PER_RANK = 64
HORIZON = 8


def flagship(device):
    """(model, plugin, state): the humanoid's WBC tick as
    __graft_entry__.py::_flagship sets it up, from its standing state."""
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.mpc.rollout import standing_state
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin

    model = zoo.humanoid(device=device)
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=30)
    return model, plugin, standing_state(model, CONTACTS)


def plan_step(n_samples: int, device, mesh=None, seed: int = 0):
    """One plan step of the dryrun's planner with ``n_samples`` samples,
    sharded over ``mesh`` (None: all in this process); on_start's
    references and warm state are rank 0's on every rank. Returns
    (U_new, info, counts, ms): counts are this process's level launches,
    NS launches, fallbacks and model-sweep launches of the plan
    (``telemetry``'s ``level_qp.launch``, ``ns_inverse.launch``,
    ``cascade.fallback``, ``model_sweep.launch``), ms its host time to a
    synchronize."""
    from qppvm_tpu_torch import telemetry
    from qppvm_tpu_torch.mpc.rollout import RolloutConfig
    from qppvm_tpu_torch.mpc.sampling import MPPIConfig, SamplingMPC
    from qppvm_tpu_torch.parallel import mesh as meshlib

    _, plugin, state = flagship(device)
    refs, warm, _ = plugin.on_start(state)
    if mesh is not None:
        refs, warm = meshlib.replicate((refs, warm), mesh)
    mppi = MPPIConfig(n_samples=n_samples, horizon=HORIZON, push_std=20.0,
                      mass_scale_std=0.05, mu_scale_range=0.2)
    rcfg = RolloutConfig(horizon=HORIZON, qp_iters=10)
    mpc = SamplingMPC(plugin, mppi, rcfg, mesh=mesh)
    U = mpc.init_plan()
    gen = torch.Generator(device=device).manual_seed(seed)
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    names = ("level_qp.launch", "ns_inverse.launch", "cascade.fallback",
             "model_sweep.launch")
    telemetry.reset(*names)
    sync()
    t0 = time.perf_counter()
    U_new, info = mpc.plan(gen, state, refs, warm, U)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    counted = telemetry.counts()
    counts = tuple(counted[name] for name in names)
    if U_new.shape != U.shape:
        raise RuntimeError(f"plan of shape {tuple(U_new.shape)}")
    return U_new, info, counts, ms


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank ``rank``'s compute device: card rank modulo the cards (made
    current), or the CPU."""
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev
    return torch.device("cpu")


def _meshes(n_ranks: int):
    """(tag, mesh) of the dryrun: 1-D, and 2-D (2, n / 2) for even n >= 4."""
    from qppvm_tpu_torch.parallel import mesh as meshlib

    out = [("1d", meshlib.make_mesh(n_ranks, "rollout"))]
    if n_ranks >= 4 and n_ranks % 2 == 0:
        out.append(("2d host x rollout",
                    meshlib.make_2d_mesh((2, n_ranks // 2))))
    return out


def _rank(rank: int, n_ranks: int, device_type: str, reps: int):
    """One rank's plans on every mesh: ``reps`` plans each (the first
    gated on its counts by the caller, the last one's time kept)."""
    dev = rank_device(rank, device_type)
    out = {}
    for tag, mesh in _meshes(n_ranks):
        runs = [plan_step(SAMPLES_PER_RANK * n_ranks, dev, mesh)
                for _ in range(reps)]
        U_new, info, counts, _ = runs[0]
        out[tag] = {
            "U_new": U_new.cpu().numpy(),
            **{k: float(info[k]) for k in ("cost_mean", "ess",
                                           "solver_fail_frac",
                                           "prim_res_max")},
            "counts": counts, "ms": [r[3] for r in runs]}
    return out


def dryrun_multichip(n_ranks: int, device=devices.DEFAULT, reps: int = 1,
                     timeout_s: float = 600.0):
    """The dryrun on ``n_ranks`` ranks computing on ``device``'s type (the
    card by default: rank r on card r modulo the cards). Checks each plan's
    health and that U_new is bitwise the same on every rank, prints the
    reference's line per mesh and returns {tag: [each rank's result]}
    (``_rank``'s dicts)."""
    from qppvm_tpu_torch.model import model_sweep
    from qppvm_tpu_torch.opt import level_qp, ns_inverse
    from qppvm_tpu_torch.parallel import mesh as meshlib

    device = devices.resolve(device)
    if device.type == "cuda":   # built once, before the ranks start
        level_qp.library()
        ns_inverse.library()
        model_sweep.library()
    ranks = meshlib.run_ranks(_rank, n_ranks, (n_ranks, device.type, reps),
                              timeout_s=timeout_s,
                              group_timeout_s=min(timeout_s, 120.0))
    results = {tag: [r[tag] for r in ranks] for tag in ranks[0]}
    for tag, per_rank in results.items():
        for r, res in enumerate(per_rank):
            if not np.isfinite(res["cost_mean"]):
                raise RuntimeError(f"[{tag}] rank {r}: cost_mean "
                                   f"{res['cost_mean']}")
            if res["solver_fail_frac"] != 0.0:
                raise RuntimeError(
                    f"[{tag}] rank {r}: solver_fail_frac="
                    f"{res['solver_fail_frac']} prim_res_max="
                    f"{res['prim_res_max']:.4g}: rollout QPs unhealthy")
            if not np.array_equal(res["U_new"], per_rank[0]["U_new"]):
                raise RuntimeError(f"[{tag}] rank {r}'s U_new differs from "
                                   "rank 0's")
        res = per_rank[0]
        print(f"dryrun_multichip({n_ranks})[{tag}]: ok — samples="
              f"{SAMPLES_PER_RANK * n_ranks} horizon={HORIZON} "
              f"cost_mean={res['cost_mean']:.3f}, ess={res['ess']:.2f}, "
              f"solver_fail_frac={res['solver_fail_frac']}, "
              f"prim_res_max={res['prim_res_max']:.4g}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="compute on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, "cpu" if args.cpu else devices.DEFAULT)


if __name__ == "__main__":
    main()
