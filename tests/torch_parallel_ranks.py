"""Rank bodies of tests/test_torch_parallel.py: importable by the spawned
ranks, and importing no JAX (each rank runs only the port).

``run(rank, x0, U)`` runs every multi-rank case on one process group of
4 gloo ranks and returns host values (numpy) for the test to check against
a sequential loop and the reference; ``card_plan`` is one rank of the
two-rank plan on the card in tests/test_torch_cuda.py.
"""
import numpy as np
import torch
import torch.distributed as dist

from qppvm_tpu_torch.model import zoo
from qppvm_tpu_torch.mpc.rollout import RolloutConfig
from qppvm_tpu_torch.mpc.sampling import MPPIConfig, SamplingMPC
from qppvm_tpu_torch.parallel import mesh as meshlib
from qppvm_tpu_torch.parallel.ring_horizon import ring_rollout
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
from qppvm_tpu_torch.runtime import robot_interface as ri

FEET = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")
# tests/test_mpc_parallel.py:101-118's planner
MPPI = dict(n_samples=16, horizon=2, noise_std=0.1)
ROLLOUT = dict(horizon=2, qp_iters=6)
PLAN_SEED = 7


def step(c, u):
    """tests/test_ring_horizon.py's nonlinear, non-commuting dynamics."""
    x, v = c
    x2 = torch.tanh(0.9 * x + 0.3 * u) + 0.05 * v
    v2 = 0.8 * v + 0.1 * torch.sin(x) + u
    return (x2, v2), (x2, torch.sum(v2))


def _np(tree):
    return tuple(t.detach().numpy() for t in tree)


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def ring_cases(x0, U):
    mesh = meshlib.make_mesh(4, axis="seg")
    x0 = tuple(torch.as_tensor(a) for a in x0)
    U = torch.as_tensor(U)
    out = {}
    final, outs, info = ring_rollout(step, x0, U, mesh, sweeps=None)
    out["exact"] = (_np(final), _np(outs), float(info.defect))
    out["defects"] = [float(ring_rollout(step, x0, U, mesh, sweeps=s)[2]
                            .defect) for s in (1, 2, 3, 4)]
    _, outs, info2 = ring_rollout(step, x0, U, mesh, sweeps=1,
                                  boundary_guess=info.boundaries)
    out["warm"] = (_np(outs), float(info2.defect))
    Ug = U.clone().requires_grad_(True)
    final, _, _ = ring_rollout(step, x0, Ug, mesh, sweeps=None)
    torch.sum(final[0] ** 2).backward()
    out["grad"] = Ug.grad.numpy()
    out["bad_horizon"] = _raises(lambda: ring_rollout(step, x0, U[:15], mesh))
    out["bad_sweeps"] = _raises(
        lambda: ring_rollout(step, x0, U, mesh, sweeps=0))
    return out


def mesh_cases(rank):
    mesh = meshlib.make_mesh(4)
    x = torch.arange(32.0).reshape(32, 1)
    out = {"rows": meshlib.shard_batch(x, mesh).numpy(),
           "indivisible": _raises(
               lambda: meshlib.shard_batch(torch.zeros(6, 1), mesh))}
    # the counterpart of test_psum_collective_on_mesh: a sum of the shards
    part = torch.sum(meshlib.shard_batch(torch.arange(64.0), mesh))
    dist.all_reduce(part, group=mesh.get_group("rollout"))
    out["psum"] = float(part)
    mesh2 = meshlib.make_2d_mesh((2, 2))
    out["mesh2d"] = (tuple(mesh2.mesh.shape), mesh2.mesh_dim_names,
                     tuple(mesh2.get_coordinate()),
                     meshlib.share(mesh2, mesh2.mesh_dim_names))
    out["replicated"] = float(meshlib.replicate(
        {"a": torch.tensor(float(rank) + 10.0)}, mesh)["a"])
    spec = meshlib.batch_spec(mesh)
    out["spec"] = (spec.mesh is mesh, spec.axis)
    return out


def plan_cases(rank):
    model = zoo.quadruped(device="cpu")
    plugin = ForceAccPlugin(model, iters=40)
    state = ri.standing_state(model, FEET)
    refs, warm, _ = plugin.on_start(state)
    mppi, rcfg = MPPIConfig(**MPPI), RolloutConfig(**ROLLOUT)

    def plan(mesh):
        mpc = SamplingMPC(plugin, mppi, rcfg, mesh=mesh)
        gen = torch.Generator().manual_seed(PLAN_SEED)
        U_new, info = mpc.plan(gen, state, refs, warm, mpc.init_plan())
        return (U_new.numpy(), float(info["cost_mean"]),
                float(info["solver_fail_frac"]), info["costs"].numpy())

    out = {"1d": plan(meshlib.make_mesh(4)),
           "2d": plan(meshlib.make_2d_mesh((2, 2))),
           "indivisible": _raises(lambda: SamplingMPC(
               plugin, MPPIConfig(n_samples=6, horizon=2), rcfg,
               mesh=meshlib.make_mesh(4)))}
    if rank == 0:   # the same plan in one process, from the same generator
        out["single"] = plan(None)
    return out


def run(rank, x0, U):
    torch.set_num_threads(1)
    torch.set_default_dtype(torch.float64)
    out = {"ring": ring_cases(x0, U), "mesh": mesh_cases(rank)}
    torch.set_default_dtype(torch.float32)
    out["plan"] = plan_cases(rank)
    return out


def one_rank(x0, U):
    """A mesh of one rank in this process (no launcher): the ring and the
    sharding take the same code. Returns the ring's final carry and
    outputs, and the shard of an 8-row batch."""
    mesh = meshlib.make_mesh(axis="seg")
    x0 = tuple(torch.as_tensor(a) for a in x0)
    final, outs, info = ring_rollout(step, x0, torch.as_tensor(U), mesh)
    rows = meshlib.shard_batch(torch.arange(8.0), mesh, "seg")
    return _np(final), _np(outs), float(info.defect), rows.numpy(), \
        mesh.size()


def card_plan(rank):
    """One rank of tests/test_torch_cuda.py's two-rank plan: the dryrun's
    planner with 16 samples on the card. Returns (U_new, cost_mean, the
    plan's counts of level launches, NS launches and fallbacks)."""
    from qppvm_tpu_torch import dryrun

    dev = dryrun.rank_device(rank, "cuda")
    U, info, counts, _ = dryrun.plan_step(16, dev, meshlib.make_mesh(2))
    return U.cpu().numpy(), float(info["cost_mean"]), counts
