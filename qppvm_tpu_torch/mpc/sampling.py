"""Sampling MPC (MPPI) over batched WBC rollouts (port of
qppvm_tpu/mpc/sampling.py).

``SamplingMPC.sample`` draws the perturbed plans, the domain
randomization and, with ``step_recovery``, the footstep decisions theta
from an explicit ``torch.Generator``; ``update`` rolls every sample out
(the sample axis is the rollouts' batch) and takes the MPPI average. The
two are separate so that callers, the tests among them, can feed the
update samples drawn elsewhere. Every reduction over samples (min, softmax
weights, argmin) is over the leading axis.

With a ``mesh`` (parallel/mesh.py) every rank draws the whole sample set
from its generator, seeded alike on every rank, exactly as the unsharded
plan draws it; keeps its K / world share, the sample axis split over all
mesh axes flattened row-major (the reference's P(mesh.axis_names)); rolls
the share out as one batch, so the level kernel sees K / world problems a
launch; and all-gathers the (K,) costs and health, so that every rank
takes the same MPPI average and holds the same U_new.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model.robot import RobotState
from qppvm_tpu_torch.mpc.rollout import (THETA_KEYS, RolloutConfig,
                                         default_cost, make_rollout_fn,
                                         make_swing_primitive)
from qppvm_tpu_torch.opt.qp import QPState
from qppvm_tpu_torch.parallel import mesh as meshlib


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    n_samples: int = 256
    horizon: int = 16
    lambda_: float = 1.0
    noise_std: float = 0.15
    push_std: float = 0.0      # random base pushes (N)
    # per-rollout true-robot mass scale (lognormal) and ground-friction
    # scale (uniform in [1 - mu_scale_range, 1]); 0 disables
    mass_scale_std: float = 0.0
    mu_scale_range: float = 0.0
    # footstep recovery: sample and average the swing primitive's decision
    # theta beside the waist plan (noise std of its logits and of dxy)
    step_recovery: bool = False
    theta_noise_std: float = 1.0
    dxy_noise_std: float = 0.08
    nu: int = 3                # control dim (waist reference velocity)
    # added to the cost of a rollout whose QP chain failed
    fail_penalty: float = 1e6


def expand_batch(state: RobotState, refs, warm, K: int):
    """A batch-1 state, references and warm state repeated for K samples
    (contiguous, as the level kernel requires)."""
    rep = lambda a: a.expand(K, *a.shape[1:]).contiguous()  # noqa: E731

    def tree(t):
        return ({k: tree(v) for k, v in t.items()} if isinstance(t, dict)
                else rep(t))

    state = RobotState(**{f.name: rep(getattr(state, f.name))
                          for f in dataclasses.fields(state)})
    warm = tuple(QPState(**{f.name: rep(getattr(s, f.name))
                            for f in dataclasses.fields(s)}) for s in warm)
    return state, tree(refs), warm


class SamplingMPC:
    """MPPI controller: perturb the nominal waist-velocity plan (and, with
    ``step_recovery``, the footstep decision theta), roll out the full
    WBC-in-the-loop dynamics per sample, average exponentially."""

    def __init__(self, plugin, mppi: MPPIConfig,
                 rollout_cfg: Optional[RolloutConfig] = None,
                 mesh=None, cost_fn=default_cost, contact_offsets=None):
        """``mesh``: a DeviceMesh over which the samples are sharded
        (None: every sample on this process); n_samples must divide over
        its ranks."""
        if mesh is not None and mppi.n_samples % mesh.size():
            raise ValueError(f"{mppi.n_samples} samples do not divide over "
                             f"the mesh's {mesh.size()} ranks")
        self.plugin = plugin
        self.mppi = mppi
        self.mesh = mesh
        self.rcfg = rollout_cfg or RolloutConfig(horizon=mppi.horizon)
        self.swing, self.init_theta = None, None
        if mppi.step_recovery:
            self.swing, self.init_theta = make_swing_primitive(
                plugin, span_s=self.rcfg.horizon * self.rcfg.dt)
        self.rollout = make_rollout_fn(plugin, self.rcfg, cost_fn,
                                       swing=self.swing,
                                       contact_offsets=contact_offsets)

    def init_plan(self, dtype=torch.float32):
        return torch.zeros((self.mppi.horizon, self.mppi.nu), dtype=dtype,
                           device=self.plugin.device)

    def sample(self, generator: torch.Generator, U_nom, theta_nom=None):
        """(U (K, H, nu), scenario) for one plan step, drawn from
        ``generator`` (on U_nom's device); with a nominal ``theta_nom``
        (unbatched, as ``init_theta`` gives it) also the sampled thetas,
        (U, scenario, theta), drawn after the rest in THETA_KEYS order."""
        m = self.mppi
        K = m.n_samples
        kw = dict(generator=generator, dtype=U_nom.dtype,
                  device=U_nom.device)
        U = U_nom[None] + m.noise_std * torch.randn(K, m.horizon, m.nu, **kw)
        scenario = {"push": m.push_std * torch.randn(K, m.horizon, 3, **kw)}
        if m.mass_scale_std > 0.0:
            scenario["mass_scale"] = torch.exp(
                m.mass_scale_std * torch.randn(K, **kw))
        if m.mu_scale_range > 0.0:
            scenario["mu_scale"] = 1.0 - m.mu_scale_range * torch.rand(K, **kw)
        if theta_nom is None:
            return U, scenario
        theta = {}
        for k in THETA_KEYS:
            v = theta_nom[k]
            std = m.dxy_noise_std if k == "dxy" else m.theta_noise_std
            theta[k] = v[None] + std * torch.randn(K, *v.shape, **kw)
        return U, scenario, theta

    def update(self, state, refs, warm, U, scenario, theta=None):
        """The MPPI update from given samples: ``state``/``refs``/``warm``
        of batch 1, ``U`` (K, H, nu), ``scenario`` as the rollout takes it,
        ``theta`` the sampled footstep decisions (step_recovery); with a
        mesh each rank rolls out its share and the rest is gathered. Returns
        (U_new (H, nu), info), or ((U_new, theta_new), info) with theta;
        info stays on the device, its ``costs`` (K,) holds each sample's
        cost, failure penalty included, and with theta its
        ``theta_best`` the best sample's decision. The update is the span
        ``plan``, a unit of the program's telemetry; each horizon step of
        the rollout a ``rollout.step`` in it."""
        with telemetry.span("plan"):
            m = self.mppi
            U_loc, scen_loc, theta_loc = U, scenario, theta
            if self.mesh is not None:
                U_loc, scen_loc, theta_loc = meshlib.shard_batch(
                    (U, scenario, theta), self.mesh, self.mesh.mesh_dim_names)
            st, rf, w = expand_batch(state, refs, warm, U_loc.shape[0])
            costs, health = self.rollout(st, rf, w, U_loc, scen_loc, theta_loc)
            failed, prim = health["solver_failed"], health["prim_res_max"]
            if self.mesh is not None:
                costs, failed, prim = (meshlib.all_gather_batch(a, self.mesh)
                                       for a in (costs, failed, prim))
            costs = torch.where(torch.isfinite(costs), costs,
                                torch.full_like(costs, m.fail_penalty))
            costs = costs + m.fail_penalty * failed.to(costs.dtype)
            beta = torch.amin(costs)
            wts = torch.exp(-(costs - beta) / m.lambda_)
            wts = wts / torch.sum(wts)
            U_new = torch.einsum("k,khu->hu", wts, U)
            best = torch.argmin(costs)
            info = {
                "cost_min": beta,
                "cost_mean": torch.mean(costs),
                "ess": 1.0 / torch.sum(wts ** 2),
                "solver_fail_frac": torch.mean(failed.to(costs.dtype)),
                "prim_res_max": torch.amax(prim),
                "U_best": U[best],
                "best_failed": failed[best],
                "solver_failed": failed,
                "costs": costs,
            }
            if theta is None:
                return U_new, info
            # the exponential average of a step-or-not decision is mushy; the
            # best sample's decision is surfaced for callers to act on
            theta_new = {k: torch.einsum("k,k...->...", wts, v)
                         for k, v in theta.items()}
            info["theta_best"] = {k: v[best] for k, v in theta.items()}
            return (U_new, theta_new), info

    def plan(self, generator: torch.Generator, state, refs, warm, U_nom):
        """One MPC re-planning step. Returns (U_new, info); the first row
        of U_new is the control applied this tick."""
        U, scenario = self.sample(generator, U_nom)
        return self.update(state, refs, warm, U, scenario)

    def plan_step(self, generator: torch.Generator, state, refs, warm, U_nom,
                  theta_nom):
        """Re-plan with the footstep-recovery channel (step_recovery):
        ((U_new, theta_new), info)."""
        U, scenario, theta = self.sample(generator, U_nom, theta_nom)
        return self.update(state, refs, warm, U, scenario, theta)

    @staticmethod
    def shift_plan(U):
        return torch.cat([U[1:], U[-1:]], dim=0)
