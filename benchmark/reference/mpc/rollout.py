"""Closed-loop WBC rollouts for sampling MPC (frozen copy of the port's
``mpc/rollout.py`` without the footstep-recovery primitive and the capture
cost), batched over samples: each of H steps runs the ForceAcc tick with the
rollout's trimmed solver profile against the contact dynamics of a
mass-scaled robot, carrying (state, refs, warm, waist_p, binv, anchors,
scen).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from benchmark.reference.model import dynamics, kinematics
from benchmark.reference.model.robot import RobotModel, RobotState
from benchmark.reference.opt import hierarchy, linalg
from benchmark.reference.runtime.robot_interface import (contact_offsets_for,
                                                     ground_forces,
                                                     init_anchors,
                                                     stop_torques)

# the reference's level-solver names and the port's
QP_BACKENDS = {"xla": "torch", "pallas": "kernel", "torch": "torch",
               "kernel": "kernel"}


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    """Rollout parameters, as the reference's (its comments give the
    measurements behind each default)."""

    horizon: int = 16
    dt: float = 0.01
    qp_iters: int = 30
    # warm-start the KKT inverse along the horizon; rho adapts across steps
    qp_warm_kinv: bool = True
    qp_warm_kinv_iters: int = 6
    qp_rho_updates: int = 0
    # rho carry along the horizon: adapt only above this residual, with a
    # higher floor than the RT loop
    qp_rho_adapt_tol: float = 1e-3
    qp_rho_scale_min: float = 0.1
    # trimmed per-step fixed costs (Ruiz sweeps, equality pinv NS)
    qp_scale_iters: int = 2
    qp_pinv_ns_iters: int = 5
    # relative primal residual above which a rollout step counts as failed
    fail_tol: float = 0.05
    # substeps > 1 refresh kinematics and contact per substep but keep the
    # step-start mass matrix and its warm inverse
    sim_substeps: int = 1
    contact_kp: float = 2e4
    contact_kd: float = 300.0
    mu: float = 0.8
    # tangential stiction parameters h-scaled for the rollout's coarse step
    # (the plant runs kt 2e4, kd_t 1500 at h 0.25-0.5 ms)
    contact_kt: float = 4e3
    contact_kd_t: float = 100.0
    # joint hard-stop gains, h-scaled likewise (plant: 2e3 / 20)
    stop_kp: float = 200.0
    stop_kd: float = 5.0
    ground_z: float = 0.0
    # level solver of each step's cascade: "torch" (qp.solve) or "kernel"
    # (the level kernel; the reference's "xla" / "pallas" map onto these)
    qp_backend: str = "torch"


def standing_state(model: RobotModel, contact_links: Sequence[str],
                   cfg: RolloutConfig = None, batch: int = 1) -> RobotState:
    """Home state shifted so the contact links stand on the ground in static
    equilibrium: the lowest contact at ``ground_z`` minus the penetration at
    which the compliant contact (kp per contact) carries the robot's
    weight."""
    cfg = cfg or RolloutConfig()
    st = model.home_state(batch)
    kin = kinematics.fk(model, st)
    idx = [model.link_index(c) for c in contact_links]
    foot_z = torch.amin(torch.stack([kin.p[:, li, 2] for li in idx]), dim=0)
    mass = torch.sum(model.inertia[:, 3, 3]) + model.base_inertia[3, 3]
    g = torch.linalg.norm(model.gravity)
    pen = mass * g / (len(idx) * cfg.contact_kp)
    shift = foot_z - cfg.ground_z + pen                       # (B,)
    zero = torch.zeros_like(shift)
    return dataclasses.replace(
        st, base_pos=st.base_pos - torch.stack([zero, zero, shift], dim=-1))


def _map(tree, fn):
    """Apply ``fn`` to every tensor of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def make_rollout_fn(plugin, cfg: RolloutConfig, cost_fn: Callable,
                    contact_offsets=None):
    """Build ``rollout(state0, refs0, warm0, controls, scenario)``
    -> ``(cost (K,), health)`` for K samples.

    Every input is batched over the samples: ``state0`` a RobotState of
    batch K, ``refs0`` the plugin's references with a leading K, ``warm0``
    per-level QPStates of batch K, ``controls`` (K, H, 3) waist-reference
    velocity offsets integrated into the waist position reference each
    step. ``scenario``: "push" (K, H, 3) external base force [required];
    "mass_scale" (K,) scales the simulated robot's inertia while the
    controller keeps the nominal model; "mu_scale" (K,) scales cfg.mu.
    ``contact_offsets``: the plant's foot patches (SimRobot convention).
    With switchable contacts each step also gates every foot by its height,
    sigmoid((0.01 - z) / 0.004): a foot in the air cannot carry its
    fz >= fz_min bound, and a toppling rollout would be infeasible by
    construction otherwise.
    ``health``: "prim_res_max" (K,) and "solver_failed" (K,) over the
    horizon."""
    if cfg.qp_backend not in QP_BACKENDS:
        raise ValueError(f"unknown qp_backend {cfg.qp_backend!r}; one of "
                         f"{sorted(QP_BACKENDS)}")
    model = plugin.model
    contact_idx = tuple(model.link_index(c) for c in plugin.contact_links)
    contact_offs = contact_offsets_for(plugin.contact_links, contact_offsets)
    auto_gate = plugin.switchable_contacts
    # full-nv armature diagonal (zeros on the floating 6): B scales with the
    # body inertias except this additive rotor term
    off6 = 6 if model.floating else 0
    arm_full = torch.nn.functional.pad(model.armature, (off6, 0))
    substeps = max(1, cfg.sim_substeps)
    h = cfg.dt / substeps
    solver_opts = dict(
        iters=cfg.qp_iters, refine=0, polish_rounds=0,
        rho_updates=cfg.qp_rho_updates, assume_warm_kinv=cfg.qp_warm_kinv,
        warm_kinv_iters=cfg.qp_warm_kinv_iters,
        rho_adapt_tol=cfg.qp_rho_adapt_tol,
        rho_scale_min=cfg.qp_rho_scale_min, scale_iters=cfg.qp_scale_iters,
        pinv_ns_iters=cfg.qp_pinv_ns_iters,
        backend=QP_BACKENDS[cfg.qp_backend])

    def one_step(carry, inp):
        state, refs, warm, waist_p, binv, anchors, scen = carry
        u_ctrl, push = inp
        waist_p = waist_p + u_ctrl * cfg.dt
        refs_t = dict(refs)
        refs_t["waist_task"] = dict(refs_t["waist_task"], p=waist_p)
        # gates: the plugin's and the feet heights'
        if auto_gate:
            z = kinematics.fk(model, state).p[:, contact_idx, 2]  # (K, nc)
            refs_t["contacts"] = {
                "active": refs_t["contacts"]["active"]
                * torch.sigmoid((0.01 - z) / 0.004)}

        # the RT plugin's own tick with the rollout's trimmed profile
        tau, warm, infos, (data, *_) = plugin.step_core(
            state, refs_t, warm, solver_opts=solver_opts)
        # actuator saturation, then joint hard stops (h-scaled gains)
        tau = torch.clamp(tau, -model.tau_max, model.tau_max)
        tau = tau + stop_torques(model, state, k_stop=cfg.stop_kp,
                                 d_stop=cfg.stop_kd)

        # the simulated robot runs the mass-scaled model; its mass matrix
        # is affine in the tick's (armature is additive)
        ms = scen["mass_scale"]
        model_s = dataclasses.replace(
            model, inertia=model.inertia * ms[:, None, None, None],
            base_inertia=model.base_inertia * ms[:, None, None])
        B_s = (ms[:, None, None] * data.B
               + (1.0 - ms)[:, None, None] * torch.diag(arm_full))
        Breg = B_s + 1e-9 * torch.eye(model.nv, dtype=B_s.dtype,
                                      device=B_s.device)
        # warm mass-matrix inverse carried along the horizon
        binv = linalg.ns_warm_inverse(Breg, binv, iters=4)
        mu_t = cfg.mu * scen["mu_scale"]
        dtype = state.q.dtype
        for sub in range(substeps):
            kin = data.kin if sub == 0 else kinematics.fk(model, state)
            J_all = (data.J_all if sub == 0
                     else kinematics.all_link_jacobians(model, kin))
            ext, anchors = ground_forces(
                model, contact_idx, contact_offs, cfg.ground_z,
                cfg.contact_kp, cfg.contact_kd, mu_t, cfg.contact_kt, kin,
                J_all, state.u, anchors, dtype, kd_t=cfg.contact_kd_t)
            udot = dynamics.forward_dynamics(model_s, state, tau,
                                             ext_wrenches=ext, kin=kin,
                                             B=B_s, binv=binv)
            state = dynamics.integrate(model, state, udot, h)
            # the base push as a velocity impulse
            dv = torch.einsum("bji,bj->bi", state.base_rot, push * h)
            state = dataclasses.replace(state, base_vel=torch.cat(
                [state.base_vel[:, :3], state.base_vel[:, 3:] + dv], dim=-1))

        c = cost_fn(model, state, tau, infos)
        prim = torch.amax(torch.stack([i.prim_res for i in infos]), dim=0)
        failed = hierarchy.solve_failed(infos, tol=cfg.fail_tol)
        return ((state, refs, warm, waist_p, binv, anchors, scen),
                (c, prim, failed))

    def _pin(state0, refs0, scenario, K):
        dt = plugin.dtype
        state0 = RobotState(**{f.name: getattr(state0, f.name).to(dt)
                               for f in dataclasses.fields(state0)})
        dev = state0.q.device
        refs0 = _map(refs0, lambda a: torch.as_tensor(a, dtype=dt, device=dev))
        one = torch.ones(K, dtype=dt, device=dev)
        scen = {k: torch.as_tensor(scenario.get(k, one), dtype=dt,
                                   device=one.device).expand(K)
                for k in ("mass_scale", "mu_scale")}
        return state0, refs0, scen

    def init_carry(state0: RobotState, refs0, warm0, scenario=None):
        """The carry ``rollout`` starts from. ``binv`` is one cold
        inversion of the start state's mass matrix; the anchors are the
        contact points' xy at the start state."""
        state0, refs0, scen = _pin(state0, refs0, scenario or {},
                                   state0.batch)
        binv0 = dynamics.mass_matrix_inverse(
            dynamics.mass_matrix(model, state0), reg=1e-9)
        anchors0 = init_anchors(model, state0, contact_idx, contact_offs,
                                plugin.dtype)
        return (state0, refs0, warm0, refs0["waist_task"]["p"], binv0,
                anchors0, scen)

    def rollout(state0: RobotState, refs0, warm0, controls, scenario):
        carry = init_carry(state0, refs0, warm0, scenario)
        dev = carry[0].q.device
        as_t = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=plugin.dtype, device=dev)
        push = as_t(scenario["push"])
        controls = as_t(controls)
        H = push.shape[1]
        costs, prims, fails = [], [], []
        for t in range(H):
            carry, (c, prim, failed) = one_step(
                carry, (controls[:, t], push[:, t]))
            costs.append(c)
            prims.append(prim)
            fails.append(failed)
        health = {"prim_res_max": torch.amax(torch.stack(prims), dim=0),
                  "solver_failed": torch.stack(fails).any(dim=0)}
        return torch.stack(costs).sum(dim=0), health

    return rollout


def default_cost(model: RobotModel, state: RobotState, tau, aux,
                 target_height: float = None):
    """Stay upright, keep base height, low effort; (B,)."""
    tilt_cost = 50.0 * (1.0 - state.base_rot[:, 2, 2])
    vel_cost = 0.1 * torch.sum(state.base_vel ** 2, dim=-1)
    effort = 1e-5 * torch.sum(tau ** 2, dim=-1)
    qd_cost = 1e-3 * torch.sum(state.qd ** 2, dim=-1)
    fall = 200.0 * torch.clamp(0.3 - state.base_pos[:, 2], min=0.0)
    return tilt_cost + vel_cost + effort + qd_cost + fall
