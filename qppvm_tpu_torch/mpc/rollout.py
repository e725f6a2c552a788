"""Closed-loop WBC rollouts for sampling MPC (port of
qppvm_tpu/mpc/rollout.py), batched over samples.

A rollout runs the floating-base ForceAcc tick against the contact
dynamics for H steps. The reference vmaps one rollout over the samples and
scans the horizon; the port carries the sample axis as the leading batch
dimension of every tensor and runs the horizon as a Python loop over the
same eight carried leaves (state, refs, warm, waist_p, binv, anchors, scen,
theta). Each step solves every sample's cascade in one call per level, so
with ``qp_backend="kernel"`` the CUDA level kernel sees all samples in one
launch per level.

Not ported yet (ROADMAP queue 1 item 2): the swing primitive, the capture
terminal cost, per-step contact gates (``scenario["gate_seq"]``) and
switchable contacts; asking for any of them raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from qppvm_tpu_torch.model import dynamics, kinematics
from qppvm_tpu_torch.model.robot import RobotModel, RobotState
from qppvm_tpu_torch.opt import hierarchy, linalg
from qppvm_tpu_torch.runtime.robot_interface import (contact_offsets_for,
                                                     ground_forces,
                                                     init_anchors,
                                                     stop_torques)

# the reference's level-solver names and the port's
QP_BACKENDS = {"xla": "torch", "pallas": "kernel", "torch": "torch",
               "kernel": "kernel"}
NOT_PORTED = "not ported yet (ROADMAP queue 1 item 2)"


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
                    swing=None, contact_offsets=None,
                    terminal_cost: Optional[Callable] = None):
    """Build ``rollout(state0, refs0, warm0, controls, scenario)`` ->
    ``(cost (K,), health)`` for K samples.

    Every input is batched over the samples: ``state0`` a RobotState of
    batch K, ``refs0`` the plugin's references with a leading K, ``warm0``
    per-level QPStates of batch K, ``controls`` (K, H, 3) waist-reference
    velocity offsets integrated into the waist position reference each
    step. ``scenario``: "push" (K, H, 3) external base force [required];
    "mass_scale" (K,) scales the simulated robot's inertia while the
    controller keeps the nominal model; "mu_scale" (K,) scales cfg.mu.
    ``contact_offsets``: the plant's foot patches (SimRobot convention).
    ``health``: "prim_res_max" (K,) and "solver_failed" (K,) over the
    horizon. The rollout also carries ``one_step``, ``init_carry`` and
    ``solver_opts``."""
    if swing is not None:
        raise NotImplementedError(f"swing primitive: {NOT_PORTED}")
    if terminal_cost is not None:
        raise NotImplementedError(f"terminal cost: {NOT_PORTED}")
    if getattr(plugin, "switchable_contacts", False):
        raise NotImplementedError(f"switchable contacts: {NOT_PORTED}")
    if cfg.qp_backend not in QP_BACKENDS:
        raise ValueError(f"unknown qp_backend {cfg.qp_backend!r}; one of "
                         f"{sorted(QP_BACKENDS)}")
    model = plugin.model
    contact_idx = tuple(model.link_index(c) for c in plugin.contact_links)
    contact_offs = contact_offsets_for(plugin.contact_links, contact_offsets)
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
        state, refs, warm, waist_p, binv, anchors, scen, theta = carry
        u_ctrl, push, gate_t, t_frac = inp
        if gate_t is not None:
            raise NotImplementedError(f"contact gate sequence: {NOT_PORTED}")
        waist_p = waist_p + u_ctrl * cfg.dt
        refs_t = dict(refs)
        refs_t["waist_task"] = dict(refs_t["waist_task"], p=waist_p)

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
        return ((state, refs, warm, waist_p, binv, anchors, scen, theta),
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

    def init_carry(state0: RobotState, refs0, warm0, scenario=None,
                   theta=None):
        """The carry ``rollout`` starts from, so callers can drive
        ``rollout.one_step`` directly. ``binv`` is one cold inversion of
        the start state's mass matrix; the anchors are the contact points'
        xy at the start state."""
        if theta is not None:
            raise NotImplementedError(f"swing decision theta: {NOT_PORTED}")
        state0, refs0, scen = _pin(state0, refs0, scenario or {},
                                   state0.batch)
        B0 = dynamics.mass_matrix(model, state0)
        B0 = B0 + 1e-9 * torch.eye(model.nv, dtype=B0.dtype, device=B0.device)
        binv0 = dynamics.mass_matrix_inverse(B0)
        anchors0 = init_anchors(model, state0, contact_idx, contact_offs,
                                plugin.dtype)
        return (state0, refs0, warm0, refs0["waist_task"]["p"], binv0,
                anchors0, scen, None)

    def rollout(state0: RobotState, refs0, warm0, controls, scenario,
                theta=None):
        if "gate_seq" in scenario:
            raise NotImplementedError(f"contact gate sequence: {NOT_PORTED}")
        carry = init_carry(state0, refs0, warm0, scenario, theta)
        dev = carry[0].q.device
        push = torch.as_tensor(scenario["push"], dtype=plugin.dtype,
                               device=dev)
        controls = torch.as_tensor(controls, dtype=plugin.dtype, device=dev)
        H = push.shape[1]
        costs, prims, fails = [], [], []
        for t in range(H):
            carry, (c, prim, failed) = one_step(
                carry, (controls[:, t], push[:, t], None, (t + 0.5) / H))
            costs.append(c)
            prims.append(prim)
            fails.append(failed)
        health = {"prim_res_max": torch.amax(torch.stack(prims), dim=0),
                  "solver_failed": torch.stack(fails).any(dim=0)}
        return torch.stack(costs).sum(dim=0), health

    rollout.one_step = one_step
    rollout.init_carry = init_carry
    rollout.solver_opts = solver_opts
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
