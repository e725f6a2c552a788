"""Closed-loop WBC rollouts for sampling MPC (port of
qppvm_tpu/mpc/rollout.py), batched over samples.

A rollout runs the floating-base ForceAcc tick against the contact
dynamics for H steps. The reference vmaps one rollout over the samples and
scans the horizon; the port carries the sample axis as the leading batch
dimension of every tensor and runs the horizon as a Python loop over the
same eight carried leaves (state, refs, warm, waist_p, binv, anchors, scen,
theta). Each step solves every sample's cascade in one call per level, so
the CUDA level kernel sees all samples in one launch per level.

Footstep recovery: ``make_swing_primitive`` schedules one swing inside the
horizon from a low-dimensional decision theta (one per sample), and
``make_capture_terminal_cost`` prices the final state by its
instantaneous capture point. Contact gates compose inside each step: the
plugin's, the scenario's ``gate_seq``, the swing's, and, for a plugin with
switchable contacts, a smooth height gate per foot.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import dynamics, kinematics
from qppvm_tpu_torch.model.robot import RobotModel, RobotState
from qppvm_tpu_torch.opt import hierarchy, linalg, ns_inverse
from qppvm_tpu_torch.runtime.robot_interface import (contact_offsets_for,
                                                     ground_forces,
                                                     init_anchors,
                                                     stop_torques)

THETA_KEYS = ("swing", "t0", "dxy")


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


def _smoothstep(x):
    x = torch.clamp(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def make_swing_primitive(plugin, *, z_lift: float = 0.05,
                         t0_max: float = 0.3, dur_frac: float = 0.8,
                         dxy_max: float = 0.25, span_s: float = None,
                         swing_kp: float = 150.0, swing_w: float = 4.0,
                         postural_deweight: float = 0.05):
    """Footstep-recovery primitive: a low-dimensional decision ``theta``
    that schedules one swing inside the horizon, shared by the rollouts and
    the robot that executes the plan. Returns ``(apply, init_theta)``.

    ``theta`` holds one decision per batch item: "swing" (K, nc) logits
    (which feet swing), "t0" (K,) logit (when the swing starts), "dxy"
    (K, 2) (where the foothold moves). ``apply(refs_t, theta, t_frac)``
    takes the references of K items at horizon fraction ``t_frac``. Within
    the swing window, ph = clip((t_frac - t0) / dur_frac, 0, 1):

    - the unload envelope ramps the activation a_i g(ph) up over the first
      and down over the last 15% of the window; the contact gate is
      multiplied by (1 - a_i g)^2 (squared: a sigmoid's residual 1 - a
      would still let ForceReg press the swing foot down);
    - the foot reference lifts ``z_lift`` sin(pi phz) and advances ``dxy``
      by a smoothstep strictly inside the unloaded plateau (phz), with its
      velocity feedforward when ``span_s`` (the horizon in seconds) is
      given;
    - the swing foot's gains and weight ramp to ``swing_kp`` / ``swing_w``,
      and its leg's postural rows deweight to ``postural_deweight``.

    Everything is smooth in theta, so MPPI's average of sampled thetas
    stays meaningful. ``init_theta()`` is lean-only planning: swing logits
    at -4 (activation about 0.02), unbatched like a nominal plan."""
    from qppvm_tpu_torch.runtime.contact_switch import chain_joints

    links = plugin.contact_links
    model = plugin.model
    kw = dict(dtype=plugin.dtype, device=plugin.device)
    # actuated-joint mask of each foot's leg chain (postural deweight)
    leg_masks = torch.zeros((len(links), model.nj), **kw)
    for i, cl in enumerate(links):
        leg_masks[i, [j for j in chain_joints(model, cl) if j < model.nj]] = 1
    # the window: unload ramp over the first RAMP, lift strictly inside the
    # unloaded plateau
    RAMP = 0.15
    LIFT0, LIFT1 = RAMP, 1.0 - RAMP
    kd_swing = 2.0 * float(np.sqrt(swing_kp))

    def apply(refs_t, theta, t_frac):
        a = torch.sigmoid(theta["swing"])                     # (K, nc)
        t0 = torch.sigmoid(theta["t0"]) * t0_max              # (K,)
        ph = torch.clamp((t_frac - t0) / dur_frac, 0.0, 1.0)
        g_act = _smoothstep(ph / RAMP) * _smoothstep((1.0 - ph) / RAMP)
        phz = torch.clamp((ph - LIFT0) / (LIFT1 - LIFT0), 0.0, 1.0)
        box = torch.sin(torch.pi * phz)                       # lift profile
        smooth = _smoothstep(phz)                             # xy progress
        dxy = torch.clamp(theta["dxy"], -dxy_max, dxy_max)    # (K, 2)
        refs_t = dict(refs_t)
        act = a * g_act[:, None]                              # (K, nc)
        refs_t["contacts"] = {
            "active": refs_t["contacts"]["active"] * (1.0 - act) ** 2}
        dp = torch.cat([dxy * smooth[:, None], (z_lift * box)[:, None]], -1)
        dv = None
        if span_s is not None:
            # d/dt of the primitive's trajectory, in real seconds
            in_lift = (phz > 0.0) & (phz < 1.0)
            dphzdt = torch.where(
                in_lift, 1.0 / ((LIFT1 - LIFT0) * dur_frac * span_s), 0.0)
            dbox = torch.pi * torch.cos(torch.pi * phz) * dphzdt
            dsmooth = 6.0 * phz * (1.0 - phz) * dphzdt
            dv = torch.cat([dxy * dsmooth[:, None],
                            (z_lift * dbox)[:, None]], -1)
        for i, cl in enumerate(links):
            key = cl + "_cartesian"
            tr = dict(refs_t[key])
            ai = a[:, i, None]
            tr["p"] = tr["p"] + ai * dp
            if dv is not None:
                tr["v"] = torch.cat([tr["v"][:, :3] + ai * dv,
                                     tr["v"][:, 3:]], -1)
            tr["kp"] = tr["kp"] + act[:, i] * (swing_kp - tr["kp"])
            tr["kd"] = tr["kd"] + act[:, i] * (kd_swing - tr["kd"])
            tr["w"] = tr["w"] + act[:, i] * (swing_w - tr["w"])
            refs_t[key] = tr
        de = 1.0
        for i in range(len(links)):
            de = de * (1.0 - act[:, i, None] * (1.0 - postural_deweight)
                       * leg_masks[i])
        refs_t["POSTURAL"] = dict(refs_t["POSTURAL"],
                                  w=refs_t["POSTURAL"]["w"] * de)
        return refs_t

    def init_theta(dtype=None):
        tkw = dict(kw, dtype=dtype or plugin.dtype)
        return {"swing": torch.full((len(links),), -4.0, **tkw),
                "t0": torch.zeros((), **tkw),
                "dxy": torch.zeros((2,), **tkw)}

    return apply, init_theta


def make_capture_terminal_cost(plugin, *, weight: float = 600.0,
                               z_contact: float = 0.03,
                               sharpness: float = 0.008, far_m2: float = 4.0,
                               g: float = 9.81) -> Callable:
    """Instantaneous-capture-point terminal cost, the value beyond the
    horizon: ``term(model, state)`` -> (B,).

    The ICP xi = com_xy + com_vel_xy sqrt(com_z / g) is where the CoM
    settles if the robot only balances; a state is capturable when xi lies
    over the support. The cost is ``weight * smoothmin_i(|xi - p_i|^2 +
    (1 - w_i) far_m2)`` over the contact feet, w_i a sigmoid height gate
    (a foot in the air cannot capture; ``far_m2`` prices it as a support
    2 m away), the smooth min a logsumexp at temperature 1 cm^2."""
    contact_idx = [plugin.model.link_index(c) for c in plugin.contact_links]

    def term(model, state):
        kin = kinematics.fk(model, state)
        _, com_p = kinematics.com(model, kin)
        vel_all = kinematics.link_velocities(model, kin, state)
        com_v = kinematics.com_velocity(model, kin, state, vel_all)
        omega = torch.sqrt(torch.clamp(com_p[:, 2], min=0.05) / g)
        icp = com_p[:, :2] + com_v[:, :2] * omega[:, None]
        p_feet = kin.p[:, contact_idx]                        # (B, nc, 3)
        w = torch.sigmoid((z_contact - p_feet[..., 2]) / sharpness)
        d2 = (torch.sum((icp[:, None] - p_feet[..., :2]) ** 2, dim=-1)
              + (1.0 - w) * far_m2)
        tau_t = 1e-2
        return weight * (-tau_t * torch.logsumexp(-d2 / tau_t, dim=-1))

    return term


def make_rollout_fn(plugin, cfg: RolloutConfig, cost_fn: Callable,
                    swing=None, contact_offsets=None,
                    terminal_cost: Optional[Callable] = None):
    """Build ``rollout(state0, refs0, warm0, controls, scenario[, theta])``
    -> ``(cost (K,), health)`` for K samples.

    Every input is batched over the samples: ``state0`` a RobotState of
    batch K, ``refs0`` the plugin's references with a leading K, ``warm0``
    per-level QPStates of batch K, ``controls`` (K, H, 3) waist-reference
    velocity offsets integrated into the waist position reference each
    step. ``scenario``: "push" (K, H, 3) external base force [required];
    "mass_scale" (K,) scales the simulated robot's inertia while the
    controller keeps the nominal model; "mu_scale" (K,) scales cfg.mu;
    "gate_seq" (K, H, nc) multiplies the contact gates step by step (a
    plugin with switchable contacts).
    ``swing``: a footstep primitive (``make_swing_primitive``'s apply),
    applied each step with the sample's ``theta`` ("swing" (K, nc), "t0"
    (K,), "dxy" (K, 2)). ``terminal_cost(model, state)`` -> (K,) is added
    on the final state. ``contact_offsets``: the plant's foot patches
    (SimRobot convention).
    With switchable contacts each step also gates every foot by its height,
    sigmoid((0.01 - z) / 0.004): a foot in the air cannot carry its
    fz >= fz_min bound, and a toppling rollout would be infeasible by
    construction otherwise.
    ``health``: "prim_res_max" (K,) and "solver_failed" (K,) over the
    horizon. The rollout also carries ``one_step``, ``init_carry`` and
    ``solver_opts``."""
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
        pinv_ns_iters=cfg.qp_pinv_ns_iters)

    def one_step(carry, inp):
        state, refs, warm, waist_p, binv, anchors, scen, theta = carry
        u_ctrl, push, gate_t, t_frac = inp
        waist_p = waist_p + u_ctrl * cfg.dt
        refs_t = dict(refs)
        refs_t["waist_task"] = dict(refs_t["waist_task"], p=waist_p)
        # gates: the plugin's, the scenario's, the swing's, the feet heights'
        if gate_t is not None:
            refs_t["contacts"] = {
                "active": refs_t["contacts"]["active"] * gate_t}
        if swing is not None and theta is not None:
            refs_t = swing(refs_t, theta, t_frac)
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
        xy at the start state; ``theta`` rides in the last leaf."""
        state0, refs0, scen = _pin(state0, refs0, scenario or {},
                                   state0.batch)
        if theta is not None:
            theta = {k: torch.as_tensor(v, dtype=plugin.dtype,
                                        device=state0.q.device)
                     for k, v in theta.items()}
        M0 = dynamics.mass_matrix(model, state0)
        binv0 = ns_inverse.spd_inverse(M0 + 1e-9 * torch.eye(
            model.nv, dtype=M0.dtype, device=M0.device))
        anchors0 = init_anchors(model, state0, contact_idx, contact_offs,
                                plugin.dtype)
        return (state0, refs0, warm0, refs0["waist_task"]["p"], binv0,
                anchors0, scen, theta)

    def rollout(state0: RobotState, refs0, warm0, controls, scenario,
                theta=None):
        carry = init_carry(state0, refs0, warm0, scenario, theta)
        dev = carry[0].q.device
        as_t = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=plugin.dtype, device=dev)
        push = as_t(scenario["push"])
        controls = as_t(controls)
        gate_seq = scenario.get("gate_seq")
        gate_seq = None if gate_seq is None else as_t(gate_seq)
        H = push.shape[1]
        t_fracs = (torch.arange(H, dtype=plugin.dtype, device=dev) + 0.5) / H
        costs, prims, fails = [], [], []
        for t in range(H):
            gate_t = None if gate_seq is None else gate_seq[:, t]
            with telemetry.span("rollout.step"):
                carry, (c, prim, failed) = one_step(
                    carry, (controls[:, t], push[:, t], gate_t, t_fracs[t]))
            costs.append(c)
            prims.append(prim)
            fails.append(failed)
        health = {"prim_res_max": torch.amax(torch.stack(prims), dim=0),
                  "solver_failed": torch.stack(fails).any(dim=0)}
        total = torch.stack(costs).sum(dim=0)
        if terminal_cost is not None:
            # the value beyond the horizon, on the final state
            total = total + terminal_cost(model, carry[0])
        return total, health

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
