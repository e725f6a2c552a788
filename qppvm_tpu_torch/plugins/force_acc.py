"""ForceAcc: floating-base whole-body control with contact force variables
(port of qppvm_tpu/plugins/force_acc.py).

Decision variable x = [qddot(nv); f_c(wrench_dim) per contact]. The
reference's stack: (waist Cartesian) / (postural + feet Cartesian +
ForceReg) << dynamic feasibility << wrench bounds (unilateral f_z >=
fz_min), solver eps = 1e4. Options swap the wrench box for friction cones
(with a moment box or a CoP box on 6D wrenches), gate the contacts, add
joint acceleration limits, put the CoM task in the stack, fold the waist
into one level at a weight, anchor ForceReg at the quasi-static share, and
keep only the position rows of the feet tasks. Per tick: model update ->
stack build -> cascade solve -> tau = ID(qddot) - sum J_c^T f_c on the
actuated rows, zeroed for items whose solve failed.

Every tick input carries a leading batch dimension B; on_start seeds the
warm state for the batch it is given.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict, Optional, Sequence

import torch

from qppvm_tpu_torch import device as device_lib
from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import dynamics
from qppvm_tpu_torch.model.robot import RobotModel, RobotState
from qppvm_tpu_torch.opt import hierarchy
from qppvm_tpu_torch.opt.variables import Optvar
from qppvm_tpu_torch.runtime import tick_graph
from qppvm_tpu_torch.tasks.acceleration import Cartesian, Postural
from qppvm_tpu_torch.tasks.base import AssembleCtx, Indices, SubTask
from qppvm_tpu_torch.tasks.force import CoM, ForceReg
from qppvm_tpu_torch.tasks.generic import (CoPBox, DynamicFeasibility,
                                          FrictionCone, GenericConstraint,
                                          JointAccLimits)


@dataclasses.dataclass(frozen=True)
class ForceAccAux:
    """Per-tick observables, batched."""

    tau: torch.Tensor                # (B, nj) commanded torque
    tau_c: torch.Tensor              # (B, nj) contact-torque contribution
    qddot: torch.Tensor              # (B, nv)
    wrenches: torch.Tensor           # (B, n_contacts, wrench_dim)
    dyn_feas_residual: torch.Tensor  # (B, 6)
    solver_failed: torch.Tensor      # (B,) bool
    prim_res: torch.Tensor           # (B,)


class ForceAccPlugin(device_lib.Settings):
    # RT-loop failure gate on the relative primal residual
    RT_FAIL_TOL = 5e-3

    def __init__(self, model: RobotModel, *,
                 contact_links: Sequence[str] = ("foot_fl", "foot_fr",
                                                 "foot_hr", "foot_hl"),
                 waist_link: str = "pelvis", eps: float = 1e4,
                 iters: int = 100, eps_abs_scale: float = 1e-5,
                 fz_min: float = 10.0,
                 use_friction_cones: bool = False, mu: float = 0.7,
                 waist_kp: float = 100.0, postural_kp: float = 25.0,
                 force_reg_weight: float = 0.1,
                 wrench_reg_scale: float = 0.02,
                 force_share_mode: str = "gate",
                 waist_priority: str = "hard", waist_weight: float = 4.0,
                 switchable_contacts: bool = False, wrench_dim: int = 3,
                 foot_tasks_6d: bool = True,
                 use_com_task: bool = False, com_task_weight: float = 1.0,
                 com_kp: float = 25.0, com_kd: float = 10.0,
                 use_joint_limits: bool = False,
                 moment_box: Sequence[float] = (30.0, 30.0, 10.0),
                 cop_box: Optional[Sequence[float]] = None,
                 dtype=torch.float32,
                 solver_opts: Optional[Dict[str, Any]] = None):
        """Options, with the reference's defaults:

        - ``wrench_dim``: 3 = point contacts (the reference's), 6 = a full
          wrench per contact (linear first);
        - ``use_friction_cones`` (``mu``): pyramid cones on the force rows
          in place of the box; with 6D wrenches the moments get the
          fz-proportional ``cop_box`` = (x_min, x_max, y_half, t_coef) if
          given, else the static ``moment_box``;
        - without cones the box is +/-1000 N with f_z >= ``fz_min``, and
          +/-``moment_box`` on 6D moments;
        - ``switchable_contacts``: every wrench constraint and ForceReg
          read the gates ``refs["contacts"]["active"]`` (B, nc), which
          on_start seeds with ones;
        - ``foot_tasks_6d`` False: position-only feet tasks (rows 0-2);
        - ``use_com_task``: the CoM task, at ``com_task_weight``, joins the
          postural level;
        - ``use_joint_limits``: JointAccLimits on the actuated rows;
        - ``waist_priority`` "hard": waist / rest, two levels; "soft": one
          level with the waist at ``waist_weight``;
        - ``force_share_mode``: ForceReg's "gate" or "static" share.

        ``solver_opts`` override the RT-loop solver keywords, e.g.
        ``rho_updates=0`` (the level kernel's profile)."""
        if not model.floating:
            raise ValueError("ForceAcc needs a floating-base model")
        self.model = model
        self.dtype = dtype
        self.device = model.device
        self.eps = eps
        self.eps_abs_scale = eps_abs_scale
        self.iters = iters
        self.contact_links = tuple(contact_links)
        self.waist_link = waist_link
        opts = dict(refine=2, rho_updates=1, polish_rounds=0,
                    assume_warm_kinv=True, polish_ns_iters=16,
                    warm_kinv_iters=8, rho_adapt_tol=1e-3, rho_scale_min=0.1,
                    eps_abs_scale=self.eps_abs_scale)
        opts.update(solver_opts or {})

        nv = model.nv
        self.wrench_dim = int(wrench_dim)
        self.opt = Optvar([("qddot", nv)]
                          + [(cl, self.wrench_dim) for cl in contact_links],
                          dtype=dtype, device=self.device)
        self.qddot = self.opt["qddot"]
        self.wrenches = [self.opt[cl] for cl in contact_links]
        # proximal weight: full on qddot, wrench_reg_scale on the wrenches so
        # ForceReg governs the force nullspace
        self.reg_diag = torch.ones(self.opt.size, dtype=dtype,
                                   device=self.device)
        if force_reg_weight > 0.0:
            self.reg_diag[nv:] = wrench_reg_scale
        opts["reg_diag"] = self.reg_diag
        # read-only: a change assigns the options anew (device.Settings)
        self.solver_opts = types.MappingProxyType(opts)

        foot_rows = None if foot_tasks_6d else (0, 1, 2)
        self.feet_tasks = [Cartesian(cl + "_cartesian", cl, self.qddot,
                                     kp=postural_kp, indices=foot_rows)
                           for cl in contact_links]
        self.waist_task = Cartesian("waist_task", waist_link, self.qddot,
                                    kp=waist_kp)
        self.postural = Postural("POSTURAL", self.qddot, kp=postural_kp)
        # built always (on_start captures its references); in the stack
        # only with use_com_task
        self.com_task = CoM("COM", self.wrenches, contact_links, kp=com_kp,
                            kd=com_kd)
        self.com_task.weight = com_task_weight
        self.use_com_task = use_com_task
        self.dyn_feas = DynamicFeasibility("DYN_FEAS", self.qddot,
                                           self.wrenches, contact_links)
        self.switchable_contacts = switchable_contacts
        gates = ([("contacts", i) for i in range(len(contact_links))]
                 if switchable_contacts else [None] * len(contact_links))
        wrench_constraints = self._wrench_constraints(
            gates, use_friction_cones, mu, fz_min, moment_box, cop_box)

        # position / orientation splits of the feet and waist tasks, built
        # and kept out of the stack, as the reference's
        self.feet_pos = [SubTask(t, Indices.range(0, 2))
                         for t in self.feet_tasks]
        self.waist_pos = SubTask(self.waist_task, Indices.range(0, 2))
        self.waist_or = SubTask(self.waist_task, Indices.range(3, 5))

        level2 = self.postural
        for t in self.feet_tasks:
            level2 = level2 + t
        if use_com_task:
            level2 = level2 + self.com_task
        self.waist_priority = waist_priority
        if waist_priority == "soft":
            self.waist_task.weight = waist_weight
            level2 = level2 + self.waist_task
        self.force_reg = None
        if force_reg_weight > 0.0:
            self.force_reg = ForceReg(
                "FORCE_REG", self.wrenches, w_tan=force_reg_weight,
                w_norm=0.5 * force_reg_weight,
                gates_key="contacts" if switchable_contacts else None,
                share_mode=force_share_mode,
                contact_links=list(contact_links))
            level2 = level2 + self.force_reg
        if waist_priority == "soft":
            stack = level2 << self.dyn_feas
        else:
            stack = (self.waist_task / level2) << self.dyn_feas
        self.joint_limits = None
        if use_joint_limits:
            self.joint_limits = JointAccLimits("JOINT_ACC_LIMITS",
                                               self.qddot)
            stack = stack << self.joint_limits
        for c in wrench_constraints:
            stack = stack << c
        self.stack = stack
        self._graph = tick_graph.TickGraph(self._tick_body, settings=self)

    def _wrench_constraints(self, gates, use_friction_cones, mu, fz_min,
                            moment_box, cop_box):
        """Per contact: friction cone (+ moment or CoP box on a 6D wrench),
        or the reference's wrench box."""
        pairs = list(zip(self.contact_links, self.wrenches, gates))
        if not use_friction_cones:
            ub, lb = [1000.0] * 3, [-1000.0, -1000.0, fz_min]
            if self.wrench_dim == 6:
                ub, lb = ub + list(moment_box), lb + [-m for m in moment_box]
            return [GenericConstraint(cl + "_bound", w, ub, lb, gate=g)
                    for cl, w, g in pairs]
        out = [FrictionCone(cl + "_cone", w.rows([0, 1, 2]), mu=mu,
                            f_min=fz_min, gate=g) for cl, w, g in pairs]
        if self.wrench_dim != 6:
            return out
        if cop_box is not None:
            xm, xM, yh, tc = cop_box
            return out + [CoPBox(cl + "_cop", w, x_min=xm, x_max=xM,
                                 y_half=yh, t_coef=tc, gate=g)
                          for cl, w, g in pairs]
        mb = list(moment_box)
        return out + [GenericConstraint(cl + "_moment", w.rows([3, 4, 5]),
                                        mb, [-m for m in mb], gate=g)
                      for cl, w, g in pairs]

    def drive_pd_profile(self, robot_k, robot_d):
        """The drive-level (k, d) to set before handing the robot to the
        QP: the reference softens the drive PD to k / 16, d / 4."""
        kw = dict(dtype=self.dtype, device=self.device)
        return (torch.as_tensor(robot_k, **kw) / 16.0,
                torch.as_tensor(robot_d, **kw) / 4.0)

    def on_start(self, state: RobotState):
        """Capture the references and seed the warm state for ``state``'s
        batch. Two-phase seed: a cold polished solve with the proximal term
        centred on the equal-share support forces, then a re-solve with the
        deployment regularization centred on that solution, so the carried
        warm state (incl. KKT inverses) matches the RT solves. The model
        update runs the plain sweeps (``compute_model_data``'s
        ``plain_sweeps`` says why); the ticks run the kernel's."""
        data = dynamics.compute_model_data(self.model, state,
                                           plain_sweeps=True)
        refs = self.stack.ref_init(self.model, data, state)
        refs["COM"] = self.com_task.ref_init(self.model, data, state)
        if self.switchable_contacts:
            refs["contacts"] = {"active": torch.ones(
                (state.batch, len(self.contact_links)), dtype=self.dtype,
                device=self.device)}
        stack_data = self.stack.build(self.model, data, state, refs,
                                      nx=self.opt.size, dtype=self.dtype)
        self.stack.validate(stack_data)
        g_mag = torch.linalg.norm(self.model.gravity.to(self.dtype))
        share = data.total_mass * g_mag / len(self.contact_links)   # (B,)
        x_share = torch.zeros((state.batch, self.opt.size), dtype=self.dtype,
                              device=self.device)
        for wr in self.wrenches:
            e = torch.zeros((state.batch, wr.size), dtype=self.dtype,
                            device=self.device)
            e[:, 2] = share
            x_share = x_share + e @ wr.M
        warm0 = tuple(dataclasses.replace(s, x=x_share)
                      for s in hierarchy.warm_start_init(stack_data))
        _, warm, _ = hierarchy.solve(stack_data, warm0, eps=self.eps,
                                     eps_abs_scale=1e-8, iters=self.iters,
                                     refine=2)
        _, warm, _ = hierarchy.solve(stack_data, warm, eps=self.eps,
                                     eps_abs_scale=self.eps_abs_scale,
                                     reg_diag=self.reg_diag, iters=self.iters,
                                     refine=2)
        return refs, warm, refs["waist_task"]["p"]

    def squat_refs(self, refs, initial_waist, depth: float = 0.1):
        """``refs`` with the waist reference at ``initial_waist`` lowered
        by ``depth`` (the reference's squat)."""
        refs = dict(refs)
        wt = dict(refs["waist_task"])
        wt["p"] = initial_waist - torch.tensor(
            [0.0, 0.0, depth], dtype=initial_waist.dtype,
            device=initial_waist.device)
        refs["waist_task"] = wt
        return refs

    def control_loop(self, state: RobotState, refs: Dict[str, Any], warm):
        """The RT tick (``_step_impl``)."""
        return self._step_impl(state, refs, warm)

    def close(self) -> None:
        """Lifecycle hook of the reference's plugin. The warm state lives
        with the caller, so the plugin holds nothing to release."""

    def step_core(self, state: RobotState, refs, warm, *,
                  solver_opts: Optional[Dict[str, Any]] = None):
        """Model update -> stack build -> cascade solve -> (tau, qddot,
        wrenches). Returns ``(tau, warm_new, infos, parts)`` with ``parts =
        (data, x, qddot, wrenches, tau_c_full)``; ``tau`` is the raw
        actuated-row torque: the inverse dynamics ``B qddot + h`` from the
        model data, less ``sum J_c^T f_c``."""
        model = self.model
        data = dynamics.compute_model_data(model, state)
        stack_data = self.stack.build(model, data, state, refs,
                                      nx=self.opt.size, dtype=self.dtype)
        opts = dict(self.solver_opts, iters=self.iters)
        opts.update(solver_opts or {})
        iters = opts.pop("iters")
        x, warm_new, infos = hierarchy.solve(stack_data, warm, eps=self.eps,
                                             iters=iters, **opts)
        with telemetry.span("torque"):
            qddot = self.qddot.value(x)
            wr = torch.stack([w.value(x) for w in self.wrenches], dim=1)
            tau_c_full = torch.zeros((state.batch, model.nv),
                                     dtype=self.dtype, device=self.device)
            for cl, w in zip(self.contact_links, self.wrenches):
                Jc = dynamics.frame_data(model, data,
                                         cl)[2][:, :self.wrench_dim]
                tau_c_full = tau_c_full + (Jc.transpose(-1, -2)
                                           @ w.value(x)[..., None])[..., 0]
            # inverse dynamics; B includes the armature, as rnea does
            tau_full = (data.B @ qddot[..., None])[..., 0] + data.h
            tau = (tau_full - tau_c_full)[:, 6:]
        return tau, warm_new, infos, (data, x, qddot, wr, tau_c_full)

    def _step_impl(self, state: RobotState, refs, warm):
        """One batched RT tick: (tau, warm_new, aux); tau is zeroed for the
        items whose solve failed. The span ``tick`` opens a unit of the
        program's telemetry. A tick whose inputs runtime/tick_graph.py's
        rule takes (float32 on one CUDA device, no gradient) replays a CUDA
        graph of ``_tick_body``; any other runs it eagerly."""
        with telemetry.span("tick"):
            return self._graph(state, refs, warm)

    def _tick_body(self, state: RobotState, refs, warm):
        tau, warm_new, infos, (data, x, qddot, wr, tau_c_full) = \
            self.step_core(state, refs, warm)
        with telemetry.span("aux"):
            failed = hierarchy.solve_failed(infos, tol=self.RT_FAIL_TOL)
            tau = torch.where(failed[:, None], torch.zeros_like(tau), tau)
            ctx = AssembleCtx(model=self.model, data=data, state=state,
                              refs=refs, nx=self.opt.size, dtype=self.dtype)
            aux = ForceAccAux(
                tau=tau, tau_c=tau_c_full[:, 6:], qddot=qddot, wrenches=wr,
                dyn_feas_residual=self.dyn_feas.check_constraint(ctx, x),
                solver_failed=failed,
                prim_res=torch.amax(
                    torch.stack([i.prim_res for i in infos]), dim=0))
        return tau, warm_new, aux
