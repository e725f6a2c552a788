"""ForceAcc: floating-base whole-body control with contact force variables
(port of qppvm_tpu/plugins/force_acc.py, point-contact stack).

Decision variable x = [qddot(nv); f_c(3) per contact]. Stack: (waist
Cartesian) / (postural + feet Cartesian + ForceReg) << dynamic feasibility
<< wrench bounds (unilateral f_z >= fz_min), solver eps = 1e4. Per tick:
model update -> stack build -> cascade solve -> tau = ID(qddot) - sum J_c^T
f_c on the actuated rows, zeroed for items whose solve failed.

Every tick input carries a leading batch dimension B; on_start seeds the
warm state for the batch it is given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from qppvm_tpu_torch.model import dynamics
from qppvm_tpu_torch.model.robot import RobotModel, RobotState
from qppvm_tpu_torch.opt import hierarchy
from qppvm_tpu_torch.opt.variables import Optvar
from qppvm_tpu_torch.tasks.acceleration import Cartesian, Postural
from qppvm_tpu_torch.tasks.base import AssembleCtx
from qppvm_tpu_torch.tasks.force import CoM, ForceReg
from qppvm_tpu_torch.tasks.generic import DynamicFeasibility, GenericConstraint


@dataclasses.dataclass(frozen=True)
class ForceAccAux:
    """Per-tick observables, batched."""

    tau: torch.Tensor                # (B, nj) commanded torque
    tau_c: torch.Tensor              # (B, nj) contact-torque contribution
    qddot: torch.Tensor              # (B, nv)
    wrenches: torch.Tensor           # (B, n_contacts, 3)
    dyn_feas_residual: torch.Tensor  # (B, 6)
    solver_failed: torch.Tensor      # (B,) bool
    prim_res: torch.Tensor           # (B,)


class ForceAccPlugin:
    # RT-loop failure gate on the relative primal residual
    RT_FAIL_TOL = 5e-3

    def __init__(self, model: RobotModel, *,
                 contact_links: Sequence[str] = ("foot_fl", "foot_fr",
                                                 "foot_hr", "foot_hl"),
                 waist_link: str = "pelvis", eps: float = 1e4,
                 iters: int = 100, eps_abs_scale: float = 1e-5,
                 fz_min: float = 10.0, waist_kp: float = 100.0,
                 postural_kp: float = 25.0, force_reg_weight: float = 0.1,
                 wrench_reg_scale: float = 0.02, com_kp: float = 25.0,
                 com_kd: float = 10.0, dtype=torch.float32,
                 solver_opts: Optional[Dict[str, Any]] = None):
        """The reference's default stack: point contacts (3 force components
        each), a wrench box, a hard waist level. Its other options (friction
        cones, 6D wrenches, CoP box, joint acceleration limits, switchable
        contacts, soft waist, CoM task in the stack, static force share,
        position-only feet) are not ported yet. ``solver_opts`` override the
        RT-loop solver keywords, e.g. ``backend="kernel"``."""
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
        self.solver_opts = dict(refine=2, rho_updates=1, polish_rounds=0,
                                assume_warm_kinv=True, polish_ns_iters=16,
                                warm_kinv_iters=8, rho_adapt_tol=1e-3,
                                rho_scale_min=0.1,
                                eps_abs_scale=self.eps_abs_scale)
        self.solver_opts.update(solver_opts or {})

        nv = model.nv
        self.wrench_dim = 3
        self.opt = Optvar([("qddot", nv)] + [(cl, 3) for cl in contact_links],
                          dtype=dtype, device=self.device)
        self.qddot = self.opt["qddot"]
        self.wrenches = [self.opt[cl] for cl in contact_links]
        # proximal weight: full on qddot, wrench_reg_scale on the wrenches so
        # ForceReg governs the force nullspace
        self.reg_diag = torch.ones(self.opt.size, dtype=dtype,
                                   device=self.device)
        if force_reg_weight > 0.0:
            self.reg_diag[nv:] = wrench_reg_scale
        self.solver_opts["reg_diag"] = self.reg_diag

        self.feet_tasks = [Cartesian(cl + "_cartesian", cl, self.qddot,
                                     kp=postural_kp)
                           for cl in contact_links]
        self.waist_task = Cartesian("waist_task", waist_link, self.qddot,
                                    kp=waist_kp)
        self.postural = Postural("POSTURAL", self.qddot, kp=postural_kp)
        # the CoM task is kept out of the stack (as by default in the
        # reference); on_start captures its references
        self.com_task = CoM("COM", self.wrenches, contact_links, kp=com_kp,
                            kd=com_kd)
        self.dyn_feas = DynamicFeasibility("DYN_FEAS", self.qddot,
                                           self.wrenches, contact_links)
        wrench_constraints = [
            GenericConstraint(cl + "_bound", w, [1000.0, 1000.0, 1000.0],
                              [-1000.0, -1000.0, fz_min])
            for cl, w in zip(contact_links, self.wrenches)]

        level2 = self.postural
        for t in self.feet_tasks:
            level2 = level2 + t
        self.force_reg = None
        if force_reg_weight > 0.0:
            self.force_reg = ForceReg(
                "FORCE_REG", self.wrenches, w_tan=force_reg_weight,
                w_norm=0.5 * force_reg_weight)
            level2 = level2 + self.force_reg
        stack = (self.waist_task / level2) << self.dyn_feas
        for c in wrench_constraints:
            stack = stack << c
        self.stack = stack

    def on_start(self, state: RobotState):
        """Capture the references and seed the warm state for ``state``'s
        batch. Two-phase seed: a cold polished solve with the proximal term
        centred on the equal-share support forces, then a re-solve with the
        deployment regularization centred on that solution, so the carried
        warm state (incl. KKT inverses) matches the RT solves."""
        data = dynamics.compute_model_data(self.model, state)
        refs = self.stack.ref_init(self.model, data, state)
        refs["COM"] = self.com_task.ref_init(self.model, data, state)
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
        backend = self.solver_opts.get("backend", "torch")
        _, warm, _ = hierarchy.solve(stack_data, warm0, eps=self.eps,
                                     eps_abs_scale=1e-8, iters=self.iters,
                                     refine=2, backend=backend)
        _, warm, _ = hierarchy.solve(stack_data, warm, eps=self.eps,
                                     eps_abs_scale=self.eps_abs_scale,
                                     reg_diag=self.reg_diag, iters=self.iters,
                                     refine=2, backend=backend)
        return refs, warm, refs["waist_task"]["p"]

    def step_core(self, state: RobotState, refs, warm, *,
                  solver_opts: Optional[Dict[str, Any]] = None):
        """Model update -> stack build -> cascade solve -> (tau, qddot,
        wrenches). Returns ``(tau, warm_new, infos, parts)`` with ``parts =
        (data, x, qddot, wrenches, tau_c_full)``; ``tau`` is the raw
        actuated-row torque."""
        model = self.model
        data = dynamics.compute_model_data(model, state)
        stack_data = self.stack.build(model, data, state, refs,
                                      nx=self.opt.size, dtype=self.dtype)
        opts = dict(self.solver_opts, iters=self.iters)
        opts.update(solver_opts or {})
        iters = opts.pop("iters")
        x, warm_new, infos = hierarchy.solve(stack_data, warm, eps=self.eps,
                                             iters=iters, **opts)
        qddot = self.qddot.value(x)
        wr = torch.stack([w.value(x) for w in self.wrenches], dim=1)
        tau_c_full = torch.zeros((state.batch, model.nv), dtype=self.dtype,
                                 device=self.device)
        for cl, w in zip(self.contact_links, self.wrenches):
            Jc = dynamics.frame_data(model, data, cl)[2][:, :3]   # (B, 3, nv)
            tau_c_full = tau_c_full + (Jc.transpose(-1, -2)
                                       @ w.value(x)[..., None])[..., 0]
        tau_full = dynamics.rnea(model, state, qddot, gravity=True,
                                 kin=data.kin)
        tau = (tau_full - tau_c_full)[:, 6:]
        return tau, warm_new, infos, (data, x, qddot, wr, tau_c_full)

    def _step_impl(self, state: RobotState, refs, warm):
        """One batched RT tick: (tau, warm_new, aux); tau is zeroed for the
        items whose solve failed."""
        tau, warm_new, infos, (data, x, qddot, wr, tau_c_full) = \
            self.step_core(state, refs, warm)
        failed = hierarchy.solve_failed(infos, tol=self.RT_FAIL_TOL)
        tau = torch.where(failed[:, None], torch.zeros_like(tau), tau)
        ctx = AssembleCtx(model=self.model, data=data, state=state, refs=refs,
                          nx=self.opt.size, dtype=self.dtype)
        aux = ForceAccAux(
            tau=tau, tau_c=tau_c_full[:, 6:], qddot=qddot, wrenches=wr,
            dyn_feas_residual=self.dyn_feas.check_constraint(ctx, x),
            solver_failed=failed,
            prim_res=torch.amax(torch.stack([i.prim_res for i in infos]),
                                dim=0))
        return tau, warm_new, aux
