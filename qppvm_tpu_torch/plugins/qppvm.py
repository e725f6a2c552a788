"""QPPVM: QP priority-based virtual-model control at the torque level
(port of qppvm_tpu/plugins/qppvm.py), for fixed-base robots.

The stack: (right EE + left EE Cartesian impedance, position rows 0-2,
Kc = 700 I, Dc = 70 I, inertia-weighted) / (joint impedance K = 5, D = 2,
inertia-weighted) << torque limits. Per tick: model update (with the mass
matrix's inverse) -> stack build (torque bounds tau_const -/+ h) -> the
two-level cascade at eps 1 -> tau_qp zeroed where the solve failed ->
tau = tau_qp + h (gravity and Coriolis compensation, on a failed solve
too). on_start captures the current EE poses and joint configuration as
references (bumpless start) and seeds the warm state with one cold,
polished solve. ``make_refs`` is the reference's moving sinusoid on the
left EE.

Every tick input carries a leading batch dimension B.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict, Optional

import torch

from qppvm_tpu_torch import device as device_lib
from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import dynamics
from qppvm_tpu_torch.model.robot import RobotModel, RobotState
from qppvm_tpu_torch.opt import hierarchy
from qppvm_tpu_torch.runtime import tick_graph, trajectory
from qppvm_tpu_torch.tasks.base import AssembleCtx, Indices
from qppvm_tpu_torch.tasks.torque import (CartesianImpedanceCtrl,
                                          JointImpedanceCtrl, TorqueLimits)


@dataclasses.dataclass(frozen=True)
class QPPVMAux:
    """Per-tick observables, batched (the reference's logged channels)."""

    tau_qp: torch.Tensor         # (B, nj) torque from the QP, before + h
    tau_desired: torch.Tensor    # (B, nj) commanded torque, tau_qp + h
    h: torch.Tensor              # (B, nj) nonlinear term
    solver_failed: torch.Tensor  # (B,) bool
    prim_res: torch.Tensor       # (B,)
    ee_left_err: torch.Tensor    # (B, 6) spring + damper wrench, left EE
    ee_right_err: torch.Tensor   # (B, 6) the same, right EE


class QPPVMPlugin(device_lib.Settings):
    # On a failed solve the reference zeroes tau_qp, still adds h and
    # commands the result (gravity compensation); runtime/plugin.py's
    # ControlLoop then commands on every tick.
    failure_policy = "command"
    # failure gate on the relative primal residual
    FAIL_TOL = 5e-3

    def __init__(self, model: RobotModel, *,
                 left_ee: str = "arm1_7", right_ee: str = "arm2_7",
                 cart_stiffness: float = 700.0, cart_damping: float = 70.0,
                 joint_stiffness: float = 5.0, joint_damping: float = 2.0,
                 eps: float = 1.0, iters: int = 100, dtype=torch.float32,
                 sine_ref: bool = False,
                 solver_opts: Optional[Dict[str, Any]] = None):
        """``solver_opts`` are merged over the RT-loop solver keywords,
        e.g. ``{"rho_updates": 0}`` for the level kernel's profile."""
        if model.floating:
            raise ValueError("QPPVM is a fixed-base controller")
        self.model = model
        self.dtype = dtype
        self.device = model.device
        self.eps = eps
        self.iters = iters
        self.sine_ref = sine_ref
        # The RT-loop profile. polish_rounds 0: in the warm-started loop
        # the polish's acceptance guard rejects it with the residuals
        # unchanged, so it costs time for nothing; on_start keeps the full
        # polish for the seed. rho_updates 1: one rho adaptation a tick
        # (the KKT inverse then rebuilt cold once); rho_updates 0 skips that
        # and is the level kernel's profile, to be validated in closed loop
        # per deployment. rho_adapt_tol / rho_scale_min gate the carried rho
        # adaptation on the residuals' size and floor it at 0.1: ungated,
        # converged ticks drift rho_scale to its floor on the noise ratio
        # sqrt(prim / dual), and a transient bound activation (the
        # sinusoid's peak acceleration) then spikes the primal residual past
        # the failure gate for a tick.
        opts = dict(refine=2, rho_updates=1, polish_rounds=0,
                    assume_warm_kinv=True, polish_ns_iters=16,
                    warm_kinv_iters=12, rho_adapt_tol=1e-3, rho_scale_min=0.1)
        opts.update(solver_opts or {})
        # read-only: a change assigns the options anew (device.Settings)
        self.solver_opts = types.MappingProxyType(opts)

        nj = model.nj
        kw = dict(dtype=dtype, device=self.device)
        Kc = torch.eye(6, **kw) * cart_stiffness
        Dc = torch.eye(6, **kw) * cart_damping
        pos = Indices.range(0, 2)

        def impedance(name, link):
            return CartesianImpedanceCtrl(name, link, indices=pos,
                                          stiffness=Kc, damping=Dc,
                                          use_inertia_matrix=True)

        self.ee_left = impedance("LEFT_ARM", left_ee)
        self.ee_right = impedance("RIGHT_ARM", right_ee)
        # the elbow pair, built and kept out of the stack as the
        # reference's; its links resolve only when it is assembled
        self.elbow_left = impedance("ELBOW_LEFT",
                                    left_ee.rsplit("_", 1)[0] + "_4")
        self.elbow_right = impedance("ELBOW_RIGHT",
                                     right_ee.rsplit("_", 1)[0] + "_4")
        self.joint_task = JointImpedanceCtrl(
            stiffness=torch.full((nj,), joint_stiffness, **kw),
            damping=torch.full((nj,), joint_damping, **kw),
            use_inertia_matrix=True)
        self.torque_limits = TorqueLimits()
        self.stack = ((self.ee_right + self.ee_left)
                      / self.joint_task) << self.torque_limits
        self._graph = tick_graph.TickGraph(self._tick_body, settings=self)

    def drive_pd_profile(self, robot_k, robot_d,
                         keep_joints=("j_arm1_5", "j_arm1_6", "j_arm1_7",
                                      "j_arm2_5", "j_arm2_6", "j_arm2_7")):
        """The drive-level (k, d) to set when handing the robot to the QP:
        zero, so the QP torques act unopposed, except on ``keep_joints``
        (the wrists), which keep their drive PD. Names the model lacks are
        skipped."""
        kw = dict(dtype=self.dtype, device=self.device)
        robot_k = torch.as_tensor(robot_k, **kw)
        robot_d = torch.as_tensor(robot_d, **kw)
        keep = torch.zeros(self.model.nj, dtype=torch.bool,
                           device=self.device)
        for name in keep_joints:
            if name in self.model.joint_names:
                keep[self.model.dof_index(name)] = True
        return (torch.where(keep, robot_k, 0.0),
                torch.where(keep, robot_d, 0.0))

    # --- lifecycle ------------------------------------------------------
    def on_start(self, state: RobotState):
        """Capture the references at ``state`` and seed the warm state
        with one cold, polished solve (the default profile's 3 rho updates
        and 2 polish rounds), so the RT loop starts hot from tick 0.
        Returns (refs, warm, start_pose), start_pose the left EE's
        references."""
        data = dynamics.compute_model_data(self.model, state, need_binv=True)
        refs = self.stack.ref_init(self.model, data, state)
        stack_data = self.stack.build(self.model, data, state, refs,
                                      nx=self.model.nj, dtype=self.dtype)
        _, warm, _ = hierarchy.solve(
            stack_data, hierarchy.warm_start_init(stack_data), eps=self.eps,
            iters=self.iters, refine=2)
        return refs, warm, dict(refs["LEFT_ARM"])

    def make_refs(self, start_pose, t, t0=0.0):
        """The left EE's references on the reference's moving sinusoid:
        y += 0.15 sin(t - t0), z += 0.15 (1 - cos(t - t0))."""
        p = start_pose["p"]
        return {"R": start_pose["R"],
                "p": trajectory.qppvm_sinusoid(p, t, t0),
                "v": torch.zeros(p.shape[:-1] + (6,), dtype=p.dtype,
                                 device=p.device)}

    def control_loop(self, state: RobotState, refs: Dict[str, Any], warm):
        """One tick: (tau_desired, new_warm, aux). The span ``tick`` opens
        a unit of the program's telemetry."""
        with telemetry.span("tick"):
            return self._step_impl(state, refs, warm)

    def close(self) -> None:
        """Lifecycle hook of the reference's plugin; the trace flush lives
        in ControlLoop.close, and the warm state with the caller, so the
        plugin holds nothing to release."""

    # --- the tick -------------------------------------------------------
    def _step_impl(self, state: RobotState, refs, warm):
        """One tick: a CUDA graph of ``_tick_body`` replayed where
        runtime/tick_graph.py's rule takes the inputs (float32 on one CUDA
        device, no gradient), else ``_tick_body`` run eagerly."""
        return self._graph(state, refs, warm)

    def _tick_body(self, state: RobotState, refs, warm):
        model = self.model
        data = dynamics.compute_model_data(model, state, need_binv=True)
        stack_data = self.stack.build(model, data, state, refs,
                                      nx=model.nj, dtype=self.dtype)
        x, warm_new, infos = hierarchy.solve(
            stack_data, warm, eps=self.eps, iters=self.iters,
            **self.solver_opts)
        with telemetry.span("torque"):
            failed = hierarchy.solve_failed(infos, tol=self.FAIL_TOL)
            tau_qp = torch.where(failed[:, None], torch.zeros_like(x), x)
            tau_d = tau_qp + data.h   # h is added on a failed solve too

        with telemetry.span("aux"):
            ctx = AssembleCtx(model=model, data=data, state=state, refs=refs,
                              nx=model.nj, dtype=self.dtype)
            ls, ld = self.ee_left.spring_damper_force(ctx)
            rs, rd = self.ee_right.spring_damper_force(ctx)
            aux = QPPVMAux(
                tau_qp=tau_qp, tau_desired=tau_d, h=data.h,
                solver_failed=failed,
                prim_res=torch.amax(
                    torch.stack([i.prim_res for i in infos]), dim=0),
                ee_left_err=ls + ld, ee_right_err=rs + rd)
        return tau_d, warm_new, aux
