"""Torque-level tasks and constraints of the QPPVM control law
(port of qppvm_tpu/tasks/torque.py), batched over a leading dimension B.

Decision variable: x = tau_qp (B, nj), the torque on top of the nonlinear
term h; the plugin adds h after the solve.

- Cartesian impedance: the desired wrench F = Kc e_pose + Dc (v_ref - v),
  rows ``indices``. Task rows A = (J_s W J_s^T + reg I)^{-1} J_s W, b = F_s,
  with W = B^{-1} (``ModelData.Binv``) under ``use_inertia_matrix``, else
  W = I: at the optimum A x = b, the end effector feels F.
- Joint impedance: A = I, b = B (K e - D qd) under ``use_inertia_matrix``,
  else K e - D qd.
- TorqueLimits: the box tau_min - h <= x <= tau_max - h.
- JointLimits: position limits as a torque box that shrinks toward a
  restoring torque near each limit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from qppvm_tpu_torch import device as device_lib
from qppvm_tpu_torch.model import spatial
from qppvm_tpu_torch.opt import linalg
from qppvm_tpu_torch.tasks.acceleration import ref_scalar
from qppvm_tpu_torch.tasks.base import (BOX, AssembleCtx, Constraint, Task,
                                        ref_tensor, take_rows)


def _gain(task, name: str, ctx: AssembleCtx):
    """The gain setting ``name`` of ``task`` on the tick's device and dtype:
    a tensor already there as it is, anything else converted once (a
    constant of the task, made anew after the tensor changes in place), so
    the tick copies nothing from the host."""
    t = getattr(task, name)
    device, dtype = ctx.state.q.device, ctx.dtype
    if isinstance(t, torch.Tensor) and t.device == device and t.dtype == dtype:
        return t
    return device_lib.constant(
        task, (name, dtype, device),
        lambda: torch.as_tensor(t).to(device=device, dtype=dtype),
        source=t if isinstance(t, torch.Tensor) else None)


class CartesianImpedanceCtrl(Task):
    """Cartesian spring-damper in torque space."""

    def __init__(self, name: str, distal_link: str, base_link: str = "world",
                 indices: Optional[Sequence[int]] = None,
                 stiffness=None, damping=None, use_inertia_matrix: bool = True,
                 reg: float = 1e-6):
        self.name = name
        self.distal_link = distal_link
        self.base_link = base_link
        self.indices = list(indices) if indices is not None else list(range(6))
        self.Kc = torch.eye(6) * 700.0 if stiffness is None else stiffness
        self.Dc = torch.eye(6) * 70.0 if damping is None else damping
        self.use_inertia_matrix = use_inertia_matrix
        self.reg = reg

    def set_stiffness_damping(self, Kc, Dc):
        self.Kc, self.Dc = Kc, Dc
        return self

    def _frame(self, model, data):
        from qppvm_tpu_torch.model.dynamics import (frame_data,
                                                    relative_frame_data)
        if self.base_link != "world":
            # relative task, expressed in the base link's frame
            return relative_frame_data(model, data, self.distal_link,
                                       self.base_link)
        return frame_data(model, data, self.distal_link)

    def ref_init(self, model, data, state):
        R, p = self._frame(model, data)[:2]
        B = p.shape[0]
        kw = dict(dtype=p.dtype, device=p.device)
        # "w": runtime task weight, per batch item
        return {"R": R, "p": p, "v": torch.zeros((B, 6), **kw),
                "w": torch.ones((B,), **kw)}

    def spring_damper_force(self, ctx: AssembleCtx):
        """(F_spring, F_damp), each (B, 6), task frame, linear first:
        Kc e_pose and Dc (v_ref - v)."""
        ref = ctx.refs[self.name]
        R, p, _, v, _ = self._frame(ctx.model, ctx.data)
        e = spatial.pose_error(ref["R"], ref["p"], R, p)
        F_spring = e @ _gain(self, "Kc", ctx).T
        F_damp = (ref["v"] - v) @ _gain(self, "Dc", ctx).T
        return F_spring, F_damp

    def assemble(self, ctx: AssembleCtx):
        J = self._frame(ctx.model, ctx.data)[2]
        if ctx.model.floating:
            J = J[..., 6:]                           # actuated columns only
        Js = take_rows(self, self.indices, J)        # (B, k, nj)
        JW = Js @ ctx.data.Binv if self.use_inertia_matrix else Js
        k = len(self.indices)
        G = JW @ Js.transpose(-1, -2) + self.reg * torch.eye(
            k, dtype=ctx.dtype, device=Js.device)
        # G is k x k SPD (k <= 6): the plain Newton-Schulz inverse, as the
        # reference's; the NS kernel serves the mass matrix's n
        A = linalg.spd_inverse(G) @ JW               # (B, k, nj) = Jbar^T
        F_spring, F_damp = self.spring_damper_force(ctx)
        F = take_rows(self, self.indices, F_spring + F_damp)
        w = self.weight * ref_scalar(ctx.refs[self.name], "w", 1.0, ctx)
        return w[:, None, None] * A, w[:, None] * F


class JointImpedanceCtrl(Task):
    """Joint-space spring-damper torque task."""

    def __init__(self, name: str = "joint_impedance", stiffness=None,
                 damping=None, use_inertia_matrix: bool = True):
        self.name = name
        self.K = stiffness  # (nj,), or None: 5.0
        self.D = damping    # (nj,), or None: 2.0
        self.use_inertia_matrix = use_inertia_matrix

    def ref_init(self, model, data, state):
        # "w": per-joint runtime weights
        return {"q": state.q.clone(), "w": torch.ones_like(state.q)}

    def assemble(self, ctx: AssembleCtx):
        nj = ctx.model.nj
        K = 5.0 if self.K is None else _gain(self, "K", ctx)
        D = 2.0 if self.D is None else _gain(self, "D", ctx)
        ref = ctx.refs[self.name]
        acc_des = K * (ref["q"] - ctx.state.q) - D * ctx.state.qd   # (B, nj)
        if self.use_inertia_matrix:
            B = ctx.data.B[:, 6:, 6:] if ctx.model.floating else ctx.data.B
            b = (B @ acc_des[..., None])[..., 0]
        else:
            b = acc_des
        w = self.weight * ref_tensor(ref.get("w", 1.0), ctx.dtype, b.device)
        wv = w.expand_as(b) if w.dim() == 2 else w.reshape(-1, 1).expand_as(b)
        A = torch.eye(nj, dtype=ctx.dtype, device=b.device)
        return wv[..., None] * A, wv * b


class TorqueLimits(Constraint):
    """Box bound on tau_qp, recomputed each tick as tau_const -/+ h."""

    name = "torque_limits"

    def __init__(self, tau_max=None, tau_min=None):
        self.tau_max = tau_max  # None: model.tau_max
        self.tau_min = tau_min  # None: -tau_max

    def assemble(self, ctx: AssembleCtx):
        tmax = (ctx.model.tau_max.to(ctx.dtype) if self.tau_max is None
                else _gain(self, "tau_max", ctx))
        tmin = -tmax if self.tau_min is None else _gain(self, "tau_min", ctx)
        h = ctx.data.h[:, 6:] if ctx.model.floating else ctx.data.h
        return BOX, None, tmin - h, tmax - h


class JointLimits(Constraint):
    """Position-limit avoidance as a torque bound: ub = k (q_max - q) -
    d qd, lb = k (q_min - q) - d qd, with ub >= lb + 1e-6; the limits move
    inward by ``margin``."""

    name = "joint_limits"

    def __init__(self, gain_k=1000.0, gain_d=50.0, margin: float = 0.0):
        self.k = gain_k
        self.d = gain_d
        self.margin = margin

    def set_gains(self, k, d):
        self.k, self.d = k, d
        return self

    def assemble(self, ctx: AssembleCtx):
        m, st = ctx.model, ctx.state
        k, d = _gain(self, "k", ctx), _gain(self, "d", ctx)
        qmax = m.q_max.to(ctx.dtype) - self.margin
        qmin = m.q_min.to(ctx.dtype) + self.margin
        ub = k * (qmax - st.q) - d * st.qd
        lb = k * (qmin - st.q) - d * st.qd
        return BOX, None, lb, torch.maximum(ub, lb + 1e-6)
