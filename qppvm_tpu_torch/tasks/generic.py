"""Generic affine constraints, joint acceleration limits, floating-base
dynamic feasibility, friction cones and the CoP box
(port of qppvm_tpu/tasks/generic.py).

A ``gate`` is a ``(refs_key, index)`` pair: ``refs[refs_key]["active"]``
(B, n_contacts) holds each item's 0..1 contact signal, and a constraint
reads its column ``index``. Gate 1 keeps the normal bounds; gate 0 turns
the rows into the equality expr(x) = 0 (a switched-off contact carries no
wrench); values between blend the bounds linearly.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from qppvm_tpu_torch import device as device_lib
from qppvm_tpu_torch.opt.variables import AffineExpr
from qppvm_tpu_torch.tasks.base import ROWS, AssembleCtx, Constraint

# the bound standing for "unbounded" in a one-sided row
_BIG = 1e20


def _gate(ctx: AssembleCtx, gate):
    """Each item's gate value (B, 1), or None without a gate."""
    if gate is None:
        return None
    key, idx = gate
    return ctx.refs[key]["active"][:, idx].to(ctx.dtype)[:, None]


def _one_sided(ctx: AssembleCtx, rows, offs, lb, ub, gate):
    """ROWS for ``lb <= rows x + offs <= ub`` (offs (k,), lb / ub (k,)),
    batched; a gate blends the bounds toward the equality rows x + offs
    = 0."""
    lb, ub = lb - offs, ub - offs
    g = _gate(ctx, gate)
    if g is not None:
        lb = g * lb + (1.0 - g) * (-offs)
        ub = g * ub + (1.0 - g) * (-offs)
    B = ctx.batch
    return (ROWS, rows.expand(B, -1, -1), lb.expand(B, -1),
            ub.expand(B, -1))


class GenericConstraint(Constraint):
    """lb <= expr(x) <= ub; with ``gate`` the bounds are scaled by the
    item's gate value, so gate 0 gives expr(x) = 0."""

    def __init__(self, name: str, expr: AffineExpr, ub, lb, gate=None):
        self.name = name
        self.expr = expr
        kw = dict(dtype=expr.M.dtype, device=expr.M.device)
        self.ub = torch.as_tensor(ub, **kw)
        self.lb = torch.as_tensor(lb, **kw)
        self.gate = gate

    def assemble(self, ctx: AssembleCtx):
        B = ctx.batch
        lb = self.lb.to(ctx.dtype).expand(B, -1)
        ub = self.ub.to(ctx.dtype).expand(B, -1)
        g = _gate(ctx, self.gate)
        if g is not None:
            lb, ub = g * lb, g * ub
        return (ROWS, self.expr.M.expand(B, -1, -1), lb - self.expr.c,
                ub - self.expr.c)


class JointAccLimits(Constraint):
    """Joint position-limit avoidance as bounds on the actuated q̈ rows:

        kp (q_min - q) - kd q̇  <=  q̈  <=  kp (q_max - q) - kd q̇

    (the commanded acceleration can always brake before the stop); a
    ``margin`` shrinks the range, and an empty range keeps lb <= ub."""

    def __init__(self, name: str, qddot: AffineExpr, kp: float = 100.0,
                 kd: Optional[float] = None, margin: float = 0.0):
        self.name = name
        self.qddot = qddot
        self.kp = kp
        self.kd = 2.0 * float(np.sqrt(kp)) if kd is None else kd
        self.margin = margin

    def assemble(self, ctx: AssembleCtx):
        off = 6 if ctx.model.floating else 0
        q, qd = ctx.state.q, ctx.state.qd
        lo = ctx.model.q_min.to(ctx.dtype) + self.margin
        hi = ctx.model.q_max.to(ctx.dtype) - self.margin
        ub = self.kp * (hi - q) - self.kd * qd
        lb = self.kp * (lo - q) - self.kd * qd
        ub = torch.maximum(ub, lb + 1e-6)
        M, c = self.qddot.M[off:], self.qddot.c[off:]
        return ROWS, M.expand(ctx.batch, -1, -1), lb - c, ub - c


class DynamicFeasibility(Constraint):
    """Floating-base rows of the equations of motion as an equality:

        B[:6, :] udot + h[:6] = sum_c (J_c^T f_c)[:6]

    ``wrenches`` are 3-vector point forces or 6-vector wrenches (linear
    first), in world frame at the contact link origins.
    """

    is_equality = True  # eliminated by projection (opt/qp.py n_eq_head)

    def __init__(self, name: str, qddot: AffineExpr,
                 wrenches: Sequence[AffineExpr], contact_links: Sequence[str]):
        self.name = name
        self.qddot = qddot
        self.wrenches = list(wrenches)
        self.contact_links = list(contact_links)

    def _rows(self, ctx: AssembleCtx):
        from qppvm_tpu_torch.model.dynamics import frame_data
        B6 = ctx.data.B[:, :6, :]                    # (B, 6, nv)
        C = B6 @ self.qddot.M                        # (B, 6, nx)
        c_off = B6 @ self.qddot.c
        for link, wr in zip(self.contact_links, self.wrenches):
            Jc = frame_data(ctx.model, ctx.data, link)[2]
            JcT6 = Jc[:, :wr.size, :6].transpose(-1, -2)   # (B, 6, k)
            C = C - JcT6 @ wr.M
            c_off = c_off - JcT6 @ wr.c
        return C, -ctx.data.h[:, :6] - c_off

    def assemble(self, ctx: AssembleCtx):
        C, rhs = self._rows(ctx)
        return ROWS, C, rhs, rhs

    def check_constraint(self, ctx: AssembleCtx, x):
        """Residual (B, 6) of the equality at solutions x (B, nx)."""
        C, rhs = self._rows(ctx)
        return (C @ x[..., None])[..., 0] - rhs


class FrictionCone(Constraint):
    """Linearized (pyramid) friction cone of one contact force in world
    frame, ground normal +z: |f_x| <= mu/sqrt(2) f_z, |f_y| <= mu/sqrt(2)
    f_z, f_min <= f_z <= f_max. A gated-off contact's rows become f = 0."""

    def __init__(self, name: str, force: AffineExpr, mu: float = 0.7,
                 f_min: float = 0.0, f_max: float = 1e4, gate=None):
        self.name = name
        self.force = force  # (3,) affine view [fx, fy, fz]
        self.mu = mu
        self.f_min = f_min
        self.f_max = f_max
        self.gate = gate

    def bounds(self, dtype, device):
        """(lb, ub) of the five rows, made once per dtype and device (a
        constant of the cone, made anew after ``f_min`` or ``f_max``
        changes)."""
        kw = dict(dtype=dtype, device=device)
        return device_lib.constant(self, ("bounds", dtype, device), lambda: (
            torch.tensor([-_BIG] * 4 + [self.f_min], **kw),
            torch.tensor([0.0] * 4 + [self.f_max], **kw)))

    def assemble(self, ctx: AssembleCtx):
        mu = self.mu / np.sqrt(2.0)
        (fx, fy, fz), (cx, cy, cz) = self.force.M, self.force.c
        rows = torch.stack([fx - mu * fz, -fx - mu * fz, fy - mu * fz,
                            -fy - mu * fz, fz])
        offs = torch.stack([cx - mu * cz, -cx - mu * cz, cy - mu * cz,
                            -cy - mu * cz, cz]).to(ctx.dtype)
        lb, ub = self.bounds(ctx.dtype, offs.device)
        return _one_sided(ctx, rows, offs, lb, ub, self.gate)


class CoPBox(Constraint):
    """fz-proportional center-of-pressure and torsion box on a full 6D
    contact wrench (flat ground, +z normal, moments about the link origin in
    world frame). With px = -my / fz, py = mx / fz:

        x_min fz <= -my <= x_max fz,  |mx| <= y_half fz,  |mz| <= t_coef fz

    Gate semantics as FrictionCone's."""

    def __init__(self, name: str, wrench: AffineExpr,
                 x_min: float = -0.05, x_max: float = 0.05,
                 y_half: float = 0.05, t_coef: float = 0.01, gate=None):
        if wrench.size != 6:
            raise ValueError("CoPBox needs a full 6D wrench view")
        self.name = name
        self.wrench = wrench
        self.x_min = float(x_min)
        self.x_max = float(x_max)
        self.y_half = float(y_half)
        self.t_coef = float(t_coef)
        self.gate = gate

    def assemble(self, ctx: AssembleCtx):
        W, c = self.wrench.M, self.wrench.c
        fz, mx, my, mz = W[2], W[3], W[4], W[5]
        cz, cmx, cmy, cmz = c[2], c[3], c[4], c[5]
        yh, xM, xm, tc = self.y_half, self.x_max, self.x_min, self.t_coef
        rows = torch.stack([mx - yh * fz, -mx - yh * fz, -my - xM * fz,
                            my + xm * fz, mz - tc * fz, -mz - tc * fz])
        offs = torch.stack([cmx - yh * cz, -cmx - yh * cz, -cmy - xM * cz,
                            cmy + xm * cz, cmz - tc * cz,
                            -cmz - tc * cz]).to(ctx.dtype)
        kw = dict(dtype=ctx.dtype, device=offs.device)
        return _one_sided(ctx, rows, offs, torch.full((6,), -_BIG, **kw),
                          torch.zeros((6,), **kw), self.gate)
