"""Generic affine constraints and floating-base dynamic feasibility
(port of qppvm_tpu/tasks/generic.py; FrictionCone, CoPBox and
JointAccLimits are not ported yet)."""
from __future__ import annotations

from typing import Sequence

import torch

from qppvm_tpu_torch.opt.variables import AffineExpr
from qppvm_tpu_torch.tasks.base import ROWS, AssembleCtx, Constraint


class GenericConstraint(Constraint):
    """lb <= expr(x) <= ub."""

    def __init__(self, name: str, expr: AffineExpr, ub, lb):
        self.name = name
        self.expr = expr
        kw = dict(dtype=expr.M.dtype, device=expr.M.device)
        self.ub = torch.as_tensor(ub, **kw)
        self.lb = torch.as_tensor(lb, **kw)

    def assemble(self, ctx: AssembleCtx):
        B = ctx.batch
        lb = self.lb.to(ctx.dtype).expand(B, -1)
        ub = self.ub.to(ctx.dtype).expand(B, -1)
        return (ROWS, self.expr.M.expand(B, -1, -1), lb - self.expr.c,
                ub - self.expr.c)


class DynamicFeasibility(Constraint):
    """Floating-base rows of the equations of motion as an equality:

        B[:6, :] udot + h[:6] = sum_c (J_c^T f_c)[:6]
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
