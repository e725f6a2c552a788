"""Force-level tasks over contact wrench variables
(port of qppvm_tpu/tasks/force.py)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from qppvm_tpu_torch.model import kinematics, spatial
from qppvm_tpu_torch.opt.variables import AffineExpr
from qppvm_tpu_torch.tasks.acceleration import ref_scalar
from qppvm_tpu_torch.tasks.base import AssembleCtx, Task


class ForceReg(Task):
    """Small-weight task pulling each contact wrench toward an equal share of
    the robot's weight, ``f_des_i = W / n_contacts * z_hat`` (tangential /
    moment targets 0), which pins the force-distribution nullspace no other
    task constrains. (The reference's contact gates and quasi-static share
    are not ported yet.)

    refs: ``f`` (additive offset on f_des), ``w`` (runtime weight scale)."""

    def __init__(self, name: str, wrenches: Sequence[AffineExpr],
                 w_tan: float = 0.1, w_norm: float = 0.05, up_index: int = 2):
        self.name = name
        self.wrenches = list(wrenches)
        self.w_tan = w_tan
        self.w_norm = w_norm
        self.weight = max(w_tan, w_norm)
        self.up_index = up_index

    def ref_init(self, model, data, state):
        n = sum(w.size for w in self.wrenches)
        B = data.com_pos.shape[0]
        kw = dict(dtype=data.com_pos.dtype, device=data.com_pos.device)
        return {"f": torch.zeros((B, n), **kw), "w": torch.ones((B,), **kw)}

    def assemble(self, ctx: AssembleCtx):
        ref = ctx.refs[self.name]
        dev = ctx.state.q.device
        share = ctx.data.total_mass * torch.linalg.norm(
            ctx.model.gravity.to(ctx.dtype)) / len(self.wrenches)   # (B,)
        f_des, row_w = [], []
        for wr in self.wrenches:
            up = torch.zeros((wr.size,), dtype=ctx.dtype, device=dev)
            up[self.up_index] = 1.0
            f_des.append(share[:, None] * up)
            rw = torch.full((wr.size,), self.w_tan, dtype=ctx.dtype, device=dev)
            rw[self.up_index] = self.w_norm
            row_w.append(rw)
        f_des = torch.cat(f_des, dim=-1) + ref["f"]
        row_w = torch.cat(row_w) * ref_scalar(ref, "w", 1.0, ctx)[:, None]
        M = torch.cat([w.M for w in self.wrenches], dim=0)
        c = torch.cat([w.c for w in self.wrenches], dim=0)
        return row_w[..., None] * M, row_w * (f_des - c)


class CoM(Task):
    """Centroidal task over 3-vector point contact forces:

        sum_i f_i                = m (a_com_des - g)
        sum_i (p_i - com) x f_i  = 0
    """

    def __init__(self, name: str, wrenches: Sequence[AffineExpr],
                 contact_links: Sequence[str], kp: float = 25.0,
                 kd: Optional[float] = None):
        self.name = name
        self.wrenches = list(wrenches)
        self.contact_links = list(contact_links)
        self.kp = kp
        self.kd = 10.0 if kd is None else kd

    def ref_init(self, model, data, state):
        z3 = torch.zeros_like(data.com_pos)
        return {"p": data.com_pos.clone(), "v": z3, "a": z3.clone()}

    def assemble(self, ctx: AssembleCtx):
        m = ctx.data.total_mass
        com = ctx.data.com_pos
        ref = ctx.refs[self.name]
        v_com = kinematics.com_velocity(ctx.model, ctx.data.kin, ctx.state,
                                        ctx.data.vel_all)
        a_des = (ref["a"] + self.kp * (ref["p"] - com)
                 + self.kd * (ref["v"] - v_com))
        g = ctx.model.gravity.to(ctx.dtype)
        lin_M = sum(wr.M[:3] for wr in self.wrenches)
        lin_c = sum(wr.c[:3] for wr in self.wrenches)
        ang_M, ang_c = 0.0, 0.0
        for link, wr in zip(self.contact_links, self.wrenches):
            p_i = kinematics.link_pose(ctx.model, ctx.data.kin, link)[1]
            S = spatial.skew(p_i - com)                          # (B, 3, 3)
            ang_M = ang_M + S @ wr.M[:3]
            ang_c = ang_c + S @ wr.c[:3]
        rows = [lin_M.expand(ctx.batch, -1, -1), ang_M]
        rhs = [m[:, None] * (a_des - g) - lin_c, -ang_c]
        return (self.weight * torch.cat(rows, dim=1),
                self.weight * torch.cat(rhs, dim=1))
