"""Force-level tasks over contact wrench variables
(port of qppvm_tpu/tasks/force.py)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from qppvm_tpu_torch import device as device_lib
from qppvm_tpu_torch.model import kinematics, spatial
from qppvm_tpu_torch.opt.variables import AffineExpr
from qppvm_tpu_torch.tasks.acceleration import ref_scalar
from qppvm_tpu_torch.tasks.base import AssembleCtx, Task


class ForceReg(Task):
    """Small-weight task pulling each contact wrench toward its share of the
    robot's weight along ``up_index`` (tangential / moment targets 0),
    which pins the force-distribution nullspace no other task constrains.

    ``share_mode``:
    - "gate": an equal share per unit gate, ``W g_i / sum_j g_j``;
    - "static": the quasi-static split at the measured CoM, min ||w||^2
      s.t. sum w_i = 1 and sum w_i (p_i - com)_xy = 0 over the gated feet
      (a 3 x 3 system solved by its adjugate), clamped at 0 and
      renormalized. Needs ``contact_links``.

    With ``gates_key`` set and ``refs[gates_key]["active"]`` (B, nc)
    present, each contact's share follows its 0..1 gate; otherwise every
    gate is 1.

    refs: ``f`` (additive offset on f_des), ``w`` (runtime weight scale)."""

    def __init__(self, name: str, wrenches: Sequence[AffineExpr],
                 w_tan: float = 0.1, w_norm: float = 0.05,
                 gates_key: Optional[str] = None, up_index: int = 2,
                 share_mode: str = "gate",
                 contact_links: Optional[Sequence[str]] = None):
        self.name = name
        self.wrenches = list(wrenches)
        self.share_mode = share_mode
        self.contact_links = list(contact_links) if contact_links else None
        if share_mode == "static" and not self.contact_links:
            raise ValueError("share_mode='static' needs contact_links")
        self.w_tan = w_tan
        self.w_norm = w_norm
        self.weight = max(w_tan, w_norm)
        self.gates_key = gates_key
        self.up_index = up_index

    def targets(self, dtype, device):
        """(each wrench's unit vector along ``up_index``, the rows'
        weights), made once per dtype and device (a constant of the task,
        made anew after a setting changes)."""
        def make():
            ups, row_w = [], []
            for wr in self.wrenches:
                up = torch.zeros((wr.size,), dtype=dtype, device=device)
                up[self.up_index] = 1.0
                ups.append(up)
                rw = torch.full((wr.size,), self.w_tan, dtype=dtype,
                                device=device)
                rw[self.up_index] = self.w_norm
                row_w.append(rw)
            return ups, torch.cat(row_w)
        return device_lib.constant(self, ("targets", dtype, device), make)

    def ref_init(self, model, data, state):
        n = sum(w.size for w in self.wrenches)
        B = data.com_pos.shape[0]
        kw = dict(dtype=data.com_pos.dtype, device=data.com_pos.device)
        return {"f": torch.zeros((B, n), **kw), "w": torch.ones((B,), **kw)}

    def _static_share(self, ctx: AssembleCtx, g):
        """Quasi-static support weights (B, nc) at the measured CoM, not
        yet normalized."""
        P = torch.stack([kinematics.link_pose(ctx.model, ctx.data.kin,
                                              link)[1]
                         for link in self.contact_links], dim=1)  # (B, nc, 3)
        d = P[..., :2] - ctx.data.com_pos[:, None, :2]          # (B, nc, 2)
        A = torch.cat([torch.ones_like(d[..., :1]), d],
                      dim=-1).transpose(-1, -2)                 # (B, 3, nc)
        M3 = (A * g[:, None, :]) @ A.transpose(-1, -2) + 1e-5 * torch.eye(
            3, dtype=ctx.dtype, device=A.device)
        m = lambda i, j: M3[:, i, j]  # noqa: E731
        c00 = m(1, 1) * m(2, 2) - m(1, 2) * m(2, 1)
        c10 = m(1, 2) * m(2, 0) - m(1, 0) * m(2, 2)
        c20 = m(1, 0) * m(2, 1) - m(1, 1) * m(2, 0)
        det = m(0, 0) * c00 + m(0, 1) * c10 + m(0, 2) * c20
        lam = (torch.stack([c00, c10, c20], dim=-1)
               / torch.clamp(det.abs(), min=1e-12)[:, None]
               * torch.sign(det)[:, None])                       # M3^-1 e1
        return torch.clamp(
            g * (A.transpose(-1, -2) @ lam[..., None])[..., 0], min=0.0)

    def assemble(self, ctx: AssembleCtx):
        ref = ctx.refs[self.name]
        dev = ctx.state.q.device
        nc = len(self.wrenches)
        if self.gates_key is not None and self.gates_key in ctx.refs:
            g = ctx.refs[self.gates_key]["active"].to(ctx.dtype)   # (B, nc)
        else:
            g = torch.ones((ctx.batch, nc), dtype=ctx.dtype, device=dev)
        W = ctx.data.total_mass * torch.linalg.norm(
            ctx.model.gravity.to(ctx.dtype))                        # (B,)
        w_sh = self._static_share(ctx, g) if self.share_mode == "static" else g
        share = W[:, None] * w_sh / torch.clamp(w_sh.sum(-1, keepdim=True),
                                                min=1e-6)
        ups, row_w = self.targets(ctx.dtype, dev)
        f_des = torch.cat([share[:, i:i + 1] * up for i, up in enumerate(ups)],
                          dim=-1) + ref["f"]
        row_w = row_w * ref_scalar(ref, "w", 1.0, ctx)[:, None]
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
