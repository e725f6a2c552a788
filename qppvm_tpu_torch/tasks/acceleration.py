"""Acceleration-level tasks over x = [qddot; contact wrenches ...]
(port of qppvm_tpu/tasks/acceleration.py)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from qppvm_tpu_torch.model import kinematics, spatial
from qppvm_tpu_torch.opt.variables import AffineExpr
from qppvm_tpu_torch.tasks.base import (AssembleCtx, Task, ref_tensor,
                                        take_rows)


def ref_scalar(ref, key, default, ctx: AssembleCtx):
    """A per-item scalar reference (B,), or the static default."""
    return ref_tensor(ref.get(key, default), ctx.dtype,
                      ctx.state.q.device).expand(ctx.batch)


class Cartesian(Task):
    """Cartesian acceleration task J udot + Jdot u = xdd_des with a PD servo
    on the pose reference; ``indices`` keeps those rows of the 6D task
    (linear first), e.g. ``(0, 1, 2)`` for position only."""

    def __init__(self, name: str, distal_link: str, qddot: AffineExpr,
                 base_link: str = "world", kp: float = 100.0,
                 kd: Optional[float] = None,
                 indices: Optional[Sequence[int]] = None):
        self.name = name
        self.base_link = base_link
        self.distal_link = distal_link
        self.qddot = qddot
        self.kp = kp
        self.kd = 2.0 * float(np.sqrt(kp)) if kd is None else kd
        # all six rows when no selection is asked for
        self.rows = None if indices is None else list(indices)

    def _frame(self, model, data):
        from qppvm_tpu_torch.model.dynamics import (frame_data,
                                                    relative_frame_data)
        if self.base_link != "world":
            return relative_frame_data(model, data, self.distal_link,
                                       self.base_link)
        return frame_data(model, data, self.distal_link)

    def ref_init(self, model, data, state):
        if self.base_link != "world":
            R, p = self._frame(model, data)[:2]
        else:
            R, p = kinematics.link_pose(model, data.kin, self.distal_link)
        B = p.shape[0]
        kw = dict(dtype=p.dtype, device=p.device)
        # "w", "kp", "kd": runtime weight and servo gains, per batch item
        return {"R": R, "p": p, "v": torch.zeros((B, 6), **kw),
                "a": torch.zeros((B, 6), **kw), "w": torch.ones((B,), **kw),
                "kp": torch.full((B,), self.kp, **kw),
                "kd": torch.full((B,), self.kd, **kw)}

    def assemble(self, ctx: AssembleCtx):
        R, p, J, v, bias = self._frame(ctx.model, ctx.data)
        ref = ctx.refs[self.name]
        e = spatial.pose_error(ref["R"], ref["p"], R, p)
        kp = ref_scalar(ref, "kp", self.kp, ctx)[:, None]
        kd = ref_scalar(ref, "kd", self.kd, ctx)[:, None]
        xdd_des = ref["a"] + kp * e + kd * (ref["v"] - v)
        A = J @ self.qddot.M
        b = xdd_des - bias - J @ self.qddot.c
        if self.rows is not None:
            A = take_rows(self, self.rows, A)
            b = take_rows(self, self.rows, b)
        w = self.weight * ref_scalar(ref, "w", 1.0, ctx)
        return w[:, None, None] * A, w[:, None] * b


class Postural(Task):
    """Joint-space acceleration task on the actuated rows of qddot."""

    def __init__(self, name: str, qddot: AffineExpr, kp: float = 25.0,
                 kd: Optional[float] = None):
        self.name = name
        self.qddot = qddot
        self.kp = kp
        self.kd = 2.0 * float(np.sqrt(kp)) if kd is None else kd

    def ref_init(self, model, data, state):
        # "w": per-joint runtime weights
        return {"q": state.q.clone(), "w": torch.ones_like(state.q)}

    def assemble(self, ctx: AssembleCtx):
        ref = ctx.refs[self.name]
        qdd_des = self.kp * (ref["q"] - ctx.state.q) - self.kd * ctx.state.qd
        off = 6 if ctx.model.floating else 0
        A = self.qddot.M[off:]
        b = qdd_des - self.qddot.c[off:]
        w = self.weight * ref_tensor(ref.get("w", 1.0), ctx.dtype, b.device)
        wv = w.expand_as(b) if w.dim() == 2 else w.reshape(-1, 1).expand_as(b)
        return wv[..., None] * A, wv * b
