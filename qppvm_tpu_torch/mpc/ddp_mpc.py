"""Receding-horizon centroidal DDP planner feeding the WBC tracker (port of
qppvm_tpu/mpc/ddp_mpc.py).

iLQR (mpc/ilqr.py) plans CoM and contact-force trajectories on the SRBD
model (mpc/centroidal.py); the whole-body controller
(plugins/force_acc.py) tracks the planned CoM as its waist reference, and
optionally the planned forces through ForceReg. ``plan`` runs eagerly on the
model's device, warm-started by shifting the previous control sequence.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from qppvm_tpu_torch.model import dynamics
from qppvm_tpu_torch.model.robot import RobotModel, RobotState
from qppvm_tpu_torch.mpc import centroidal, ilqr


@dataclasses.dataclass(frozen=True)
class CentroidalMPCConfig:
    horizon: int = 40
    dt: float = 0.02
    iterations: int = 8
    w_pos: float = 50.0
    w_ang: float = 20.0
    f_max: float = 1000.0   # box clamp on planned force components


class CentroidalMPC:
    """plan(state, p_ref, U_prev[, active]) -> (ILQRResult, params), for one
    robot (a batch-1 state)."""

    def __init__(self, model: RobotModel, contact_links: Sequence[str],
                 cfg: CentroidalMPCConfig = CentroidalMPCConfig(),
                 dtype=torch.float32):
        self.model = model
        self.contact_links = tuple(contact_links)
        self.cfg = cfg
        self.dtype = dtype

    def _params(self, state: RobotState, active):
        data = dynamics.compute_model_data(self.model, state)
        return data, centroidal.from_robot(self.model, data,
                                           self.contact_links, self.cfg.dt,
                                           active)

    def init_plan(self, state: RobotState, active=None):
        """(H, nu): the gravity feed-forward at every step."""
        _, params = self._params(state, active)
        return centroidal.gravity_feedforward(params)[None].repeat(
            self.cfg.horizon, 1)

    def plan(self, state: RobotState, p_ref, U_prev,
             active: Optional[torch.Tensor] = None):
        cfg, kw = self.cfg, dict(dtype=self.dtype, device=self.model.device)
        active = (torch.ones(len(self.contact_links), **kw) if active is None
                  else torch.as_tensor(active, **kw))
        p_ref = torch.as_tensor(p_ref, **kw)
        data, params = self._params(state, active)
        # world CoM velocity ~ world base linear velocity (stance); the
        # start in the planner's dtype (the reference's is float32 always)
        x0 = centroidal.init_state(
            data.com_pos[0], state.base_rot[0] @ state.base_vel[0, 3:],
            **kw)
        cost = centroidal.standing_cost(params, p_ref, w_pos=cfg.w_pos,
                                        w_ang=cfg.w_ang)
        Iinv = centroidal.inertia_inverse(params)
        u_zero = torch.zeros(3 * params.nc, **kw)
        solver = ilqr.make_solver(
            lambda x, u: centroidal.dynamics_step(params, x, u, Iinv), cost,
            lambda x: 10.0 * cost(x, u_zero),
            ilqr.ILQRConfig(iterations=cfg.iterations,
                            u_min=-cfg.f_max, u_max=cfg.f_max))
        # receding-horizon warm start: the previous plan shifted one step
        U0 = torch.cat([U_prev[1:], U_prev[-1:]], dim=0)
        return solver(x0, U0), params

    @staticmethod
    def waist_ref_from_plan(res: ilqr.ILQRResult, k: int = 1):
        """The CoM position k steps into the plan: the WBC's waist
        reference."""
        return res.X[k][:3]

    @staticmethod
    def force_ref_offset(res: ilqr.ILQRResult, params, total_weight,
                         k: int = 0, gates=None, wrench_dim: int = 3):
        """``refs["FORCE_REG"]["f"]`` offset, (nc * wrench_dim,), that makes
        the WBC's force distribution track the plan's step-k forces: ForceReg
        anchors it at the gate-weighted share ``W g_i / sum(g)`` plus this
        offset, so the offset is ``f_plan - share``. ``gates``: the
        plugin's ``refs["contacts"]["active"]`` of one robot, (nc,) or
        (1, nc); omit it only for an all-contacts-on stack. The plan's
        3-vector forces fill the force rows of each ``wrench_dim``-wide
        block."""
        f_plan = res.U[k].reshape(params.nc, 3)
        g = (torch.ones(params.nc, dtype=f_plan.dtype, device=f_plan.device)
             if gates is None else torch.as_tensor(
                 gates, dtype=f_plan.dtype,
                 device=f_plan.device).reshape(params.nc))
        share_z = total_weight * g / torch.clamp(torch.sum(g), min=1e-6)
        zero = torch.zeros_like(share_z)
        off3 = f_plan - torch.stack([zero, zero, share_z], dim=-1)
        return torch.nn.functional.pad(off3, (0, wrench_dim - 3)).reshape(-1)
