"""Floating-base state estimation (port of qppvm_tpu/runtime/estimator.py),
batch-first.

Two tiers, after the reference's ``sync_model``:

1. ``sync_model_state``: the reference's data flow. Joint state from the
   robot, base position and world linear velocity from the shared-memory
   channels the simulator publishes, orientation and body angular velocity
   from the IMU, fused into one floating-base state.
2. ``FloatingBaseEstimator``: leg odometry for deployments with no
   ground-truth position channel. Stance feet anchor world positions; the
   base position and linear velocity are rebuilt from joint kinematics and
   the IMU orientation. Contact make and break are 0/1 gates (B, nc), so
   every shape is static.

The reference jits its update; here it is a plain method of eager ops.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from qppvm_tpu_torch.model import dynamics, kinematics
from qppvm_tpu_torch.model.robot import RobotModel, RobotState
from qppvm_tpu_torch.opt import linalg


def sync_model_state(robot, model: RobotModel,
                     dtype=torch.float32) -> RobotState:
    """A floating-base RobotState assembled as the reference does:
    shared-memory base position and world velocity, IMU orientation and
    angular velocity. ``robot`` is any backend with get_motor_position /
    velocity, get_imu and shared_memory holding the
    '/sim/floating_base_{position,velocity}' channels, each batch-first."""
    kw = dict(dtype=dtype, device=model.device)
    q = torch.as_tensor(robot.get_motor_position(), **kw)
    qd = torch.as_tensor(robot.get_motor_velocity(), **kw)
    if not model.floating:
        return RobotState.init(model, q=q, qd=qd, batch=q.shape[0],
                               dtype=dtype)
    imu = robot.get_imu()
    R = torch.as_tensor(imu.orientation, **kw)
    omega_b = torch.as_tensor(imu.angular_velocity, **kw)
    sh = robot.shared_memory
    fb_pos = torch.as_tensor(
        sh.get_shared_object("/sim/floating_base_position").get(), **kw)
    fb_vel_w = torch.as_tensor(
        sh.get_shared_object("/sim/floating_base_velocity").get(), **kw)
    # world linear velocity into body coordinates; base_vel is [w; v]
    v_b = torch.einsum("bji,bj->bi", R, fb_vel_w)
    return RobotState(q=q, qd=qd, base_rot=R, base_pos=fb_pos,
                      base_vel=torch.cat([omega_b, v_b], dim=-1))


@dataclasses.dataclass(frozen=True)
class EstimatorState:
    """Carried leg-odometry state, batch-first."""

    base_pos: torch.Tensor     # (B, 3) world base position estimate
    anchors: torch.Tensor      # (B, nc, 3) world positions of stance feet
    active_prev: torch.Tensor  # (B, nc) 0/1 gates of the previous tick


class FloatingBaseEstimator:
    """Leg odometry: stance feet are world-fixed anchors.

    Each tick, from measured (q, qd) and the IMU's (R, omega_body):
    - base position: p = mean over voting feet of (anchor_c - R r_c), r_c
      the base-frame foot position from FK;
    - base linear velocity: least squares of the stance constraint
      0 = J_c u over the voting feet (3x3 normal equations through the
      plain Newton-Schulz inverse, as the reference's);
    - a contact make re-anchors that foot at its current world position.
    """

    def __init__(self, model: RobotModel, contact_links: Sequence[str],
                 dtype=torch.float32, ground_z: Optional[float] = 0.0):
        """``ground_z``: terrain prior. A freshly made contact re-anchors
        with its z pinned to this height instead of inheriting the
        (possibly drifted) base estimate; leg odometry has no absolute
        height reference. None disables it (unknown terrain)."""
        if not model.floating:
            raise ValueError("FloatingBaseEstimator needs a floating base")
        self.model = model
        self.contact_links = tuple(contact_links)
        self.dtype = dtype
        self.ground_z = ground_z

    def _gates(self, active, batch):
        kw = dict(dtype=self.dtype, device=self.model.device)
        if active is None:
            return torch.ones((batch, len(self.contact_links)), **kw)
        return torch.as_tensor(active, **kw).expand(
            batch, len(self.contact_links))

    def _feet_base_frame(self, q, R):
        """Base-frame foot positions r_c (B, nc, 3) and their world linear
        Jacobians (B, nc, 3, nv), with the base at the origin rotated by R.
        Only the kinematics and Jacobians are computed: positions and
        Jacobians do not read the mass matrix, bias or twists the
        reference's compute_model_data also builds."""
        model = self.model
        st = RobotState.init(model, q=q, base_rot=R, batch=q.shape[0],
                             dtype=self.dtype)
        kin = kinematics.fk(model, st)
        z = torch.zeros((st.batch, model.nj, 6), dtype=self.dtype,
                        device=model.device)
        data = dynamics.ModelData(
            kin=kin, B=None, h=None,
            J_all=kinematics.all_link_jacobians(model, kin), vel_all=z,
            bias_all=z, com_pos=None, total_mass=None,
            base_vel=st.base_vel)
        r, J = [], []
        for cl in self.contact_links:
            _, pc, Jc, _, _ = dynamics.frame_data(model, data, cl)
            r.append(pc)          # == R r_base, since base_pos = 0
            J.append(Jc[:, :3])   # linear rows, columns [w_b v_b qd]
        return torch.stack(r, dim=1), torch.stack(J, dim=1)

    def init(self, state: RobotState,
             active=None) -> EstimatorState:
        active = self._gates(active, state.batch)
        r, _ = self._feet_base_frame(state.q, state.base_rot)
        return EstimatorState(base_pos=state.base_pos,
                              anchors=state.base_pos[:, None, :] + r,
                              active_prev=active)

    def update(self, est: EstimatorState, q, qd, imu_R, imu_omega,
               active=None):
        """(RobotState, EstimatorState) of this tick from the sensors."""
        kw = dict(dtype=self.dtype, device=self.model.device)
        q = torch.as_tensor(q, **kw)
        qd = torch.as_tensor(qd, **kw)
        R = torch.as_tensor(imu_R, **kw)
        omega_b = torch.as_tensor(imu_omega, **kw)
        active = self._gates(active, q.shape[0])
        r, J = self._feet_base_frame(q, R)
        # Only contacts that were already in stance vote: a freshly made
        # contact has no valid anchor yet (it re-anchors below). Fall back
        # to every active contact if none persisted.
        persistent = active * est.active_prev
        voters = torch.where(persistent.sum(-1, keepdim=True) > 0.5,
                             persistent, active)
        w = voters / torch.clamp(voters.sum(-1, keepdim=True), min=1.0)

        # position: each voting anchor gives p = anchor - R r_base
        base_pos = torch.sum(w[..., None] * (est.anchors - r), dim=1)
        # no active contact: hold the previous estimate
        any_active = (active.sum(-1) > 0.5)[:, None]
        base_pos = torch.where(any_active, base_pos, est.base_pos)

        # linear velocity: 0 = J_w w_b + J_v v_b + J_q qd over the voters
        A = J[..., 3:6]                                     # (B, nc, 3, 3)
        b = -(torch.einsum("bcij,bj->bci", J[..., :3], omega_b)
              + torch.einsum("bcij,bj->bci", J[..., 6:], qd))
        Aw = A * voters[..., None, None]
        bw = b * voters[..., None]
        AtA = (torch.einsum("bcki,bckj->bij", Aw, Aw)
               + 1e-8 * torch.eye(3, **kw))
        Atb = torch.einsum("bcki,bck->bi", Aw, bw)
        v_b = (linalg.spd_inverse_ns(AtA, iters=16, refine=2)
               @ Atb[..., None])[..., 0]
        v_b = torch.where(any_active, v_b, torch.zeros_like(v_b))

        # contact make: re-anchor at the current world position estimate,
        # the z pinned to the terrain prior when there is one
        made = (active > 0.5) & (est.active_prev < 0.5)
        new_anchor = base_pos[:, None, :] + r
        if self.ground_z is not None:
            new_anchor = torch.cat([new_anchor[..., :2], torch.full_like(
                new_anchor[..., 2:], float(self.ground_z))], dim=-1)
        anchors = torch.where(made[..., None], new_anchor, est.anchors)

        state = RobotState(q=q, qd=qd, base_rot=R, base_pos=base_pos,
                           base_vel=torch.cat([omega_b, v_b], dim=-1))
        return state, EstimatorState(base_pos=base_pos, anchors=anchors,
                                     active_prev=active)
