"""Robot hardware-abstraction layer and simulated backend (port of
qppvm_tpu/runtime/robot_interface.py), batch-first.

``SimRobot`` mirrors the reference's sense / command / move split: drive
PD plus commanded effort, integrated with compliant ground contact for a
floating base, with IMU and floating-base channels. ``ground_forces`` is
the one contact model: the plant (``_sim_step``) and the MPC rollout both
call it. Every state and every per-robot tensor carries a leading batch
dimension B.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import dynamics, kinematics
from qppvm_tpu_torch.model.robot import RobotModel, RobotState


class SharedObject:
    """Typed in-process channel."""

    def __init__(self, value=None):
        self._value = value

    def set(self, value):
        self._value = value

    def get(self):
        return self._value


class SharedMemory:
    """Name -> SharedObject registry."""

    def __init__(self):
        self._objects: Dict[str, SharedObject] = {}

    def get_shared_object(self, name: str) -> SharedObject:
        if name not in self._objects:
            self._objects[name] = SharedObject()
        return self._objects[name]


@dataclasses.dataclass(frozen=True)
class ImuReading:
    orientation: torch.Tensor          # (B, 3, 3) world-from-base
    angular_velocity: torch.Tensor     # (B, 3) body frame
    linear_acceleration: torch.Tensor  # (B, 3) body frame, gravity included


def standing_state(model: RobotModel, contact_links, ground_z: float = 0.0,
                   batch: int = 1) -> RobotState:
    """Home state translated so the lowest contact link rests on the ground
    plane (no penetration; ``mpc.rollout.standing_state`` adds the
    equilibrium penetration)."""
    st = model.home_state(batch)
    kin = kinematics.fk(model, st)
    foot_z = torch.amin(torch.stack(
        [kin.p[:, model.link_index(c), 2] for c in contact_links]), dim=0)
    zero = torch.zeros_like(foot_z)
    shift = torch.stack([zero, zero, foot_z - ground_z], dim=-1)
    return dataclasses.replace(st, base_pos=st.base_pos - shift)


def contact_offsets_for(contact_links, contact_offsets=None):
    """Per contact link, its local contact points as a tuple of 3-tuples:
    the given patch, else the link origin."""
    offs = []
    for link in contact_links:
        if contact_offsets and link in contact_offsets:
            offs.append(tuple(map(tuple, np.asarray(
                contact_offsets[link], float).reshape(-1, 3).tolist())))
        else:
            offs.append(((0.0, 0.0, 0.0),))
    return tuple(offs)


def ground_forces(model: RobotModel, contact_idx, contact_offsets, ground_z,
                  kp_c, kd_c, mu, kt_c, kin, J_all, u, anchors, dtype,
                  kd_t=None):
    """The ground-contact model: per-point compliant normal force and a
    tangential spring-damper to a per-point xy stiction anchor, clamped to
    the friction cone mu fz; where the clamp saturates the anchor slides so
    the spring stays consistent with the clamped force; anchors reset to
    the point while it is airborne. Forces are accumulated as wrenches
    (force and moment) at each contact link's origin.

    ``kin``, ``J_all`` (B, nj, 6, nv), ``u`` (B, nv) and ``anchors``
    (B, n_pts, 2) are batched; ``mu`` is a float or a (B,) tensor.
    ``kd_t``: tangential damping (default 5 kd_c, the plant's value; a
    coarse integrator must pass an h-scaled one). Every test is per point
    of each item. Returns ``(ext (B, nj, 6), new_anchors (B, n_pts, 2))``."""
    if kd_t is None:
        kd_t = 5.0 * kd_c
    Bsz = u.shape[0]
    dev = u.device
    ext = torch.zeros((Bsz, model.nj, 6), dtype=dtype, device=dev)
    mu = torch.as_tensor(mu, dtype=dtype, device=dev).reshape(-1, 1)
    new_anchors = []
    pt = 0
    for li, offsets in zip(contact_idx, contact_offsets):
        n_pts = len(offsets)
        off = torch.tensor(offsets, dtype=dtype, device=dev)      # (K, 3)
        tw = (J_all[:, li] @ u[..., None])[..., 0]                # (B, 6)
        r = torch.einsum("bij,kj->bki", kin.R[:, li], off)        # (B, K, 3)
        p = kin.p[:, li, None] + r
        v = tw[:, None, :3] + torch.linalg.cross(
            tw[:, None, 3:].expand_as(r), r, dim=-1)
        pen = ground_z - p[..., 2]                        # > 0 in contact
        in_contact = pen > 0.0
        fz = torch.clamp((kp_c * pen - kd_c * v[..., 2]) / n_pts, min=0.0)
        a = anchors[:, pt:pt + n_pts]
        ft = (-kt_c * (p[..., :2] - a) - kd_t * v[..., :2]) / n_pts
        ft_norm = torch.linalg.norm(ft, dim=-1) + 1e-9
        scale = torch.clamp(mu * fz / ft_norm, max=1.0)
        ft = ft * scale[..., None]
        a_slide = p[..., :2] + (ft * n_pts + kd_t * v[..., :2]) / kt_c
        new_anchors.append(torch.where(
            in_contact[..., None],
            torch.where((scale < 1.0)[..., None], a_slide, a), p[..., :2]))
        f = torch.where(in_contact[..., None],
                        torch.cat([ft, fz[..., None]], dim=-1), 0.0)
        wrench = torch.cat([f, torch.linalg.cross(r, f, dim=-1)], dim=-1)
        ext[:, li] += wrench.sum(dim=1)
        pt += n_pts
    return ext, torch.cat(new_anchors, dim=1)


def init_anchors(model: RobotModel, state: RobotState, contact_idx,
                 contact_offsets, dtype=torch.float32):
    """Initial stiction anchors (B, n_pts, 2): each contact point's world
    xy at ``state``."""
    kin = kinematics.fk(model, state)
    pts = []
    for li, offsets in zip(contact_idx, contact_offsets):
        off = torch.tensor(offsets, dtype=dtype, device=state.q.device)
        r = torch.einsum("bij,kj->bki", kin.R[:, li], off)
        pts.append((kin.p[:, li, None] + r)[..., :2])
    if not pts:
        return torch.zeros((state.batch, 0, 2), dtype=dtype,
                           device=state.q.device)
    return torch.cat(pts, dim=1)


def stop_torques(model: RobotModel, state: RobotState,
                 k_stop: float = 2e3, d_stop: float = 20.0):
    """Joint-limit hard-stop torques (B, nj): stiff damped springs beyond
    [q_min, q_max], not clipped by tau_max."""
    dtype = state.q.dtype
    below = torch.clamp(model.q_min.to(dtype) - state.q, min=0.0)
    above = torch.clamp(state.q - model.q_max.to(dtype), min=0.0)
    in_stop = (below > 0.0) | (above > 0.0)
    return k_stop * (below - above) - torch.where(in_stop, d_stop * state.qd,
                                                  0.0)


def _sim_step(model: RobotModel, h: float, contact_idx, contact_offsets,
              ground_z, kp_c, kd_c, mu, kt_c, state: RobotState, anchors,
              tau_ref, q_ref, k, d):
    """One physics substep: drive PD + effort (clipped to tau_max) + joint
    hard stops + ground contact. Returns ``(new_state, new_anchors)``."""
    tau = tau_ref + k * (q_ref - state.q) - d * state.qd
    tau = torch.clamp(tau, -model.tau_max, model.tau_max)
    tau = tau + stop_torques(model, state)
    ext, new_anchors, kin = None, anchors, None
    if contact_idx:
        kin = kinematics.fk(model, state)
        J_all = kinematics.all_link_jacobians(model, kin)
        u = state.u if model.floating else state.qd
        ext, new_anchors = ground_forces(
            model, contact_idx, contact_offsets, ground_z, kp_c, kd_c, mu,
            kt_c, kin, J_all, u, anchors, state.q.dtype)
    udot = dynamics.forward_dynamics(model, state, tau, ext_wrenches=ext,
                                     kin=kin)
    return dynamics.integrate(model, state, udot, h), new_anchors


class SimRobot:
    """Simulated robot: drive-level PD + commanded effort, integrated with
    compliant ground contact for floating-base robots; ``sense`` through the
    getters, then ``set_reference`` and ``move`` advance one control
    period of ``substeps`` physics steps. Runs on the model's device."""

    def __init__(self, model: RobotModel, state: Optional[RobotState] = None,
                 dt: float = 1e-3, substeps: int = 4, contact_links=(),
                 ground_z: float = 0.0, contact_kp: float = 2e4,
                 contact_kd: float = 300.0, mu: float = 0.8,
                 contact_kt: float = 2e4, contact_offsets=None,
                 dtype=torch.float32):
        """``contact_offsets``: optional dict link_name -> (K, 3) local
        contact points (flat-foot patches); default the link origin."""
        self.model = model
        self.dt = dt
        self.substeps = substeps
        self.state = state if state is not None else model.home_state()
        self.dtype = dtype
        self.contact_links = tuple(contact_links)
        self._contact_idx = tuple(model.link_index(c) for c in contact_links)
        self._contact_offsets = contact_offsets_for(contact_links,
                                                    contact_offsets)
        self.ground_z = ground_z
        self.contact_kp = contact_kp
        self.contact_kd = contact_kd
        self.mu = mu
        self.contact_kt = contact_kt
        kw = dict(dtype=dtype, device=model.device)
        # drive-level impedance (set_stiffness / set_damping)
        self.k = torch.zeros(model.nj, **kw)
        self.d = torch.zeros(model.nj, **kw)
        self._q_ref = self.state.q
        self._tau_ref = torch.zeros((self.state.batch, model.nj), **kw)
        self.shared_memory = SharedMemory()
        self._fb_pos = self.shared_memory.get_shared_object(
            "/sim/floating_base_position")
        self._fb_vel = self.shared_memory.get_shared_object(
            "/sim/floating_base_velocity")
        self._publish_fb()
        # one stiction anchor per contact point (static friction)
        self._anchors = init_anchors(model, self.state, self._contact_idx,
                                     self._contact_offsets, dtype)
        # one physics substep: step(state, anchors, tau_ref, q_ref, k, d)
        # -> (state, anchors)
        self.step = partial(_sim_step, model, dt / substeps,
                            self._contact_idx, self._contact_offsets,
                            ground_z, contact_kp, contact_kd, mu, contact_kt)

    # --- sense side -----------------------------------------------------
    def get_motor_position(self):
        return self.state.q

    def get_motor_velocity(self):
        return self.state.qd

    def get_imu(self) -> ImuReading:
        st = self.state
        g = self.model.gravity.to(st.q.dtype)
        return ImuReading(orientation=st.base_rot,
                          angular_velocity=st.base_vel[:, :3],
                          linear_acceleration=-torch.einsum(
                              "bji,j->bi", st.base_rot, g))

    # --- command side ---------------------------------------------------
    def _tensor(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.model.device)

    def set_stiffness(self, k):
        self.k = self._tensor(k)

    def set_damping(self, d):
        self.d = self._tensor(d)

    def set_reference(self, tau_ref=None, q_ref=None):
        if tau_ref is not None:
            self._tau_ref = self._tensor(tau_ref)
        if q_ref is not None:
            self._q_ref = self._tensor(q_ref)

    def move(self):
        """Advance physics by one control period (the span ``plant``, a
        ``plant.substep`` in it for each substep)."""
        with telemetry.span("plant"):
            for _ in range(self.substeps):
                with telemetry.span("plant.substep"):
                    self.state, self._anchors = self.step(
                        self.state, self._anchors, self._tau_ref,
                        self._q_ref, self.k, self.d)
            self._publish_fb()

    def _publish_fb(self):
        if self.model.floating:
            self._fb_pos.set(self.state.base_pos)
            self._fb_vel.set(torch.einsum("bij,bj->bi", self.state.base_rot,
                                          self.state.base_vel[:, 3:]))
