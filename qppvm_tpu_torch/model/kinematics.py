"""Batched forward kinematics, Jacobians, CoM and bias accelerations
(port of qppvm_tpu/model/kinematics.py).

Every state tensor has a leading batch dimension B. The FK and velocity
recursions run level by level over the kinematic tree: joints at one depth
are independent, so each level is one gather + batched product + scatter.

Public conventions: world frame, linear-first twists ``[v; w]``; generalized
velocity of a floating model ``u = [base_twist_body (w, v); qd]``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qppvm_tpu_torch import device as device_lib
from qppvm_tpu_torch.model import spatial
from qppvm_tpu_torch.model.robot import REVOLUTE, RobotModel, RobotState


@dataclasses.dataclass(frozen=True)
class KinData:
    """Per-step kinematic data for all links (dims: batch, link)."""

    R: torch.Tensor         # (B, nj, 3, 3) world-from-link rotation
    p: torch.Tensor         # (B, nj, 3) link origin in world
    S_ang: torch.Tensor     # (B, nj, 3) world joint axis
    S_lin_at: torch.Tensor  # (B, nj, 3) world joint-axis origin
    base_R: torch.Tensor    # (B, 3, 3)
    base_p: torch.Tensor    # (B, 3)


_LEVEL_CACHE = {}


def tree_levels(parent):
    """Static depth levels: list of (joint_idx, parent_idx) numpy arrays, one
    per tree depth."""
    key = tuple(parent)
    if key not in _LEVEL_CACHE:
        depth = []
        for i, p in enumerate(parent):
            depth.append(0 if p < 0 else depth[p] + 1)
        levels = []
        for d in range(max(depth) + 1 if depth else 0):
            idx = np.asarray([i for i in range(len(parent)) if depth[i] == d],
                             np.int64)
            par = np.asarray([parent[i] for i in idx], np.int64)
            levels.append((idx, par))
        _LEVEL_CACHE[key] = levels
    return _LEVEL_CACHE[key]


_STATIC_CACHE = {}


def _static(model: RobotModel, name: str, make):
    """Topology-derived constant ``make()`` as a tensor on the model's
    device, cached per (topology, device) so the tick copies no index or
    mask arrays to the card."""
    key = (name, model.parent, model.joint_type, str(model.device))
    if key not in _STATIC_CACHE:
        _STATIC_CACHE[key] = make()
    return _STATIC_CACHE[key]


def frame_spec(model: RobotModel, name: str, like: torch.Tensor):
    """``model.frame_spec(name)`` with its offsets as tensors of ``like``'s
    dtype and device, made once (a constant of the model), so the tick
    copies nothing from the host; None for a link."""
    def make():
        spec = model.frame_spec(name)
        if spec is None:
            return None
        li, E_off, p_off = spec
        kw = dict(dtype=like.dtype, device=like.device)
        return li, torch.as_tensor(E_off, **kw), torch.as_tensor(p_off, **kw)
    return device_lib.constant(model, ("frame", name, like.dtype, like.device),
                               make)


def device_levels(model: RobotModel):
    """``tree_levels`` on the model's device: per level (idx, clamped parent
    idx, root mask)."""
    as_t = lambda a: torch.as_tensor(a, device=model.device)  # noqa: E731
    return _static(model, "levels", lambda: [
        (as_t(idx), as_t(np.maximum(par, 0)), as_t(par < 0))
        for idx, par in tree_levels(model.parent)])


def _is_revolute(model: RobotModel) -> torch.Tensor:
    return _static(model, "revolute", lambda: torch.as_tensor(
        np.asarray([t == REVOLUTE for t in model.joint_type]),
        device=model.device))


def joint_local_all(model: RobotModel, q):
    """Local transforms of all joints: E (B, nj, 3, 3), p (B, nj, 3)."""
    axis = model.axis.to(q.dtype)
    E_tree = model.E_tree.to(q.dtype)
    p_tree = model.p_tree.to(q.dtype)
    c = torch.cos(q)[..., None, None]
    s = torch.sin(q)[..., None, None]
    K = spatial.skew(axis)                             # (nj, 3, 3)
    I = torch.eye(3, dtype=q.dtype, device=q.device)
    R_rot = I + s * K + (1.0 - c) * (K @ K)            # rotates by +q
    E_rev = R_rot.transpose(-1, -2) @ E_tree
    p_rev = p_tree.expand(q.shape[0], -1, -1)
    p_pri = p_tree + torch.einsum("nji,bnj->bni", E_tree, axis * q[..., None])
    rev = _is_revolute(model)
    E = torch.where(rev[:, None, None], E_rev, E_tree)
    p = torch.where(rev[:, None], p_rev, p_pri)
    return E, p


def fk(model: RobotModel, state: RobotState) -> KinData:
    """World pose of every link frame + world joint axes (level-parallel)."""
    base_R, base_p = state.base_rot, state.base_pos
    E_loc, p_loc = joint_local_all(model, state.q)
    B, nj = state.q.shape
    R = torch.zeros((B, nj, 3, 3), dtype=state.q.dtype, device=state.q.device)
    p = torch.zeros((B, nj, 3), dtype=state.q.dtype, device=state.q.device)
    for idx, parc, root in device_levels(model):
        Rp = torch.where(root[:, None, None], base_R[:, None], R[:, parc])
        pp = torch.where(root[:, None], base_p[:, None], p[:, parc])
        R_wi = Rp @ E_loc[:, idx].transpose(-1, -2)
        p_wi = pp + torch.einsum("bnij,bnj->bni", Rp, p_loc[:, idx])
        R = R.index_copy(1, idx, R_wi)
        p = p.index_copy(1, idx, p_wi)
    S_ang = torch.einsum("bnij,nj->bni", R, model.axis.to(state.q.dtype))
    return KinData(R=R, p=p, S_ang=S_ang, S_lin_at=p, base_R=base_R,
                   base_p=base_p)


def point_jacobians(model: RobotModel, kin: KinData, points_w, link_idx_mask):
    """Jacobians (B, L, 6, nv) of L world points (B, L, 3); ``link_idx_mask``
    (L, nj) bool: joint j moves point l. Rows linear-first [v; w]; columns
    [base(6, body twist (w, v)); qd] when floating."""
    dtype = points_w.dtype
    rev = _is_revolute(model)
    r = points_w[:, :, None, :] - kin.S_lin_at[:, None, :, :]  # (B, L, nj, 3)
    ang_rev = kin.S_ang[:, None].expand_as(r)
    lin_rev = torch.linalg.cross(ang_rev, r, dim=-1)
    ang = torch.where(rev[:, None], ang_rev, torch.zeros_like(r))
    lin = torch.where(rev[:, None], lin_rev, ang_rev)
    mask = link_idx_mask[..., None].to(dtype)                 # (L, nj, 1)
    Jq = torch.cat([lin * mask, ang * mask], dim=-1).transpose(-1, -2)
    if not model.floating:
        return Jq
    Rb = kin.base_R[:, None]                                   # (B, 1, 3, 3)
    rb = points_w - kin.base_p[:, None]                        # (B, L, 3)
    J_lin_w = -spatial.skew(rb) @ Rb                           # (B, L, 3, 3)
    J_lin_v = Rb.expand_as(J_lin_w)
    Jb = torch.cat([torch.cat([J_lin_w, J_lin_v], dim=-1),
                    torch.cat([J_lin_v, torch.zeros_like(J_lin_w)], dim=-1)],
                   dim=-2)                                      # (B, L, 6, 6)
    return torch.cat([Jb, Jq], dim=-1)


def _ancestor_mask(model: RobotModel) -> torch.Tensor:
    return _static(model, "ancestors", lambda: torch.as_tensor(
        model.ancestor_mask(), device=model.device))


def all_link_jacobians(model: RobotModel, kin: KinData):
    """(B, nj, 6, nv) world Jacobians at every link origin."""
    return point_jacobians(model, kin, kin.p, _ancestor_mask(model))


def link_jacobian(model: RobotModel, kin: KinData, link: str):
    """(B, 6, nv) world Jacobian of a named link frame origin."""
    li = model.link_index(link)
    B = kin.p.shape[0]
    if li < 0:
        if not model.floating:
            return torch.zeros((B, 6, model.nv), dtype=kin.p.dtype,
                               device=kin.p.device)
        m = torch.zeros((1, model.nj), dtype=torch.bool, device=kin.p.device)
        return point_jacobians(model, kin, kin.base_p[:, None], m)[:, 0]
    mask = _ancestor_mask(model)[li][None]
    return point_jacobians(model, kin, kin.p[:, li][:, None], mask)[:, 0]


def link_pose(model: RobotModel, kin: KinData, link: str):
    """(R (B, 3, 3), p (B, 3)) world pose of a named link or extra frame."""
    spec = frame_spec(model, link, kin.base_R)
    if spec is not None:
        li, E_off, p_off = spec
        Rp, pp = ((kin.base_R, kin.base_p) if li < 0
                  else (kin.R[:, li], kin.p[:, li]))
        return Rp @ E_off, pp + Rp @ p_off
    li = model.link_index(link)
    if li < 0:
        return kin.base_R, kin.base_p
    return kin.R[:, li], kin.p[:, li]


def point_position(model: RobotModel, kin: KinData, link: str, local_point):
    """(B, 3) world position of a point given in the coordinates of a named
    link or frame."""
    R, p = link_pose(model, kin, link)
    local = torch.as_tensor(local_point, dtype=p.dtype, device=p.device)
    return p + R @ local


def _link_masses(model: RobotModel):
    """Per-link mass and mass-weighted local CoM, read off spatial.mcI's
    blocks: m*cx = M[2,4], m*cy = M[0,5], m*cz = M[1,3]."""
    I = model.inertia
    return I[:, 5, 5], torch.stack([I[:, 2, 4], I[:, 0, 5], I[:, 1, 3]], -1)


def _base_com_local(model: RobotModel):
    Ib = model.base_inertia
    mb = Ib[5, 5]
    return mb, torch.stack([Ib[2, 4], Ib[0, 5], Ib[1, 3]]) / torch.clamp(
        mb, min=1e-12)


def com(model: RobotModel, kin: KinData):
    """(total_mass (B,), com_world (B, 3)); includes the floating root."""
    m_links, mc_local = _link_masses(model)
    com_w = kin.p + torch.einsum(
        "bnij,nj->bni", kin.R, mc_local / torch.clamp(m_links, min=1e-12)[:, None])
    total = torch.sum(m_links)
    weighted = torch.sum(m_links[:, None] * com_w, dim=1)
    if model.floating:
        mb, cb_local = _base_com_local(model)
        com_b = kin.base_p + kin.base_R @ cb_local
        total = total + mb
        weighted = weighted + mb * com_b
    total = total.expand(kin.p.shape[0])
    return total, weighted / torch.clamp(total, min=1e-12)[:, None]


def link_velocities(model: RobotModel, kin: KinData, state: RobotState,
                    J_all=None):
    """(B, nj, 6) world twist [v; w] of each link origin = J_all u (qd on a
    fixed base); ``J_all`` reuses Jacobians already computed at ``kin``."""
    J = all_link_jacobians(model, kin) if J_all is None else J_all
    u = state.u if model.floating else state.qd
    return torch.einsum("bnrv,bv->bnr", J, u)


def com_velocity(model: RobotModel, kin: KinData, state: RobotState, vel_all):
    """Measured CoM velocity (B, 3): mass-weighted average of per-link CoM
    point velocities; ``vel_all`` (B, nj, 6) linear-first link twists."""
    m_links, mc_local = _link_masses(model)
    c_w = torch.einsum("bnij,nj->bni", kin.R,
                       mc_local / torch.clamp(m_links, min=1e-12)[:, None])
    v_pts = vel_all[..., :3] + torch.linalg.cross(vel_all[..., 3:], c_w, dim=-1)
    total = torch.sum(m_links)
    weighted = torch.sum(m_links[:, None] * v_pts, dim=1)
    if model.floating:
        mb, cb_local = _base_com_local(model)
        w_b = torch.einsum("bij,bj->bi", kin.base_R, state.base_vel[:, :3])
        v_b = torch.einsum("bij,bj->bi", kin.base_R, state.base_vel[:, 3:])
        v_cb = v_b + torch.linalg.cross(w_b, kin.base_R @ cb_local, dim=-1)
        total = total + mb
        weighted = weighted + mb * v_cb
    return weighted / torch.clamp(total, min=1e-12)


def motion_subspace_all(model: RobotModel, dtype) -> torch.Tensor:
    """(nj, 6) local motion subspaces, angular-first."""
    ax = model.axis.to(dtype)
    z = torch.zeros_like(ax)
    rev = _is_revolute(model)[:, None]
    return torch.where(rev, torch.cat([ax, z], -1), torch.cat([z, ax], -1))


def propagate_va(model: RobotModel, qd, qdd, v_base, a_base, E_loc, p_loc):
    """Level-parallel forward sweep of body-frame spatial velocity and
    acceleration: v_i = X v_par + S qd_i; a_i = X a_par + S qdd_i + v x S qd.
    Returns ((B, nj, 6), (B, nj, 6))."""
    dtype = E_loc.dtype
    qd, qdd = qd.to(dtype), qdd.to(dtype)
    B, nj = qd.shape
    S = motion_subspace_all(model, dtype)
    v = torch.zeros((B, nj, 6), dtype=dtype, device=qd.device)
    a = torch.zeros_like(v)
    for idx, parc, root in device_levels(model):
        vp = torch.where(root[:, None], v_base[:, None], v[:, parc])
        ap = torch.where(root[:, None], a_base[:, None], a[:, parc])
        E, pl = E_loc[:, idx], p_loc[:, idx]
        vj = S[idx] * qd[:, idx, None]
        v_i = spatial.xform_apply(E, pl, vp) + vj
        a_i = (spatial.xform_apply(E, pl, ap) + S[idx] * qdd[:, idx, None]
               + spatial.cross_motion(v_i, vj))
        v = v.index_copy(1, idx, v_i)
        a = a.index_copy(1, idx, a_i)
    return v, a


def bias_accelerations(model: RobotModel, kin: KinData, state: RobotState):
    """(B, nj, 6) classical bias acceleration Jdot*u of each link origin,
    linear-first world frame."""
    dtype = state.q.dtype
    B = state.q.shape[0]
    vb = (state.base_vel if model.floating
          else torch.zeros((B, 6), dtype=dtype, device=state.q.device))
    ab = torch.zeros((B, 6), dtype=dtype, device=state.q.device)
    E_loc, p_loc = joint_local_all(model, state.q)
    v_body, a_body = propagate_va(model, state.qd, torch.zeros_like(state.qd),
                                  vb, ab, E_loc, p_loc)
    rot = lambda v: torch.einsum("bnij,bnj->bni", kin.R, v)  # noqa: E731
    w_w, v_w = rot(v_body[..., :3]), rot(v_body[..., 3:])
    aw_ang, aw_lin = rot(a_body[..., :3]), rot(a_body[..., 3:])
    lin_cl = aw_lin + torch.linalg.cross(w_w, v_w, dim=-1)
    return torch.cat([lin_cl, aw_ang], dim=-1)
