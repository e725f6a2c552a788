"""Spatial (Plücker) algebra primitives (port of qppvm_tpu/model/spatial.py).

Featherstone conventions, angular-first: motion vectors ``[omega; v]``,
force vectors ``[n; f]``; a frame (E, p) has E rotating parent coordinates
into local ones and p the frame origin in parent coordinates. Every
function broadcasts over any leading dimensions (batch, links).
"""
from __future__ import annotations

import torch


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(v):
    """3-vector -> 3x3 skew-symmetric matrix (skew(v) @ u == v x u)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def _mat3(rows):
    """(..., 3, 3) from a 3 x 3 nested list of (...) tensors."""
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def _cos_sin(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return c, s, torch.ones_like(c), torch.zeros_like(c)


def rot_x(theta):
    """Coordinate rotation about x by ``theta``."""
    c, s, o, z = _cos_sin(theta)
    return _mat3([[o, z, z], [z, c, s], [z, -s, c]])


def rot_y(theta):
    """Coordinate rotation about y by ``theta``."""
    c, s, o, z = _cos_sin(theta)
    return _mat3([[c, z, -s], [z, o, z], [s, z, c]])


def rot_z(theta):
    """Coordinate rotation about z by ``theta``."""
    c, s, o, z = _cos_sin(theta)
    return _mat3([[c, s, z], [-s, c, z], [z, z, o]])


def rot_axis_angle(axis, theta):
    """Rodrigues: E = R(axis, theta)^T, the coordinate rotation (child from
    parent) of a revolute joint turning the child by +theta about ``axis``
    (parent coordinates)."""
    theta = torch.as_tensor(theta, dtype=axis.dtype, device=axis.device)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    c, s = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
    K = skew(axis)
    I = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return (I + s * K + (1.0 - c) * (K @ K)).transpose(-1, -2)


def xform(E, p):
    """Spatial motion transform X = [[E, 0], [-E p^x, E]] (v_child = X
    v_parent) of a child frame at origin p, orientation E."""
    Z = torch.zeros_like(E)
    top = torch.cat([E, Z], dim=-1)
    bot = torch.cat([-E @ skew(p), E], dim=-1)
    return torch.cat([top, bot], dim=-2)


def xform_inv_apply(E, p, v):
    """Apply X^{-1} (child->parent motion transform) to motion vector v."""
    w = torch.einsum("...ji,...j->...i", E, v[..., :3])
    lin = torch.einsum("...ji,...j->...i", E, v[..., 3:]) + _cross(p, w)
    return torch.cat([w, lin], dim=-1)


def xform_apply(E, p, v):
    """Apply X (parent->child motion transform) to motion vector v."""
    w = torch.einsum("...ij,...j->...i", E, v[..., :3])
    lin = torch.einsum("...ij,...j->...i", E, v[..., 3:] - _cross(p, v[..., :3]))
    return torch.cat([w, lin], dim=-1)


def xform_force_apply(E, p, f):
    """Apply X* = X^{-T} (parent->child force transform) to force f."""
    n = torch.einsum("...ij,...j->...i", E, f[..., :3] - _cross(p, f[..., 3:]))
    lin = torch.einsum("...ij,...j->...i", E, f[..., 3:])
    return torch.cat([n, lin], dim=-1)


def xform_force_inv_apply(E, p, f):
    """Apply (X*)^{-1} = X^T (child->parent force transform)."""
    lin = torch.einsum("...ji,...j->...i", E, f[..., 3:])
    n = torch.einsum("...ji,...j->...i", E, f[..., :3]) + _cross(p, lin)
    return torch.cat([n, lin], dim=-1)


def crm(v):
    """Spatial cross-product operator of motion vector v: crm(v) @ m =
    v x m."""
    w, lin = v[..., :3], v[..., 3:]
    Z = torch.zeros_like(skew(w))
    top = torch.cat([skew(w), Z], dim=-1)
    bot = torch.cat([skew(lin), skew(w)], dim=-1)
    return torch.cat([top, bot], dim=-2)


def cross_motion(v, m):
    """v x m for motion vectors."""
    w, lin = v[..., :3], v[..., 3:]
    mw, mlin = m[..., :3], m[..., 3:]
    return torch.cat([_cross(w, mw), _cross(lin, mw) + _cross(w, mlin)], dim=-1)


def cross_force(v, f):
    """v x* f for a motion vector v and force vector f."""
    w, lin = v[..., :3], v[..., 3:]
    fn, fl = f[..., :3], f[..., 3:]
    return torch.cat([_cross(w, fn) + _cross(lin, fl), _cross(w, fl)], dim=-1)


def mcI(m, c, Ic):
    """Spatial inertia (6x6) of a body: mass m, CoM c and rotational inertia
    Ic about the CoM, both in local coordinates."""
    C = skew(c)
    I3 = torch.eye(3, dtype=Ic.dtype, device=Ic.device)
    top = torch.cat([Ic + m * (C @ C.transpose(-1, -2)), m * C], dim=-1)
    bot = torch.cat([m * C.transpose(-1, -2), m * I3], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inertia_apply(I, v):
    """I @ v for 6x6 spatial inertia."""
    return torch.einsum("...ij,...j->...i", I, v)


def quat_to_mat(qw, qx, qy, qz):
    """Unit quaternion (w, x, y, z) -> rotation matrix (rotates vectors)."""
    return _mat3([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)]])


def so3_log(R):
    """Rotation matrix -> rotation vector (axis * angle), safe near 0."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    s = torch.sin(theta)
    small = torch.abs(s) < 1e-6
    scale = torch.where(small, 0.5 + theta * theta / 12.0,
                        theta / torch.where(small, torch.ones_like(s), 2.0 * s))
    return w * scale[..., None]


def so3_exp(w):
    """Rotation vector -> rotation matrix, safe near 0."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    small = theta[..., 0] < 1e-8
    axis = w / torch.where(theta > 1e-8, theta, torch.ones_like(theta))
    K = skew(axis)
    t = theta[..., None]
    I = torch.eye(3, dtype=w.dtype, device=w.device)
    R = I + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)
    return torch.where(small[..., None, None], I + skew(w), R)


def pose_error(R_ref, p_ref, R, p):
    """6D pose error [e_pos; e_rot] (linear-first, world frame):
    e_pos = p_ref - p, e_rot = log(R_ref R^T)."""
    e_pos = p_ref - p
    e_rot = so3_log(R_ref @ R.transpose(-1, -2))
    return torch.cat([e_pos, e_rot], dim=-1)
