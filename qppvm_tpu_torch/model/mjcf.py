"""MJCF (MuJoCo XML) loader -> RobotModel (port of qppvm_tpu/model/mjcf.py).

Host only: MuJoCo's own compiler parses the file (defaults, compiler
settings, fromto geoms), and this module converts the compiled ``mjModel``
into the port's ``RobotModel`` on the device asked for. It needs the
``mujoco`` package, imported when the loader is called; where that package
is not installed the loader raises ImportError and every other module
works without it (the card tests load no MJCF file: a CUDA host need not
have ``mujoco``). Gymnasium ships the classic published MJCF robots
(ant.xml, humanoid.xml).

Mapping notes:
- one link per JOINT (hinge/slide). A body with several joints becomes a
  chain of links whose last element carries the body's inertia (the
  standard composite-joint emulation); a body with NO joints is lumped
  into its nearest moving ancestor and its frame registered as an extra
  named frame (same policy as the URDF loader's fixed-joint lumping).
- a body whose first joint is FREE becomes the floating base (must be a
  child of the world and carry the free joint at the body origin).
- link frames sit at the joint anchor (``jnt_pos``) with the body-frame
  orientation; every named body is additionally registered as a frame, so
  task/contact code can keep addressing MuJoCo body names.
- ``tau_max`` comes from the actuators (|gear| * max |ctrlrange|) when the
  joint is actuated, ``armature`` from ``dof_armature``, limits from
  ``jnt_range``, the home configuration from ``qpos0``, gravity from
  ``opt.gravity``.
- capsule "feet": for bodies whose distal capsule geom ends away from the
  joint anchor, ``tip_frames=True`` registers ``<name>_tip`` frames at the
  far capsule end — contact points for point-foot robots like ant (a
  contact frame ON a joint axis would zero that joint's column of the
  contact Jacobian; see zoo._add_leg4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from qppvm_tpu_torch import device as devices
from qppvm_tpu_torch.model.robot import (PRISMATIC, REVOLUTE, RobotModel,
                                         build_model)

_BIG = 1e3


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def load_mjcf(path: Optional[str] = None, *, xml: Optional[str] = None,
              tip_frames: bool = False, dtype=torch.float32,
              device=devices.DEFAULT) -> RobotModel:
    """Load a MuJoCo XML model file (or literal ``xml`` text) into a
    RobotModel on ``device``."""
    import mujoco

    if xml is not None:
        m = mujoco.MjModel.from_xml_string(xml)
    else:
        m = mujoco.MjModel.from_xml_path(path)

    def body_name(b):
        n = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_BODY, b)
        return n if n else f"body_{b}"

    def joint_name(j):
        n = mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_JOINT, j)
        return n if n else f"joint_{j}"

    # --- identify the floating base ----------------------------------
    floating = False
    base_body = None
    for j in range(m.njnt):
        if m.jnt_type[j] == mujoco.mjtJoint.mjJNT_FREE:
            if floating:
                raise ValueError("multiple free joints unsupported")
            floating = True
            base_body = int(m.jnt_bodyid[j])
            if int(m.body_parentid[base_body]) != 0:
                raise ValueError("free joint must hang off the world body")
            if np.linalg.norm(m.jnt_pos[j]) > 1e-12:
                raise ValueError("free joint with offset anchor unsupported")
        elif m.jnt_type[j] == mujoco.mjtJoint.mjJNT_BALL:
            raise ValueError("ball joints unsupported (decompose into "
                             "hinges in the MJCF)")

    # builder state
    parent: List[int] = []
    joint_type: List[int] = []
    axis: List[np.ndarray] = []
    E_tree: List[np.ndarray] = []
    p_tree: List[np.ndarray] = []
    mass: List[float] = []
    com: List[np.ndarray] = []
    icom: List[np.ndarray] = []
    jnames: List[str] = []
    lnames: List[str] = []
    q_home: List[float] = []
    q_min: List[float] = []
    q_max: List[float] = []
    tau_max: List[float] = []
    armature: List[float] = []
    frames: List[tuple] = []

    # Per-joint actuation limit. MuJoCo semantics: an actuator without
    # ctrlrange (ctrllimited false) has UNBOUNDED control -> the joint's
    # torque cap is _BIG, not gear*1 (which would be a silently tight cap
    # on models other than the shipped ant/humanoid). Multiple actuators on
    # one joint SUM their authority (their torques superpose).
    jnt_tau = {}
    for a in range(m.nu):
        if m.actuator_trntype[a] == mujoco.mjtTrn.mjTRN_JOINT:
            j = int(m.actuator_trnid[a, 0])
            gear = abs(float(m.actuator_gear[a, 0]))
            cr = m.actuator_ctrlrange[a]
            lim = max(abs(float(cr[0])), abs(float(cr[1])))
            cap = gear * lim if m.actuator_ctrllimited[a] else _BIG
            jnt_tau[j] = min(jnt_tau.get(j, 0.0) + cap, _BIG)

    def body_inertial(b, R_off, p_off):
        """(mass, com, I_com) of body b expressed in a frame displaced from
        the body frame by (R_off, p_off): x_frame = R_off^T (x_body - p_off).
        """
        bm = float(m.body_mass[b])
        R_iq = _quat_to_mat(m.body_iquat[b])
        I_b = R_iq @ np.diag(m.body_inertia[b]) @ R_iq.T  # about COM, body fr
        c_b = m.body_ipos[b]
        c_f = R_off.T @ (c_b - p_off)
        I_f = R_off.T @ I_b @ R_off
        return bm, c_f, I_f

    # attach[b] = (link_idx, R, p): pose of body b's frame in that link's
    # frame (link -1 = floating base / fixed root)
    attach: Dict[int, tuple] = {}
    base_mass = 0.0
    base_com = np.zeros(3)
    base_I = np.zeros((3, 3))
    root_name = "world"

    def _pax(d):
        return (float(d @ d) * np.eye(3) - np.outer(d, d))

    def lump_base(b, R, p):
        nonlocal base_mass, base_com, base_I
        bm, c, I = body_inertial(b, np.eye(3), np.zeros(3))
        if bm <= 0:
            return
        c_w = p + R @ c
        I_w = R @ I @ R.T
        tot = base_mass + bm
        new_com = (base_mass * base_com + bm * c_w) / tot
        base_I = (base_I + base_mass * _pax(base_com - new_com)
                  + I_w + bm * _pax(c_w - new_com))
        base_com = new_com
        base_mass = tot

    home = []

    for b in range(1, m.nbody):
        pb = int(m.body_parentid[b])
        R_pb = _quat_to_mat(m.body_quat[b])
        p_pb = np.array(m.body_pos[b], float)

        if b == base_body:
            root_name = body_name(b)
            attach[b] = (-1, np.eye(3), np.zeros(3))
            lump_base(b, np.eye(3), np.zeros(3))
            continue

        if pb == 0 and not floating:
            # fixed-base root chain: bodies hang off the world
            attach_parent = (-1, np.eye(3), np.zeros(3))
        elif pb == 0:
            raise ValueError(f"body {body_name(b)} attached to the world "
                             "beside the floating base")
        else:
            attach_parent = attach[pb]
        pl, R_l, p_l = attach_parent
        # pose of body b in link pl's frame
        R_b = R_l @ R_pb
        p_b = p_l + R_l @ p_pb

        njb = int(m.body_jntnum[b])
        if njb == 0:
            # lump into the carrying link
            if pl == -1 and floating:
                lump_base(b, R_b, p_b)
            elif pl == -1:
                lump_base(b, R_b, p_b)
            else:
                bm, c, I = body_inertial(b, np.eye(3), np.zeros(3))
                if bm > 0:
                    c_l = p_b + R_b @ c
                    I_l = R_b @ I @ R_b.T
                    tot = mass[pl] + bm
                    new_com = (mass[pl] * com[pl] + bm * c_l) / tot
                    icom[pl] = (icom[pl] + mass[pl] * _pax(com[pl] - new_com)
                                + I_l + bm * _pax(c_l - new_com))
                    com[pl] = new_com
                    mass[pl] = tot
            frames.append((body_name(b), pl, R_b, p_b))
            attach[b] = (pl, R_b, p_b)
            continue

        jadr = int(m.body_jntadr[b])
        cur_parent = pl
        cur_R = R_b            # link->body-frame rotation for anchor math
        prev_anchor = None
        for k in range(njb):
            j = jadr + k
            jt = int(m.jnt_type[j])
            if jt == mujoco.mjtJoint.mjJNT_FREE:
                raise ValueError("free joint on a non-root body")
            our_type = REVOLUTE if jt == mujoco.mjtJoint.mjJNT_HINGE \
                else PRISMATIC
            anchor = np.array(m.jnt_pos[j], float)
            if k == 0:
                # E_tree convention is parent-FROM-child (fk composes
                # R_world = R_parent @ E_tree^T), so store the transpose of
                # the child-axes-in-parent rotation
                E = R_b.T
                off = p_b + R_b @ anchor
            else:
                E = np.eye(3)
                off = anchor - prev_anchor
            prev_anchor = anchor
            i = len(parent)
            parent.append(cur_parent)
            joint_type.append(our_type)
            axis.append(np.array(m.jnt_axis[j], float))
            E_tree.append(E)
            p_tree.append(off)
            if k == njb - 1:
                bm, c, I = body_inertial(b, np.eye(3), anchor)
                mass.append(bm)
                com.append(c)
                icom.append(I)
            else:
                mass.append(0.0)
                com.append(np.zeros(3))
                icom.append(np.zeros((3, 3)))
            jnames.append(joint_name(j))
            lnames.append(f"{joint_name(j)}_link")
            lim = bool(m.jnt_limited[j])
            q_min.append(float(m.jnt_range[j, 0]) if lim else -_BIG)
            q_max.append(float(m.jnt_range[j, 1]) if lim else _BIG)
            qadr = int(m.jnt_qposadr[j])
            # clamp the home posture INTO the joint range: published files
            # can carry qpos0 outside jnt_range (humanoid.xml knees: qpos0=0
            # vs range [-160deg, -2deg]); MuJoCo enforces the limit in sim,
            # and a home the postural task can never reach destabilizes a
            # stand (measured: knees hyperextend until the robot bows over)
            q_home.append(float(np.clip(m.qpos0[qadr],
                                        q_min[-1], q_max[-1])))
            tau_max.append(jnt_tau.get(j, _BIG))
            dadr = int(m.jnt_dofadr[j])
            armature.append(float(m.dof_armature[dadr]))
            cur_parent = i
        # register the BODY frame on the last link (body origin relative to
        # the last joint anchor, identity rotation — link frame carries the
        # body orientation)
        last = len(parent) - 1
        frames.append((body_name(b), last, np.eye(3), -prev_anchor))
        attach[b] = (last, np.eye(3), -prev_anchor)

    if tip_frames:
        gt_capsule = int(mujoco.mjtGeom.mjGEOM_CAPSULE)
        gt_sphere = int(mujoco.mjtGeom.mjGEOM_SPHERE)
        for g in range(m.ngeom):
            gt = int(m.geom_type[g])
            if gt not in (gt_capsule, gt_sphere):
                continue
            b = int(m.geom_bodyid[g])
            if b == 0 or b not in attach:
                continue
            # leaf bodies only (feet)
            if any(int(m.body_parentid[bb]) == b for bb in range(m.nbody)):
                continue
            li, R_bf, p_bf = attach[b]
            if li == -1:
                continue
            if gt == gt_capsule:
                Rg = _quat_to_mat(m.geom_quat[g])
                half = float(m.geom_size[g, 1])
                # the far capsule end = the contact tip (ant feet)
                tips = [m.geom_pos[g] + s * Rg @ np.array([0.0, 0.0, half])
                        for s in (+1.0, -1.0)]
                far = max(tips, key=lambda t: float(np.linalg.norm(t)))
            else:
                # sphere foot (published humanoid.xml:49,62): contact tip =
                # the sphere's lowest point in the body frame (feet bodies
                # are ~world-aligned at home)
                r = float(m.geom_size[g, 0])
                far = m.geom_pos[g] - np.array([0.0, 0.0, r])
            p_tip = p_bf + R_bf @ far
            tip_name = body_name(b) + "_tip"
            if any(f[0] == tip_name for f in frames):
                continue   # one tip per body (first geom wins)
            frames.append((tip_name, li, np.eye(3), p_tip))

    model = build_model(
        parent=parent, joint_type=joint_type, axis=np.stack(axis),
        E_tree=np.stack(E_tree), p_tree=np.stack(p_tree), mass=mass,
        com=com, inertia_com=icom, joint_names=jnames, link_names=lnames,
        root_name=root_name, floating=floating, base_mass=base_mass,
        base_com=base_com, base_inertia_com=base_I,
        q_home=q_home, q_min=q_min, q_max=q_max, tau_max=tau_max,
        armature=armature, gravity=tuple(np.array(m.opt.gravity, float)),
        dtype=dtype, device=device,
    )
    return dataclasses.replace(model, frames=tuple(
        (n, li, tuple(map(tuple, np.asarray(E, float))),
         tuple(np.asarray(p, float))) for (n, li, E, p) in frames))
