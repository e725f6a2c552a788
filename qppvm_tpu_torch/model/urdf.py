"""Minimal URDF loader -> RobotModel (port of qppvm_tpu/model/urdf.py).

The robot description is parsed on the host with numpy and ``xml.etree``;
the model's tensors are built on the device asked for. Supports:
revolute/continuous/prismatic/fixed joints, inertial blocks with origin
offsets and joint limits; the home configuration is q = 0 (the
reference's docstring also promises named "home" configurations, which
it never parses). Fixed-joint
subtrees are *lumped*: child inertia is transformed into the parent link and
the child link name becomes a named frame on the parent (usable as a task
frame / contact link).
"""
from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np
import torch

from qppvm_tpu_torch import device as devices
from qppvm_tpu_torch.model.robot import (PRISMATIC, REVOLUTE, RobotModel,
                                         build_model)


def _rpy_to_mat(r, p, y):
    """URDF rpy -> rotation matrix R = Rz(y) Ry(p) Rx(r) (rotates vectors)."""
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def _parse_origin(elem) -> tuple[np.ndarray, np.ndarray]:
    if elem is None:
        return np.eye(3), np.zeros(3)
    xyz = np.fromstring(elem.get("xyz", "0 0 0"), sep=" ")
    rpy = np.fromstring(elem.get("rpy", "0 0 0"), sep=" ")
    return _rpy_to_mat(*rpy), xyz


class _Link:
    def __init__(self, name):
        self.name = name
        self.mass = 0.0
        self.com = np.zeros(3)
        self.inertia = np.zeros((3, 3))

    @staticmethod
    def from_xml(elem) -> "_Link":
        lk = _Link(elem.get("name"))
        inertial = elem.find("inertial")
        if inertial is not None:
            R, p = _parse_origin(inertial.find("origin"))
            mass_el = inertial.find("mass")
            lk.mass = (float(mass_el.get("value")) if mass_el is not None
                       else 0.0)
            lk.com = p
            in_el = inertial.find("inertia")
            if in_el is not None:
                ixx = float(in_el.get("ixx", 0))
                iyy = float(in_el.get("iyy", 0))
                izz = float(in_el.get("izz", 0))
                ixy = float(in_el.get("ixy", 0))
                ixz = float(in_el.get("ixz", 0))
                iyz = float(in_el.get("iyz", 0))
                I_local = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz],
                                    [ixz, iyz, izz]])
                # inertia given in the inertial frame; rotate to link frame
                lk.inertia = R @ I_local @ R.T
        return lk

    def lump(self, other: "_Link", R_po: np.ndarray, p_po: np.ndarray):
        """Absorb ``other`` rigidly attached at (R_po, p_po) in our frame."""
        m2 = other.mass
        if m2 <= 0 and np.allclose(other.inertia, 0):
            return
        com2 = p_po + R_po @ other.com
        I2 = R_po @ other.inertia @ R_po.T
        m1 = self.mass
        com_new = ((m1 * self.com + m2 * com2) / max(m1 + m2, 1e-12))

        def shift(I, m, c, c_new):
            d = c - c_new
            return I + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))

        self.inertia = shift(self.inertia, m1, self.com, com_new) + \
            shift(I2, m2, com2, com_new)
        self.com = com_new
        self.mass = m1 + m2


def load_urdf(source: str, *, floating: Optional[bool] = None,
              root_link: Optional[str] = None, armature=None,
              gravity=(0.0, 0.0, -9.81), dtype=torch.float32,
              device=devices.DEFAULT) -> RobotModel:
    """Parse a URDF string or file path into a RobotModel on ``device``.

    ``floating``: force floating/fixed base; default: floating iff the URDF
    has a joint of type "floating", else fixed.
    """
    if "<robot" not in source:
        with open(source) as f:
            source = f.read()
    root = ET.fromstring(source)

    links: Dict[str, _Link] = {}
    for le in root.findall("link"):
        links[le.get("name")] = _Link.from_xml(le)

    joints = []
    child_of = {}
    for je in root.findall("joint"):
        j = dict(
            name=je.get("name"),
            type=je.get("type"),
            parent=je.find("parent").get("link"),
            child=je.find("child").get("link"),
        )
        j["R"], j["p"] = _parse_origin(je.find("origin"))
        ax = je.find("axis")
        j["axis"] = (np.fromstring(ax.get("xyz"), sep=" ")
                     if ax is not None else np.array([1.0, 0, 0]))
        lim = je.find("limit")
        for key, default in (("lower", -3.14), ("upper", 3.14),
                             ("effort", 200.0), ("velocity", 10.0)):
            j[key] = (float(lim.get(key, default)) if lim is not None
                      else default)
        joints.append(j)
        child_of[j["child"]] = j

    root_candidates = [n for n in links if n not in child_of]
    if root_link is None:
        if len(root_candidates) != 1:
            raise ValueError(f"ambiguous root links: {root_candidates}")
        root_link = root_candidates[0]

    is_floating = floating
    if is_floating is None:
        is_floating = any(j["type"] == "floating" for j in joints)

    # children adjacency
    children: Dict[str, List[dict]] = {}
    for j in joints:
        if j["type"] == "floating":
            continue
        children.setdefault(j["parent"], []).append(j)

    # Depth-first build, lumping fixed joints.
    parent_idx: List[int] = []
    jtype: List[int] = []
    axes: List[np.ndarray] = []
    E_tree: List[np.ndarray] = []
    p_tree: List[np.ndarray] = []
    body_links: List[_Link] = []
    jnames: List[str] = []
    lnames: List[str] = []
    qmin, qmax, taumax, vmax = [], [], [], []
    frames: List[tuple] = []

    root_body = links[root_link]

    def absorb_fixed(body_idx: Optional[int], base_body: _Link, link_name: str,
                     R_acc: np.ndarray, p_acc: np.ndarray):
        """Recursively lump ``link_name``'s fixed subtree into base_body
        (attached at R_acc, p_acc in base_body frame) and record frames."""
        for j in children.get(link_name, []):
            R_j = R_acc @ j["R"]
            p_j = p_acc + R_acc @ j["p"]
            if j["type"] == "fixed":
                child = links[j["child"]]
                base_body.lump(child, R_j, p_j)
                frames.append((j["child"],
                               -1 if body_idx is None else body_idx,
                               tuple(np.round(R_j, 12).flatten().tolist()),
                               tuple(np.round(p_j, 12).tolist())))
                absorb_fixed(body_idx, base_body, j["child"], R_j, p_j)
            else:
                build_joint(j, body_idx, R_j, p_j)

    def build_joint(j, par_idx: Optional[int], R_off, p_off):
        i = len(parent_idx)
        parent_idx.append(-1 if par_idx is None else par_idx)
        if j["type"] in ("revolute", "continuous"):
            jtype.append(REVOLUTE)
        elif j["type"] == "prismatic":
            jtype.append(PRISMATIC)
        else:
            raise ValueError(f"unsupported joint type {j['type']}")
        axes.append(j["axis"] / max(np.linalg.norm(j["axis"]), 1e-12))
        # E_tree maps parent coords -> joint coords at q=0: E = R_off^T
        E_tree.append(R_off.T)
        p_tree.append(p_off)
        body = _Link(j["child"])
        body.lump(links[j["child"]], np.eye(3), np.zeros(3))
        body_links.append(body)
        jnames.append(j["name"])
        lnames.append(j["child"])
        qmin.append(j["lower"])
        qmax.append(j["upper"])
        taumax.append(j["effort"])
        vmax.append(j["velocity"])
        absorb_fixed(i, body, j["child"], np.eye(3), np.zeros(3))

    absorb_fixed(None, root_body, root_link, np.eye(3), np.zeros(3))

    nj = len(parent_idx)
    model = build_model(
        parent=parent_idx,
        joint_type=jtype,
        axis=np.stack(axes),
        E_tree=np.stack(E_tree),
        p_tree=np.stack(p_tree),
        mass=[b.mass for b in body_links],
        com=[b.com for b in body_links],
        inertia_com=[b.inertia for b in body_links],
        joint_names=jnames,
        link_names=lnames,
        root_name=root_link,
        floating=bool(is_floating),
        base_mass=root_body.mass,
        base_com=root_body.com,
        base_inertia_com=root_body.inertia,
        q_min=qmin,
        q_max=qmax,
        tau_max=taumax,
        v_max=vmax,
        armature=armature,
        gravity=gravity,
        dtype=dtype,
        device=device,
    )
    return dataclasses.replace(model, frames=tuple(frames))
