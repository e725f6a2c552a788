"""Built-in robot models (port of qppvm_tpu/model/zoo.py).

The same programmatic builder as the reference, so each model is the
reference's, built without JAX, on ``device`` (the card unless the caller
asks for the CPU):

- ``arm7``: fixed-base 7-DoF arm;
- ``dual_arm``: fixed-base torso + two 7-DoF arms (links ``arm1_*`` /
  ``arm2_*``);
- ``quadruped``: floating-base ``pelvis`` + 4 legs, feet
  ``foot_fl/fr/hr/hl`` (22 generalized DoF);
- ``biped``: floating-base biped, feet ``l_sole``/``r_sole`` (18);
- ``centaur``: the quadruped base with a torso and two 7-DoF arms (37);
- ``humanoid``: floating-base 32-joint humanoid (38).

Every joint is revolute: the reference's zoo imports ``PRISMATIC`` but no
model uses it, so this module needs none.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import device as devices
from benchmark.reference.model.robot import REVOLUTE, RobotModel, build_model


def _box_inertia(m, x, y, z):
    return np.diag([m / 12.0 * (y * y + z * z),
                    m / 12.0 * (x * x + z * z),
                    m / 12.0 * (x * x + y * y)])


class _Builder:
    def __init__(self, root_name="base_link", floating=False, base_mass=0.0,
                 base_size=(0.3, 0.3, 0.2)):
        self.parent, self.joint_type, self.axis, self.E, self.p = [], [], [], [], []
        self.mass, self.com, self.icom, self.jn, self.ln = [], [], [], [], []
        self.q_home, self.q_min, self.q_max = [], [], []
        self.tau_max, self.armature = [], []
        self.root_name = root_name
        self.floating = floating
        self.base_mass = base_mass
        self.base_inertia = _box_inertia(max(base_mass, 1e-6), *base_size)

    def add(self, name, parent, axis, offset, mass, length, link_name=None,
            jtype=REVOLUTE, home=0.0, lim=2.9, tau=150.0, radius=0.05,
            com_along=None):
        """Add link + joint: ``offset`` is the joint origin in parent coords;
        a rod of ``length`` along ``com_along`` (default +z) gives the
        inertia."""
        i = len(self.parent)
        self.parent.append(parent)
        self.joint_type.append(jtype)
        self.axis.append(np.asarray(axis, float))
        self.E.append(np.eye(3))
        self.p.append(np.asarray(offset, float))
        self.mass.append(mass)
        d = np.asarray(com_along if com_along is not None else [0, 0, 1.0], float)
        d = d / max(np.linalg.norm(d), 1e-9)
        self.com.append(d * length / 2.0)
        I_axial = 0.5 * mass * radius * radius
        I_perp = mass * (length * length / 12.0 + radius * radius / 4.0)
        Ic = np.eye(3) * I_perp
        Ic += np.outer(d, d) * (I_axial - I_perp)
        self.icom.append(Ic)
        self.jn.append(f"j_{name}" if not name.startswith("j_") else name)
        self.ln.append(link_name or name)
        self.q_home.append(home)
        self.q_min.append(-lim)
        self.q_max.append(lim)
        self.tau_max.append(tau)
        self.armature.append(0.01 + 1e-3 * tau)
        return i

    def finish(self, gravity=(0, 0, -9.81), dtype=torch.float32,
               device=devices.DEFAULT):
        return build_model(
            parent=self.parent, joint_type=self.joint_type,
            axis=np.stack(self.axis), E_tree=np.stack(self.E),
            p_tree=np.stack(self.p), mass=self.mass, com=self.com,
            inertia_com=self.icom, joint_names=self.jn, link_names=self.ln,
            root_name=self.root_name, floating=self.floating,
            base_mass=self.base_mass, base_inertia_com=self.base_inertia,
            q_home=self.q_home, q_min=self.q_min, q_max=self.q_max,
            tau_max=self.tau_max, armature=self.armature, gravity=gravity,
            dtype=dtype, device=device)


def _add_arm7(b, prefix, parent, root_offset, mirror=1.0, home=None):
    """7-DoF anthropomorphic arm; links ``{prefix}_1..7``."""
    if home is None:
        home = [0.0, 0.5 * mirror, 0.0, -1.2, 0.0, 0.8, 0.0]
    axes = [(0, 0, 1), (0, 1, 0), (0, 0, 1), (0, 1, 0), (0, 0, 1), (0, 1, 0),
            (0, 0, 1)]
    lens = [0.15, 0.12, 0.26, 0.12, 0.24, 0.10, 0.08]
    mass = [3.0, 2.6, 2.4, 2.0, 1.6, 1.2, 0.6]
    taus = [120, 120, 80, 80, 40, 40, 20]
    off = [root_offset, (0, 0, 0.15), (0, 0, 0.12), (0, 0, 0.26),
           (0, 0, 0.12), (0, 0, 0.24), (0, 0, 0.10)]
    p = parent
    for k in range(7):
        p = b.add(f"{prefix}_{k + 1}", p, axes[k], off[k], mass[k], lens[k],
                  home=home[k], tau=taus[k])
    return p


def arm7(dtype=torch.float32, device=devices.DEFAULT) -> RobotModel:
    """Fixed-base 7-DoF arm."""
    b = _Builder(root_name="base_link")
    _add_arm7(b, "arm1", -1, (0, 0, 0.1))
    return b.finish(dtype=dtype, device=device)


def _add_torso_arms(b, torso_offset):
    """Torso yaw joint on the root with two 7-DoF arms (``arm1``/``arm2``)."""
    torso = b.add("torso_yaw", -1, (0, 0, 1), torso_offset, 10.0, 0.3,
                  link_name="torso", tau=200.0)
    _add_arm7(b, "arm1", torso, (0.0, 0.25, 0.25), mirror=1.0)
    _add_arm7(b, "arm2", torso, (0.0, -0.25, 0.25), mirror=-1.0)


def dual_arm(dtype=torch.float32, device=devices.DEFAULT) -> RobotModel:
    """Fixed-base torso + two 7-DoF arms, end-effectors ``arm1_7`` /
    ``arm2_7``."""
    b = _Builder(root_name="base_link")
    _add_torso_arms(b, (0, 0, 0.4))
    return b.finish(dtype=dtype, device=device)


def _add_leg4(b, prefix, parent, root_offset, foot_name):
    """4-DoF leg (hip pitch/roll, knee, ankle pitch) ending in a foot link
    at the distal end of the shank (the ankle joint's origin), so the knee
    column of the contact Jacobian is not zero."""
    hip1 = b.add(f"{prefix}_hip_y", parent, (0, 1, 0), root_offset, 2.0, 0.1,
                 home=0.4, tau=200.0)
    hip2 = b.add(f"{prefix}_hip_x", hip1, (1, 0, 0), (0, 0, -0.05), 2.0, 0.25,
                 home=0.0, tau=200.0, com_along=[0, 0, -1])
    knee = b.add(f"{prefix}_knee", hip2, (0, 1, 0), (0, 0, -0.30), 1.5, 0.30,
                 home=-0.8, tau=200.0, com_along=[0, 0, -1])
    return b.add(f"{prefix}_ankle_y", knee, (0, 1, 0), (0, 0, -0.30), 0.3,
                 0.02, home=0.0, tau=60.0, com_along=[0, 0, -1],
                 link_name=foot_name)


def _four_legged():
    """Floating ``pelvis`` with four legs, feet ``foot_fl/fr/hr/hl``."""
    b = _Builder(root_name="pelvis", floating=True, base_mass=25.0,
                 base_size=(0.6, 0.4, 0.2))
    _add_leg4(b, "fl", -1, (0.3, 0.2, -0.05), "foot_fl")
    _add_leg4(b, "fr", -1, (0.3, -0.2, -0.05), "foot_fr")
    _add_leg4(b, "hr", -1, (-0.3, -0.2, -0.05), "foot_hr")
    _add_leg4(b, "hl", -1, (-0.3, 0.2, -0.05), "foot_hl")
    return b


def quadruped(dtype=torch.float32, device=devices.DEFAULT) -> RobotModel:
    """Floating-base quadruped: pelvis + 4 legs (16 joints, 22 generalized
    DoF)."""
    return _four_legged().finish(dtype=dtype, device=device)


def centaur(dtype=torch.float32, device=devices.DEFAULT) -> RobotModel:
    """Floating-base centaur: the quadruped's base and legs plus a torso and
    two 7-DoF arms with end-effectors ``arm1_7`` / ``arm2_7`` (31 joints,
    37 generalized DoF)."""
    b = _four_legged()
    _add_torso_arms(b, (0.2, 0.0, 0.1))
    return b.finish(dtype=dtype, device=device)


def _add_leg6(b, prefix, parent, root_offset, foot_name):
    h1 = b.add(f"{prefix}_hip_z", parent, (0, 0, 1), root_offset, 2.0, 0.08,
               tau=150.0)
    h2 = b.add(f"{prefix}_hip_x", h1, (1, 0, 0), (0, 0, -0.06), 2.0, 0.08,
               tau=150.0)
    h3 = b.add(f"{prefix}_hip_y", h2, (0, 1, 0), (0, 0, -0.06), 3.0, 0.35,
               home=-0.35, tau=250.0, com_along=[0, 0, -1])
    kn = b.add(f"{prefix}_knee", h3, (0, 1, 0), (0, 0, -0.38), 2.5, 0.38,
               home=0.7, tau=250.0, com_along=[0, 0, -1])
    a1 = b.add(f"{prefix}_ankle_y", kn, (0, 1, 0), (0, 0, -0.40), 1.0, 0.06,
               home=-0.35, tau=150.0, com_along=[0, 0, -1])
    return b.add(f"{prefix}_ankle_x", a1, (1, 0, 0), (0, 0, -0.05), 0.8, 0.04,
                 tau=120.0, com_along=[0, 0, -1], link_name=foot_name)


def biped(dtype=torch.float32, device=devices.DEFAULT) -> RobotModel:
    """Floating-base 12-DoF biped, feet ``l_sole`` / ``r_sole``."""
    b = _Builder(root_name="pelvis", floating=True, base_mass=15.0,
                 base_size=(0.25, 0.3, 0.25))
    _add_leg6(b, "l_leg", -1, (0.0, 0.11, -0.05), "l_sole")
    _add_leg6(b, "r_leg", -1, (0.0, -0.11, -0.05), "r_sole")
    return b.finish(dtype=dtype, device=device)


def humanoid(dtype=torch.float32, device=devices.DEFAULT) -> RobotModel:
    """Floating-base 32-DoF humanoid: 2x6 legs + 3 waist + 2x7 arms + 2 neck
    + 1 head, on ``device`` (the card unless the caller asks for the
    CPU)."""
    b = _Builder(root_name="pelvis", floating=True, base_mass=12.0,
                 base_size=(0.25, 0.3, 0.2))
    _add_leg6(b, "l_leg", -1, (0.0, 0.11, -0.05), "l_sole")
    _add_leg6(b, "r_leg", -1, (0.0, -0.11, -0.05), "r_sole")
    w1 = b.add("waist_z", -1, (0, 0, 1), (0, 0, 0.12), 4.0, 0.1, tau=300.0)
    w2 = b.add("waist_x", w1, (1, 0, 0), (0, 0, 0.08), 4.0, 0.1, tau=300.0)
    w3 = b.add("waist_y", w2, (0, 1, 0), (0, 0, 0.08), 12.0, 0.25,
               link_name="torso", tau=300.0)
    _add_arm7(b, "arm1", w3, (0.0, 0.20, 0.22))
    _add_arm7(b, "arm2", w3, (0.0, -0.20, 0.22))
    n1 = b.add("neck_z", w3, (0, 0, 1), (0, 0, 0.28), 0.6, 0.05, tau=20.0)
    n2 = b.add("neck_y", n1, (0, 1, 0), (0, 0, 0.05), 0.5, 0.05, tau=20.0)
    b.add("head", n2, (1, 0, 0), (0, 0, 0.05), 1.5, 0.12, tau=20.0,
          link_name="head")
    return b.finish(dtype=dtype, device=device)


def by_name(name: str, dtype=torch.float32,
            device=devices.DEFAULT) -> RobotModel:
    """The zoo model called ``name``."""
    return {"arm7": arm7, "dual_arm": dual_arm, "quadruped": quadruped,
            "centaur": centaur, "biped": biped,
            "humanoid": humanoid}[name](dtype=dtype, device=device)
