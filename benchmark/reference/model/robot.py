"""Static-topology robot model and batched robot state
(port of qppvm_tpu/model/robot.py).

``RobotModel`` holds the numeric parameters as tensors shared by every batch
item, and the topology (``parent``, ``joint_type``, names, frames) as plain
Python tuples. ``RobotState`` carries a leading batch dimension on every
field.

Conventions (as in the reference): link ``i`` hangs off ``parent[i]``
(``-1`` = root link) through joint ``i``; internal spatial algebra is
angular-first; the public API (Jacobians, twists, wrenches) is linear-first
in the world frame; a floating base has generalized velocity
``u = [base_twist_body(6, angular-first); qd(nj)]``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from benchmark.reference import device as devices
from benchmark.reference.model import spatial

REVOLUTE = 0
PRISMATIC = 1


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Robot description: tensors shared by the batch + static topology."""

    axis: torch.Tensor          # (nj, 3) joint axis in joint frame
    E_tree: torch.Tensor        # (nj, 3, 3) child-from-parent rotation at q=0
    p_tree: torch.Tensor        # (nj, 3) joint origin in parent coords
    inertia: torch.Tensor       # (nj, 6, 6) spatial inertia in link coords
    base_inertia: torch.Tensor  # (6, 6)
    q_home: torch.Tensor        # (nj,)
    q_min: torch.Tensor
    q_max: torch.Tensor
    tau_max: torch.Tensor
    v_max: torch.Tensor
    armature: torch.Tensor      # (nj,) reflected rotor inertia on B's diagonal
    gravity: torch.Tensor       # (3,)

    parent: Tuple[int, ...]
    joint_type: Tuple[int, ...]
    joint_names: Tuple[str, ...]
    link_names: Tuple[str, ...]
    root_name: str
    floating: bool
    # name -> (parent link idx [-1 = root], E row-major 9-tuple, p 3-tuple)
    frames: Tuple[Tuple[str, int, Tuple[float, ...], Tuple[float, ...]], ...] = ()

    @property
    def nj(self) -> int:
        return len(self.parent)

    @property
    def nv(self) -> int:
        return self.nj + 6 if self.floating else self.nj

    @property
    def device(self) -> torch.device:
        return self.axis.device

    @property
    def dtype(self) -> torch.dtype:
        return self.axis.dtype

    def dof_index(self, joint_name: str) -> int:
        """Index of a joint in q (ValueError for an unknown name)."""
        return self.joint_names.index(joint_name)

    def link_index(self, link_name: str) -> int:
        if link_name == self.root_name:
            return -1
        try:
            return self.link_names.index(link_name)
        except ValueError:
            raise KeyError(
                f"unknown link {link_name!r}; known links: "
                f"{(self.root_name,) + self.link_names}, frames: "
                f"{tuple(f[0] for f in self.frames)}") from None

    def frame_spec(self, name: str):
        """(parent_link_idx, E_off (3,3), p_off (3,)) numpy arrays for an
        extra frame, else None."""
        for fname, li, E, p in self.frames:
            if fname == name:
                return (li, np.asarray(E, float).reshape(3, 3),
                        np.asarray(p, float))
        return None

    def is_frame(self, name: str) -> bool:
        """Whether ``name`` is an extra frame (not a link)."""
        return any(f[0] == name for f in self.frames)

    def ancestor_mask(self) -> np.ndarray:
        """(nj, nj) bool; m[l, j] = joint j is on the path root -> link l."""
        m = np.zeros((self.nj, self.nj), dtype=bool)
        for l in range(self.nj):
            j = l
            while j >= 0:
                m[l, j] = True
                j = self.parent[j]
        return m

    def home_state(self, batch: int = 1) -> "RobotState":
        return RobotState.init(self, self.q_home.expand(batch, self.nj),
                               batch=batch)


@dataclasses.dataclass(frozen=True)
class RobotState:
    """Batched generalized state. ``base_rot``/``base_pos``: world pose of the
    root link; ``base_vel``: root twist in body coords, angular-first."""

    q: torch.Tensor         # (B, nj)
    qd: torch.Tensor        # (B, nj)
    base_rot: torch.Tensor  # (B, 3, 3) world-from-base rotation
    base_pos: torch.Tensor  # (B, 3)
    base_vel: torch.Tensor  # (B, 6) [w; v] in base coords

    @staticmethod
    def init(model: RobotModel, q=None, qd=None, base_rot=None, base_pos=None,
             base_vel=None, batch: int = 1, dtype=None) -> "RobotState":
        dtype = dtype or model.dtype
        kw = dict(dtype=dtype, device=model.device)
        nj = model.nj

        def field(v, shape, default):
            if v is None:
                return default(shape).to(**kw)
            return torch.as_tensor(v, **kw).expand(shape).clone()

        return RobotState(
            q=field(q, (batch, nj), torch.zeros),
            qd=field(qd, (batch, nj), torch.zeros),
            base_rot=field(base_rot, (batch, 3, 3),
                           lambda s: torch.eye(3).expand(s).clone()),
            base_pos=field(base_pos, (batch, 3), torch.zeros),
            base_vel=field(base_vel, (batch, 6), torch.zeros))

    @property
    def batch(self) -> int:
        return self.q.shape[0]

    @property
    def u(self) -> torch.Tensor:
        """Generalized velocity [base_twist(6); qd] (floating models)."""
        return torch.cat([self.base_vel, self.qd], dim=-1)

    def astype(self, dtype) -> "RobotState":
        """The state with every field in ``dtype``."""
        return RobotState(**{f.name: getattr(self, f.name).to(dtype)
                             for f in dataclasses.fields(self)})


def build_model(*, parent, joint_type, axis, E_tree, p_tree, mass, com,
                inertia_com, joint_names, link_names, root_name="base_link",
                floating=False, base_mass=0.0, base_com=None,
                base_inertia_com=None, q_home=None, q_min=None, q_max=None,
                tau_max=None, v_max=None, armature=None,
                gravity=(0.0, 0.0, -9.81), dtype=torch.float32,
                device=devices.DEFAULT) -> RobotModel:
    """Assemble a RobotModel from per-link primitive data."""
    nj = len(parent)
    kw = dict(dtype=dtype, device=devices.resolve(device))
    t = lambda a: torch.as_tensor(np.asarray(a), **kw)  # noqa: E731
    I_links = torch.stack([spatial.mcI(t(mass[i]), t(com[i]),
                                       t(inertia_com[i])) for i in range(nj)])
    base_com = np.zeros(3) if base_com is None else base_com
    base_inertia_com = (np.eye(3) * 1e-6 if base_inertia_com is None
                        else base_inertia_com)
    base_I = spatial.mcI(t(base_mass), t(base_com), t(base_inertia_com))

    def vec(x, default):
        return torch.full((nj,), default, **kw) if x is None \
            else t(x).reshape(nj)

    return RobotModel(
        axis=t(axis).reshape(nj, 3), E_tree=t(E_tree).reshape(nj, 3, 3),
        p_tree=t(p_tree).reshape(nj, 3), inertia=I_links,
        base_inertia=base_I, q_home=vec(q_home, 0.0),
        q_min=vec(q_min, -3.1), q_max=vec(q_max, 3.1),
        tau_max=vec(tau_max, 200.0), v_max=vec(v_max, 10.0),
        armature=vec(armature, 0.0), gravity=t(gravity),
        parent=tuple(int(p) for p in parent),
        joint_type=tuple(int(j) for j in joint_type),
        joint_names=tuple(joint_names), link_names=tuple(link_names),
        root_name=root_name, floating=bool(floating))
