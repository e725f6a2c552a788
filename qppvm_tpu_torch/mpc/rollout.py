"""Standing initial state (port of qppvm_tpu/mpc/rollout.py, the part the
ForceAcc tick needs; the rollout itself is not ported yet)."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from qppvm_tpu_torch.model import kinematics
from qppvm_tpu_torch.model.robot import RobotModel, RobotState


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    """The compliant-ground parameters ``standing_state`` reads."""

    contact_kp: float = 2e4
    ground_z: float = 0.0


def standing_state(model: RobotModel, contact_links: Sequence[str],
                   cfg: RolloutConfig = None, batch: int = 1) -> RobotState:
    """Home state shifted so the contact links stand on the ground in static
    equilibrium: the lowest contact at ``ground_z`` minus the penetration at
    which the compliant contact (kp per contact) carries the robot's
    weight."""
    cfg = cfg or RolloutConfig()
    st = model.home_state(batch)
    kin = kinematics.fk(model, st)
    idx = [model.link_index(c) for c in contact_links]
    foot_z = torch.amin(torch.stack([kin.p[:, li, 2] for li in idx]), dim=0)
    mass = torch.sum(model.inertia[:, 3, 3]) + model.base_inertia[3, 3]
    g = torch.linalg.norm(model.gravity)
    pen = mass * g / (len(idx) * cfg.contact_kp)
    shift = foot_z - cfg.ground_z + pen                       # (B,)
    zero = torch.zeros_like(shift)
    return dataclasses.replace(
        st, base_pos=st.base_pos - torch.stack([zero, zero, shift], dim=-1))
