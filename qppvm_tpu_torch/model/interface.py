"""Stateful ModelInterface (port of qppvm_tpu/model/interface.py): the
XBot::ModelInterface surface over the port's batched functions, for one
robot.

The wrapper holds a batch-1 RobotState on the model's device. Setters take
one robot's vectors, (n,) or (1, n); queries return one robot's values,
without the batch dimension, as the reference's do. The batched functions
in ``kinematics`` and ``dynamics`` stay the path for many robots.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from qppvm_tpu_torch import device as devices
from qppvm_tpu_torch.model import dynamics, kinematics, zoo
from qppvm_tpu_torch.model.robot import RobotModel


class ModelInterface:
    """Holds a RobotModel, the current batch-1 RobotState and the ModelData
    computed from it on demand."""

    def __init__(self, model: RobotModel, dtype=None):
        self.model = model
        self.dtype = dtype or model.dtype
        self.state = model.home_state()
        self._data: Optional[dynamics.ModelData] = None

    # --- construction ---------------------------------------------------
    @staticmethod
    def get_model(source: str, device=devices.DEFAULT,
                  **kw) -> "ModelInterface":
        """Load from a zoo name, else a URDF path or string, on
        ``device``."""
        try:
            return ModelInterface(zoo.by_name(source, device=device))
        except KeyError:
            from qppvm_tpu_torch.model.urdf import load_urdf
            return ModelInterface(load_urdf(source, device=device, **kw))

    def _row(self, v):
        """One robot's vector as a (1, n) tensor on the model's device."""
        return torch.as_tensor(v, dtype=self.dtype,
                               device=self.model.device).reshape(1, -1)

    # --- state I/O ------------------------------------------------------
    def set_joint_position(self, q) -> None:
        self.state = dataclasses.replace(self.state, q=self._row(q))
        self._data = None

    def set_joint_velocity(self, qd) -> None:
        self.state = dataclasses.replace(self.state, qd=self._row(qd))
        self._data = None

    def set_joint_acceleration(self, qddot) -> None:
        """Stored for ``compute_inverse_dynamics``."""
        self._qddot = self._row(qddot)

    def set_joint_effort(self, tau) -> None:
        self._tau = self._row(tau)

    def set_floating_base_state(self, R, p, twist_world_linfirst) -> None:
        """World pose and world twist ([v; w], linear first) of the base."""
        R = torch.as_tensor(R, dtype=self.dtype,
                            device=self.model.device).reshape(1, 3, 3)
        tw = self._row(twist_world_linfirst)
        v_b = torch.einsum("bji,bj->bi", R, tw[:, :3])
        w_b = torch.einsum("bji,bj->bi", R, tw[:, 3:])
        self.state = dataclasses.replace(
            self.state, base_rot=R, base_pos=self._row(p),
            base_vel=torch.cat([w_b, v_b], dim=-1))
        self._data = None

    def get_floating_base_pose(self):
        return self.state.base_rot[0], self.state.base_pos[0]

    def get_joint_position(self):
        return self.state.q[0]

    def get_joint_velocity(self):
        return self.state.qd[0]

    def sync_from(self, robot) -> None:
        """model->syncFrom(robot): joints, and a floating base's state,
        from a batch-1 robot."""
        self.set_joint_position(robot.get_motor_position())
        self.set_joint_velocity(robot.get_motor_velocity())
        if self.model.floating and hasattr(robot, "state"):
            st = robot.state
            self.state = dataclasses.replace(
                self.state, base_rot=st.base_rot, base_pos=st.base_pos,
                base_vel=st.base_vel)
        self._data = None

    def update(self) -> None:
        """Recompute the kinematics and dynamics caches (model->update())."""
        self._data = dynamics.compute_model_data(self.model, self.state)

    @property
    def data(self) -> dynamics.ModelData:
        if self._data is None:
            self.update()
        return self._data

    def init_log(self, trace, capacity: Optional[int] = None) -> None:
        """model->initLog(logger, n): set the trace's capacity before the
        loop starts."""
        if capacity is not None:
            trace.capacity = capacity
        self._trace = trace

    def log(self, trace=None) -> None:
        """model->log: the model's state into a runtime/logger.TraceBuffer."""
        trace = trace if trace is not None else getattr(self, "_trace", None)
        if trace is None:
            return
        trace.add("model/q", self.state.q[0])
        trace.add("model/qd", self.state.qd[0])
        if self.model.floating:
            trace.add("model/base_pos", self.state.base_pos[0])
            trace.add("model/base_vel", self.state.base_vel[0])
        trace.add("model/com", self.data.com_pos[0])

    # --- queries --------------------------------------------------------
    def get_joint_num(self) -> int:
        return self.model.nj

    def get_dof_index(self, joint_name: str) -> int:
        return self.model.dof_index(joint_name)

    def get_effort_limits(self):
        return self.model.tau_max

    def get_joint_limits(self):
        return self.model.q_min, self.model.q_max

    def get_robot_state(self, name: str):
        """Named configurations: only "home"."""
        if name != "home":
            raise KeyError(name)
        return self.model.q_home

    def get_pose(self, link: str):
        R, p = kinematics.link_pose(self.model, self.data.kin, link)
        return R[0], p[0]

    def get_point_position(self, link: str, local_point):
        return kinematics.point_position(self.model, self.data.kin, link,
                                         local_point)[0]

    def get_jacobian(self, link: str):
        return dynamics.frame_data(self.model, self.data, link)[2][0]

    def get_com(self):
        return kinematics.com(self.model, self.data.kin)[1][0]

    def get_inertia_matrix(self):
        """B(q)."""
        return self.data.B[0]

    def compute_nonlinear_term(self):
        return self.data.h[0]

    def compute_inverse_dynamics(self, qddot=None):
        """tau = ID(q, qd, qddot); ``qddot`` defaults to the one set, else
        zero."""
        if qddot is None:
            qddot = getattr(self, "_qddot", torch.zeros(
                self.model.nv, dtype=self.dtype, device=self.model.device))
        return dynamics.inverse_dynamics(self.model, self.state,
                                         self._row(qddot),
                                         kin=self.data.kin)[0]

    def compute_gravity_compensation(self):
        st0 = dataclasses.replace(self.state,
                                  qd=torch.zeros_like(self.state.qd),
                                  base_vel=torch.zeros_like(
                                      self.state.base_vel))
        return dynamics.nonlinear_term(self.model, st0)[0]
