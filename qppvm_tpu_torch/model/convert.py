"""Carry a reference model, state and solver state across into the port.

The reference (``qppvm_tpu``) keeps its robot as a pytree of arrays plus
static metadata. These helpers take those fields as numpy arrays (the
caller extracts them) and build the port's objects on a chosen device, so
both packages can be fed the same robot, state, references and warm start.
Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from qppvm_tpu_torch import device as devices
from qppvm_tpu_torch.model.robot import RobotModel, RobotState
from qppvm_tpu_torch.opt.qp import QPState

MODEL_ARRAYS = ("axis", "E_tree", "p_tree", "inertia", "base_inertia",
                "q_home", "q_min", "q_max", "tau_max", "v_max", "armature",
                "gravity")
MODEL_META = ("parent", "joint_type", "joint_names", "link_names",
              "root_name", "floating", "frames")
STATE_FIELDS = ("q", "qd", "base_rot", "base_pos", "base_vel")
QPSTATE_FIELDS = ("x", "z", "y", "Kinv", "rho_scale")
ESTIMATOR_FIELDS = ("base_pos", "anchors", "active_prev")
ILQR_RESULT_FIELDS = ("U", "X", "cost", "K", "k", "reg")
CENTROIDAL_FIELDS = ("mass", "inertia", "footholds", "active", "gravity",
                     "dt")


def robot_model(arrays: Mapping[str, np.ndarray], meta: Mapping[str, Any],
                device=devices.DEFAULT, dtype=torch.float32) -> RobotModel:
    """RobotModel from the reference's array fields (``MODEL_ARRAYS``) and
    static metadata (``MODEL_META``)."""
    kw = dict(dtype=dtype, device=devices.resolve(device))
    tensors = {k: torch.tensor(np.asarray(arrays[k]), **kw)
               for k in MODEL_ARRAYS}
    static = {k: meta[k] for k in MODEL_META if k in meta}
    for k in ("parent", "joint_type", "joint_names", "link_names", "frames"):
        if k in static:
            static[k] = tuple(static[k])
    return RobotModel(**tensors, **static)


def robot_state(arrays: Mapping[str, np.ndarray], device=devices.DEFAULT,
                dtype=torch.float32) -> RobotState:
    """RobotState from arrays that already carry the leading batch dim."""
    device = devices.resolve(device)
    return RobotState(**{k: torch.tensor(np.asarray(arrays[k]),
                                            dtype=dtype, device=device)
                         for k in STATE_FIELDS})


def refs(tree: Mapping[str, Any], device=devices.DEFAULT,
         dtype=torch.float32) -> Dict[str, Any]:
    """Nested refs dict of numpy arrays -> the same dict of tensors."""
    device = devices.resolve(device)
    return {k: (refs(v, device, dtype) if isinstance(v, Mapping)
                else torch.tensor(np.asarray(v), dtype=dtype, device=device))
            for k, v in tree.items()}


def qp_states(levels: Sequence[Mapping[str, np.ndarray]],
              device=devices.DEFAULT, dtype=torch.float32) -> tuple:
    """Per-level warm QPStates from arrays (``QPSTATE_FIELDS``, batched)."""
    device = devices.resolve(device)
    return tuple(QPState(**{k: torch.tensor(np.asarray(lv[k]), dtype=dtype,
                                               device=device)
                            for k in QPSTATE_FIELDS})
                 for lv in levels)


def estimator_state(arrays: Mapping[str, np.ndarray],
                    device=devices.DEFAULT, dtype=torch.float32):
    """The leg-odometry EstimatorState from the reference's unbatched
    arrays (``ESTIMATOR_FIELDS``), as batch 1."""
    from qppvm_tpu_torch.runtime.estimator import EstimatorState
    device = devices.resolve(device)
    return EstimatorState(**{k: torch.tensor(np.asarray(arrays[k])[None],
                                             dtype=dtype, device=device)
                             for k in ESTIMATOR_FIELDS})


def _tensors(arrays, fields, device, dtype):
    device = devices.resolve(device)
    return {k: torch.tensor(np.asarray(arrays[k]), dtype=dtype,
                            device=device) for k in fields}


def ilqr_result(arrays: Mapping[str, np.ndarray], device=devices.DEFAULT,
                dtype=torch.float32):
    """The iLQR's ILQRResult from the reference's arrays
    (``ILQR_RESULT_FIELDS``)."""
    from qppvm_tpu_torch.mpc.ilqr import ILQRResult
    return ILQRResult(**_tensors(arrays, ILQR_RESULT_FIELDS, device, dtype))


def centroidal_params(arrays: Mapping[str, np.ndarray],
                      device=devices.DEFAULT, dtype=torch.float32):
    """The SRBD CentroidalParams from the reference's arrays
    (``CENTROIDAL_FIELDS``)."""
    from qppvm_tpu_torch.mpc.centroidal import CentroidalParams
    return CentroidalParams(**_tensors(arrays, CENTROIDAL_FIELDS, device,
                                       dtype))
