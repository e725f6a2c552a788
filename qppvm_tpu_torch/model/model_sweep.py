"""The model update's recursive sweeps through one hand-written CUDA kernel
(``csrc/model_sweep.cu``; it replaces no TPU kernel).

``sweep(model, state)`` returns ``(kin, h, bias_all)``, what
``sweep_reference`` computes in plain PyTorch (``kinematics.fk``,
``dynamics.nonlinear_term``, ``kinematics.bias_accelerations``), in one
launch: one warp a batch item, level by level over the tree. It takes a
float32 CUDA state that needs no gradient, whose model shares one inertia
across the batch (``takes``), and raises on anything else;
``dynamics.compute_model_data`` routes every other state to the plain
functions.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import kinematics
from qppvm_tpu_torch.model.robot import RobotModel, RobotState

# the largest nj the kernel takes (csrc/model_sweep.cu's kMaxNj: lane l of
# an item's warp owns links l and l + 32)
MAX_NJ = 64

_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of csrc/model_sweep.cu, with its C interface
    declared."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.model_sweep_launch.argtypes = [p] * 12 + [i] * 4 + [p] * 6
    lib.model_sweep_launch.restype = i
    lib.model_sweep_max_nj.argtypes = []
    lib.model_sweep_max_nj.restype = i
    return lib


def library() -> ctypes.CDLL:
    """The built kernel library (compiled from csrc/model_sweep.cu on first
    use)."""
    global _lib
    if _lib is None:
        from qppvm_tpu_torch import build
        _lib = bind(build.load("model_sweep"))
    return _lib


def topology(parent, joint_type) -> np.ndarray:
    """The kernel's topology array (int32) of a tree with parents
    ``parent`` (-1 for a root): parent (a root's is nj, the base), joint
    type, depth, then each node's children in ascending order (CSR over nj
    + 1 nodes, the base last: its children are the roots)."""
    nj = len(parent)
    par = [nj if p < 0 else p for p in parent]
    depth = []
    for p in parent:
        depth.append(0 if p < 0 else depth[p] + 1)
    children = [[] for _ in range(nj + 1)]
    for i, p in enumerate(par):
        children[p].append(i)
    start = np.cumsum([0] + [len(c) for c in children])
    flat = [i for c in children for i in c]
    return np.concatenate([par, joint_type, depth, start, flat]).astype(
        np.int32)


def _topology(model: RobotModel):
    """(topology on the model's device, number of depth levels), cached per
    tree and device."""
    return kinematics._static(model, "sweep_topology", lambda: (
        torch.as_tensor(topology(model.parent, model.joint_type),
                        device=model.device),
        len(kinematics.tree_levels(model.parent))))


def sweep_reference(model: RobotModel, state: RobotState):
    """The kernel's function in plain PyTorch: ``(kin, h, bias_all)``."""
    from qppvm_tpu_torch.model import dynamics
    kin = kinematics.fk(model, state)
    return (kin, dynamics.nonlinear_term(model, state, kin=kin),
            kinematics.bias_accelerations(model, kin, state))


def _tensors(model: RobotModel, state: RobotState):
    """The state's and the model's tensors the kernel reads, in its
    argument order."""
    return (state.q, state.qd, state.base_rot, state.base_pos,
            state.base_vel, model.axis, model.E_tree, model.p_tree,
            model.inertia, model.base_inertia, model.gravity)


def takes(model: RobotModel, state: RobotState) -> bool:
    """Whether the kernel takes ``model`` and ``state``: float32
    throughout, one (nj, 6, 6) inertia shared by the batch (not a per-item
    scaled model), nj <= MAX_NJ, and no tensor that needs a gradient (the
    kernel's outputs carry none; the plain functions are differentiable)."""
    ins = _tensors(model, state)
    return (all(t.dtype == torch.float32 for t in ins)
            and not any(t.requires_grad for t in ins)
            and tuple(model.inertia.shape) == (model.nj, 6, 6)
            and model.nj <= MAX_NJ)


def sweep(model: RobotModel, state: RobotState):
    """``(kin, h, bias_all)`` of ``state`` in one kernel launch; counts one
    ``model_sweep.launch`` (``telemetry``)."""
    q = state.q
    if q.device.type != "cuda":
        raise ValueError(f"the model-sweep kernel runs on CUDA, not "
                         f"{q.device}")
    nj, B = model.nj, q.shape[0]
    ins = _tensors(model, state)
    shapes = ((B, nj), (B, nj), (B, 3, 3), (B, 3), (B, 6), (nj, 3),
              (nj, 3, 3), (nj, 3), (nj, 6, 6), (6, 6), (3,))
    if any(tuple(t.shape) != sh for t, sh in zip(ins, shapes)):
        raise ValueError(f"shapes {[tuple(t.shape) for t in ins]} are not "
                         f"{list(shapes)} (the model's inertia is shared "
                         f"by the batch)")
    bad = [i for i, t in enumerate(ins) if t.dtype != torch.float32
           or t.device != q.device or t.requires_grad]
    if bad:
        raise ValueError(f"the model-sweep kernel takes float32 tensors on "
                         f"{q.device} that need no gradient; argument {bad[0]}"
                         f" is {ins[bad[0]].dtype} on {ins[bad[0]].device}, "
                         f"requires_grad {ins[bad[0]].requires_grad}")
    if nj > MAX_NJ:
        raise ValueError(f"the model-sweep kernel takes nj <= {MAX_NJ}, "
                         f"not {nj}")
    lib = library()
    topo, n_levels = _topology(model)
    ins = [t.contiguous() for t in ins]
    kw = dict(dtype=torch.float32, device=q.device)
    R = torch.empty((B, nj, 3, 3), **kw)
    p = torch.empty((B, nj, 3), **kw)
    S_ang = torch.empty((B, nj, 3), **kw)
    h = torch.empty((B, model.nv), **kw)
    bias = torch.empty((B, nj, 6), **kw)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.model_sweep_launch(
            *(t.data_ptr() for t in ins), topo.data_ptr(), B, nj, n_levels,
            int(model.floating),
            *(t.data_ptr() for t in (R, p, S_ang, h, bias)), stream)
    if rc != 0:
        raise RuntimeError(f"model_sweep kernel launch failed: CUDA error "
                           f"{rc}")
    telemetry.count("model_sweep.launch")
    kin = kinematics.KinData(R=R, p=p, S_ang=S_ang, S_lin_at=p,
                             base_R=state.base_rot, base_p=state.base_pos)
    return kin, h, bias
