"""Parity of the PyTorch port's rigid-body model with qppvm_tpu.

The same numpy-seeded inputs go through the JAX reference (float32 pinned,
although the suite enables x64) and through qppvm_tpu_torch in float32;
the port takes them with a leading batch dimension.

Tolerances: both sides run float32 with sums in a different order, through
a kinematic tree up to 7 levels deep. Quantities are held to
rtol 1e-4 with an absolute floor of 1e-4 times their magnitude scale, about
a hundred float32 ulps: far below any modelling error (a wrong axis, frame
or index moves them by O(1) of their scale).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu.model import dynamics as jdyn
from qppvm_tpu.model import kinematics as jkin
from qppvm_tpu.model import robot as jrobot
from qppvm_tpu.model import zoo as jzoo
from qppvm_tpu_torch.model import convert, dynamics, kinematics, zoo

torch.set_num_threads(1)
B = 3


def _close(actual, desired, scale=None, rtol=1e-4):
    desired = np.asarray(desired, np.float64)
    scale = float(np.max(np.abs(desired))) + 1.0 if scale is None else scale
    np.testing.assert_allclose(np.asarray(actual, np.float64), desired,
                               rtol=rtol, atol=1e-4 * scale)


def _random_states(model_nj, seed, floating=True):
    rng = np.random.default_rng(seed)
    rots = []
    for _ in range(B):
        Q, R = np.linalg.qr(rng.normal(size=(3, 3)))
        rots.append(Q * np.sign(np.diag(R)))
    rots = np.stack(rots)
    rots[:, :, 0] *= np.linalg.det(rots)[:, None]   # proper rotations
    return dict(q=rng.normal(size=(B, model_nj)) * 0.5,
                qd=rng.normal(size=(B, model_nj)),
                base_rot=rots if floating else np.tile(np.eye(3), (B, 1, 1)),
                base_pos=rng.normal(size=(B, 3)) * 0.3,
                base_vel=rng.normal(size=(B, 6)) if floating
                else np.zeros((B, 6)))


def _jax_states(arrs):
    return jrobot.RobotState(**{k: jnp.asarray(v, jnp.float32)
                                for k, v in arrs.items()})


def _jax_reference(jm, arrs, udot, frames=(), relative=()):
    """Everything the tests compare, from one jitted vmapped JAX program
    (one compilation instead of thousands of eager dispatches)."""
    def one(st, ud):
        data = jdyn.compute_model_data(jm, st)
        out = dict(fk=jkin.fk(jm, st), data=data,
                   rnea=jdyn.rnea(jm, st, ud))
        for name in frames:
            out[name] = jdyn.frame_data(jm, data, name)
        for distal, base in relative:
            out[distal + "@" + base] = jdyn.relative_frame_data(
                jm, data, distal, base)
        return out
    res = jax.jit(jax.vmap(one))(_jax_states(arrs),
                                 jnp.asarray(udot, jnp.float32))
    return jax.tree.map(np.asarray, res)


def _jax_model_arrays(jm):
    return ({k: np.asarray(getattr(jm, k)) for k in convert.MODEL_ARRAYS},
            {k: getattr(jm, k) for k in convert.MODEL_META})


def _sibling_tree():
    """Floating base -> link0 -> {link1, link2 (prismatic), link3}; link1 ->
    link4, with an extra frame on link4 and one on the root: three siblings
    share parent 0, which the backward RNEA sweep must accumulate with an
    index_add."""
    rng = np.random.default_rng(7)
    parent = [-1, 0, 0, 0, 1]
    jtype = [0, 0, 1, 0, 0]
    axes = rng.normal(size=(5, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    jm = jrobot.build_model(
        parent=parent, joint_type=jtype, axis=axes,
        E_tree=np.tile(np.eye(3), (5, 1, 1)), p_tree=rng.normal(size=(5, 3)) * 0.2,
        mass=rng.uniform(0.5, 3.0, 5), com=rng.normal(size=(5, 3)) * 0.05,
        inertia_com=[np.eye(3) * 0.02 * (i + 1) for i in range(5)],
        joint_names=[f"j{i}" for i in range(5)],
        link_names=[f"link{i}" for i in range(5)], root_name="base",
        floating=True, base_mass=4.0, base_inertia_com=np.eye(3) * 0.1,
        armature=rng.uniform(0.0, 0.1, 5), dtype=jnp.float32)
    E = tuple(float(v) for v in np.eye(3)[[1, 2, 0]].ravel())
    frames = (("tool", 4, E, (0.05, 0.0, 0.1)),
              ("imu", -1, E, (0.0, 0.1, 0.05)))
    return dataclasses.replace(jm, frames=frames)


def test_zoo_humanoid_matches_reference():
    jm, tm = jzoo.humanoid(), zoo.humanoid(device="cpu")
    arrays, meta = _jax_model_arrays(jm)
    for k in convert.MODEL_ARRAYS:
        np.testing.assert_allclose(getattr(tm, k).numpy(), arrays[k],
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    for k in convert.MODEL_META:
        assert getattr(tm, k) == meta[k], k
    assert (tm.nj, tm.nv) == (32, 38)


@pytest.fixture(scope="module")
def humanoid_case():
    jm = jzoo.humanoid()
    tm = zoo.humanoid(device="cpu")
    arrs = _random_states(jm.nj, seed=0)
    udot = np.random.default_rng(1).normal(size=(B, tm.nv))
    ts = convert.robot_state(arrs, device="cpu")
    ref = _jax_reference(jm, arrs, udot, frames=("l_sole", "pelvis"),
                         relative=(("arm1_7", "torso"),))
    return tm, ts, udot, ref, dynamics.compute_model_data(tm, ts)


def test_fk_matches_reference(humanoid_case):
    tm, ts, _, ref, _ = humanoid_case
    kin = kinematics.fk(tm, ts)
    _close(kin.R, ref["fk"].R, scale=1.0)
    _close(kin.p, ref["fk"].p)
    _close(kin.S_ang, ref["fk"].S_ang, scale=1.0)


@pytest.mark.parametrize("field", ["B", "h", "J_all", "bias_all", "vel_all",
                                   "com_pos", "total_mass"])
def test_compute_model_data_matches_reference(humanoid_case, field):
    _, _, _, ref, tdata = humanoid_case
    _close(getattr(tdata, field), getattr(ref["data"], field))


def test_rnea_matches_reference(humanoid_case):
    tm, ts, udot, ref, _ = humanoid_case
    _close(dynamics.rnea(tm, ts, torch.tensor(udot, dtype=torch.float32)),
           ref["rnea"])


@pytest.mark.parametrize("name", ["l_sole", "pelvis"])
def test_frame_data_matches_reference(humanoid_case, name):
    tm, _, _, ref, tdata = humanoid_case
    for a, r in zip(dynamics.frame_data(tm, tdata, name), ref[name]):
        _close(a, r)


def test_relative_frame_data_matches_reference(humanoid_case):
    tm, _, _, ref, tdata = humanoid_case
    ours = dynamics.relative_frame_data(tm, tdata, "arm1_7", "torso")
    for a, r in zip(ours, ref["arm1_7@torso"]):
        _close(a, r)


def test_sibling_tree_rnea_and_frames_match_reference():
    jm = _sibling_tree()
    arrays, meta = _jax_model_arrays(jm)
    tm = convert.robot_model(arrays, meta, device="cpu")
    arrs = _random_states(jm.nj, seed=3)
    ts = convert.robot_state(arrs, device="cpu")
    udot = np.random.default_rng(4).normal(size=(B, tm.nv))
    ref = _jax_reference(jm, arrs, udot, frames=("tool", "imu"))
    tau = dynamics.rnea(tm, ts, torch.tensor(udot, dtype=torch.float32))
    tdata = dynamics.compute_model_data(tm, ts)
    _close(tau, ref["rnea"])
    _close(tdata.B, ref["data"].B)
    for name in ("tool", "imu"):
        for a, r in zip(dynamics.frame_data(tm, tdata, name), ref[name]):
            _close(a, r)
