"""Parity of the port's robot-description layer with qppvm_tpu:
``model/urdf.py``, ``model/mjcf.py``, ``model/interface.py``, the spatial,
kinematics and dynamics functions they need, and ``config.build_model`` /
``run.main`` on a URDF scenario.

The URDF texts are copies of tests/test_urdf.py's two-link arm and
tests/test_mujoco_crosscheck.py's 7-DoF arm. Loaded models are held to the
reference's field by field in float32, to 1e-6 of each field's scale (the
parsing is the same numpy on both sides; the spatial inertias are built by
each package's float32 products). Queries run in float64 on both sides
and are held to 1e-9 of each output's scale.

The reference's ModelInterface runs eagerly; here its ``dynamics`` and
``kinematics`` modules are swapped for jitted versions of the same
functions (eager JAX compiles each small op of a new shape, seconds a
robot) and its sessions run on threads from the module's start.
"""
import dataclasses
import os
import re
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu import config as jconfig
from qppvm_tpu.model import dynamics as jdynamics
from qppvm_tpu.model import interface as jinterface
from qppvm_tpu.model import kinematics as jkinematics
from qppvm_tpu.model import spatial as jspatial
from qppvm_tpu.model import zoo as jzoo
from qppvm_tpu.model.urdf import load_urdf as jload_urdf
from qppvm_tpu.runtime.robot_interface import SimRobot as JSimRobot
from qppvm_tpu_torch import config, run
from qppvm_tpu_torch.model import convert, dynamics, spatial, zoo
from qppvm_tpu_torch.model.interface import ModelInterface
from qppvm_tpu_torch.model.urdf import load_urdf
from qppvm_tpu_torch.runtime.logger import TraceBuffer
from qppvm_tpu_torch.runtime.robot_interface import SimRobot

torch.set_num_threads(1)
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

URDF_2LINK = """
<robot name="twolink">
  <link name="base"/>
  <link name="l1">
    <inertial>
      <origin xyz="0 0 0.25"/>
      <mass value="2.0"/>
      <inertia ixx="0.05" iyy="0.05" izz="0.001" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <link name="l2">
    <inertial>
      <origin xyz="0 0 0.2"/>
      <mass value="1.0"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.001" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <link name="tool">
    <inertial>
      <origin xyz="0 0 0.05"/>
      <mass value="0.3"/>
      <inertia ixx="0.001" iyy="0.001" izz="0.001" ixy="0" ixz="0" iyz="0"/>
    </inertial>
  </link>
  <joint name="j1" type="revolute">
    <parent link="base"/><child link="l1"/>
    <origin xyz="0 0 0.1"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2" effort="100" velocity="5"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="0 0 0.5"/><axis xyz="0 1 0"/>
    <limit lower="-2.5" upper="2.5" effort="60" velocity="5"/>
  </joint>
  <joint name="jt" type="fixed">
    <parent link="l2"/><child link="tool"/>
    <origin xyz="0 0 0.4" rpy="0 0 1.0"/>
  </joint>
</robot>
"""

URDF_ARM = """
<robot name="xarm">
  <link name="base"/>
  <link name="s1"><inertial>
    <origin xyz="0.02 -0.01 0.11"/><mass value="3.1"/>
    <inertia ixx="0.031" iyy="0.027" izz="0.012" ixy="0.002" ixz="-0.001" iyz="0.003"/>
  </inertial></link>
  <link name="s2"><inertial>
    <origin xyz="-0.01 0.03 0.14"/><mass value="2.4"/>
    <inertia ixx="0.022" iyy="0.019" izz="0.008" ixy="-0.001" ixz="0.002" iyz="0.001"/>
  </inertial></link>
  <link name="s3"><inertial>
    <origin xyz="0.015 0.0 0.12"/><mass value="1.9"/>
    <inertia ixx="0.015" iyy="0.014" izz="0.005" ixy="0.001" ixz="0" iyz="-0.002"/>
  </inertial></link>
  <link name="s4"><inertial>
    <origin xyz="0 0.02 0.1"/><mass value="1.4"/>
    <inertia ixx="0.009" iyy="0.008" izz="0.003" ixy="0" ixz="0.001" iyz="0"/>
  </inertial></link>
  <link name="s5"><inertial>
    <origin xyz="0.01 0 0.08"/><mass value="0.9"/>
    <inertia ixx="0.004" iyy="0.004" izz="0.002" ixy="0" ixz="0" iyz="0.001"/>
  </inertial></link>
  <link name="s6"><inertial>
    <origin xyz="0 -0.01 0.06"/><mass value="0.6"/>
    <inertia ixx="0.002" iyy="0.002" izz="0.001" ixy="0" ixz="0" iyz="0"/>
  </inertial></link>
  <link name="s7"><inertial>
    <origin xyz="0 0 0.04"/><mass value="0.3"/>
    <inertia ixx="0.001" iyy="0.001" izz="0.0005" ixy="0" ixz="0" iyz="0"/>
  </inertial></link>
  <joint name="q1" type="revolute"><parent link="base"/><child link="s1"/>
    <origin xyz="0 0 0.15"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3" effort="150" velocity="4"/></joint>
  <joint name="q2" type="revolute"><parent link="s1"/><child link="s2"/>
    <origin xyz="0.05 0 0.22" rpy="0.3 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-2.2" upper="2.2" effort="150" velocity="4"/></joint>
  <joint name="q3" type="revolute"><parent link="s2"/><child link="s3"/>
    <origin xyz="0 0.04 0.28" rpy="0 -0.2 0.1"/><axis xyz="1 0 0"/>
    <limit lower="-2.8" upper="2.8" effort="100" velocity="5"/></joint>
  <joint name="q4" type="revolute"><parent link="s3"/><child link="s4"/>
    <origin xyz="0.03 0 0.24"/><axis xyz="0 1 0"/>
    <limit lower="-2.5" upper="2.5" effort="80" velocity="5"/></joint>
  <joint name="q5" type="revolute"><parent link="s4"/><child link="s5"/>
    <origin xyz="0 0 0.2" rpy="0.1 0.1 0"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3" effort="40" velocity="6"/></joint>
  <joint name="q6" type="revolute"><parent link="s5"/><child link="s6"/>
    <origin xyz="0 0.02 0.16"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2" effort="25" velocity="6"/></joint>
  <joint name="q7" type="revolute"><parent link="s6"/><child link="s7"/>
    <origin xyz="0 0 0.12"/><axis xyz="1 0 0"/>
    <limit lower="-2.8" upper="2.8" effort="12" velocity="8"/></joint>
</robot>
"""
# the same arm with its links named as zoo.arm7's, for config 1's stack
# (end effector arm1_7, elbow arm1_4)
URDF_ARM1 = re.sub(r'"s(\d)"', r'"arm1_\1"', URDF_ARM)
# a fixed joint at the root and a floating base
URDF_FLOATING = URDF_2LINK.replace('<link name="base"/>', """<link name="base">
    <inertial><origin xyz="0 0 0.05"/><mass value="4.0"/>
      <inertia ixx="0.02" iyy="0.03" izz="0.04" ixy="0" ixz="0" iyz="0"/>
    </inertial></link>
  <link name="imu"/>
  <joint name="ji" type="fixed"><parent link="base"/><child link="imu"/>
    <origin xyz="0.1 0 0.02" rpy="0.2 0 0"/></joint>""")
URDFS = {"two_link": (URDF_2LINK, {}),
         "two_link_floating": (URDF_2LINK, {"floating": True}),
         "floating_with_root_frame": (URDF_FLOATING, {"floating": True}),
         "xarm": (URDF_ARM, {})}


def _close(actual, desired, rel):
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape, (actual.shape, desired.shape)
    scale = float(np.max(np.abs(desired), initial=0.0)) + 1.0
    np.testing.assert_allclose(actual, desired, rtol=0.0, atol=rel * scale)


def _close_models(got, want, rel=1e-6):
    for k in convert.MODEL_ARRAYS:
        _close(getattr(got, k).numpy(), np.asarray(getattr(want, k)), rel)
    for k in convert.MODEL_META:
        g, w = getattr(got, k), getattr(want, k)
        if k == "frames":
            assert [f[:2] for f in g] == [f[:2] for f in w]
            for fg, fw in zip(g, w):
                _close(np.ravel(fg[2]), np.ravel(fw[2]), 1e-12)
                _close(fg[3], fw[3], 1e-12)
        else:
            assert tuple(g) == tuple(w) if isinstance(g, tuple) else g == w, k


# ---- model sessions on both sides ---------------------------------------

def _session(side, source, load=(), q=None, qd=None, qddot=None, base=None,
             links=(), query=True):
    """One ModelInterface session of ``side`` ("torch" or "jax") in float64:
    load ``source``, set the state and, with ``query``, run every query
    (those of a link on each of ``links``); the results as numpy arrays by
    name."""
    if side == "torch":
        mi = ModelInterface.get_model(source, device="cpu", **dict(load))
        mi = ModelInterface(dataclasses.replace(mi.model, **{
            k: getattr(mi.model, k).to(F64) for k in convert.MODEL_ARRAYS}))
        ke = lambda m: dynamics.kinetic_energy(m.model, m.state)[0]  # noqa
    else:
        mi = jinterface.ModelInterface.get_model(source, **dict(load))
        mi = jinterface.ModelInterface(jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64), mi.model), jnp.float64)
        mi.state = mi.state.astype(jnp.float64)
        ke = lambda m: JDYN.kinetic_energy(m.model, m.state)  # noqa
    out = {"nj": mi.get_joint_num(), "limits": mi.get_joint_limits(),
           "effort": mi.get_effort_limits(),
           "home": mi.get_robot_state("home")}
    if q is not None:
        mi.set_joint_position(q)
    if qd is not None:
        mi.set_joint_velocity(qd)
    if base is not None:
        mi.set_floating_base_state(*base)
        out["base_pose"] = mi.get_floating_base_pose()
        out["base_vel"] = mi.state.base_vel.reshape(6)
    out["q"], out["qd"] = mi.get_joint_position(), mi.get_joint_velocity()
    if not query:
        return _flat(out)
    mi.update()
    for link in links:
        out[f"pose {link}"] = mi.get_pose(link)
        out[f"point {link}"] = mi.get_point_position(link, [0.01, -0.02, 0.03])
        out[f"J {link}"] = mi.get_jacobian(link)
    out.update(com=mi.get_com(), B=mi.get_inertia_matrix(),
               h=mi.compute_nonlinear_term(),
               id0=mi.compute_inverse_dynamics(),
               g=mi.compute_gravity_compensation(), ke=ke(mi))
    if qddot is not None:
        mi.set_joint_acceleration(qddot)
        out["id"] = mi.compute_inverse_dynamics()
    return _flat(out)


def _flat(out):
    """Numpy arrays by name; (R, p) and (lower, upper) pairs by part."""
    flat = {}
    for k, v in out.items():
        for i, part in enumerate(v if isinstance(v, tuple) else (v,)):
            flat[f"{k} {i}"] = np.asarray(part)
    return flat


JDYN = SimpleNamespace(
    compute_model_data=jax.jit(jdynamics.compute_model_data),
    frame_data=jax.jit(jdynamics.frame_data, static_argnums=2),
    inverse_dynamics=jax.jit(jdynamics.inverse_dynamics),
    nonlinear_term=jax.jit(jdynamics.nonlinear_term),
    kinetic_energy=jax.jit(jdynamics.kinetic_energy))
JKIN = SimpleNamespace(
    link_pose=jax.jit(jkinematics.link_pose, static_argnums=2),
    point_position=jax.jit(jkinematics.point_position, static_argnums=2),
    com=jax.jit(jkinematics.com))


def _rand(nj, seed, floating=False):
    rng = np.random.default_rng(seed)
    kw = dict(q=rng.uniform(-1.0, 1.0, nj), qd=rng.uniform(-1.0, 1.0, nj),
              qddot=rng.uniform(-1.0, 1.0, nj + 6 * floating))
    if floating:
        w = rng.uniform(-0.5, 0.5, 3)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        th = np.linalg.norm(w)
        R = (np.eye(3) + np.sin(th) / th * K
             + (1 - np.cos(th)) / th ** 2 * K @ K)
        kw["base"] = (R, rng.uniform(-0.5, 0.5, 3), rng.uniform(-1, 1, 6))
    return kw


# tests/test_model_interface.py's robots (its queries and inverse dynamics
# on the dual arm, its floating-base round trip on the quadruped) and the
# URDF robots: (source, session options)
SESSIONS = {
    "dual_arm": ("dual_arm", dict(links=("arm1_7",), **dict(
        _rand(15, 0), qddot=np.linspace(-1, 1, 15)))),
    "quadruped": ("quadruped", dict(query=False,
                                    **_rand(16, 1, floating=True))),
    "xarm": (URDF_ARM, dict(links=("s7", "base"), **_rand(7, 2))),
    "floating_urdf": (URDF_FLOATING, dict(load={"floating": True},
                                          links=("tool", "l1"),
                                          **_rand(2, 3, floating=True))),
}


@pytest.fixture(scope="module")
def sessions():
    """The reference's sessions, on threads from the module's start."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jinterface, "dynamics", JDYN)
    mp.setattr(jinterface, "kinematics", JKIN)
    pool = ThreadPoolExecutor(len(SESSIONS))
    futs = {name: pool.submit(_session, "jax", src, **opts)
            for name, (src, opts) in SESSIONS.items()}
    yield futs
    pool.shutdown(wait=True)
    mp.undo()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(sessions):
    """Start the reference's sessions at the module's start."""


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_model_interface_matches_reference(sessions, name):
    """Every ModelInterface query of a session, float64, against the
    reference's."""
    src, opts = SESSIONS[name]
    got = _session("torch", src, **opts)
    want = sessions[name].result()
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v, 1e-9)


def test_model_interface_round_trips(tmp_path):
    """tests/test_model_interface.py's port-side checks: shapes, names,
    the floating base's body twist, sync_from a robot, a bad name."""
    mi = ModelInterface.get_model("dual_arm", device="cpu")
    assert mi.get_joint_num() == 15 and mi.get_dof_index("j_arm1_5") == 5
    mi.update()
    R, p = mi.get_pose("arm1_7")
    assert R.shape == (3, 3) and p.shape == (3,)
    assert mi.get_jacobian("arm1_7").shape == (6, 15)
    assert mi.get_inertia_matrix().shape == (15, 15)
    assert mi.compute_nonlinear_term().shape == (15,)
    with pytest.raises(KeyError):
        mi.get_robot_state("crouch")
    mi = ModelInterface.get_model("quadruped", device="cpu")
    mi.set_floating_base_state(torch.eye(3), [0.1, 0.2, 0.5],
                               [0.3, 0.0, 0.0, 0.0, 0.0, 0.2])
    np.testing.assert_allclose(mi.state.base_vel[0].numpy(),
                               [0, 0, 0.2, 0.3, 0, 0], atol=1e-7)
    np.testing.assert_allclose(mi.get_floating_base_pose()[1].numpy(),
                               [0.1, 0.2, 0.5], atol=1e-7)
    model = zoo.arm7(device="cpu")
    robot = SimRobot(model)
    robot.state = dataclasses.replace(robot.state, q=robot.state.q + 0.1)
    mi = ModelInterface(model)
    mi.sync_from(robot)
    torch.testing.assert_close(mi.get_joint_position(), robot.state.q[0])
    jmi = jinterface.ModelInterface(jzoo.arm7())
    jrobot = JSimRobot(jmi.model)
    jrobot.state = dataclasses.replace(jrobot.state, q=jrobot.state.q + 0.1)
    jmi.sync_from(jrobot)
    _close(mi.get_joint_position().numpy(), jmi.get_joint_position(), 1e-6)
    # model->initLog / model->log into the port's TraceBuffer
    trace = TraceBuffer(str(tmp_path / "model_log"))
    mi = ModelInterface.get_model("quadruped", device="cpu")
    mi.init_log(trace, capacity=4)
    mi.log()
    mi.log()
    assert trace.capacity == 4
    assert sorted(trace._buffers) == ["model/base_pos", "model/base_vel",
                                      "model/com", "model/q", "model/qd"]
    np.testing.assert_array_equal(trace._buffers["model/com"][:2],
                                  np.stack([mi.get_com().numpy()] * 2))


# ---- loaders -------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(URDFS))
def test_load_urdf_matches_reference(name):
    text, kw = URDFS[name]
    got = load_urdf(text, device="cpu", **kw)
    want = jload_urdf(text, **kw)
    assert got.device == torch.device("cpu") and got.dtype == torch.float32
    _close_models(got, want)
    assert got.nv == want.nv and got.floating == want.floating


def test_load_urdf_lumps_fixed_joints(tmp_path):
    """tests/test_urdf.py's checks on the port: names, limits, the tool's
    mass lumped into l2 and its frame, the floating base; a file path
    loads like the text."""
    m = load_urdf(URDF_2LINK, device="cpu")
    assert m.nj == 2 and m.joint_names == ("j1", "j2")
    assert m.link_names == ("l1", "l2") and not m.floating
    assert m.frame_spec("tool") is not None and m.frame_spec("l2") is None
    assert float(m.q_min[1]) == -2.5 and float(m.tau_max[0]) == 100.0
    np.testing.assert_allclose(float(m.inertia[1, 5, 5]), 1.3, rtol=1e-6)
    path = tmp_path / "two_link.urdf"
    path.write_text(URDF_2LINK)
    _close_models(load_urdf(str(path), device="cpu"), jload_urdf(URDF_2LINK))
    m = load_urdf(URDF_2LINK, floating=True, device="cpu")
    assert m.floating and m.nv == 8
    with pytest.raises(ValueError, match="ambiguous root"):
        load_urdf(URDF_2LINK.replace('<link name="base"/>',
                                     '<link name="base"/><link name="x"/>'),
                  device="cpu")


@pytest.mark.parametrize("robot", ["ant", "humanoid"])
def test_load_mjcf_matches_reference(robot):
    """gymnasium's published ant.xml (with the feet's tip frames) and
    humanoid.xml, compiled by MuJoCo on both sides."""
    pytest.importorskip("mujoco")
    gymnasium = pytest.importorskip("gymnasium")
    from qppvm_tpu.model.mjcf import load_mjcf as jload_mjcf
    from qppvm_tpu_torch.model.mjcf import load_mjcf
    path = os.path.join(os.path.dirname(gymnasium.__file__), "envs",
                        "mujoco", "assets", f"{robot}.xml")
    tips = robot == "ant"
    got = load_mjcf(path, tip_frames=tips, device="cpu")
    _close_models(got, jload_mjcf(path, tip_frames=tips))
    with open(path) as f:
        text = f.read()
    _close_models(load_mjcf(xml=text, tip_frames=tips, device="cpu"), got,
                  0.0)


# ---- spatial, kinematics, dynamics ---------------------------------------

def _spatial_inputs(seed=0):
    rng = np.random.default_rng(seed)
    E = jspatial.rot_axis_angle(jnp.asarray(rng.standard_normal(3)), 0.7)
    I6 = np.asarray(jspatial.mcI(1.3, jnp.asarray(rng.standard_normal(3)),
                                 jnp.eye(3) * 0.2))
    q = rng.standard_normal(4)
    return dict(theta=rng.standard_normal(5), axis=rng.standard_normal(3),
                E=np.asarray(E), p=rng.standard_normal(3),
                v=rng.standard_normal(6), I=I6, quat=q / np.linalg.norm(q))


SPATIAL = {
    "rot_x": lambda s, a: s.rot_x(a["theta"]),
    "rot_y": lambda s, a: s.rot_y(a["theta"]),
    "rot_z": lambda s, a: s.rot_z(a["theta"]),
    "rot_axis_angle": lambda s, a: s.rot_axis_angle(a["axis"], a["theta"][0]),
    "xform": lambda s, a: s.xform(a["E"], a["p"]),
    "xform_inv_apply": lambda s, a: s.xform_inv_apply(a["E"], a["p"], a["v"]),
    "xform_force_apply": lambda s, a: s.xform_force_apply(a["E"], a["p"],
                                                          a["v"]),
    "crm": lambda s, a: s.crm(a["v"]),
    "inertia_apply": lambda s, a: s.inertia_apply(a["I"], a["v"]),
    "quat_to_mat": lambda s, a: s.quat_to_mat(*a["quat"]),
}


@pytest.mark.parametrize("fn", sorted(SPATIAL))
def test_spatial_matches_reference(fn):
    """The spatial functions the loaders and ModelInterface need, float64,
    to 1e-12 of their scale; the transforms also against their identities
    (X^-1 X v = v, X* = X^-T)."""
    a = _spatial_inputs()
    got = SPATIAL[fn](spatial, {k: torch.tensor(v) for k, v in a.items()})
    want = SPATIAL[fn](jspatial, {k: jnp.asarray(v) for k, v in a.items()})
    _close(got.numpy(), want, 1e-12)
    if fn == "xform_inv_apply":
        X = spatial.xform(torch.tensor(a["E"]), torch.tensor(a["p"]))
        _close((X @ got).numpy(), a["v"], 1e-12)
    if fn == "xform_force_apply":
        X = spatial.xform(torch.tensor(a["E"]), torch.tensor(a["p"]))
        _close(got.numpy(), (torch.linalg.inv(X).T @ torch.tensor(
            a["v"])).numpy(), 1e-12)


# ---- config.py and run.py on a URDF scenario ----------------------------

def _urdf_config(tmp_path):
    urdf = tmp_path / "arm.urdf"
    urdf.write_text(URDF_ARM1)
    path = tmp_path / "urdf_arm.yaml"
    with open(os.path.join(REPO, "configs", "config1_arm7.yaml")) as f:
        path.write_text(f.read().replace("zoo: arm7", f"urdf: {urdf}"))
    return str(path)


def test_build_model_urdf_matches_reference(tmp_path):
    path = _urdf_config(tmp_path)
    cfg = config.load_scenario(path)
    assert cfg.to_dict() == jconfig.load_scenario(path).to_dict()
    model = config.build_model(cfg, device="cpu")
    _close_models(model, jconfig.build_model(jconfig.load_scenario(path)))
    assert model.link_names[-1] == "arm1_7" and "arm1_4" in model.link_names


def test_run_main_on_urdf_scenario(tmp_path):
    """Config 1's QPPVM stack on the URDF arm for 10 ticks, like a zoo
    scenario."""
    out = run.main(["--config", _urdf_config(tmp_path), "--seconds", "0.01",
                    "--cpu"])
    assert set(out) == {"scenario", "seconds", "p50_ms", "p99_ms",
                        "deadline_misses", "final_q_norm", "device"}
    assert out["device"] == "cpu" and out["scenario"] == "config1_arm7"
    assert np.isfinite(out["final_q_norm"]) and out["final_q_norm"] < 0.1
