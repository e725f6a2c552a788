"""Parity of the port's contact-physics plant and closed loop with
qppvm_tpu, on the humanoid.

- ``spatial.so3_exp``; ``dynamics.forward_dynamics`` ("ns" and "chol",
  with and without a given mass matrix and inverse) and ``integrate``;
- ``robot_interface.ground_forces`` with the 4-point foot patch of
  bench_rt_loop.py, points in contact and airborne, anchors sticking and
  sliding; ``stop_torques`` beyond both joint limits; ``_sim_step``; and
  ``SimRobot`` sense / command / move over two control periods;
- the plant's cold mass-matrix inverse and the MPC rollout's start inverse
  go through ``ns_inverse.ns_inverse(Breg, iters=24)`` (the NS kernel on
  the card), which on CPU tensors is ``linalg.spd_inverse_ns(Breg, 22, 2)``
  to the bit;
- the first 3 ticks of the closed loop (``runtime/rt_loop.py``) against the
  same loop in JAX (bench_rt_loop.py's tick), both from the port's
  on_start (carried across), so the loop is held alone.

Inputs are numpy-seeded and fed to both sides in float32; JAX programs are
jitted and vmapped over the batch, one program for the four variants of
forward dynamics, one for ground contact, one for the closed loop's tick.

Tolerances: float32 on both sides with sums in another order. Kinematic
quantities and forces to rtol 1e-4 with a floor of 1e-4 of their scale, as
tests/test_torch_model.py. Accelerations go through the inverse of a mass
matrix of condition ~1e4 and a 22-iteration Newton-Schulz inverse with two
refinement steps: 1e-3 of their scale. Closed-loop torques to 1e-3 of
their scale, as tests/test_torch_force_acc.py's ticks; a wrong contact
point, sign or frame moves any of these by O(1) of its scale.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu.model import dynamics as jdyn
from qppvm_tpu.model import kinematics as jkin
from qppvm_tpu.model import robot as jrobot
from qppvm_tpu.model import spatial as jspatial
from qppvm_tpu.model import zoo as jzoo
from qppvm_tpu.opt import linalg as jlinalg
from qppvm_tpu.opt import qp as jqp
from qppvm_tpu.plugins.force_acc import ForceAccPlugin as JForceAcc
from qppvm_tpu.runtime import robot_interface as jri
from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import convert, dynamics, spatial, zoo
from qppvm_tpu_torch.mpc import rollout
from qppvm_tpu_torch.opt import linalg, ns_inverse
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
from qppvm_tpu_torch.runtime import robot_interface as ri
from qppvm_tpu_torch.runtime import rt_loop

torch.set_num_threads(1)
B = 3
CONTACTS = rt_loop.CONTACTS
PATCH = {c: rt_loop.FOOT_PATCH for c in CONTACTS}
CONTACT = dict(ground_z=0.0, kp_c=2e4, kd_c=300.0, mu=0.8, kt_c=2e4)


def _close(actual, desired, rtol=1e-4, floor=1e-4):
    desired = np.asarray(desired, np.float64)
    scale = float(np.max(np.abs(desired))) + 1.0
    np.testing.assert_allclose(np.asarray(actual, np.float64), desired,
                               rtol=rtol, atol=floor * scale)


def _jstate(arrs):
    return jrobot.RobotState(**{k: jnp.asarray(v, jnp.float32)
                                for k, v in arrs.items()})


def _tstate(arrs):
    return convert.robot_state(arrs, device="cpu")


def _np_state(st):
    return {k: np.asarray(getattr(st, k)) for k in convert.STATE_FIELDS}


@pytest.fixture(scope="module")
def models():
    return jzoo.humanoid(), zoo.humanoid(device="cpu")


def _near_ground_states(jm, seed):
    """B states near the standing pose: item 0 pressed 4 mm into the ground
    and nearly at rest (every patch point in contact), item 1 tilted about
    x (one side of each patch airborne), item 2 lifted 5 mm (all
    airborne); random velocities and a perturbed posture."""
    rng = np.random.default_rng(seed)
    st0 = jri.standing_state(jm, CONTACTS)
    base = {k: np.broadcast_to(np.asarray(v), (B,) + np.shape(v)).copy()
            for k, v in _np_state(st0).items()}
    base["q"] = base["q"] + 0.01 * rng.normal(size=base["q"].shape)
    # item 0 nearly at rest, so some of its anchors can stick
    slow = np.array([0.01, 1.0, 1.0])[:, None]
    base["qd"] = 0.2 * slow * rng.normal(size=base["qd"].shape)
    base["base_vel"] = 0.1 * slow * rng.normal(size=(B, 6))
    c, s = np.cos(0.03), np.sin(0.03)
    base["base_rot"][1] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    base["base_pos"][:, 2] += np.array([-0.004, -0.001, 0.005])
    return base


def test_so3_exp_matches_reference():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(6, 3)) * np.array([[1.0], [0.3], [1e-3], [1e-9],
                                            [0.0], [2.5]])
    w = w.astype(np.float32)
    ref = np.asarray(jax.vmap(jspatial.so3_exp)(jnp.asarray(w)))
    _close(spatial.so3_exp(torch.tensor(w)), ref, rtol=1e-5, floor=1e-6)


FD_CASES = [("ns", False), ("ns", True), ("chol", False), ("chol", True)]


@pytest.fixture(scope="module")
def fd_case(models):
    """forward_dynamics and integrate in each FD_CASES variant, from one
    jitted vmapped JAX program. ``given``: the mass matrix and (for "ns")
    an NS inverse of it are passed in, as the rollout does."""
    jm, tm = models
    arrs = _near_ground_states(jm, seed=1)
    rng = np.random.default_rng(2)
    tau = (20.0 * rng.normal(size=(B, tm.nj))).astype(np.float32)
    ext = np.zeros((B, tm.nj, 6), np.float32)
    for c in CONTACTS:
        ext[:, tm.link_index(c)] = 50.0 * rng.normal(size=(B, 6))

    def ref_fn(st, ta, ex):
        out = []
        for method, given in FD_CASES:
            kw = {}
            if given:
                Bm = jdyn.mass_matrix(jm, st)
                kw = dict(B=Bm, binv=jlinalg.spd_inverse_ns(
                    Bm + 1e-9 * jnp.eye(jm.nv, dtype=jnp.float32), iters=22,
                    refine=2)
                    if method == "ns" else None)
            udot = jdyn.forward_dynamics(jm, st, ta, ext_wrenches=ex,
                                         method=method, **kw)
            out.append((udot, jdyn.integrate(jm, st, udot, 1e-3)))
        return out

    ref = jax.jit(jax.vmap(ref_fn))(_jstate(arrs), jnp.asarray(tau),
                                   jnp.asarray(ext))
    return dict(arrs=arrs, tau=tau, ext=ext,
                ref=dict(zip(FD_CASES, jax.tree.map(np.asarray, ref))))


@pytest.mark.parametrize("method,given", FD_CASES)
def test_forward_dynamics_and_integrate_match_reference(models, fd_case,
                                                        method, given):
    """``given``: the mass matrix and (for "ns") an NS inverse of it are
    passed in, as the rollout does."""
    jm, tm = models
    udot_ref, st_ref = fd_case["ref"][method, given]
    ts = _tstate(fd_case["arrs"])
    kw = {}
    if given:
        Bm = dynamics.mass_matrix(tm, ts)
        kw = dict(B=Bm, binv=linalg.spd_inverse_ns(
            Bm + 1e-9 * torch.eye(tm.nv), iters=22, refine=2)
            if method == "ns" else None)
    udot = dynamics.forward_dynamics(tm, ts, torch.tensor(fd_case["tau"]),
                                     ext_wrenches=torch.tensor(fd_case["ext"]),
                                     method=method, **kw)
    _close(udot, udot_ref, rtol=1e-3, floor=1e-3)
    # integrate from the reference's udot: the step alone
    st = dynamics.integrate(
        tm, ts, torch.tensor(udot_ref, dtype=torch.float32), 1e-3)
    for k in convert.STATE_FIELDS:
        _close(getattr(st, k), getattr(st_ref, k))


@pytest.fixture
def ns_calls(monkeypatch):
    """The ``iters`` of every ``ns_inverse.ns_inverse`` call."""
    calls, real = [], ns_inverse.ns_inverse

    def spy(K, iters=26):
        calls.append(iters)
        return real(K, iters)

    monkeypatch.setattr(ns_inverse, "ns_inverse", spy)
    return calls


def test_forward_dynamics_inverts_through_the_ns_kernel(models, ns_calls):
    jm, tm = models
    ts = _tstate(_near_ground_states(jm, seed=1))
    tau = torch.tensor(np.random.default_rng(2).normal(size=(B, tm.nj)),
                       dtype=torch.float32)
    udot = dynamics.forward_dynamics(tm, ts, tau)
    assert ns_calls == [24]
    Bm = dynamics.mass_matrix(tm, ts)
    Breg = Bm + 1e-9 * torch.eye(tm.nv)
    binv = linalg.spd_inverse_ns(Breg, iters=22, refine=2)
    assert torch.equal(ns_inverse.ns_inverse(Breg, iters=24), binv)
    assert torch.equal(udot, dynamics.forward_dynamics(tm, ts, tau, B=Bm,
                                                       binv=binv))


def test_rollout_start_inverse_goes_through_the_ns_kernel(models, ns_calls):
    _, tm = models
    plugin = ForceAccPlugin(tm, contact_links=CONTACTS, waist_link="pelvis",
                            iters=12)
    roll = rollout.make_rollout_fn(plugin, rollout.RolloutConfig(),
                                   rollout.default_cost,
                                   contact_offsets=PATCH)
    st = rollout.standing_state(tm, CONTACTS, batch=2)
    carry = roll.init_carry(st, {"waist_task": {"p": torch.zeros(2, 3)}},
                            None)
    assert ns_calls == [24]
    B0 = dynamics.mass_matrix(tm, st) + 1e-9 * torch.eye(tm.nv)
    assert torch.equal(carry[4], linalg.spd_inverse_ns(B0, iters=22,
                                                       refine=2))


@pytest.mark.parametrize("dtype,n,takes", [
    (torch.float32, 22, True), (torch.float32, 139, True),
    (torch.float32, 140, False), (torch.float64, 22, False),
    (torch.float16, 22, False)])
def test_mass_matrix_inverse_rule(dtype, n, takes):
    """The NS kernel takes float32 matrices up to its largest size (139
    here); on the card anything else runs the plain NS, counted."""
    assert ns_inverse.takes(dtype, n, 139) is takes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mass_matrix_inverse_on_the_cpu(models, ns_calls, dtype):
    """``ns_inverse.spd_inverse``: a CPU tensor of any dtype goes through
    ns_inverse.ns_inverse (iters 24), bitwise spd_inverse_ns(B, 22, 2),
    and counts no plain routing."""
    jm, tm = models
    ts = _tstate(_near_ground_states(jm, seed=1))
    K = (dynamics.mass_matrix(tm, ts) + 1e-9 * torch.eye(tm.nv)).to(dtype)
    telemetry.reset("model.plain_inverse")
    X = ns_inverse.spd_inverse(K)
    assert ns_calls == [24] and telemetry.counts()["model.plain_inverse"] == 0
    assert X.dtype == dtype
    assert torch.equal(X, linalg.spd_inverse_ns(K, iters=22, refine=2))


@pytest.fixture(scope="module")
def contact_case(models):
    """ground_forces, stop_torques and one _sim_step on the same inputs,
    from one jitted vmapped JAX program."""
    jm, tm = models
    arrs = _near_ground_states(jm, seed=3)
    rng = np.random.default_rng(4)
    idx = tuple(tm.link_index(c) for c in CONTACTS)
    offs = ri.contact_offsets_for(CONTACTS, PATCH)
    ts = _tstate(arrs)
    a0 = ri.init_anchors(tm, ts, idx, offs).numpy()
    # anchors 0.1 mm off the points (sticking) or 5 cm off (the spring
    # saturates the friction cone: sliding), alternately
    shift = np.where(np.arange(a0.shape[1])[None, :, None] % 2 == 0,
                     1e-4, 0.05) * rng.choice([-1.0, 1.0], size=a0.shape)
    anchors = (a0 + shift).astype(np.float32)
    # posture with joints beyond both limits
    q = arrs["q"].copy()
    q[:, 1] = np.asarray(jm.q_min)[1] - 0.05
    q[:, 4] = np.asarray(jm.q_max)[4] + 0.02
    arrs = dict(arrs, q=q.astype(np.float32))
    tau_ref = (10.0 * rng.normal(size=(B, tm.nj))).astype(np.float32)
    k = np.full(tm.nj, 50.0, np.float32)
    d = np.full(tm.nj, 2.0, np.float32)
    q_ref = (q + 0.01 * rng.normal(size=q.shape)).astype(np.float32)

    def ref_fn(st, an, tr, qr):
        kin = jkin.fk(jm, st)
        J_all = jkin.all_link_jacobians(jm, kin)
        ext, an_new = jri.ground_forces(
            jm, idx, offs, *CONTACT.values(), kin, J_all, st.u, an,
            jnp.float32)
        stop = jri.stop_torques(jm, st)
        st_new, an_sim = jri._sim_step(jm, 5e-4, idx, offs,
                                       *CONTACT.values(), st, an, tr, qr,
                                       jnp.asarray(k), jnp.asarray(d))
        return ext, an_new, stop, st_new, an_sim

    ref = jax.jit(jax.vmap(ref_fn))(_jstate(arrs), jnp.asarray(anchors),
                                   jnp.asarray(tau_ref), jnp.asarray(q_ref))
    return dict(arrs=arrs, anchors=anchors, idx=idx, offs=offs,
                tau_ref=tau_ref, q_ref=q_ref, k=k, d=d,
                ref=jax.tree.map(np.asarray, ref))


def test_ground_forces_match_reference(models, contact_case):
    jm, tm = models
    c = contact_case
    ts = _tstate(c["arrs"])
    kin = dynamics.kinematics.fk(tm, ts)
    J_all = dynamics.kinematics.all_link_jacobians(tm, kin)
    ext, anchors = ri.ground_forces(tm, c["idx"], c["offs"],
                                    *CONTACT.values(), kin, J_all, ts.u,
                                    torch.tensor(c["anchors"]),
                                    torch.float32)
    ext_ref, anchors_ref = c["ref"][0], c["ref"][1]
    _close(ext, ext_ref)
    _close(anchors, anchors_ref, rtol=1e-5, floor=1e-6)
    # the case covers every branch: points in contact and airborne (the
    # anchor resets to the point), sticking (unchanged) and sliding (moved)
    a_in, a_out = c["anchors"], anchors.numpy()
    pts = ri.init_anchors(tm, ts, c["idx"], c["offs"]).numpy()
    airborne = np.all(np.abs(a_out - pts) < 1e-7, axis=-1)
    stuck = np.all(a_out == a_in, axis=-1)
    slid = ~airborne & ~stuck
    assert airborne.any() and (~airborne).any()
    assert stuck.any() and slid.any()
    assert (ext_ref[..., 2] > 0).any()


def test_stop_torques_match_reference(models, contact_case):
    jm, tm = models
    ts = _tstate(contact_case["arrs"])
    stop = ri.stop_torques(tm, ts).numpy()
    _close(stop, contact_case["ref"][2])
    assert (stop[:, 1] > 0).all() and (stop[:, 4] < 0).all()


def test_sim_step_matches_reference(models, contact_case):
    jm, tm = models
    c = contact_case
    t = torch.tensor
    st, anchors = ri._sim_step(tm, 5e-4, c["idx"], c["offs"],
                               *CONTACT.values(), _tstate(c["arrs"]),
                               t(c["anchors"]), t(c["tau_ref"]),
                               t(c["q_ref"]), t(c["k"]), t(c["d"]))
    st_ref, an_ref = c["ref"][3], c["ref"][4]
    for k in ("q", "base_rot", "base_pos"):
        _close(getattr(st, k), getattr(st_ref, k))
    for k in ("qd", "base_vel"):
        _close(getattr(st, k), getattr(st_ref, k), rtol=1e-3, floor=1e-3)
    _close(anchors, an_ref, rtol=1e-5, floor=1e-6)


def test_sim_robot_sense_and_move_match_reference(models):
    """Two control periods of 4 substeps under drive PD + effort."""
    jm, tm = models
    rng = np.random.default_rng(5)
    st_j = jri.standing_state(jm, CONTACTS)
    st_t = ri.standing_state(tm, CONTACTS)
    _close(st_t.base_pos[0], st_j.base_pos)
    robots = (jri.SimRobot(jm, state=st_j, dt=1e-3, substeps=4,
                           contact_links=CONTACTS, contact_offsets=PATCH),
              ri.SimRobot(tm, state=st_t, dt=1e-3, substeps=4,
                          contact_links=CONTACTS, contact_offsets=PATCH))
    k = np.full(tm.nj, 100.0, np.float32)
    d = np.full(tm.nj, 3.0, np.float32)
    tau = (5.0 * rng.normal(size=tm.nj)).astype(np.float32)
    q_ref = (np.asarray(st_j.q) + 0.02 * rng.normal(size=tm.nj)).astype(
        np.float32)
    for r, batch in zip(robots, (lambda a: a, lambda a: a[None])):
        r.set_stiffness(k)
        r.set_damping(d)
        r.set_reference(tau_ref=batch(tau), q_ref=batch(q_ref))
        r.move()
        r.move()
    rj, rt = robots
    for name in ("q", "base_rot", "base_pos"):
        _close(getattr(rt.state, name)[0], getattr(rj.state, name))
    for name in ("qd", "base_vel"):
        _close(getattr(rt.state, name)[0], getattr(rj.state, name),
               rtol=1e-3, floor=1e-3)
    _close(rt.get_motor_position()[0], rj.get_motor_position())
    imu_t, imu_j = rt.get_imu(), rj.get_imu()
    for f in ("orientation", "angular_velocity", "linear_acceleration"):
        _close(getattr(imu_t, f)[0], getattr(imu_j, f), rtol=1e-3,
               floor=1e-3)
    for ch in ("/sim/floating_base_position", "/sim/floating_base_velocity"):
        _close(rt.shared_memory.get_shared_object(ch).get()[0],
               rj.shared_memory.get_shared_object(ch).get(), rtol=1e-3,
               floor=1e-3)
    _close(rt._anchors[0], rj._anchors, rtol=1e-5, floor=1e-6)


def test_closed_loop_first_ticks_match_reference(models):
    """bench_rt_loop.py's tick (ForceAcc RT profile, unbatched XLA solves)
    against ClosedLoop.run with the plain level solver, both from the
    port's on_start (tests/test_torch_force_acc.py holds on_start itself),
    3 ticks of 2 substeps with the state fed back."""
    jm, tm = models
    ticks, substeps = 3, 2
    tplugin = ForceAccPlugin(tm, contact_links=CONTACTS, waist_link="pelvis",
                             iters=12, solver_opts=dict(rt_loop.RT_PROFILE))
    trobot = ri.SimRobot(tm, state=ri.standing_state(tm, CONTACTS), dt=1e-3,
                         substeps=substeps, contact_links=CONTACTS,
                         contact_offsets=PATCH)
    trefs, twarm, _ = tplugin.on_start(trobot.state)
    item0 = lambda t: ({k: item0(v) for k, v in t.items()}  # noqa: E731
                       if isinstance(t, dict) else jnp.asarray(t[0].numpy()))
    refs = item0(trefs)
    warm = tuple(jqp.QPState(**{f: item0(getattr(lv, f))
                                for f in convert.QPSTATE_FIELDS})
                 for lv in twarm)
    plugin = JForceAcc(jm, contact_links=CONTACTS, waist_link="pelvis",
                       iters=12, solver_opts=rt_loop.RT_PROFILE)
    robot = jri.SimRobot(jm, state=jri.standing_state(jm, CONTACTS),
                         dt=1e-3, substeps=substeps, contact_links=CONTACTS,
                         contact_offsets=PATCH)
    sim = partial(jri._sim_step, jm, 1e-3 / substeps, robot._contact_idx,
                  robot._contact_offsets, 0.0, robot.contact_kp,
                  robot.contact_kd, robot.mu, robot.contact_kt)
    zero = jnp.zeros(jm.nj, jnp.float32)

    @jax.jit
    def tick(st, anchors, w):
        tau, w, aux = plugin._step_impl(st, refs, w)
        for _ in range(substeps):
            st, anchors = sim(st, anchors, tau, st.q, zero, zero)
        return st, anchors, w, tau, aux.solver_failed

    st, anchors, w = robot.state, robot._anchors, warm
    taus_ref = []
    for _ in range(ticks):
        st, anchors, w, tau, failed = tick(st, anchors, w)
        assert not bool(failed)
        taus_ref.append(np.asarray(tau))

    loop = rt_loop.ClosedLoop(tplugin, trobot, trefs, twarm)
    res = loop.run(ticks, record=ticks)
    assert int(res.n_fail) == 0
    for tau, tau_ref in zip(res.taus, taus_ref):
        _close(tau[0], tau_ref, rtol=1e-3, floor=1e-3)
    for k in ("q", "base_pos", "base_rot"):
        _close(getattr(res.state, k)[0], getattr(st, k))
    _close(res.anchors[0], anchors, rtol=1e-5, floor=1e-6)
