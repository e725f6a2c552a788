"""Parity of the port's sense-to-model path and gait with qppvm_tpu:
``runtime/estimator.py`` (``sync_model_state``, ``FloatingBaseEstimator``)
and ``runtime/gait.py`` (``GaitScript``), alone and closed in a loop.

The same numpy-seeded inputs go to both sides in float32 (the suite
enables x64, so the JAX side is pinned). Both start from the port's
``on_start`` on the quadruped of tests/test_gait_walk.py (switchable
contacts, friction cones at mu 0.5, position-only feet tasks, iters 60),
carried across, so no JAX on_start is compiled. The JAX side compiles four
programs once, side by side on threads: the estimator's init and update,
the tick and the plant's substep; the gait script runs eagerly on both
sides, as it does in deployment.

Tolerances:
- estimator outputs (base position, anchors, base twist): 1e-5 absolute +
  1e-5 relative (float32 kinematics through a 3x3 Newton-Schulz solve);
- gait references: 1e-6 of each leaf's scale (a few float32 ulps of
  kinematics and min-jerk arithmetic; a wrong gate, phase, pacing or servo
  term moves a leaf by O(1) of its scale); the gait's integer
  bookkeeping exactly;
- the closed loop's torques: 1e-3 of their scale, as
  tests/test_torch_qppvm.py holds QPPVM's (a 2-level cascade each tick,
  float32 sums in another order).
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu.model import zoo as jzoo
from qppvm_tpu.model.robot import RobotState as JRobotState
from qppvm_tpu.opt.qp import QPState as JQPState
from qppvm_tpu.plugins.force_acc import ForceAccPlugin as JForceAcc
from qppvm_tpu.runtime import estimator as jestimator
from qppvm_tpu.runtime import gait as jgait
from qppvm_tpu.runtime.contact_switch import LegLiftPhases as JPhases
from qppvm_tpu.runtime.robot_interface import SimRobot as JSimRobot
from qppvm_tpu_torch.model import convert, zoo
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
from qppvm_tpu_torch.runtime import estimator, gait
from qppvm_tpu_torch.runtime.contact_switch import LegLiftPhases
from qppvm_tpu_torch.runtime.robot_interface import SimRobot, standing_state

torch.set_num_threads(1)
FEET = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")
WALK = dict(contact_links=FEET, waist_link="pelvis", iters=60,
            switchable_contacts=True, use_friction_cones=True, mu=0.5,
            foot_tasks_6d=False)
# tests/test_gait_walk.py's stride
WALK_PHASES = dict(settle=100, shift=600, dwell=100, unload=150, lift=250,
                   hold=0, lower=300, reload=250)
WALK_GAIT = dict(order=("foot_hl", "foot_fl", "foot_hr", "foot_fr"),
                 stride=(0.06, 0.0), n_strides=1, shift_mode="edge",
                 touch_depth=0.012)
# every option of the stride logic at once, over 2 strides: adaptive
# shift pacing, the unload gate (a loose position bar, so a state's
# velocity decides), the CoM servo and the relative replant
OPTIONS = dict(stride=(0.05, 0.01), n_strides=2, shift_a_max=0.5,
               unload_gate={"tol_p": 0.5, "tol_v": 0.05, "max_extra": 5},
               com_servo=True, relative_replant=True, tail=10,
               lift_height=0.04)
LOOP_TICKS = 5
BOOK = ("_k", "_t0", "_extra", "total")


def _close(actual, desired, rtol, floor):
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape, (actual.shape, desired.shape)
    scale = float(np.max(np.abs(desired), initial=0.0)) + 1.0
    np.testing.assert_allclose(actual, desired, rtol=rtol,
                               atol=floor * scale)


def _est_close(actual, desired):
    np.testing.assert_allclose(np.asarray(actual, np.float64),
                               np.asarray(desired, np.float64),
                               rtol=1e-5, atol=1e-5)


def _f32(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _item(tree):
    """Item 0 of a port tree of tensors, as numpy."""
    if isinstance(tree, dict):
        return {k: _item(v) for k, v in tree.items()}
    return tree[0].numpy()


def _jstate(st):
    return JRobotState(**{k: jnp.asarray(getattr(st, k)[0].numpy())
                          for k in convert.STATE_FIELDS})


def _compare_refs(got, ref):
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k, v in got.items():
        if isinstance(v, dict):
            _compare_refs(v, ref[k])
        else:
            _close(v[0].numpy(), np.asarray(ref[k]), rtol=0.0, floor=1e-6)


@pytest.fixture(scope="module")
def quad():
    """The walk's quadruped on both sides from the port's on_start, and
    the JAX estimator, tick and plant substep compiled side by side."""
    tm = zoo.quadruped(device="cpu")
    tp = ForceAccPlugin(tm, **WALK)
    st = standing_state(tm, FEET)
    refs, warm, waist = tp.on_start(st)
    jm = jzoo.quadruped()
    jp = JForceAcc(jm, **WALK)
    jst = _jstate(st)
    jrefs = _f32(_item(refs))
    jwarm = tuple(JQPState(**{f: jnp.asarray(getattr(lv, f)[0].numpy())
                              for f in convert.QPSTATE_FIELDS})
                  for lv in warm)
    jest = jestimator.FloatingBaseEstimator(jm, FEET)
    jrobot = JSimRobot(jm, state=jst, dt=1e-3, substeps=2,
                       contact_links=FEET, ground_z=0.0)
    ones = jnp.ones(len(FEET), jnp.float32)
    es_shape = jax.eval_shape(jest.init, jst)
    lowered = [jax.jit(jest.init).lower(jst),
               jest._update.lower(es_shape, jst.q, jst.qd, jst.base_rot,
                                  jst.base_vel[:3], ones),
               jp._step.lower(jst, jrefs, jwarm),
               jrobot._step.lower(jst, jrobot._anchors, jrobot._tau_ref,
                                  jrobot._q_ref, jrobot.k, jrobot.d)]
    with ThreadPoolExecutor(len(lowered)) as pool:
        init, update, step, sim = pool.map(lambda lw: lw.compile(), lowered)
    jest._update = update
    jp._step = step
    return dict(tm=tm, tp=tp, st=st, refs=refs, warm=warm, waist=waist,
                jm=jm, jp=jp, jst=jst, jrefs=jrefs, jwarm=jwarm,
                jwaist=jnp.asarray(waist[0].numpy()), jest=jest,
                jinit=init, jsim=sim)


def _rot(rng, scale):
    """A rotation matrix exp([scale N(0, 1)]x), float32."""
    w = scale * rng.normal(size=3)
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K
            + (1 - np.cos(th)) * K @ K).astype(np.float32)


def _sensor_robots(model, data):
    """A port robot (batch-first) and a reference robot (unbatched) whose
    getters and shared-memory channels hold ``data``."""
    def robot(lift):
        chans = {"/sim/floating_base_position": data["pos"],
                 "/sim/floating_base_velocity": data["vel"]}
        shm = SimpleNamespace(get_shared_object=lambda n: SimpleNamespace(
            get=lambda: lift(chans[n])))
        return SimpleNamespace(
            get_motor_position=lambda: lift(data["q"]),
            get_motor_velocity=lambda: lift(data["qd"]),
            get_imu=lambda: SimpleNamespace(orientation=lift(data["R"]),
                                            angular_velocity=lift(data["w"])),
            shared_memory=shm)
    return (robot(lambda a: torch.tensor(a[None])),
            robot(lambda a: jnp.asarray(a)))


@pytest.mark.parametrize("name", ["quadruped", "arm7"])
def test_sync_model_state_matches_reference(name):
    tm, jm = zoo.by_name(name, device="cpu"), jzoo.by_name(name)
    rng = np.random.default_rng(4)
    data = {"q": rng.normal(size=tm.nj), "qd": rng.normal(size=tm.nj),
            "R": _rot(rng, 0.3), "w": rng.normal(size=3),
            "pos": rng.normal(size=3), "vel": rng.normal(size=3)}
    data = {k: np.asarray(v, np.float32) for k, v in data.items()}
    trobot, jrobot = _sensor_robots(tm, data)
    got = estimator.sync_model_state(trobot, tm)
    ref = jestimator.sync_model_state(jrobot, jm)
    assert got.batch == 1
    for k in convert.STATE_FIELDS:
        _close(getattr(got, k)[0].numpy(), np.asarray(getattr(ref, k)),
               rtol=1e-6, floor=1e-7)


def test_estimator_matches_reference(quad):
    """init, then updates over a gate sequence with a break, a make (the
    re-anchor pinned at ground_z), no active contact and a make from
    there, at perturbed measurements."""
    tm, st, jest = quad["tm"], quad["st"], quad["jest"]
    est = estimator.FloatingBaseEstimator(tm, FEET)
    es, jes = est.init(st), quad["jinit"](quad["jst"])
    for k in convert.ESTIMATOR_FIELDS:
        _est_close(getattr(es, k)[0].numpy(), np.asarray(getattr(jes, k)))
    # the converted reference state continues as the port's own
    es = convert.estimator_state(
        {k: np.asarray(getattr(jes, k)) for k in convert.ESTIMATOR_FIELDS},
        device="cpu")
    gates = [[1, 1, 1, 1], [0, 1, 1, 1], [0, 1, 1, 1], [1, 1, 1, 1],
             [1, 0, 0, 1], [0, 0, 0, 0], [0, 1, 0, 0], [1, 1, 1, 1]]
    rng = np.random.default_rng(5)
    q0 = st.q[0].numpy()
    for g in gates:
        q = (q0 + 0.05 * rng.normal(size=q0.shape)).astype(np.float32)
        qd = rng.normal(size=q0.shape).astype(np.float32)
        R = _rot(rng, 0.1)
        w = (0.5 * rng.normal(size=3)).astype(np.float32)
        g = np.float32(g)
        out, es = est.update(es, torch.tensor(q[None]),
                             torch.tensor(qd[None]), torch.tensor(R[None]),
                             torch.tensor(w[None]), torch.tensor(g[None]))
        jout, jes = jest.update(jes, q, qd, R, w, g)
        for k in convert.ESTIMATOR_FIELDS:
            _est_close(getattr(es, k)[0].numpy(), np.asarray(getattr(jes, k)))
        for k in ("base_pos", "base_vel", "base_rot", "q"):
            _est_close(getattr(out, k)[0].numpy(), np.asarray(getattr(jout, k)))
    made = es.anchors[0, 0]   # foot_fl, made on the last tick
    assert float(made[2]) == 0.0
    with pytest.raises(ValueError, match="floating base"):
        estimator.FloatingBaseEstimator(zoo.arm7(device="cpu"), ())


def _states(quad, rng, n):
    """``n`` perturbed standing states, as (port, reference) pairs."""
    st = quad["st"]
    out = []
    for _ in range(n):
        s = dataclasses.replace(
            st, q=st.q + torch.tensor(0.02 * rng.normal(size=st.q.shape),
                                      dtype=torch.float32),
            qd=torch.tensor(0.1 * rng.normal(size=st.qd.shape),
                            dtype=torch.float32),
            base_pos=st.base_pos + torch.tensor(
                0.005 * rng.normal(size=(1, 3)), dtype=torch.float32),
            base_vel=torch.tensor(0.02 * rng.normal(size=(1, 6)),
                                  dtype=torch.float32))
        out.append((s, _jstate(s)))
    return out


def _moving(quad, tg):
    """A state (port, reference) whose base moves 0.3 m/s along the
    current stride's CoM transfer direction: the unload gate pauses."""
    s = tg._script
    d = (s.c1 - s.c0)[0, :2]
    d = d / torch.linalg.norm(d)
    v = torch.zeros((1, 6))
    v[0, 3:5] = 0.3 * d
    st = dataclasses.replace(quad["st"], base_vel=v)
    return st, _jstate(st)


def test_gait_refs_match_reference(quad):
    """refs_at over 2 strides at every phase and stride boundary (+-1),
    the unload gate pausing on a moving state and passing on a still one,
    the relative replant at the lower phase's entry, then the tail."""
    tm, tp = quad["tm"], quad["tp"]
    tg = gait.GaitScript(tm, tp, quad["refs"], quad["waist"], **OPTIONS)
    jg = jgait.GaitScript(quad["jm"], quad["jp"], quad["jrefs"],
                          quad["jwaist"], **OPTIONS)
    assert tg.total == jg.total
    rng = np.random.default_rng(6)
    still = (quad["st"], quad["jst"])
    pauses, shifts = 0, []

    def call(i, pair):
        nonlocal pauses
        extra = tg._extra
        r = tg.refs_at(i, pair[0])
        jr = jg.refs_at(i, pair[1])
        for k in BOOK:
            assert getattr(tg, k) == getattr(jg, k), (i, k)
        s, js = tg._script, jg._script
        assert (dataclasses.astuple(s.ph), s.total, s.foot) == (
            dataclasses.astuple(js.ph), js.total, js.foot), i
        _close(tg._wint, jg._wint, rtol=0.0, floor=1e-6)
        _compare_refs(r, jr)
        pauses += tg._extra > extra

    for k in range(OPTIONS["n_strides"]):
        pairs = iter(_states(quad, rng, 24))
        start = tg._t0 + tg._script.total + tg._extra if k else 0
        call(start, next(pairs))          # the stride boundary
        assert tg._k == k
        s = tg._script
        shifts.append(s.ph.shift)
        for j in (1, s.t_shift0 - 1, s.t_shift0, s.t_shift0 + 1,
                  s.t_dwell0 - 1, s.t_dwell0, s.t_unload0 - 1):
            call(tg._t0 + tg._extra + j, next(pairs))
        base = tg._t0 + tg._extra + s.t_unload0
        moving = _moving(quad, tg)
        call(base, moving)       # paused: extra 1
        call(base + 1, moving)   # paused again: extra 2
        call(base + 2, still)    # settled: the clock runs on
        for j in (s.t_unload0 + 1, s.t_lift0 - 1, s.t_lift0, s.t_lift0 + 1,
                  s.t_lower0 - 1, s.t_lower0, s.t_lower0 + 1,
                  s.t_reload0 - 1, s.t_reload0, s.t_reload0 + 1,
                  s.total - 1):
            call(tg._t0 + tg._extra + j, next(pairs))
    call(tg._t0 + tg._script.total + tg._extra + 3, still)   # the tail
    assert pauses == 2 * OPTIONS["n_strides"]
    # the pacing lengthened a stride's shift past the schedule's
    assert max(shifts) > tg.phases.shift, shifts
    assert tg._k == OPTIONS["n_strides"] - 1


def test_gait_checks():
    """One robot only; n_strides 0 holds the base references."""
    tm = zoo.quadruped(device="cpu")
    tp = ForceAccPlugin(tm, **WALK)
    st = standing_state(tm, FEET, batch=2)
    refs = {c + "_cartesian": {"p": torch.zeros((1, 3))} for c in FEET}
    g = gait.GaitScript(tm, tp, refs, torch.zeros((1, 3)), n_strides=0)
    with pytest.raises(ValueError, match="one robot"):
        g.refs_at(0, st)
    assert g.refs_at(0, standing_state(tm, FEET)) is g.refs
    assert g.total == g.tail


def test_estimator_gait_loop_matches_reference(quad):
    """LOOP_TICKS ticks of the walk's loop on both sides from the same
    start: estimator (gates from the previous tick's references) ->
    refs_at (the walk's stride, with the CoM servo) -> tick -> plant."""
    tm, tp = quad["tm"], quad["tp"]
    kw = dict(WALK_GAIT, phases=LegLiftPhases(**WALK_PHASES), com_servo=True)
    tg = gait.GaitScript(tm, tp, quad["refs"], quad["waist"], **kw)
    jg = jgait.GaitScript(quad["jm"], quad["jp"], quad["jrefs"],
                          quad["jwaist"],
                          **dict(kw, phases=JPhases(**WALK_PHASES)))
    robot = SimRobot(tm, state=quad["st"], dt=1e-3, substeps=2,
                     contact_links=FEET, ground_z=0.0)
    jrobot = JSimRobot(quad["jm"], state=quad["jst"], dt=1e-3, substeps=2,
                       contact_links=FEET, ground_z=0.0)
    jrobot._step = quad["jsim"]
    est = estimator.FloatingBaseEstimator(tm, FEET)
    jest = quad["jest"]
    es, jes = est.init(robot.state), quad["jinit"](jrobot.state)
    warm, jwarm = quad["warm"], quad["jwarm"]
    gates = torch.ones((1, len(FEET)))
    jgates = jnp.ones(len(FEET), jnp.float32)
    for i in range(LOOP_TICKS):
        imu, jimu = robot.get_imu(), jrobot.get_imu()
        state, es = est.update(es, robot.get_motor_position(),
                               robot.get_motor_velocity(), imu.orientation,
                               imu.angular_velocity, active=gates)
        jstate, jes = jest.update(jes, jrobot.get_motor_position(),
                                  jrobot.get_motor_velocity(),
                                  jimu.orientation, jimu.angular_velocity,
                                  active=jgates)
        r, jr = tg.refs_at(i, state), _f32(jg.refs_at(i, jstate))
        gates, jgates = r["contacts"]["active"], jr["contacts"]["active"]
        tau, warm, aux = tp.control_loop(state, r, warm)
        jtau, jwarm, jaux = quad["jp"].control_loop(jstate, jr, jwarm)
        assert not bool(aux.solver_failed.any())
        assert not bool(jaux.solver_failed)
        _close(tau[0].numpy(), np.asarray(jtau), rtol=1e-3, floor=1e-3)
        _est_close(state.base_pos[0].numpy(), np.asarray(jstate.base_pos))
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        jrobot.set_reference(tau_ref=jtau, q_ref=jstate.q)
        jrobot.move()
    _close(tg._wint, jg._wint, rtol=1e-3, floor=1e-6)
    _close(robot.state.q[0].numpy(), np.asarray(jrobot.state.q),
           rtol=1e-4, floor=1e-5)


def test_gait_copies_the_reference_faults(quad):
    """Two faults of the reference's gait, copied for parity (ROADMAP
    section 3): the servo clips at com_servo["max"] and never reads
    com_servo_max, and a new stride does not zero the servo's integrator."""
    kw = dict(n_strides=2, com_servo={"kp": 10.0}, com_servo_max=0.01)
    tg = gait.GaitScript(quad["tm"], quad["tp"], quad["refs"], quad["waist"],
                         **kw)
    jg = jgait.GaitScript(quad["jm"], quad["jp"], quad["jrefs"],
                          quad["jwaist"], **kw)
    st = dataclasses.replace(quad["st"], base_pos=quad["st"].base_pos
                             + torch.tensor([[0.1, 0.0, 0.0]]))
    for g, s0, s, lift in ((tg, quad["st"], st, lambda a: a[0].numpy()),
                           (jg, quad["jst"], _jstate(st), np.asarray)):
        g.refs_at(0, s0)
        r = g.refs_at(1, s)     # the base 0.1 m ahead of the stride's start
        plain = g._script.refs_at(1)["waist_task"]["p"]
        corr = lift(r["waist_task"]["p"]) - lift(plain)
        # clipped at the dict's 0.12, not at com_servo_max's 0.01
        np.testing.assert_allclose(corr, [-0.12, 0.0, 0.0], atol=2e-3)
        g._wint = np.array([0.05, -0.05])
        g.refs_at(g._script.total, s)   # the next stride starts
        assert g._k == 1
        np.testing.assert_allclose(g._wint, [0.05, -0.05], atol=1e-3)
