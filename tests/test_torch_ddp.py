"""Parity of the port's centroidal DDP planner with qppvm_tpu:
``mpc/centroidal.py``, ``mpc/ilqr.py`` and ``mpc/ddp_mpc.py``, alone and
composed with the ForceAcc tracker in closed loop; ``config.build_mpc``'s
``ilqr`` branch and ``run.main``'s fault on it.

Inputs are made from a numpy seed and go to both sides. Whole plans (U, X,
K, k, cost, reg) are held in float64 on both sides: the line search's
argmin over 6 rollouts and its acceptance test can flip under float32
roundoff, after which two plans part ways. The reference's CentroidalMPC
cannot plan in float64 (its start state is float32 always, and its scan
refuses the mixed carry): its module's ``init_state`` is given a float64
default while the JAX plan is traced, which is what the port does with
its planner's dtype; both planners hold the robot model in float64.
Single steps (``dynamics_step``, the cost, the humanoid's ``from_robot``)
are held in float32.

The JAX programs (the LQR, hover and squat solves, the plan, the
quadruped's tick and plant substep, ``from_robot`` on the humanoid) are
traced once at module scope and compiled on threads. The closed loop
starts both sides from the port's on_start (the float32 on_start knife
edge stays out, ROADMAP section 3).

Tolerances:
- float32 single steps: 1e-6 of each output's scale (a few ulps; the SRBD
  inertia's 3x3 Newton-Schulz inverse in another order);
- float64 plans: 1e-9 of each field's scale (the two packages agree to
  1e-14 on the LQR; sums in another order);
- the closed loop's torques: 1e-3 of their scale, as
  tests/test_torch_gait.py holds them; its second plan, from states
  20 float32 ticks apart: 1e-4 of each field's scale.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu import run as jrun
from qppvm_tpu.model import dynamics as jdynamics
from qppvm_tpu.model import zoo as jzoo
from qppvm_tpu.model.robot import RobotState as JRobotState
from qppvm_tpu.mpc import centroidal as jcentroidal
from qppvm_tpu.mpc import ilqr as jilqr
from qppvm_tpu.mpc.ddp_mpc import CentroidalMPC as JCentroidalMPC
from qppvm_tpu.mpc.ddp_mpc import CentroidalMPCConfig as JMPCConfig
from qppvm_tpu.opt.qp import QPState as JQPState
from qppvm_tpu.plugins.force_acc import ForceAccPlugin as JForceAcc
from qppvm_tpu.runtime.robot_interface import SimRobot as JSimRobot
from qppvm_tpu_torch import config, run
from qppvm_tpu_torch.model import convert, dynamics, kinematics, zoo
from qppvm_tpu_torch.mpc import centroidal, ilqr
from qppvm_tpu_torch.mpc.ddp_mpc import CentroidalMPC, CentroidalMPCConfig
from qppvm_tpu_torch.opt import ns_inverse
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
from qppvm_tpu_torch.runtime.robot_interface import SimRobot, standing_state

torch.set_num_threads(1)
F64 = torch.float64
FEET = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")
SOLES = ("l_sole", "r_sole")
# tests/test_ddp_mpc.py's planner
MPC_CFG = dict(horizon=15, dt=0.02, iterations=4)
LOOP_TICKS, PLAN_EVERY = 40, 20
RESULT_FIELDS = convert.ILQR_RESULT_FIELDS


def _close(actual, desired, rel, floor=0.0):
    """|actual - desired| <= rel (max |desired| + 1) elementwise."""
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape, (actual.shape, desired.shape)
    scale = float(np.max(np.abs(desired), initial=0.0)) + 1.0
    np.testing.assert_allclose(actual, desired, rtol=0.0,
                               atol=rel * scale + floor)


def _np(tree, fields):
    return {f: np.asarray(getattr(tree, f)) for f in fields}


def _close_result(res, jres, rel):
    for f in RESULT_FIELDS:
        _close(getattr(res, f).numpy(), np.asarray(getattr(jres, f)), rel)


# ---- the problems, on both sides -----------------------------------------

def _lqr_problem(nx=4, nu=2, H=30, seed=0):
    """tests/test_ilqr.py's LQR problem, float64."""
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.05 * rng.standard_normal((nx, nx))
    B = 0.1 * rng.standard_normal((nx, nu))
    return A, B, np.eye(nx), 0.1 * np.eye(nu), rng.standard_normal(nx), H


def _lqr_solver(lib, A, B, Q, R, iterations=3):
    """(solve, make) of the LQR problem in ``lib`` (torch or jnp)."""
    t = ((lambda a: torch.tensor(a, dtype=F64)) if lib is torch
         else jnp.asarray)
    A, B, Q, R = map(t, (A, B, Q, R))
    mod = ilqr if lib is torch else jilqr
    return mod.make_solver(lambda x, u: A @ x + B @ u,
                           lambda x, u: 0.5 * (x @ Q @ x + u @ R @ u),
                           lambda x: 0.5 * x @ Q @ x,
                           mod.ILQRConfig(iterations=iterations))


def _riccati(A, B, Q, R, H):
    """Finite-horizon discrete LQR gains by the backward Riccati recursion
    (numpy oracle), time order."""
    P, Ks = Q.copy(), []
    for _ in range(H):
        K = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        P = Q + A.T @ P @ (A - B @ K)
        Ks.append(K)
    return np.stack(Ks[::-1])


def _srbd(active=(1.0, 1.0, 1.0, 1.0)):
    """tests/test_ilqr.py's SRBD parameters, as numpy float64."""
    return dict(mass=np.float64(40.0), inertia=2.0 * np.eye(3),
                footholds=np.array([[0.1, 0.1, 0.0], [0.1, -0.1, 0.0],
                                    [-0.1, 0.1, 0.0], [-0.1, -0.1, 0.0]]),
                active=np.asarray(active, np.float64),
                gravity=np.array([0.0, 0.0, -9.81]), dt=np.float64(0.02))


def _params(arrays, side, dtype):
    if side == "torch":
        return convert.centroidal_params(arrays, "cpu", dtype)
    return jcentroidal.CentroidalParams(
        **{k: jnp.asarray(v, dtype) for k, v in arrays.items()})


# tests/test_ilqr.py's hover and squat: (H, iterations, dz, final weight)
CENTROIDAL_CASES = {"hover": (20, 8, 0.0, 10.0), "squat": (40, 10, -0.1, 50.0)}


def _centroidal_solver(side, case):
    """(solve, x0, U0) of a tests/test_ilqr.py centroidal case, float64."""
    H, iterations, dz, final_w = CENTROIDAL_CASES[case]
    p0 = np.array([0.0, 0.0, 0.5])
    p_ref = p0 + np.array([0.0, 0.0, dz])
    if side == "torch":
        mod, lib, dt = centroidal, ilqr, F64
        p = _params(_srbd(), side, dt)
        x0 = mod.init_state(torch.tensor(p0), dtype=dt, device="cpu")
        zero = torch.zeros(12, dtype=dt)
        U0 = mod.gravity_feedforward(p)[None].repeat(H, 1)
    else:
        mod, lib, dt = jcentroidal, jilqr, jnp.float64
        p = _params(_srbd(), side, dt)
        x0 = mod.init_state(jnp.asarray(p0), dtype=dt)
        zero = jnp.zeros(12, dt)
        U0 = jnp.tile(mod.gravity_feedforward(p)[None], (H, 1))
    cost = mod.standing_cost(p, p_ref=p_ref)
    dyn = (partial(mod.dynamics_step, p, Iinv=mod.inertia_inverse(p))
           if side == "torch" else partial(mod.dynamics_step, p))
    solve = lib.make_solver(dyn, cost,
                            lambda x: final_w * cost(x, zero),
                            lib.ILQRConfig(iterations=iterations))
    return solve, x0, U0


def _jstate(st, dtype=jnp.float32):
    return JRobotState(**{k: jnp.asarray(getattr(st, k)[0].numpy(), dtype)
                          for k in convert.STATE_FIELDS})


def _state64(st):
    return dataclasses.replace(st, **{k: getattr(st, k).to(F64)
                                      for k in convert.STATE_FIELDS})


def _model64(jmodel):
    """The reference's model carried across in float64 (the same values)."""
    return convert.robot_model(
        {k: np.asarray(getattr(jmodel, k)) for k in convert.MODEL_ARRAYS},
        {k: getattr(jmodel, k) for k in convert.MODEL_META}, "cpu", F64)


def _f32(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _item(tree):
    if isinstance(tree, dict):
        return {k: _item(v) for k, v in tree.items()}
    return tree[0].numpy()


def _jfrom_robot(model, contacts):
    return jax.jit(lambda st: jcentroidal.from_robot(
        model, jdynamics.compute_model_data(model, st), contacts, 0.02))


@pytest.fixture(scope="module")
def ref():
    """Both sides' objects, and every JAX program of this file traced here
    and compiled on threads."""
    tm = zoo.quadruped(device="cpu")
    tp = ForceAccPlugin(tm, contact_links=FEET, waist_link="pelvis",
                        iters=40)
    st = standing_state(tm, FEET)
    refs, warm, waist = tp.on_start(st)
    jm = jzoo.quadruped()
    jp = JForceAcc(jm, contact_links=FEET, waist_link="pelvis", iters=40)
    jst = _jstate(st)
    jrefs = _f32(_item(refs))
    jwarm = tuple(JQPState(**{f: jnp.asarray(getattr(lv, f)[0].numpy())
                              for f in convert.QPSTATE_FIELDS})
                  for lv in warm)
    jrobot = JSimRobot(jm, state=jst, dt=1e-3, substeps=4,
                       contact_links=FEET)
    mpc = CentroidalMPC(_model64(jm), FEET, CentroidalMPCConfig(**MPC_CFG),
                        dtype=F64)
    # the reference's plan on its model in float64 (its float32 model would
    # keep the total mass in float32)
    jmpc = JCentroidalMPC(jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                       jm), FEET, JMPCConfig(**MPC_CFG),
                          dtype=jnp.float64)
    U0 = mpc.init_plan(_state64(st))
    com0 = kinematics.com(tm, kinematics.fk(tm, st))[1][0].to(F64)
    p_ref = com0 - torch.tensor([0.0, 0.0, 0.04], dtype=F64)
    A, B, Q, R, x0, H = _lqr_problem()
    hum, jhum = zoo.humanoid(device="cpu"), jzoo.humanoid()
    hum_st = standing_state(hum, SOLES)
    programs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcentroidal, "init_state",
                   partial(jcentroidal.init_state, dtype=jnp.float64))
        programs["plan"] = jmpc._plan.lower(
            jst.astype(jnp.float64), jnp.asarray(p_ref.numpy()),
            jnp.asarray(U0.numpy()), jnp.ones(len(FEET), jnp.float64))
    programs["tick"] = jp._step.lower(jst, jrefs, jwarm)
    programs["sim"] = jrobot._step.lower(jst, jrobot._anchors,
                                         jrobot._tau_ref, jrobot._q_ref,
                                         jrobot.k, jrobot.d)
    programs["lqr"] = jax.jit(_lqr_solver(jnp, A, B, Q, R)).lower(
        jnp.asarray(x0), jnp.zeros((H, 2)))
    for case in CENTROIDAL_CASES:
        solve, jx0, jU0 = _centroidal_solver("jax", case)
        programs[case] = jax.jit(solve).lower(jx0, jU0)
    programs["from_humanoid"] = _jfrom_robot(jhum, SOLES).lower(
        _jstate(hum_st))
    with ThreadPoolExecutor(len(programs)) as pool:
        compiled = dict(zip(programs, pool.map(lambda lw: lw.compile(),
                                               programs.values())))
    jp._step = compiled["tick"]
    jmpc._plan = compiled["plan"]
    jrobot._step = compiled["sim"]     # the closed loop's plant
    return dict(tm=tm, tp=tp, st=st, refs=refs, warm=warm, waist=waist,
                jp=jp, jst=jst, jrefs=jrefs, jwarm=jwarm, jrobot=jrobot,
                mpc=mpc, jmpc=jmpc, U0=U0, com0=com0, p_ref=p_ref, hum=hum,
                hum_st=hum_st, lqr=(A, B, Q, R, x0, H),
                **{f"j{k}": v for k, v in compiled.items()})


# ---- centroidal.py -------------------------------------------------------

def test_dynamics_step_and_cost_match_reference():
    """float32 single steps at seeded states and forces, one contact gated
    off: the step, the cost and gravity_feedforward."""
    rng = np.random.default_rng(0)
    arrays = _srbd(active=(0.0, 1.0, 1.0, 1.0))
    arrays["inertia"] = arrays["inertia"] + 0.1 * np.array(
        [[0.0, 1.0, 0.5], [1.0, 0.0, -0.3], [0.5, -0.3, 0.0]])
    p, jp = (_params(arrays, s, d) for s, d in (("torch", torch.float32),
                                                ("jax", jnp.float32)))
    cost = centroidal.standing_cost(p, torch.tensor([0.0, 0.05, 0.45]))
    jcost = jcentroidal.standing_cost(jp, jnp.asarray([0.0, 0.05, 0.45]))
    Iinv = centroidal.inertia_inverse(p)
    for _ in range(4):
        x = rng.standard_normal(12).astype(np.float32)
        u = (100.0 * rng.standard_normal(12)).astype(np.float32)
        xt, ut = torch.tensor(x), torch.tensor(u)
        _close(centroidal.dynamics_step(p, xt, ut, Iinv).numpy(),
               jcentroidal.dynamics_step(jp, jnp.asarray(x), jnp.asarray(u)),
               1e-6)
        _close(cost(xt, ut).item(), float(jcost(jnp.asarray(x),
                                                  jnp.asarray(u))), 1e-6)
    _close(centroidal.gravity_feedforward(p).numpy(),
           jcentroidal.gravity_feedforward(jp), 1e-6)
    x0 = centroidal.init_state(torch.tensor([0.0, 0.0, 0.5]),
                               torch.tensor([0.1, 0.0, 0.0]), device="cpu")
    assert x0.dtype == torch.float32 and x0.shape == (centroidal.NX,)
    _close(x0.numpy(), jcentroidal.init_state(jnp.asarray([0.0, 0.0, 0.5]),
                                              jnp.asarray([0.1, 0.0, 0.0])),
           0.0)
    assert centroidal.nu(p) == jcentroidal.nu(jp) == 12


def test_init_state_defaults_to_the_card():
    """init_state puts x0 on ``device``, the card by default, whatever its
    input: a list or an array never lands on the CPU unasked."""
    for com in ([0.0, 0.0, 0.5], np.array([0.0, 0.0, 0.5]),
                torch.tensor([0.0, 0.0, 0.5])):
        x0 = centroidal.init_state(com, [0.1, 0.0, 0.0], device="cpu")
        assert x0.device.type == "cpu" and x0.dtype == torch.float32
        assert x0.tolist() == pytest.approx([0.0, 0.0, 0.5, 0.1] + [0.0] * 8)
        if torch.cuda.is_available():
            assert centroidal.init_state(com).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                centroidal.init_state(com)


@pytest.mark.parametrize("robot", ["quadruped", "humanoid"])
def test_from_robot_matches_reference(ref, robot):
    """SRBD parameters from the full model at the standing state
    (compute_model_data, the feet's frames, the mass matrix's angular base
    block): the humanoid's in float32; the quadruped's in float64, as the
    reference's plan returns them."""
    if robot == "quadruped":
        got = centroidal.from_robot(
            ref["mpc"].model, dynamics.compute_model_data(
                ref["mpc"].model, _state64(ref["st"])), FEET, 0.02)
        want = ref["jmpc"].plan(ref["jst"].astype(jnp.float64),
                                ref["p_ref"].numpy(),
                                jnp.asarray(ref["U0"].numpy()))[1]
        rel = 1e-9
    else:
        model, st = ref["hum"], ref["hum_st"]
        got = centroidal.from_robot(
            model, dynamics.compute_model_data(model, st), SOLES, 0.02)
        want, rel = ref["jfrom_humanoid"](_jstate(st)), 1e-6
    for f in convert.CENTROIDAL_FIELDS:
        _close(getattr(got, f).numpy(), np.asarray(getattr(want, f)), rel)
    assert got.nc == (len(FEET) if robot == "quadruped" else len(SOLES))


def test_from_robot_rejects_a_batch(ref):
    tm = ref["tm"]
    st = standing_state(tm, FEET, batch=2)
    with pytest.raises(ValueError, match="batch of 2"):
        centroidal.from_robot(tm, dynamics.compute_model_data(tm, st), FEET,
                              0.02)


# ---- ilqr.py -------------------------------------------------------------

def test_ilqr_lqr_matches_reference_and_riccati(ref):
    """tests/test_ilqr.py's LQR problem in float64: the whole result
    against JAX's; the cost against the Riccati policy's (rtol 1e-3, the
    JAX test's bar) and the final gains against the Riccati gains (the
    final LM regularization, 5e-5 here, moves them by up to 2e-3)."""
    A, B, Q, R, x0, H = ref["lqr"]
    res = _lqr_solver(torch, A, B, Q, R)(torch.tensor(x0),
                                        torch.zeros((H, 2), dtype=F64))
    jres = ref["jlqr"](jnp.asarray(x0), jnp.zeros((H, 2)))
    _close_result(res, jres, 1e-9)
    Ks = _riccati(A, B, Q, R, H)
    x, c_opt = x0.copy(), 0.0
    for t in range(H):
        u = -Ks[t] @ x
        c_opt += 0.5 * (x @ Q @ x + u @ R @ u)
        x = A @ x + B @ u
    c_opt += 0.5 * x @ Q @ x
    np.testing.assert_allclose(res.cost.item(), c_opt, rtol=1e-3)
    _close(res.K.numpy(), -Ks, 1e-3)


def test_ilqr_feedback_gains_stabilize():
    """tests/test_ilqr.py's feedback check on the port: the returned
    time-varying gains bring a perturbed start closer to 0."""
    A, B, Q, R, x0, H = _lqr_problem(seed=3)
    res = _lqr_solver(torch, A, B, Q, R)(torch.tensor(x0),
                                        torch.zeros((H, 2), dtype=F64))
    x = x0 + 0.1
    for t in range(H):
        u = res.U[t].numpy() + res.K[t].numpy() @ (x - res.X[t].numpy())
        x = A @ x + B @ u
    assert np.linalg.norm(x) < np.linalg.norm(x0 + 0.1)


@pytest.mark.parametrize("case", sorted(CENTROIDAL_CASES))
def test_centroidal_cases_match_reference(ref, case):
    """tests/test_ilqr.py's hover and squat, float64: the whole plan against
    JAX's, and the JAX test's own gates on the port's."""
    solve, x0, U0 = _centroidal_solver("torch", case)
    res = solve(x0, U0)
    _close_result(res, ref[f"j{case}"](*_centroidal_solver("jax", case)[1:]),
                  1e-9)
    assert torch.isfinite(res.U).all()
    if case == "hover":
        F = res.U[0].numpy().reshape(4, 3)
        weight = 40.0 * 9.81
        assert abs(F[:, 2].sum() - weight) < 0.05 * weight, F
        assert np.all(F[:, 2] > 0.15 * weight)
        assert np.linalg.norm(res.X[-1, :3].numpy() - [0, 0, 0.5]) < 0.01
    else:
        assert abs(res.X[-1, 2].item() - 0.4) < 0.03


def test_contact_gating_matches_reference():
    """tests/test_ilqr.py's gating case: a gated-off foothold carries no
    feed-forward force and its force moves nothing, on both sides."""
    arrays = _srbd(active=(0.0, 1.0, 1.0, 1.0))
    p, jp = _params(arrays, "torch", F64), _params(arrays, "jax", jnp.float64)
    u = centroidal.gravity_feedforward(p)
    F = u.numpy().reshape(4, 3)
    assert F[0, 2] == 0.0 and abs(F[1:, 2].sum() - 40.0 * 9.81) < 1.0
    x0 = centroidal.init_state(torch.tensor([0.0, 0.0, 0.5]), dtype=F64,
                               device="cpu")
    bump = torch.tensor([0.0, 0.0, 1000.0] + [0.0] * 9, dtype=F64)
    Iinv = centroidal.inertia_inverse(p)
    x1a = centroidal.dynamics_step(p, x0, u, Iinv)
    torch.testing.assert_close(
        centroidal.dynamics_step(p, x0, u + bump, Iinv), x1a, rtol=0.0,
        atol=1e-12)
    jx1 = jcentroidal.dynamics_step(jp, jnp.asarray(x0.numpy()),
                                    jnp.asarray(u.numpy()))
    _close(x1a.numpy(), jx1, 1e-12)


# ---- ddp_mpc.py ----------------------------------------------------------

def test_plan_matches_reference(ref):
    """One CentroidalMPC.plan on the quadruped from its standing state at
    tests/test_ddp_mpc.py's config and target, float64 on both sides."""
    st = _state64(ref["st"])
    res, params = ref["mpc"].plan(st, ref["p_ref"], ref["U0"])
    jres, jparams = ref["jmpc"].plan(ref["jst"].astype(jnp.float64),
                                     ref["p_ref"].numpy(),
                                     jnp.asarray(ref["U0"].numpy()))
    _close_result(res, jres, 1e-9)
    for f in convert.CENTROIDAL_FIELDS:
        _close(getattr(params, f).numpy(), np.asarray(getattr(jparams, f)),
               1e-9)
    assert abs(res.X[-1, 2].item() - ref["p_ref"][2].item()) < 0.005


def test_planner_routes_every_inverse(ref, monkeypatch):
    """A plan inverts Q_uu once a step of every backward pass and the SRBD
    inertia once, each through ns_inverse (one launch each on the card):
    horizon x (iterations + 1) + 1, at 22 and 16 iterations."""
    calls = []
    real = ns_inverse.ns_inverse
    monkeypatch.setattr(ns_inverse, "ns_inverse", lambda K, iters: (
        calls.append((tuple(K.shape), iters)) or real(K, iters)))
    ref["mpc"].plan(_state64(ref["st"]), ref["p_ref"], ref["U0"])
    H, it = MPC_CFG["horizon"], MPC_CFG["iterations"]
    assert calls.count(((1, 12, 12), ilqr.QUU_NS_ITERS)) == H * (it + 1)
    assert calls.count(((1, 3, 3), centroidal.INERTIA_NS_ITERS)) == 1
    assert len(calls) == H * (it + 1) + 1


@pytest.mark.parametrize("gated,wrench_dim", [(False, 3), (True, 3),
                                              (True, 6)])
def test_plan_references_match_reference(ref, gated, wrench_dim):
    """waist_ref_from_plan and force_ref_offset on the JAX plan carried
    across (convert.ilqr_result, centroidal_params): ungated, gated, and
    embedded in 6D wrench blocks."""
    jres, jparams = ref["jmpc"].plan(ref["jst"].astype(jnp.float64),
                                     ref["p_ref"].numpy(),
                                     jnp.asarray(ref["U0"].numpy()))
    res = convert.ilqr_result(_np(jres, RESULT_FIELDS), "cpu", F64)
    params = convert.centroidal_params(
        _np(jparams, convert.CENTROIDAL_FIELDS), "cpu", F64)
    gates = np.array([1.0, 0.0, 1.0, 1.0]) if gated else None
    for k in (1, 5):
        _close(CentroidalMPC.waist_ref_from_plan(res, k).numpy(),
               JCentroidalMPC.waist_ref_from_plan(jres, k), 0.0)
    W = 470.0
    got = CentroidalMPC.force_ref_offset(
        res, params, W, k=2, wrench_dim=wrench_dim,
        gates=None if gates is None else torch.tensor(gates[None]))
    want = JCentroidalMPC.force_ref_offset(jres, jparams, W, k=2,
                                           gates=gates,
                                           wrench_dim=wrench_dim)
    assert got.shape == (len(FEET) * wrench_dim,)
    _close(got.numpy(), want, 1e-12)


def test_closed_loop_matches_reference(ref):
    """tests/test_ddp_mpc.py's squat, LOOP_TICKS ticks, a plan every
    PLAN_EVERY ticks (float64, the JAX plan's U carried across as the
    port's next warm start), the planned CoM 5 steps ahead as the waist
    reference; torques every tick and both plans held to the reference's."""
    tm, tp, jp, jrobot = ref["tm"], ref["tp"], ref["jp"], ref["jrobot"]
    robot = SimRobot(tm, state=ref["st"], dt=1e-3, substeps=4,
                     contact_links=FEET)
    mpc, jmpc, com0, p_ref = ref["mpc"], ref["jmpc"], ref["com0"], ref["p_ref"]
    U, jU = ref["U0"], jnp.asarray(ref["U0"].numpy())
    warm, jwarm = ref["warm"], ref["jwarm"]
    jcom0, jwaist = com0.numpy(), ref["waist"][0].numpy().astype(np.float64)
    for i in range(LOOP_TICKS):
        if i % PLAN_EVERY == 0:
            res, _ = mpc.plan(_state64(robot.state), p_ref, U)
            jres, _ = jmpc.plan(jrobot.state.astype(jnp.float64),
                                p_ref.numpy(), jU)
            _close_result(res, jres, 1e-9 if i == 0 else 1e-4)
            jU = jres.U
            U = convert.ilqr_result(_np(jres, RESULT_FIELDS), "cpu", F64).U
        # the planned CoM's offset as a waist offset, in float64
        refs_t = dict(ref["refs"])
        refs_t["waist_task"] = dict(refs_t["waist_task"], p=(
            ref["waist"].to(F64) + CentroidalMPC.waist_ref_from_plan(res, 5)
            - com0).float())
        jrefs_t = dict(ref["jrefs"])
        jrefs_t["waist_task"] = dict(jrefs_t["waist_task"], p=jnp.asarray(
            jwaist + JCentroidalMPC.waist_ref_from_plan(jres, 5) - jcom0,
            jnp.float32))
        tau, warm, aux = tp.control_loop(robot.state, refs_t, warm)
        jtau, jwarm, jaux = jp.control_loop(jrobot.state, jrefs_t, jwarm)
        assert not bool(aux.solver_failed.any())
        assert not bool(jaux.solver_failed)
        _close(tau[0].numpy(), np.asarray(jtau), 1e-3)
        robot.set_reference(tau_ref=tau, q_ref=robot.state.q)
        robot.move()
        jrobot.set_reference(tau_ref=jtau, q_ref=jrobot.state.q)
        jrobot.move()
    _close(robot.state.q[0].numpy(), np.asarray(jrobot.state.q), 1e-4)


# ---- config.py and run.py ------------------------------------------------

ILQR_YAML = """
name: ddp_quadruped
robot:
  zoo: quadruped
plugin:
  type: force_acc
  contact_links: [foot_fl, foot_fr, foot_hr, foot_hl]
  waist_link: pelvis
mpc:
  enabled: true
  type: ilqr
  horizon: 15
  qp_iters: 4
"""


def test_build_mpc_ilqr_branch(tmp_path):
    path = tmp_path / "ilqr.yaml"
    path.write_text(ILQR_YAML)
    cfg = config.load_scenario(str(path))
    model = config.build_model(cfg, device="cpu")
    mpc = config.build_mpc(cfg, config.build_plugin(cfg, model))
    assert isinstance(mpc, CentroidalMPC) and mpc.model is model
    assert mpc.contact_links == FEET
    assert dataclasses.asdict(mpc.cfg) == dataclasses.asdict(
        JMPCConfig(horizon=15, iterations=4))
    U = mpc.init_plan(standing_state(model, FEET))
    assert U.shape == (15, 12) and U.device == torch.device("cpu")


def test_run_ilqr_raises_like_reference(tmp_path, monkeypatch):
    """The reference's runner calls init_plan() with no state on every
    planner, so ``mpc.type: ilqr`` raises TypeError before any plan; the
    port copies it (ROADMAP section 3). on_start is stubbed on both sides:
    the fault is in the call after it."""
    path = tmp_path / "ilqr.yaml"
    path.write_text(ILQR_YAML)
    monkeypatch.setattr(JForceAcc, "on_start", lambda self, st: (None,) * 3)
    monkeypatch.setattr(ForceAccPlugin, "on_start",
                        lambda self, st: (None,) * 3)
    for main in (jrun.main, run.main):
        with pytest.raises(TypeError, match="init_plan.*state"):
            main(["--config", str(path), "--cpu"])
