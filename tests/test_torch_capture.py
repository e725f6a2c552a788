"""Parity of the port's footstep-recovery path with qppvm_tpu:
``kinematics.link_velocities``, ``runtime/trajectory.py``,
``runtime/contact_switch.py`` (``chain_joints``, ``LegLiftScript``), the
swing primitive and the capture terminal cost of ``mpc/rollout.py``, one
rollout carrying every new rollout option at once (switchable friction
cones, ``gate_seq``, the swing with a decision per sample, the terminal
cost) and ``SamplingMPC.update`` with the step-recovery channel.

The same numpy-seeded inputs go to both sides in float32 (the suite
enables x64, so the JAX side is pinned). Both start from the port's
``on_start`` on the quadruped (the references and warm state carried
across), so the rollouts are held alone and no JAX on_start is compiled.
The JAX side compiles two programs, the rollout and the MPPI step, once,
side by side on two threads; everything else runs it eagerly or in small
jitted programs. The reference runs its "xla" level solver; the port's
levels run the level kernel's plain version on CPU tensors.

Tolerances:
- costs, plans U and decisions theta: ``_close`` of
  tests/test_torch_mpc.py, rtol 1e-3 with an absolute floor of 1e-3 of
  the scale (float32 sums in another order through 3 steps of contact
  dynamics, each fed by a 2-level QP cascade); prim_res_max to the level
  kernel's bar (1e-5 + 2e-2 relative), a residual near roundoff moving by
  percents;
- references, twists and the terminal cost: rtol 1e-5 with an absolute
  floor of 1e-6 of the scale (a few float32 ulps; a wrong axis, gate,
  batch row or gain moves them by O(1) of their scale).
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu.model import kinematics as jkin
from qppvm_tpu.model import zoo as jzoo
from qppvm_tpu.model.robot import RobotState as JRobotState
from qppvm_tpu.mpc import rollout as jrollout
from qppvm_tpu.mpc import sampling as jsampling
from qppvm_tpu.opt.qp import QPState as JQPState
from qppvm_tpu.plugins.force_acc import ForceAccPlugin as JForceAcc
from qppvm_tpu.runtime import contact_switch as jcs
from qppvm_tpu.runtime import trajectory as jtraj
from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import convert, kinematics, zoo
from qppvm_tpu_torch.mpc import rollout, sampling
from qppvm_tpu_torch.opt import level_qp
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
from qppvm_tpu_torch.runtime import contact_switch, trajectory
from qppvm_tpu_torch.runtime.robot_interface import standing_state

torch.set_num_threads(1)
FEET = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")
SOLES = ("l_sole", "r_sole")
# tests/test_mpc_scenarios.py's quadruped: switchable contacts, friction
# cones at mu 0.5, position-only feet tasks, iters 40
QUAD = dict(contact_links=FEET, waist_link="pelvis", iters=40,
            switchable_contacts=True, use_friction_cones=True, mu=0.5,
            foot_tasks_6d=False)
K, H = 2, 3
# test_step_recovery_decision_channel's rollout (dt 0.04, mu 1.3) at H 3,
# 20 QP iterations and 2 substeps; the MPPI step's rollouts in 1 substep
# (each substep adds about 3 s to a program's tracing here)
RCFG = dict(horizon=H, qp_iters=20, dt=0.04, sim_substeps=2, mu=1.3)
MCFG = dict(RCFG, sim_substeps=1)
MPPI = dict(n_samples=3, horizon=H, noise_std=0.2, push_std=20.0,
            step_recovery=True, theta_noise_std=1.5, dxy_noise_std=0.1)
# two different decisions in one batch: foot_fr steps early, foot_fl
# later and sideways
THETAS = {"swing": [[-8.0, 3.0, -8.0, -8.0], [2.0, -6.0, -8.0, -1.0]],
          "t0": [-2.0, 0.5], "dxy": [[0.0, 0.1], [0.08, -0.3]]}


def _close(actual, desired, rtol=1e-3, floor=1e-3):
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape, (actual.shape, desired.shape)
    scale = float(np.max(np.abs(desired), initial=0.0)) + 1.0
    np.testing.assert_allclose(actual, desired, rtol=rtol,
                               atol=floor * scale)


def _tight(actual, desired):
    _close(actual, desired, rtol=1e-5, floor=1e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _item(tree, i):
    """Item ``i`` of a port tree of tensors, as numpy."""
    if isinstance(tree, dict):
        return {k: _item(v, i) for k, v in tree.items()}
    return tree[i].numpy()


def _jstate(st, i=0):
    return JRobotState(**{k: jnp.asarray(getattr(st, k)[i].numpy())
                          for k in convert.STATE_FIELDS})


def _compare_tree(got, ref, i=None, compare=_tight):
    """Every leaf of the port's ``got`` (item ``i`` of a batch, or batch 1)
    against the reference's unbatched ``ref``."""
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k, v in got.items():
        if isinstance(v, dict):
            _compare_tree(v, ref[k], i, compare)
        else:
            compare(v[0 if i is None else i].numpy(), ref[k])


@pytest.fixture(scope="module")
def quad():
    """The quadruped on both sides from the port's on_start, and the JAX
    rollout and MPPI-step programs, compiled side by side. The MPPI
    program is traced with jax.random.normal answering the fixed unit
    draws: the plan noise and the pushes, then the thetas by shape."""
    tm = zoo.quadruped(device="cpu")
    tp = ForceAccPlugin(tm, **QUAD)
    st = rollout.standing_state(tm, FEET)
    refs, warm, _ = tp.on_start(st)
    jm = jzoo.quadruped()
    jp = JForceAcc(jm, **QUAD)
    jst, jrefs = _jstate(st), _f32(_item(refs, 0))
    jwarm = tuple(JQPState(**{f: jnp.asarray(getattr(lv, f)[0].numpy())
                              for f in convert.QPSTATE_FIELDS})
                  for lv in warm)

    jcfg = jrollout.RolloutConfig(**RCFG)
    jswing, _ = jrollout.make_swing_primitive(jp, span_s=H * RCFG["dt"])
    jroll = jrollout.make_rollout_fn(
        jp, jcfg, jrollout.default_cost, swing=jswing,
        terminal_cost=jrollout.make_capture_terminal_cost(jp))
    roll_fn = jax.jit(jax.vmap(lambda U, sc, th: jroll(jst, jrefs, jwarm, U,
                                                         sc, th)))

    rng = np.random.default_rng(0)
    controls = (0.15 * rng.normal(size=(K, H, 3))).astype(np.float32)
    gate_seq = np.ones((K, H, 4), np.float32)
    gate_seq[0, :, 0] = np.clip(1.0 - np.arange(H) / 2.0, 0.0, 1.0)
    gate_seq[1, 1:, 2] = 0.5
    scen = {"push": (20.0 * rng.normal(size=(K, H, 3))).astype(np.float32),
            "gate_seq": gate_seq}
    thetas = {k: np.asarray(v, np.float32) for k, v in THETAS.items()}

    M = MPPI["n_samples"]
    rng = np.random.default_rng(1)
    unit = {"U": rng.normal(size=(M, H, 3)), "push": rng.normal(size=(M, H, 3)),
            "swing": rng.normal(size=(M, 4)), "t0": rng.normal(size=(M,)),
            "dxy": rng.normal(size=(M, 2))}
    unit = {k: v.astype(np.float32) for k, v in unit.items()}
    U_nom = (0.05 * rng.normal(size=(H, 3))).astype(np.float32)
    theta_nom = {"swing": np.float32([-4.0, 1.0, -4.0, -2.0]),
                 "t0": np.float32(-1.0), "dxy": np.float32([0.02, 0.05])}
    by_shape = {(M, H, 3): [unit["U"], unit["push"]]}
    for k in ("swing", "t0", "dxy"):
        by_shape[unit[k].shape] = [unit[k]]

    def normal(key, shape, dtype=None):
        return jnp.asarray(by_shape[tuple(shape)].pop(0))

    jmpc = jsampling.SamplingMPC(jp, jsampling.MPPIConfig(**MPPI),
                                 jrollout.RolloutConfig(**MCFG))
    mpc_args = (jax.random.PRNGKey(0), jst, jrefs, jwarm, jnp.asarray(U_nom),
                _f32(theta_nom))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", normal)
        with ThreadPoolExecutor(2) as pool:
            roll_c = pool.submit(lambda: roll_fn.lower(
                controls, scen, thetas).compile())
            mpc_c = pool.submit(lambda: jax.jit(jmpc._step_impl).lower(
                *mpc_args).compile())
            roll_c, mpc_c = roll_c.result(), mpc_c.result()
    assert not any(by_shape.values())   # every draw went in, in its place
    return dict(tm=tm, tp=tp, st=st, refs=refs, warm=warm, jm=jm, jp=jp,
                jrefs=jrefs, controls=controls, scen=scen, thetas=thetas,
                roll_ref=_np(roll_c(controls, scen, thetas)),
                mpc_ref=_np(mpc_c(*mpc_args)), unit=unit, U_nom=U_nom,
                theta_nom=theta_nom)


# ---- model/kinematics.py::link_velocities --------------------------------

@pytest.mark.parametrize("name, contacts", [("humanoid", SOLES),
                                            ("quadruped", FEET)])
def test_link_velocities_match_reference(name, contacts):
    jm, tm = jzoo.by_name(name), zoo.by_name(name, device="cpu")
    st = standing_state(tm, contacts, batch=3)
    rng = np.random.default_rng(2)
    st = dataclasses.replace(
        st, q=st.q + torch.tensor(0.2 * rng.normal(size=st.q.shape),
                                  dtype=torch.float32),
        qd=torch.tensor(rng.normal(size=st.qd.shape), dtype=torch.float32),
        base_vel=torch.tensor(rng.normal(size=(3, 6)), dtype=torch.float32))
    ref = jax.jit(jax.vmap(lambda s: jkin.link_velocities(
        jm, jkin.fk(jm, s), s)))(JRobotState(**{
            k: jnp.asarray(getattr(st, k).numpy())
            for k in convert.STATE_FIELDS}))
    got = kinematics.link_velocities(tm, kinematics.fk(tm, st), st)
    assert got.shape == (3, tm.nj, 6)
    _tight(got.numpy(), np.asarray(ref))


# ---- runtime/trajectory.py ---------------------------------------------------

def test_trajectory_functions_match_reference():
    rng = np.random.default_rng(3)
    p0, p1 = (rng.normal(size=(3,)).astype(np.float32) for _ in range(2))
    tp0, tp1 = torch.tensor(p0), torch.tensor(p1)
    jp0, jp1 = jnp.asarray(p0), jnp.asarray(p1)
    for t in (-0.1, 0.0, 0.07, 0.15, 0.2999, 0.3, 0.5):
        for got, ref in ((trajectory.min_jerk(tp0, tp1, t, 0.3),
                          jtraj.min_jerk(jp0, jp1, t, 0.3)),
                         (trajectory.min_jerk_pva(tp0, tp1, t, 0.3),
                          jtraj.min_jerk_pva(jp0, jp1, t, 0.3)),
                         ((trajectory.qppvm_sinusoid(tp0, t, t0=0.05),),
                          (jtraj.qppvm_sinusoid(jp0, t, t0=0.05),))):
            for g, r in zip(got, ref):
                _tight(g.numpy(), np.asarray(r))
    wps = rng.normal(size=(4, 2)).astype(np.float32)
    times = np.float32([0.0, 0.4, 0.5, 1.2])
    for t in (-0.2, 0.0, 0.2, 0.4, 0.45, 0.9, 1.2, 1.5):
        got = trajectory.waypoint_spline(torch.tensor(wps),
                                         torch.tensor(times), t)
        ref = jtraj.waypoint_spline(jnp.asarray(wps), jnp.asarray(times),
                                    jnp.float32(t))
        for g, r in zip(got, ref):
            _tight(g.numpy(), np.asarray(r))


# ---- runtime/contact_switch.py ------------------------------------------------

@pytest.mark.parametrize("name", ["humanoid", "arm7", "dual_arm",
                                  "quadruped", "biped", "centaur"])
def test_chain_joints_match_reference(name):
    jm, tm = jzoo.by_name(name), zoo.by_name(name, device="cpu")
    for link in tm.link_names:
        assert (contact_switch.chain_joints(tm, link)
                == jcs.chain_joints(jm, link)), link


SCRIPTS = {
    # the leg-lift recipe: CoM margin inside the support triangle
    "edge": dict(),
    # a stride: centroid shift, foothold offset, stance gains, CoM task
    "centroid_stride": dict(shift_mode="centroid", foothold_offset=(0.06,
                                                                    -0.02),
                            stance_kp=60.0, stance_w=2.0, lift_height=0.04,
                            swing_kp=100.0, swing_w=3.0),
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_leg_lift_script_matches_reference(quad, case):
    """refs_at at every phase boundary and one tick either side (JAX eager,
    no solve), and com_ref_at, from the same references."""
    kw = dict(SCRIPTS[case], phases=contact_switch.LegLiftPhases(
        settle=5, shift=8, dwell=3, unload=4, lift=6, hold=3, lower=5,
        reload=4))
    com = case == "centroid_stride"
    tp = ForceAccPlugin(quad["tm"], **QUAD, use_com_task=com)
    jp = JForceAcc(quad["jm"], **QUAD, use_com_task=com)
    st, refs = quad["st"], quad["refs"]
    waist = refs["waist_task"]["p"] + 0.01
    script = contact_switch.LegLiftScript(quad["tm"], tp, refs, waist,
                                          "foot_hl", state=st, **kw)
    jscript = jcs.LegLiftScript(
        quad["jm"], jp, quad["jrefs"], waist[0].numpy(), "foot_hl",
        state=_jstate(st), **dict(kw, phases=jcs.LegLiftPhases(
            **dataclasses.asdict(kw["phases"]))))
    bounds = [0, script.t_shift0, script.t_dwell0, script.t_unload0,
              script.t_lift0, script.t_hold0, script.t_lower0,
              script.t_reload0, script.total]
    assert bounds[1:] == [jscript.t_shift0, jscript.t_dwell0,
                          jscript.t_unload0, jscript.t_lift0,
                          jscript.t_hold0, jscript.t_lower0,
                          jscript.t_reload0, jscript.total]
    for i in sorted({max(b + d, 0) for b in bounds for d in (-1, 0, 1)}):
        _compare_tree(script.refs_at(i), _np(jscript.refs_at(i)))
        for g, r in zip(script.com_ref_at(i), jscript.com_ref_at(i)):
            _tight(g[0].numpy(), np.asarray(r))
    # the swing foot really moves the references it should
    lifted = script.refs_at(script.t_hold0)
    assert float(lifted["contacts"]["active"][0, 3]) == 0.0
    assert float(lifted["foot_hl_cartesian"]["p"][0, 2]) > float(
        refs["foot_hl_cartesian"]["p"][0, 2]) + 0.03


# ---- mpc/rollout.py: the swing primitive ---------------------------------------

def _varied_refs(refs, n, seed):
    """``refs`` of batch 1 repeated for ``n`` items whose feet gains,
    weights, positions, postural weights and contact gates all differ."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(lambda a: np.repeat(a, n, axis=0).astype(np.float32),
                       {k: _item(v, slice(0, 1)) for k, v in refs.items()})
    for c in FEET:
        tr = out[c + "_cartesian"]
        tr["kp"] = (tr["kp"] * (1.0 + rng.uniform(0.0, 1.0, n))).astype(
            np.float32)
        tr["kd"] = (2.0 * np.sqrt(tr["kp"])).astype(np.float32)
        tr["w"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        tr["p"] = (tr["p"] + 0.01 * rng.normal(size=tr["p"].shape)).astype(
            np.float32)
        tr["v"] = (0.1 * rng.normal(size=tr["v"].shape)).astype(np.float32)
    out["POSTURAL"]["w"] = rng.uniform(
        0.5, 1.5, out["POSTURAL"]["w"].shape).astype(np.float32)
    out["contacts"]["active"] = np.float32([[1.0, 1.0, 1.0, 1.0],
                                            [1.0, 0.5, 1.0, 1.0],
                                            [0.8, 1.0, 1.0, 0.0]])[:n]
    return out


@pytest.mark.parametrize("span_s", [None, 0.48])
def test_swing_primitive_matches_reference(quad, span_s):
    """apply over a t_frac grid, three decisions in one batch, each item
    with its own references, against the reference item by item."""
    apply, init_theta = rollout.make_swing_primitive(quad["tp"],
                                                     span_s=span_s)
    japply, jinit = jrollout.make_swing_primitive(quad["jp"], span_s=span_s)
    japply_jit = jax.jit(japply)
    for k, v in init_theta().items():
        _tight(v.numpy(), np.asarray(jinit()[k]))
    refs = _varied_refs(quad["refs"], 3, seed=4)
    trefs = convert.refs(refs, device="cpu")
    theta = {"swing": np.float32([[-8.0, 3.0, -8.0, -8.0],
                                  [1.0, -1.0, 4.0, -4.0],
                                  [-4.0, -4.0, -4.0, -4.0]]),
             "t0": np.float32([-2.0, 0.3, 1.5]),
             "dxy": np.float32([[0.0, 0.1], [0.3, -0.4], [-0.05, 0.02]])}
    ttheta = {k: torch.tensor(v) for k, v in theta.items()}
    for t_frac in np.float32([0.0, 0.05, 0.12, 0.2, 0.35, 0.5, 0.61, 0.8,
                              0.93, 1.0]):
        got = apply(trefs, ttheta, torch.tensor(t_frac))
        for i in range(3):
            ref = japply_jit(_f32(jax.tree.map(lambda a: a[i], refs)),
                         _f32(jax.tree.map(lambda a: a[i], theta)),
                         jnp.float32(t_frac))
            _compare_tree(got, _np(ref), i)


# ---- mpc/rollout.py: the capture terminal cost ---------------------------------

def test_capture_terminal_cost_matches_reference():
    """The humanoid shoved sideways (as tests/test_capture_step.py shoves
    it) with one foot raised, the other, both and neither."""
    jm, tm = jzoo.humanoid(), zoo.humanoid(device="cpu")
    tp = ForceAccPlugin(tm, contact_links=SOLES, waist_link="pelvis")
    jp = JForceAcc(jm, contact_links=SOLES, waist_link="pelvis")
    st = standing_state(tm, SOLES, batch=4)
    rng = np.random.default_rng(5)
    q = st.q.numpy() + 0.02 * rng.normal(size=st.q.shape)
    q[[0, 2], 2] -= 0.5   # left hip flexed, knee bent: l_sole raised
    q[[0, 2], 3] += 1.0
    q[1, 8] -= 0.5        # the right foot
    q[1, 9] += 1.0
    base_vel = 0.2 * rng.normal(size=(4, 6))
    base_vel[:, 4] += 1.2
    base_pos = st.base_pos.numpy().copy()
    base_pos[2, 2] += 0.02    # item 2: both feet off the ground
    st = dataclasses.replace(
        st, q=torch.tensor(q, dtype=torch.float32),
        qd=torch.tensor(0.5 * rng.normal(size=st.qd.shape),
                        dtype=torch.float32),
        base_vel=torch.tensor(base_vel, dtype=torch.float32),
        base_pos=torch.tensor(base_pos, dtype=torch.float32))
    z = kinematics.fk(tm, st).p[:, [tm.link_index(c) for c in SOLES], 2]
    assert bool((z[0, 0] > 0.03) & (z[1, 1] > 0.03) & (z[3] < 0.01).all())
    term = rollout.make_capture_terminal_cost(tp)
    jterm = jrollout.make_capture_terminal_cost(jp)
    ref = jax.jit(jax.vmap(lambda s: jterm(jm, s)))(JRobotState(**{
        k: jnp.asarray(getattr(st, k).numpy())
        for k in convert.STATE_FIELDS}))
    got = term(tm, st)
    assert got.shape == (4,)
    _tight(got.numpy(), np.asarray(ref))


# ---- mpc/rollout.py: the rollout with every new option --------------------------

def test_rollout_with_gates_swing_and_terminal_cost_matches_reference(quad):
    """K 2, H 3: switchable cones with the height gate, a gate_seq that
    ramps foot_fl off in sample 0, two different swing decisions, the
    capture terminal cost; every level in the level kernel's profile."""
    tcfg = rollout.RolloutConfig(**RCFG)
    swing, _ = rollout.make_swing_primitive(quad["tp"], span_s=H * tcfg.dt)
    roll = rollout.make_rollout_fn(
        quad["tp"], tcfg, rollout.default_cost, swing=swing,
        terminal_cost=rollout.make_capture_terminal_cost(quad["tp"]))
    st, refs, warm = sampling.expand_batch(quad["st"], quad["refs"],
                                           quad["warm"], K)
    telemetry.reset("cascade.fallback")
    cost, health = roll(st, refs, warm, torch.tensor(quad["controls"]),
                        {k: torch.tensor(v) for k, v in quad["scen"].items()},
                        {k: torch.tensor(v) for k, v in
                         quad["thetas"].items()})
    assert telemetry.counts()["cascade.fallback"] == 0
    cost_ref, health_ref = quad["roll_ref"]
    assert cost.shape == (K,)
    _close(cost.numpy(), cost_ref)
    _close(health["prim_res_max"].numpy(), health_ref["prim_res_max"],
           rtol=2e-2, floor=1e-5)
    np.testing.assert_array_equal(health["solver_failed"].numpy(),
                                  health_ref["solver_failed"])
    # the routing rule: the rollout's levels are in the level kernel's
    # profile, and leave it with the options that leave it
    off = rollout.make_rollout_fn(quad["tp"], rollout.RolloutConfig(
        **RCFG, qp_rho_updates=1), rollout.default_cost)
    for r, takes in ((roll, True), (off, False)):
        cfg = level_qp.config_from_opts(r.solver_opts, n_eq_head=0,
                                        n_eq_tail=0, iters=12)
        assert (cfg is not None) is takes


# ---- mpc/sampling.py: the step-recovery channel -----------------------------------

def test_mppi_step_recovery_update_matches_reference(quad):
    """SamplingMPC.update with theta on the samples the reference's plan
    step was fed (its normal draws replaced by the same numpy ones)."""
    m = sampling.MPPIConfig(**MPPI)
    tmpc = sampling.SamplingMPC(quad["tp"], m, rollout.RolloutConfig(
        **MCFG))
    unit, t = quad["unit"], lambda a: torch.tensor(a)  # noqa: E731
    U = t(quad["U_nom"])[None] + m.noise_std * t(unit["U"])
    theta = {k: t(v)[None] + (m.dxy_noise_std if k == "dxy"
                              else m.theta_noise_std) * t(unit[k])
             for k, v in quad["theta_nom"].items()}
    (U_new, theta_new), info = tmpc.update(
        quad["st"], quad["refs"], quad["warm"], U,
        {"push": m.push_std * t(unit["push"])}, theta)
    (U_ref, theta_ref), info_ref = quad["mpc_ref"]
    _close(U_new.numpy(), U_ref, floor=1e-4)
    for k in ("swing", "t0", "dxy"):
        _close(theta_new[k].numpy(), theta_ref[k])
        _close(info["theta_best"][k].numpy(), info_ref["theta_best"][k])
    for k in ("cost_min", "cost_mean", "ess"):
        _close(info[k].numpy(), info_ref[k])
    _close(info["U_best"].numpy(), info_ref["U_best"], floor=1e-4)
    assert int(torch.argmin(info["costs"])) != 0   # theta_best is indexed
    assert float(info["solver_fail_frac"]) == float(
        info_ref["solver_fail_frac"])
    _close(info["prim_res_max"].numpy(), info_ref["prim_res_max"],
           rtol=2e-2, floor=1e-5)
    # the sampler draws thetas beside the plan, from the nominal one
    g = torch.Generator().manual_seed(0)
    U_s, scen, th = tmpc.sample(g, t(quad["U_nom"]), {
        k: t(v) for k, v in quad["theta_nom"].items()})
    assert U_s.shape == (3, H, 3) and scen["push"].shape == (3, H, 3)
    assert {k: tuple(v.shape) for k, v in th.items()} == {
        "swing": (3, 4), "t0": (3,), "dxy": (3, 2)}
