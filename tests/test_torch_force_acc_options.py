"""Parity of the port's ForceAcc options with qppvm_tpu: the constraint
layer (gates, FrictionCone, CoPBox, JointAccLimits), SubTask / Indices,
``Cartesian(indices=...)``, ForceReg's gated and static shares, the
stacks of the plugin's option sets on the quadruped, the centaur and the
biped, the lifecycle hooks, and a chained run of the centaur with friction
cones.

Inputs are numpy-seeded and fed to both sides in float32 (the suite
enables x64, so the JAX side is pinned). Single tasks and constraints run
the JAX side eagerly, item by item; each stack or tick runs one jitted,
vmapped JAX program. The JAX plugins run their default xla level solver
and the port's levels the level kernel's plain version (on CPU tensors),
in bench.py's real-time solver profile.

Tolerances are those of tests/test_torch_force_acc.py: rows, bounds and
references to rtol 1e-4 with an absolute floor of 1e-4 of each array's
scale (bounds standing for "unbounded", |b| >= 1e19, must match in place
and sign, and the scale is taken over the others); solver states to the
level-kernel bars of tests/test_pallas_qp.py; torques, wrenches and
accelerations to 1e-3 of their scale.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu.model import dynamics as jdyn
from qppvm_tpu.model import zoo as jzoo
from qppvm_tpu.mpc import rollout as jrollout
from qppvm_tpu.model.robot import RobotState as JRobotState
from qppvm_tpu.opt.variables import Optvar as JOptvar
from qppvm_tpu.plugins.force_acc import ForceAccPlugin as JForceAcc
from qppvm_tpu.stack.autostack import AutoStack as JAutoStack
from qppvm_tpu.tasks import acceleration as jacc
from qppvm_tpu.tasks import base as jbase
from qppvm_tpu.tasks import force as jforce
from qppvm_tpu.tasks import generic as jgen
from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import convert, dynamics, zoo
from qppvm_tpu_torch.mpc.rollout import standing_state
from qppvm_tpu_torch.opt.variables import Optvar
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
from qppvm_tpu_torch.tasks import acceleration, base, force, generic

torch.set_num_threads(1)
B = 2
FEET = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")
SOLES = ("l_sole", "r_sole")
PROFILE = dict(rho_updates=0, warm_kinv_iters=4, cold_ns_iters=10,
               scale_iters=2, pinv_ns_iters=5)
CENTAUR_CONES = dict(use_friction_cones=True, mu=0.7)
# the quadruped's option set (robot, contacts, options)
QUAD_SWITCH = ("quadruped", FEET, dict(use_friction_cones=True,
                                       foot_tasks_6d=False,
                                       switchable_contacts=True))
# the biped's full-wrench option sets
BIPED_6D = [dict(wrench_dim=6, use_friction_cones=True,
                 cop_box=(-0.05, 0.1, 0.05, 0.01), force_share_mode="static"),
            dict(wrench_dim=6, use_friction_cones=True, mu=0.6,
                 moment_box=(25.0, 20.0, 8.0)),
            dict(wrench_dim=6, moment_box=(20.0, 20.0, 5.0),
                 waist_priority="soft", waist_weight=3.0, use_com_task=True,
                 com_task_weight=0.5)]
# contact gates of the two batch items: on, off and half-way
GATES = np.array([[1.0, 0.0, 0.5, 1.0], [0.5, 1.0, 1.0, 0.0]])
BIG = 1e19


def _close(actual, desired, rtol=1e-4, floor=1e-4):
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    assert actual.shape == desired.shape, (actual.shape, desired.shape)
    huge = np.abs(desired) >= BIG
    np.testing.assert_array_equal(np.sign(actual[huge]), np.sign(desired[huge]))
    assert np.all(np.abs(actual[huge]) >= BIG)
    rest = np.where(huge, 0.0, desired)
    scale = float(np.max(np.abs(rest), initial=0.0)) + 1.0
    np.testing.assert_allclose(np.where(huge, 0.0, actual), rest, rtol=rtol,
                               atol=floor * scale)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _item(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _f32(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _batched(tree):
    return jax.tree.map(lambda a: np.broadcast_to(a, (B,) + np.shape(a)), tree)


def _port_states(st, seed):
    """The standing state (arrays by field, unbatched) for B items: q
    perturbed by 0.01 N(0, 1), small joint and base velocities."""
    rng = np.random.default_rng(seed)
    arrs = {k: np.broadcast_to(np.asarray(st[k]),
                               (B,) + np.shape(st[k])).copy()
            for k in convert.STATE_FIELDS}
    arrs["q"] = arrs["q"] + 0.01 * rng.normal(size=arrs["q"].shape)
    arrs["qd"] = 0.1 * rng.normal(size=arrs["qd"].shape)
    arrs["base_vel"] = 0.05 * rng.normal(size=(B, 6))
    return arrs


def _jstate(arrs):
    return JRobotState(**{k: jnp.asarray(v, jnp.float32)
                          for k, v in arrs.items()})


def _validate_off(mp):
    # validate() reads the stack on the host, which jit cannot; the port
    # runs the same check in its own on_start
    mp.setattr(JAutoStack, "validate", staticmethod(lambda *a, **k: None))


def _compare_stacks(sd, ref):
    assert (sd.n_eq, sd.has_box) == (ref.n_eq, ref.has_box)
    assert len(sd.levels) == len(ref.levels)
    for lv, rlv in zip(sd.levels, ref.levels):
        _close(lv.A, rlv.A)
        _close(lv.b, rlv.b)
    for k in ("C", "lC", "uC", "lb", "ub"):
        _close(getattr(sd, k), getattr(ref, k))


@pytest.fixture(scope="module")
def centaur():
    """The centaur with friction cones: the JAX on_start (one program),
    then two chained batched ticks from its warm state (one program, which
    also returns each tick's stack, the stack of the same plugin with joint
    acceleration limits, and the model data). The two programs compile
    side by side, on two threads."""
    jm = jzoo.centaur()
    jp = JForceAcc(jm, iters=12, solver_opts=dict(PROFILE),
                   **CENTAUR_CONES)
    jp_jl = JForceAcc(jm, iters=12, solver_opts=dict(PROFILE),
                      use_joint_limits=True, **CENTAUR_CONES)
    st = jax.jit(lambda: jrollout.standing_state(jm, FEET))()
    arrs = _port_states({k: np.asarray(getattr(st, k))
                         for k in convert.STATE_FIELDS}, seed=0)

    def tick(s, r, w):
        data = jdyn.compute_model_data(jm, s)
        build = lambda p: p.stack.build(jm, data, s, r, nx=p.opt.size,  # noqa
                                        dtype=jnp.float32)
        return jp._step_impl(s, r, w), build(jp), build(jp_jl), data

    def batched(tree):
        return jax.tree.map(lambda a: jax.ShapeDtypeStruct(
            (B,) + a.shape, a.dtype), tree)

    with pytest.MonkeyPatch.context() as mp:
        _validate_off(mp)
        refs_s, warm_s, _ = jax.eval_shape(jp.on_start, st)
        with ThreadPoolExecutor(2) as pool:
            start = pool.submit(lambda: jax.jit(jp.on_start).lower(
                st).compile())
            step = pool.submit(lambda: jax.jit(jax.vmap(tick)).lower(
                jax.eval_shape(lambda: _jstate(arrs)),
                batched(refs_s), batched(warm_s)).compile())
            start, step = start.result(), step.result()
    refs, warm, waist = start(st)
    refs_b, warm_b = _batched(_np(refs)), _batched(_np(warm))
    ticks, w = [], warm_b
    for _ in range(2):
        (tau, w, aux), stack, stack_jl, data = step(_jstate(arrs), refs_b, w)
        ticks.append(_np((tau, w, aux)))
    return dict(jm=jm, jp=jp, state=_np(st), refs=_np(refs),
                waist=np.asarray(waist), warm=_np(warm), arrs=arrs,
                refs_b=refs_b, warm_b=warm_b, ticks=ticks,
                stack=_np(stack), stack_jl=_np(stack_jl), data=data)


@pytest.fixture(scope="module")
def port_centaur(centaur):
    tm = zoo.centaur(device="cpu")
    plugin = ForceAccPlugin(tm, iters=12,
                            solver_opts=dict(PROFILE),
                            **CENTAUR_CONES)
    ts = convert.robot_state(centaur["arrs"], device="cpu")
    return dict(tm=tm, plugin=plugin, ts=ts,
                data=dynamics.compute_model_data(tm, ts))


def _ctx_pair(centaur, port_centaur, jrefs, nx):
    """JAX contexts per item and the port's batched context, same refs."""
    jctx = [jbase.AssembleCtx(
        model=centaur["jm"], data=_item(centaur["data"], i),
        state=_item(_jstate(centaur["arrs"]), i), refs=_item(jrefs, i),
        nx=nx, dtype=jnp.float32) for i in range(B)]
    tctx = base.AssembleCtx(model=port_centaur["tm"],
                            data=port_centaur["data"],
                            state=port_centaur["ts"],
                            refs=convert.refs(_np(jrefs), device="cpu"),
                            nx=nx)
    return jctx, tctx


def _wrench_vars(dim):
    """The centaur's decision variable with ``dim``-vector wrenches, in
    both packages."""
    spec = [("qddot", 37)] + [(c, dim) for c in FEET]
    return JOptvar(spec, dtype=jnp.float32), Optvar(spec, device="cpu")


def _compare_rows(jcon, tcon, jctx, tctx):
    kind, C, lo, hi = tcon.assemble(tctx)
    rows = [jcon.assemble(c) for c in jctx]
    assert kind == rows[0][0] == "rows"
    for got, k in ((C, 1), (lo, 2), (hi, 3)):
        _close(got, np.stack([np.broadcast_to(np.asarray(r[k]),
                                              got.shape[1:]) for r in rows]))


def _gate_refs(g):
    """Gate ``g`` on contact 1 of item 0; item 1 keeps every contact on."""
    active = np.ones((B, len(FEET)))
    active[0, 1] = g
    return {"contacts": {"active": jnp.asarray(active, jnp.float32)}}


@pytest.mark.parametrize("g", [1.0, 0.0, 0.5])
def test_gated_constraints_match_reference(centaur, port_centaur, g):
    """GenericConstraint (the wrench box), FrictionCone and CoPBox on
    contact 1, gated by ``g``."""
    jv, tv = _wrench_vars(6)
    jctx, tctx = _ctx_pair(centaur, port_centaur, _gate_refs(g), jv.size)
    jw, tw = jv["foot_fr"], tv["foot_fr"]
    gate = ("contacts", 1)
    ub, lb = [1000.0, 1000.0, 1000.0, 30, 30, 10], [-1000.0, -1000.0, 10.0,
                                                    -30, -30, -10]
    pairs = [
        (jgen.GenericConstraint("box", jw, jnp.asarray(ub), jnp.asarray(lb),
                                gate=gate),
         generic.GenericConstraint("box", tw, ub, lb, gate=gate)),
        (jgen.FrictionCone("cone", jw.rows([0, 1, 2]), mu=0.6, f_min=10.0,
                           gate=gate),
         generic.FrictionCone("cone", tw.rows([0, 1, 2]), mu=0.6, f_min=10.0,
                              gate=gate)),
        (jgen.CoPBox("cop", jw, x_min=-0.05, x_max=0.1, y_half=0.04,
                     t_coef=0.02, gate=gate),
         generic.CoPBox("cop", tw, x_min=-0.05, x_max=0.1, y_half=0.04,
                        t_coef=0.02, gate=gate))]
    for jcon, tcon in pairs:
        _compare_rows(jcon, tcon, jctx, tctx)
    _, _, lo, hi = pairs[1][1].assemble(tctx)
    if g == 0.0:   # a switched-off contact carries no force: f = 0
        assert torch.equal(lo[0], hi[0])
    with pytest.raises(ValueError, match="6D"):
        generic.CoPBox("cop", tw.rows([0, 1, 2]))


@pytest.mark.parametrize("margin", [0.0, 3.0])
def test_joint_acc_limits_match_reference(centaur, port_centaur, margin):
    """Margin 3 rad empties every range (limits +/-2.9): lb <= ub still."""
    jctx, tctx = _ctx_pair(centaur, port_centaur, {}, centaur["jp"].opt.size)
    jcon = jgen.JointAccLimits("jl", centaur["jp"].qddot, margin=margin)
    tcon = generic.JointAccLimits("jl", port_centaur["plugin"].qddot,
                                  margin=margin)
    _compare_rows(jcon, tcon, jctx, tctx)
    _, _, lo, hi = tcon.assemble(tctx)
    assert bool((lo <= hi).all())


def _compare_task(jtask, ttask, jctx, tctx):
    A, b = ttask.assemble(tctx)
    rows = [jtask.assemble(c) for c in jctx]
    _close(A, np.stack([np.asarray(r[0]) for r in rows]))
    _close(b, np.stack([np.asarray(r[1]) for r in rows]))
    return A, b


def _moving_refs(centaur, names):
    """The on_start references of ``names`` with random velocity and
    acceleration feed-forwards."""
    rng = np.random.default_rng(3)
    refs = {}
    for n in names:
        r = dict(centaur["refs_b"][n])
        r["v"] = rng.normal(size=(B, 6))
        r["a"] = rng.normal(size=(B, 6))
        refs[n] = r
    return _f32(refs)


def test_cartesian_indices_and_subtask_match_reference(centaur,
                                                       port_centaur):
    refs = _moving_refs(centaur, ("foot_fl_cartesian", "waist_task"))
    jp, tp = centaur["jp"], port_centaur["plugin"]
    jctx, tctx = _ctx_pair(centaur, port_centaur, refs, jp.opt.size)
    pos = [(jacc.Cartesian("foot_fl_cartesian", "foot_fl", jp.qddot,
                           kp=25.0, indices=(0, 1, 2))),
           acceleration.Cartesian("foot_fl_cartesian", "foot_fl", tp.qddot,
                                  kp=25.0, indices=(0, 1, 2))]
    A, _ = _compare_task(*pos, jctx, tctx)
    assert A.shape[1] == 3
    full = acceleration.Cartesian("foot_fl_cartesian", "foot_fl", tp.qddot,
                                  kp=25.0)
    assert torch.equal(A, full.assemble(tctx)[0][:, :3])
    sub = (jbase.SubTask(jp.waist_task, jbase.Indices.range(3, 5)),
           base.SubTask(tp.waist_task, base.Indices.range(3, 5)))
    assert sub[1].name == sub[0].name == "waist_task[[3, 4, 5]]"
    A, _ = _compare_task(*sub, jctx, tctx)
    assert torch.equal(A, tp.waist_task.assemble(tctx)[0][:, 3:6])
    assert base.Indices.range(0, 2) == [0, 1, 2]


@pytest.mark.parametrize("share_mode", ["gate", "static"])
def test_force_reg_shares_match_reference(centaur, port_centaur, share_mode):
    """ForceReg on 3D wrenches with the contact gates of GATES (on, off and
    half-way), a random offset ``f`` and weight ``w``; the quasi-static
    share at the measured CoM, or the equal share per unit gate."""
    rng = np.random.default_rng(4)
    refs = _f32({"FR": {"f": rng.normal(size=(B, 12)),
                        "w": rng.uniform(0.5, 2.0, size=B)},
                 "contacts": {"active": GATES}})
    jp, tp = centaur["jp"], port_centaur["plugin"]
    jctx, tctx = _ctx_pair(centaur, port_centaur, refs, jp.opt.size)
    kw = dict(w_tan=0.1, w_norm=0.05, gates_key="contacts",
              share_mode=share_mode, contact_links=list(FEET))
    _, b = _compare_task(jforce.ForceReg("FR", jp.wrenches, **kw),
                         force.ForceReg("FR", tp.wrenches, **kw), jctx, tctx)
    # the normal rows' targets: the shares (plus the offset), which carry
    # the robot's weight and none on a switched-off contact
    share = b[:, 2::3] / (0.05 * tctx.refs["FR"]["w"][:, None]) \
        - tctx.refs["FR"]["f"][:, 2::3]
    weight = port_centaur["data"].total_mass * 9.81
    torch.testing.assert_close(share.sum(-1), weight, rtol=1e-5, atol=1e-3)
    assert bool((share[GATES == 0.0].abs() < 1e-3).all())
    with pytest.raises(ValueError, match="contact_links"):
        force.ForceReg("FR", tp.wrenches, share_mode="static")


def test_centaur_on_start_matches_reference(centaur, port_centaur):
    """References, initial waist and the seeded warm state of the centaur
    with friction cones."""
    plugin = port_centaur["plugin"]
    st = standing_state(plugin.model, FEET)
    for k in ("q", "base_rot", "base_pos"):
        _close(getattr(st, k)[0], getattr(centaur["state"], k))
    telemetry.reset("cascade.fallback")
    refs, warm, waist = plugin.on_start(st)
    # cold polished solves: counted
    assert telemetry.counts()["cascade.fallback"] == 4
    leaves = jax.tree_util.tree_leaves_with_path(centaur["refs"])
    assert len(leaves) == sum(len(r) for r in refs.values())
    for path, leaf in leaves:
        ours = refs
        for p in path:
            ours = ours[p.key]
        _close(ours[0], leaf)
    _close(waist[0], centaur["waist"])
    for ours, ref in zip(warm, centaur["warm"]):
        sc = float(np.max(np.abs(ref.x))) + 1.0
        np.testing.assert_allclose(ours.x[0], ref.x, atol=2e-4 * sc,
                                   rtol=2e-4)


def test_centaur_two_chained_ticks_match_reference(centaur, port_centaur):
    """tau over two chained batched ticks from the reference's own on_start
    state, the centaur's stacks at the first tick (friction cones, and with
    joint acceleration limits), and every wrench inside its cone."""
    plugin = port_centaur["plugin"]
    ts = port_centaur["ts"]
    refs = convert.refs(centaur["refs_b"], device="cpu")
    sd = plugin.stack.build(plugin.model, port_centaur["data"], ts, refs,
                            nx=plugin.opt.size)
    assert [tuple(lv.A.shape) for lv in sd.levels] == [(B, 6, 49),
                                                      (B, 67, 49)]
    assert tuple(sd.C.shape) == (B, 26, 49)
    _compare_stacks(sd, centaur["stack"])
    tp_jl = ForceAccPlugin(plugin.model, iters=12, use_joint_limits=True,
                           **CENTAUR_CONES)
    sd_jl = tp_jl.stack.build(plugin.model, port_centaur["data"], ts, refs,
                              nx=plugin.opt.size)
    assert tuple(sd_jl.C.shape) == (B, 57, 49)
    _compare_stacks(sd_jl, centaur["stack_jl"])
    warm = convert.qp_states([{k: getattr(lv, k)
                               for k in convert.QPSTATE_FIELDS}
                              for lv in centaur["warm_b"]], device="cpu")
    mu = 0.7 / np.sqrt(2.0)
    for tau_ref, warm_ref, aux_ref in centaur["ticks"]:
        tau, warm, aux = plugin._step_impl(ts, refs, warm)
        assert not aux.solver_failed.any()
        np.testing.assert_array_equal(aux.solver_failed.numpy(),
                                      aux_ref.solver_failed)
        _close(tau, tau_ref, rtol=1e-3, floor=1e-3)
        _close(aux.wrenches, aux_ref.wrenches, rtol=1e-3, floor=1e-3)
        _close(aux.qddot, aux_ref.qddot, rtol=1e-3, floor=1e-3)
        for ours, ref in zip(warm, warm_ref):
            sc = float(np.max(np.abs(ref.x))) + 1.0
            np.testing.assert_allclose(ours.x, ref.x, atol=2e-4 * sc,
                                       rtol=2e-4)
        np.testing.assert_allclose(aux.prim_res, aux_ref.prim_res, atol=1e-5,
                                   rtol=2e-2)
        f = aux.wrenches
        assert bool((f[..., :2].abs() <= mu * f[..., 2:] + 1e-3).all())
        assert bool((f[..., 2] >= 10.0 - 1e-3).all())


def _option_cases(robot, contacts, option_sets, seed, solver, gates=None):
    """For each of ``option_sets``: the port's plugin with those options and
    the ``solver`` keywords, its on_start from B perturbed standing states
    and two batched ticks there; the JAX plugin's stack on the same states
    and references, held against the port's. One JAX program builds every
    stack and each contact's world Jacobian, which the last tick's contact
    torque must sum. Returns (stack, last tick's aux) per option set."""
    tm, jm = zoo.by_name(robot, device="cpu"), jzoo.by_name(robot)
    st = standing_state(tm, contacts)
    arrs = _port_states({k: getattr(st, k)[0].numpy()
                         for k in convert.STATE_FIELDS}, seed)
    ts = convert.robot_state(arrs, device="cpu")
    plugins, jplugins, runs = [], [], []
    for options in option_sets:
        plugin = ForceAccPlugin(tm, contact_links=contacts, **solver,
                                **options)
        refs, warm, _ = plugin.on_start(ts)
        if gates is not None:
            refs["contacts"]["active"] = torch.tensor(gates,
                                                      dtype=torch.float32)
        plugins.append(plugin)
        jplugins.append(JForceAcc(jm, contact_links=contacts, iters=12,
                                  **options))
        runs.append((refs, warm))

    def build(s, rs):
        data = jdyn.compute_model_data(jm, s)
        return ([jp.stack.build(jm, data, s, r, nx=jp.opt.size,
                                dtype=jnp.float32)
                 for jp, r in zip(jplugins, rs)],
                jnp.stack([jdyn.frame_data(jm, data, c)[2]
                           for c in contacts]))

    jrefs = [jax.tree.map(lambda t: jnp.asarray(t.numpy()), r)
             for r, _ in runs]
    ref_stacks, J = _np(jax.jit(jax.vmap(build))(_jstate(arrs), jrefs))
    data = dynamics.compute_model_data(tm, ts)
    out = []
    for plugin, (refs, warm), ref_stack in zip(plugins, runs, ref_stacks):
        sd = plugin.stack.build(tm, data, ts, refs, nx=plugin.opt.size)
        _compare_stacks(sd, ref_stack)
        for _ in range(2):
            _, warm, aux = plugin._step_impl(ts, refs, warm)
        assert not aux.solver_failed.any()
        # the contact torque sums J^T f over every wrench row
        dim = plugin.wrench_dim
        tau_c = np.einsum("bckv,bck->bv", J[:, :, :dim],
                          aux.wrenches.numpy())
        _close(aux.tau_c, tau_c[:, 6:], rtol=1e-3, floor=1e-3)
        out.append((sd, aux))
    return out


def test_quadruped_switchable_cones_position_feet_match_reference():
    """Friction cones, position-only feet tasks, switchable contacts with
    the gates of GATES: the stack (C: 6 + 4 x 5 rows; level QPs m 26 and
    32 with the locks) and the ticks, where a switched-off foot carries no
    force."""
    robot, contacts, options = QUAD_SWITCH
    [(sd, aux)] = _option_cases(robot, contacts, [options], seed=1,
                                gates=GATES, solver=dict(
                                    iters=12, solver_opts=dict(PROFILE)))
    assert [tuple(lv.A.shape) for lv in sd.levels] == [(B, 6, 34),
                                                      (B, 40, 34)]
    assert tuple(sd.C.shape) == (B, 26, 34)
    assert float(aux.wrenches[GATES == 0.0].abs().max()) < 0.05


def test_biped_full_wrench_option_sets_match_reference():
    """6D wrenches on the biped, in the plugin's default solver profile
    (the real-time one fails on the cone and CoP stack now and then, in
    both packages): friction cones with the CoP box and the quasi-static
    share (C: 6 + 2 x (5 + 6) rows; level QPs m 28 and 34); cones with the
    static moment box; and the wrench box with its moment rows, the waist
    in one level at a weight and the CoM task in the stack (one level).
    The contact torque sums all six wrench rows."""
    cases = _option_cases("biped", SOLES, BIPED_6D, seed=2,
                          solver=dict(iters=100))
    (cop, aux), (moment, _), (soft, _) = cases
    assert tuple(cop.C.shape) == (B, 28, 30)
    assert tuple(moment.C.shape) == (B, 22, 30)
    assert tuple(aux.wrenches.shape) == (B, 2, 6)
    assert len(soft.levels) == 1 and tuple(soft.C.shape) == (B, 18, 30)


def test_on_start_seeds_contact_gates_and_lifecycle_hooks(centaur):
    """on_start's (B, nc) gates; drive_pd_profile, squat_refs, close and
    control_loop against the reference's; the SubTask splits are built and
    kept out of the stack."""
    tm = zoo.quadruped(device="cpu")
    plugin = ForceAccPlugin(tm, iters=12, switchable_contacts=True,
                            solver_opts=dict(PROFILE))
    st = standing_state(tm, FEET, batch=B)
    refs, warm, waist = plugin.on_start(st)
    assert torch.equal(refs["contacts"]["active"], torch.ones(B, 4))
    jp = centaur["jp"]
    k0, d0 = np.full(tm.nj, 800.0), np.full(tm.nj, 20.0)
    for ours, ref in zip(plugin.drive_pd_profile(k0, d0),
                         jp.drive_pd_profile(k0, d0)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    jsq = jp.squat_refs(centaur["refs"], centaur["waist"], depth=0.05)
    sq = plugin.squat_refs(refs, waist, depth=0.05)
    _close(sq["waist_task"]["p"][0] - waist[0],
           np.asarray(jsq["waist_task"]["p"]) - centaur["waist"])
    assert sq["POSTURAL"] is refs["POSTURAL"]
    assert torch.equal(refs["waist_task"]["p"], waist)    # not changed
    tau, _, _ = plugin.control_loop(st, sq, warm)
    tau2, _, _ = plugin._step_impl(st, sq, warm)
    assert torch.equal(tau, tau2)
    assert plugin.close() is None
    assert len(plugin.feet_pos) == 4
    names = {t.name for lv in plugin.stack.levels for t in lv}
    for t in plugin.feet_pos + [plugin.waist_pos, plugin.waist_or]:
        assert t.name not in names
