"""Parity of the PyTorch port's batched ForceAcc humanoid tick with
qppvm_tpu: the slice as a whole.

Both sides build ForceAccPlugin on the humanoid with bench.py's real-time
solver profile. The JAX side runs its default xla level solver: the
Pallas kernel in interpret mode at n = 44 would cost minutes to compile
here, and its parity with the xla path is pinned by
tests/test_pallas_qp.py. The port's levels, in the level kernel's profile,
run the level kernel's plain version on CPU tensors. JAX programs are jitted (one compilation each) and pinned to
float32; tick inputs are numpy-seeded.

Tolerances (float32 on both sides, sums in another order): stack data and
references to rtol 1e-4 with an absolute floor of 1e-4 of each array's
scale; solver outputs to the level-kernel bars of tests/test_pallas_qp.py;
torques to 1e-3 of their scale (about 0.04 Nm on a 40 Nm knee torque), a
hundredth of what a wrong task row or contact Jacobian would move them.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qppvm_tpu.model import dynamics as jdyn
from qppvm_tpu.model import zoo as jzoo
from qppvm_tpu.mpc import rollout as jrollout
from qppvm_tpu.opt import qp as jqp
from qppvm_tpu.plugins.force_acc import ForceAccPlugin as JForceAcc
from qppvm_tpu.stack.autostack import AutoStack as JAutoStack
from qppvm_tpu.tasks.base import AssembleCtx as JAssembleCtx
from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import convert, dynamics, kinematics, spatial, zoo
from qppvm_tpu_torch.mpc.rollout import standing_state
from qppvm_tpu_torch.opt import qp
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
from qppvm_tpu_torch.tasks.base import AssembleCtx

torch.set_num_threads(1)
CONTACTS = ("l_sole", "r_sole")
PROFILE = dict(rho_updates=0, warm_kinv_iters=4, cold_ns_iters=10,
               scale_iters=2, pinv_ns_iters=5)
B = 2


def _close(actual, desired, rtol=1e-4, floor=1e-4):
    desired = np.asarray(desired, np.float64)
    scale = float(np.max(np.abs(desired))) + 1.0
    np.testing.assert_allclose(np.asarray(actual, np.float64), desired,
                               rtol=rtol, atol=floor * scale)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batched(tree):
    return jax.tree.map(lambda a: np.broadcast_to(a, (B,) + np.shape(a)), tree)


@pytest.fixture(scope="module")
def jax_side():
    jm = jzoo.humanoid()
    plugin = JForceAcc(jm, contact_links=CONTACTS, waist_link="pelvis",
                       iters=12, solver_opts=dict(PROFILE))
    st = jax.jit(lambda: jrollout.standing_state(jm, CONTACTS))()
    polish = []
    orig_polish = jqp._polish

    def record_polish(P, q, A, l, u, x, y, **kw):
        x_new, y_new = orig_polish(P, q, A, l, u, x, y, **kw)
        jax.debug.callback(
            lambda acc, *rows: polish.append(
                (bool(acc), tuple(np.asarray(r) for r in rows))),
            jnp.any(x_new != x), A, l, u, x, y, ordered=True)
        return x_new, y_new

    # the residuals each rho adaptation reads (the in-loop calls, which
    # pass the equality projector Pn; both on_start levels have equalities)
    residuals = []
    orig_residuals = jqp._rel_residuals

    def record_residuals(P, q, A, x, z, y, Pn=None):
        prim, dual = orig_residuals(P, q, A, x, z, y, Pn=Pn)
        if Pn is not None:
            jax.debug.callback(
                lambda p, d: residuals.append((float(p), float(d))),
                prim, dual, ordered=True)
        return prim, dual

    # on_start is traced with the recorders in place; the tick and the CoM
    # rows without them. The three programs then compile side by side.
    with pytest.MonkeyPatch.context() as mp:
        # validate() reads the stack on the host, which jit cannot; the
        # port runs the same check in its own on_start
        mp.setattr(JAutoStack, "validate", staticmethod(lambda *a, **k: None))
        mp.setattr(jqp, "_polish", record_polish)
        mp.setattr(jqp, "_rel_residuals", record_residuals)
        start = jax.jit(plugin.on_start).lower(st)
        refs_s, warm_s, _ = jax.eval_shape(plugin.on_start, st)

    # the batch: the standing state with q perturbed by 0.01 N(0, 1)
    states = _batched(_np(st))
    states = dataclasses.replace(states, q=states.q + 0.01 * np.random.default_rng(
        0).normal(size=(B, jm.nj)))
    jstates = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), states)

    def tick(s, r, w):   # the tick, plus its StackData for the stack test
        stack = plugin.stack.build(jm, jdyn.compute_model_data(jm, s), s, r,
                                   nx=plugin.opt.size, dtype=jnp.float32)
        return plugin._step_impl(s, r, w), stack

    # the CoM task is kept out of the default stack: its rows alone, at the
    # tick states given random joint and base velocities (its D term)
    rng = np.random.default_rng(1)
    com_states = dataclasses.replace(
        states, qd=0.3 * rng.normal(size=(B, jm.nj)),
        base_vel=0.3 * rng.normal(size=(B, 6)))
    jcom_states = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                               com_states)

    def com_rows(s, r):
        ctx = JAssembleCtx(model=jm, data=jdyn.compute_model_data(jm, s),
                           state=s, refs=r, nx=plugin.opt.size,
                           dtype=jnp.float32)
        return plugin.com_task.assemble(ctx)

    batched = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: jax.ShapeDtypeStruct((B,) + a.shape, a.dtype), tree)
    lowered = (start,
               jax.jit(jax.vmap(tick)).lower(jstates, batched(refs_s),
                                             batched(warm_s)),
               jax.jit(jax.vmap(com_rows)).lower(jcom_states,
                                                 batched(refs_s)))
    with ThreadPoolExecutor(3) as pool:
        start, step, com_fn = pool.map(lambda lw: lw.compile(), lowered)
    refs, warm, waist = start(st)
    jax.block_until_ready(warm)
    jax.effects_barrier()
    refs_b, warm_b = _batched(_np(refs)), _batched(_np(warm))
    ticks, w = [], warm_b
    for _ in range(2):
        (tau, w, aux), stack = step(jstates, refs_b, w)
        ticks.append(_np((tau, w, aux)))
    com = com_fn(jcom_states, refs_b)
    return dict(com_states={k: getattr(com_states, k)
                            for k in convert.STATE_FIELDS},
                com_rows=_np(com),state=_np(st), warm=_np(warm),
                ref_leaves=jax.tree_util.tree_leaves_with_path(_np(refs)),
                waist=np.asarray(waist), polish=[acc for acc, _ in polish],
                polish_inputs=[rows for _, rows in polish],
                residuals=residuals,
                states={k: getattr(states, k) for k in convert.STATE_FIELDS},
                refs_b=refs_b, ticks=ticks, stack=_np(stack),
                warm_b=[{k: getattr(lv, k) for k in convert.QPSTATE_FIELDS}
                        for lv in warm_b])


@pytest.fixture(scope="module")
def torch_side():
    plugin = ForceAccPlugin(zoo.humanoid(device="cpu"), contact_links=CONTACTS,
                            waist_link="pelvis", iters=12,
                            solver_opts=dict(PROFILE))
    st = standing_state(plugin.model, CONTACTS)
    polish = []
    orig_polish = qp._polish

    def record_polish(*args, **kw):
        x_new, y_new = orig_polish(*args, **kw)
        polish.append(bool(torch.any(x_new != args[5])))
        return x_new, y_new

    telemetry.reset("cascade.fallback")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qp, "_polish", record_polish)
        refs, warm, waist = plugin.on_start(st)
    return dict(plugin=plugin, state=st, refs=refs, warm=warm, waist=waist,
                polish=polish,
                on_start_fallbacks=telemetry.counts()["cascade.fallback"])


def test_standing_state_matches_reference(jax_side, torch_side):
    for k in ("q", "base_rot", "base_pos"):
        _close(getattr(torch_side["state"], k)[0],
               getattr(jax_side["state"], k))


def test_stack_data_matches_reference(jax_side, torch_side):
    plugin = torch_side["plugin"]
    ts = convert.robot_state(jax_side["states"], device="cpu")
    data = dynamics.compute_model_data(plugin.model, ts)
    sd = plugin.stack.build(plugin.model, data, ts,
                            convert.refs(jax_side["refs_b"], device="cpu"),
                            nx=plugin.opt.size)
    ref = jax_side["stack"]
    assert (sd.n_eq, sd.has_box) == (ref.n_eq, ref.has_box) == (6, False)
    assert [tuple(lv.A.shape) for lv in sd.levels] == [(B, 6, 44), (B, 50, 44)]
    assert tuple(sd.C.shape) == (B, 12, 44)
    for lv, rlv in zip(sd.levels, ref.levels):
        _close(lv.A, rlv.A)
        _close(lv.b, rlv.b)
    for k in ("C", "lC", "uC", "lb", "ub"):
        _close(getattr(sd, k), getattr(ref, k))


def _replay_on_start(plugin, state, decide, active_rows=None,
                     residuals=None):
    """The port's on_start with each polish acceptance replaced by
    ``decide(k, own)`` (k: the polish call's index; own: the port's own
    guard decision for the one batch item) and, with ``active_rows``, each
    polish's active set replaced by the one the port's rule picks on
    ``active_rows[k]`` = (A, l, u, x, y). With ``residuals``, the (prim,
    dual) that each rho adaptation reads are replaced by the recorded ones,
    so that rho_scale, and each KKT matrix built from it, follows the
    recording. Returns the warm state and, per polish call, the port's own
    decision, the imposed one and whether the output is the candidate or
    the old (x, y)."""
    calls, adapts = [], []
    orig_active, orig_residuals = qp._polish_active, qp._rel_residuals
    orig_accept, orig_polish = qp._polish_accept, qp._polish

    def imposed_residuals(P, q, A, x, z, y, Pn=None):
        prim, dual = orig_residuals(P, q, A, x, z, y, Pn=Pn)
        if residuals is None or Pn is None:
            return prim, dual
        rec = residuals[len(adapts)]
        adapts.append(rec)
        return tuple(torch.full_like(v, r) for v, r in zip((prim, dual), rec))

    def imposed_active(A, l, u, x, y, eps_active=1e-4):
        if active_rows is None:
            return orig_active(A, l, u, x, y, eps_active)
        rows = active_rows[len(calls)]
        return orig_active(*(torch.tensor(r[None], dtype=torch.float32)
                             for r in rows), eps_active)

    def imposed_accept(P, q, A, l, u, x, y, x_p, y_p):
        own = orig_accept(P, q, A, l, u, x, y, x_p, y_p)
        assert own.shape == (1,)
        take = bool(decide(len(calls), bool(own[0])))
        calls.append(dict(own=bool(own[0]), imposed=take, old=x, cand=x_p))
        return torch.full_like(own, take)

    def observed_polish(*args, **kw):
        x_new, y_new = orig_polish(*args, **kw)
        c = calls[-1]
        c["took_cand"] = bool(torch.equal(x_new, c["cand"]))
        c["took_old"] = bool(torch.equal(x_new, c["old"]))
        return x_new, y_new

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qp, "_polish_active", imposed_active)
        mp.setattr(qp, "_polish_accept", imposed_accept)
        mp.setattr(qp, "_polish", observed_polish)
        mp.setattr(qp, "_rel_residuals", imposed_residuals)
        _, warm, _ = plugin.on_start(state)
    if residuals is not None:
        assert len(adapts) == len(residuals)
    return warm, calls


def test_on_start_matches_reference(jax_side, torch_side):
    """References, initial waist and the seeded warm state.

    The polish acceptance guard (dual_new <= dual_old + 1e-12, with 1e-6
    relative feasibility on the DynamicFeasibility equality rows) is a
    float32 knife edge on this ill-conditioned level: the inputs reach it
    with roundoff-level differences, and the two sides may take different
    branches (which side JAX's XLA lands on differs between machines). The
    active set is a second such edge: a row whose multiplier is roundoff
    noise is active by the sign of that noise (one row of level 0 on the
    first polish), and the candidate then moves by hundreds of force
    units. Fed identical inputs the two implementations agree. So the
    branch record is reported, not pinned; the port's on_start is replayed
    with the reference's decisions imposed on both steps: the active set
    the rule picks on the reference's recorded polish inputs, and the
    reference's recorded acceptance (the port's own candidate where the
    reference accepted, the old (x, y) where it rejected). Its warm state
    is held to the level-kernel bars, and by the first tick run from it;
    the KKT inverses are held in a second replay that also imposes the
    reference's rho adaptation."""
    record = (f"polish branches accepted: reference {jax_side['polish']}, "
              f"port {torch_side['polish']}")
    assert len(torch_side["polish"]) == len(jax_side["polish"]) == 8, record
    # the on_start solves are outside the level kernel's profile: counted
    assert torch_side["on_start_fallbacks"] == 4
    for path, leaf in jax_side["ref_leaves"]:
        ours = torch_side["refs"]
        for p in path:
            ours = ours[p.key]
        _close(ours[0], leaf)
    _close(torch_side["waist"][0], jax_side["waist"])

    ref_branches = jax_side["polish"]
    warm, calls = _replay_on_start(torch_side["plugin"], torch_side["state"],
                                   lambda k, own: ref_branches[k],
                                   active_rows=jax_side["polish_inputs"])
    assert [c["imposed"] for c in calls] == ref_branches, record
    for ours, ref in zip(warm, jax_side["warm"]):
        sc = float(np.max(np.abs(ref.x))) + 1.0
        np.testing.assert_allclose(ours.x[0], ref.x, atol=2e-4 * sc, rtol=2e-4,
                                   err_msg=record)
        for k in ("z", "y"):
            _close(getattr(ours, k)[0], getattr(ref, k), rtol=5e-4, floor=5e-4)
        # on_start adapts rho at rho_adapt_tol 0 from roundoff-level
        # residuals (see test_torch_qp's cold-profile test): 10%
        np.testing.assert_allclose(ours.rho_scale[0], ref.rho_scale, rtol=0.1,
                                   err_msg=record)

    # a 7% rho_scale gap moves level 1's KKT matrix, so the KKT inverses
    # are held elementwise at the bars above in a second replay, with the
    # reference's rho adaptation imposed too (4 solves x 4 chunks): rho then
    # follows the reference's to float32 roundoff, and each Kinv inverts the
    # same matrix as the reference's
    assert len(jax_side["residuals"]) == 16
    warm_rho, _ = _replay_on_start(torch_side["plugin"], torch_side["state"],
                                   lambda k, own: ref_branches[k],
                                   active_rows=jax_side["polish_inputs"],
                                   residuals=jax_side["residuals"])
    for ours, ref in zip(warm_rho, jax_side["warm"]):
        np.testing.assert_allclose(ours.rho_scale[0], ref.rho_scale,
                                   rtol=1e-6, err_msg=record)
        sc = float(np.max(np.abs(ref.x))) + 1.0
        np.testing.assert_allclose(ours.x[0], ref.x, atol=2e-4 * sc, rtol=2e-4,
                                   err_msg=record)
        _close(ours.Kinv[0], ref.Kinv, rtol=5e-4, floor=5e-4)

    # the whole warm state of the first replay by what the tick does with
    # it: the first batched tick from it against the reference's first tick
    # from its own, at the bars of the chained test
    ts = convert.robot_state(jax_side["states"], device="cpu")
    refs = convert.refs(jax_side["refs_b"], device="cpu")
    warm_b = tuple(qp.QPState(**{f: getattr(lv, f).expand(
        B, *getattr(lv, f).shape[1:]).contiguous()
        for f in convert.QPSTATE_FIELDS}) for lv in warm)
    tau, warm_t, aux = torch_side["plugin"]._step_impl(ts, refs, warm_b)
    tau_ref, warm_ref, aux_ref = jax_side["ticks"][0]
    np.testing.assert_array_equal(aux.solver_failed.numpy(),
                                  aux_ref.solver_failed)
    _close(tau, tau_ref, rtol=1e-3, floor=1e-3)
    for ours, ref in zip(warm_t, warm_ref):
        sc = float(np.max(np.abs(ref.x))) + 1.0
        np.testing.assert_allclose(ours.x, ref.x, atol=2e-4 * sc, rtol=2e-4,
                                   err_msg=record)


def test_on_start_replay_takes_the_imposed_decision(torch_side):
    """The replay mechanism itself, whichever side JAX lands on: every
    polish decision is flipped against the port's own guard, and each
    polish must then return the candidate where acceptance was imposed and
    the old (x, y) where rejection was."""
    _, calls = _replay_on_start(torch_side["plugin"], torch_side["state"],
                                lambda k, own: not own)
    assert len(calls) == 8
    assert any(c["imposed"] and not c["own"] for c in calls), calls
    for k, c in enumerate(calls):
        assert c["imposed"] != c["own"]
        if c["imposed"]:
            assert c["took_cand"], f"polish {k}: imposed accept not taken"
        else:
            assert c["took_old"], f"polish {k}: imposed reject not taken"


def test_two_chained_ticks_match_reference(jax_side, torch_side):
    """tau over two chained batched ticks from the reference's own on_start
    state (carried across with model.convert), so the tick is held alone."""
    plugin = torch_side["plugin"]
    ts = convert.robot_state(jax_side["states"], device="cpu")
    refs = convert.refs(jax_side["refs_b"], device="cpu")
    warm = convert.qp_states(jax_side["warm_b"], device="cpu")
    for tau_ref, warm_ref, aux_ref in jax_side["ticks"]:
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


def test_com_task_rows_match_reference(jax_side, torch_side):
    """tasks/force.py::CoM, which on_start reads its references from but
    the default stack leaves out, assembled alone (6 rows: net force, and
    moments about the CoM)."""
    plugin = torch_side["plugin"]
    ts = convert.robot_state(jax_side["com_states"], device="cpu")
    ctx = AssembleCtx(model=plugin.model,
                      data=dynamics.compute_model_data(plugin.model, ts),
                      state=ts,
                      refs=convert.refs(jax_side["refs_b"], device="cpu"),
                      nx=plugin.opt.size)
    A, b = plugin.com_task.assemble(ctx)
    A_ref, b_ref = jax_side["com_rows"]
    assert tuple(A.shape) == A_ref.shape == (B, 6, 44)
    _close(A, A_ref)
    _close(b, b_ref)


# step_core's torque against the RNEA pass it replaced: (robot, contacts,
# options) on point contacts, friction cones and 6D wrenches
TORQUE_CASES = {
    "humanoid-points": ("humanoid", CONTACTS, {}),
    "centaur-cones": ("centaur", ("foot_fl", "foot_fr", "foot_hr", "foot_hl"),
                      dict(use_friction_cones=True, mu=0.7)),
    "biped-6d": ("biped", CONTACTS, dict(wrench_dim=6,
                                         use_friction_cones=True)),
}
# |tau - tau_rnea| as a share of max |tau_rnea|: roundoff of two orders of
# summation
TORQUE_BARS = {torch.float32: 2e-6, torch.float64: 1e-10}


def _random_state(model, contacts, dtype, seed):
    """B standing states with q perturbed by 0.01 N(0, 1), a random base
    rotation and small joint and base velocities."""
    st = standing_state(model, contacts, batch=B)
    g = torch.Generator().manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g,  # noqa: E731
                                      dtype=dtype)
    return dataclasses.replace(
        st, q=st.q + 0.01 * rand(B, model.nj), qd=0.1 * rand(B, model.nj),
        base_vel=0.05 * rand(B, 6),
        base_rot=st.base_rot @ spatial.so3_exp(0.2 * rand(B, 3)))


def _torque_case(robot, contacts, options, dtype, seed=0):
    """The plugin on ``robot`` in ``dtype`` in the real-time profile, with
    its on_start's references and warm state at B random states."""
    tm = zoo.by_name(robot, dtype=dtype, device="cpu")
    plugin = ForceAccPlugin(tm, contact_links=contacts, iters=12,
                            dtype=dtype,
                            solver_opts=dict(PROFILE),
                            **options)
    st = _random_state(tm, contacts, dtype, seed)
    refs, warm, _ = plugin.on_start(st)
    return plugin, st, refs, warm


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("case", list(TORQUE_CASES))
def test_step_core_torque_is_the_inverse_dynamics(case, dtype):
    """tau = B qddot + h - sum J_c^T f_c on the actuated rows equals the
    RNEA of the tick's qddot less the contact torque it returns."""
    plugin, st, refs, warm = _torque_case(*TORQUE_CASES[case], dtype)
    tau, _, _, (data, _, qddot, _, tau_c_full) = plugin.step_core(st, refs,
                                                                  warm)
    ref = (dynamics.rnea(plugin.model, st, qddot, gravity=True,
                         kin=data.kin) - tau_c_full)[:, 6:]
    assert tau.dtype == dtype and tau.shape == ref.shape
    err = float((tau - ref).abs().max())
    assert err <= TORQUE_BARS[dtype] * float(ref.abs().max()), err


def test_step_core_torque_walks_no_tree(monkeypatch):
    """The torque layer reads B and h from the tick's model data: with the
    model data computed beforehand and ``dynamics.rnea`` raising, step_core
    gives the same tau."""
    plugin, st, refs, warm = _torque_case(*TORQUE_CASES["humanoid-points"],
                                          torch.float32)
    tau_ref = plugin.step_core(st, refs, warm)[0]
    data = dynamics.compute_model_data(plugin.model, st)

    def tree_walk(*args, **kwargs):
        raise AssertionError("step_core called dynamics.rnea")

    monkeypatch.setattr(dynamics, "compute_model_data",
                        lambda *args, **kwargs: data)
    monkeypatch.setattr(dynamics, "rnea", tree_walk)
    assert torch.equal(plugin.step_core(st, refs, warm)[0], tau_ref)


def test_inverse_dynamics_is_b_qddot_plus_h_for_a_scaled_model():
    """The identity the torque rests on, for the rollout's per-item
    mass-scaled model (inertia (B, nj, 6, 6)): the mass matrix and h of
    that model give its RNEA."""
    dtype = torch.float64
    tm = zoo.quadruped(dtype=dtype, device="cpu")
    ms = torch.tensor([0.8, 1.3], dtype=dtype)
    model_s = dataclasses.replace(
        tm, inertia=tm.inertia * ms[:, None, None, None],
        base_inertia=tm.base_inertia * ms[:, None, None])
    st = _random_state(tm, ("foot_fl", "foot_fr", "foot_hr", "foot_hl"),
                       dtype, seed=1)
    udot = torch.randn((B, tm.nv), generator=torch.Generator().manual_seed(2),
                       dtype=dtype)
    kin = kinematics.fk(model_s, st)
    tau = ((dynamics.mass_matrix(model_s, st, kin=kin) @ udot[..., None])
           [..., 0] + dynamics.nonlinear_term(model_s, st, kin=kin))
    ref = dynamics.rnea(model_s, st, udot, gravity=True, kin=kin)
    assert float((tau - ref).abs().max()) <= 1e-10 * float(ref.abs().max())
