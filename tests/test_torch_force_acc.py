"""Parity of the PyTorch port's batched ForceAcc humanoid tick with
qppvm_tpu: the slice as a whole.

Both sides build ForceAccPlugin on the humanoid with bench.py's real-time
solver profile. The JAX side runs ``backend="xla"``: the Pallas kernel in
interpret mode at n = 44 would cost minutes to compile here, and its parity
with the xla path is pinned by tests/test_pallas_qp.py. The port runs
``backend="kernel"``, which on CPU tensors is the level kernel's plain
version. JAX programs are jitted (one compilation each) and pinned to
float32; tick inputs are numpy-seeded.

Tolerances (float32 on both sides, sums in another order): stack data and
references to rtol 1e-4 with an absolute floor of 1e-4 of each array's
scale; solver outputs to the level-kernel bars of tests/test_pallas_qp.py;
torques to 1e-3 of their scale (about 0.04 Nm on a 40 Nm knee torque), a
hundredth of what a wrong task row or contact Jacobian would move them.
"""
import dataclasses

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
from qppvm_tpu_torch.model import convert, dynamics, zoo
from qppvm_tpu_torch.mpc.rollout import standing_state
from qppvm_tpu_torch.opt import hierarchy, qp
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
                       iters=12, solver_opts=dict(PROFILE, backend="xla"))
    st = jax.jit(lambda: jrollout.standing_state(jm, CONTACTS))()
    polish = []
    orig_polish = jqp._polish

    def record_polish(P, q, A, l, u, x, y, **kw):
        x_new, y_new = orig_polish(P, q, A, l, u, x, y, **kw)
        jax.debug.callback(lambda a: polish.append(bool(a)),
                           jnp.any(x_new != x), ordered=True)
        return x_new, y_new

    with pytest.MonkeyPatch.context() as mp:
        # validate() reads the stack on the host, which jit cannot; the
        # port runs the same check in its own on_start
        mp.setattr(JAutoStack, "validate", staticmethod(lambda *a, **k: None))
        mp.setattr(jqp, "_polish", record_polish)
        refs, warm, waist = jax.jit(plugin.on_start)(st)
        jax.block_until_ready(warm)
        jax.effects_barrier()

    # the batch: the standing state with q perturbed by 0.01 N(0, 1)
    states = _batched(_np(st))
    states = dataclasses.replace(states, q=states.q + 0.01 * np.random.default_rng(
        0).normal(size=(B, jm.nj)))
    jstates = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), states)
    refs_b, warm_b = _batched(_np(refs)), _batched(_np(warm))

    def tick(s, r, w):   # the tick, plus its StackData for the stack test
        stack = plugin.stack.build(jm, jdyn.compute_model_data(jm, s), s, r,
                                   nx=plugin.opt.size, dtype=jnp.float32)
        return plugin._step_impl(s, r, w), stack

    step = jax.jit(jax.vmap(tick))
    ticks, w = [], warm_b
    for _ in range(2):
        (tau, w, aux), stack = step(jstates, refs_b, w)
        ticks.append(_np((tau, w, aux)))

    # the CoM task is kept out of the default stack: its rows alone, at the
    # tick states given random joint and base velocities (its D term)
    rng = np.random.default_rng(1)
    com_states = dataclasses.replace(
        states, qd=0.3 * rng.normal(size=(B, jm.nj)),
        base_vel=0.3 * rng.normal(size=(B, 6)))

    def com_rows(s, r):
        ctx = JAssembleCtx(model=jm, data=jdyn.compute_model_data(jm, s),
                           state=s, refs=r, nx=plugin.opt.size,
                           dtype=jnp.float32)
        return plugin.com_task.assemble(ctx)

    com = jax.jit(jax.vmap(com_rows))(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), com_states), refs_b)
    return dict(com_states={k: getattr(com_states, k)
                            for k in convert.STATE_FIELDS},
                com_rows=_np(com),state=_np(st), warm=_np(warm),
                ref_leaves=jax.tree_util.tree_leaves_with_path(_np(refs)),
                waist=np.asarray(waist), polish=polish,
                states={k: getattr(states, k) for k in convert.STATE_FIELDS},
                refs_b=refs_b, ticks=ticks, stack=_np(stack),
                warm_b=[{k: getattr(lv, k) for k in convert.QPSTATE_FIELDS}
                        for lv in warm_b])


@pytest.fixture(scope="module")
def torch_side():
    plugin = ForceAccPlugin(zoo.humanoid(), contact_links=CONTACTS,
                            waist_link="pelvis", iters=12,
                            solver_opts=dict(PROFILE, backend="kernel"))
    st = standing_state(plugin.model, CONTACTS)
    polish = []
    orig_polish = qp._polish

    def record_polish(*args, **kw):
        x_new, y_new = orig_polish(*args, **kw)
        polish.append(bool(torch.any(x_new != args[5])))
        return x_new, y_new

    hierarchy.fallbacks = 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qp, "_polish", record_polish)
        refs, warm, waist = plugin.on_start(st)
    return dict(plugin=plugin, state=st, refs=refs, warm=warm, waist=waist,
                polish=polish, on_start_fallbacks=hierarchy.fallbacks)


def test_standing_state_matches_reference(jax_side, torch_side):
    for k in ("q", "base_rot", "base_pos"):
        _close(getattr(torch_side["state"], k)[0],
               getattr(jax_side["state"], k))


def test_stack_data_matches_reference(jax_side, torch_side):
    plugin = torch_side["plugin"]
    ts = convert.robot_state(jax_side["states"])
    data = dynamics.compute_model_data(plugin.model, ts)
    sd = plugin.stack.build(plugin.model, data, ts,
                            convert.refs(jax_side["refs_b"]),
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


def test_on_start_matches_reference(jax_side, torch_side):
    """References, initial waist and the seeded warm state.

    The polish acceptance guard (dual_new <= dual_old + 1e-12, with 1e-6
    relative feasibility on the DynamicFeasibility equality rows) is a
    float32 knife edge on this ill-conditioned level: the inputs reach it
    with roundoff-level differences, and the two sides may take different
    branches (the port may accept the first polish of level 0 where the
    reference rejects it). Fed identical inputs the two implementations
    agree. So the branch record is reported, not pinned; the port's
    on_start is replayed with the reference's branches imposed (its own
    polish where the reference accepted, none where it rejected) and its
    warm state held to the level-kernel bars."""
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

    plugin = torch_side["plugin"]
    branches = iter(jax_side["polish"])
    orig_polish = qp._polish

    def reference_branch(P, q, A, l, u, x, y, **kw):
        if next(branches):
            return orig_polish(P, q, A, l, u, x, y, **kw)
        return x, y

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qp, "_polish", reference_branch)
        _, warm, _ = plugin.on_start(torch_side["state"])
    for ours, ref in zip(warm, jax_side["warm"]):
        sc = float(np.max(np.abs(ref.x))) + 1.0
        np.testing.assert_allclose(ours.x[0], ref.x, atol=2e-4 * sc, rtol=2e-4,
                                   err_msg=record)
        for k in ("z", "y", "Kinv"):
            _close(getattr(ours, k)[0], getattr(ref, k), rtol=5e-4, floor=5e-4)
        # on_start adapts rho at rho_adapt_tol 0 from roundoff-level
        # residuals (see test_torch_qp's cold-profile test): 10%
        np.testing.assert_allclose(ours.rho_scale[0], ref.rho_scale, rtol=0.1,
                                   err_msg=record)


def test_two_chained_ticks_match_reference(jax_side, torch_side):
    """tau over two chained batched ticks from the reference's own on_start
    state (carried across with model.convert), so the tick is held alone."""
    plugin = torch_side["plugin"]
    ts = convert.robot_state(jax_side["states"])
    refs = convert.refs(jax_side["refs_b"])
    warm = convert.qp_states(jax_side["warm_b"])
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
    ts = convert.robot_state(jax_side["com_states"])
    ctx = AssembleCtx(model=plugin.model,
                      data=dynamics.compute_model_data(plugin.model, ts),
                      state=ts, refs=convert.refs(jax_side["refs_b"]),
                      nx=plugin.opt.size)
    A, b = plugin.com_task.assemble(ctx)
    A_ref, b_ref = jax_side["com_rows"]
    assert tuple(A.shape) == A_ref.shape == (B, 6, 44)
    _close(A, A_ref)
    _close(b, b_ref)
