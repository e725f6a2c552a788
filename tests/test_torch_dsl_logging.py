"""Parity of the rest of the port's DSL and logging with qppvm_tpu: the
affine algebra of ``opt/variables.py``, ``AutoStack.constraint_row_order``
and ``AutoStack.log``, ``RobotModel.is_frame`` and ``RobotState.astype``,
``qp.solve_batch`` and ``runtime/logger.py::scan_with_stream``.

- The affine cases are tests/test_stack_dsl.py:61-80's, each evaluated on
  both sides at the same x: exact (float32 identities and small integers).
- ``constraint_row_order`` of the quadruped's ForceAcc stack with every
  constraint kind (dynamic feasibility, friction cones, the CoP-free
  3-force box, joint acceleration limits): the same names in the same
  order.
- ``AutoStack.log``: the dual arm's QPPVM stack (tests/test_log_hooks.py's
  set-up) built and solved by the port, logged by both packages from the
  same stack data, solution and infos: the same channels, shapes and
  values (rtol 1e-6: the residual A x - b is a float32 product on each
  side). A batch of 2 raises ValueError.
- ``qp.solve_batch``: bitwise the port's ``qp.solve``, and within 1e-6 of
  the reference's ``solve_batch`` (jitted) on 3 well-conditioned float64
  QPs at 40 iterations without polish.
- ``scan_with_stream``: a 2-state linear loop streamed by both packages (2
  chunks of 4 ticks) into equal traces; then the quadruped's closed loop
  (tests/test_trace_stream.py's set-up, 2 chunks of 8 ticks) streamed by
  the port, bitwise equal to the same ticks dispatched one by one with a
  host copy a channel, in 2 host copies in all.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu.model import zoo as jzoo
from qppvm_tpu.model.urdf import load_urdf as jload_urdf
from qppvm_tpu.opt import hierarchy as jhier
from qppvm_tpu.opt import qp as jqp
from qppvm_tpu.opt.variables import AffineExpr as JAffine
from qppvm_tpu.opt.variables import Optvar as JOptvar
from qppvm_tpu.plugins.force_acc import ForceAccPlugin as JForceAcc
from qppvm_tpu.runtime import logger as jlogger
from qppvm_tpu.stack.autostack import AutoStack as JAutoStack
from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import dynamics, zoo
from qppvm_tpu_torch.model.urdf import load_urdf
from qppvm_tpu_torch.opt import hierarchy, qp
from qppvm_tpu_torch.opt.variables import AffineExpr, Optvar
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
from qppvm_tpu_torch.plugins.qppvm import QPPVMPlugin
from qppvm_tpu_torch.runtime import robot_interface as ri
from qppvm_tpu_torch.runtime.logger import TraceBuffer, scan_with_stream

torch.set_num_threads(1)
FEET = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")
SEGMENTS = [("qddot", 4), ("w1", 3), ("w2", 3)]


def _affine_cases(opt, zero, S):
    """tests/test_stack_dsl.py:61-80's expressions, and the rest of the
    algebra, built by one package."""
    w1, w2, q = opt["w1"], opt["w2"], opt["qddot"]
    return {"qddot": q, "w1": w1, "stack": w1 / w2,
            "zero_pad": w1 / zero(10, 3),
            "matmul": S @ w1, "rows": w1.rows([2]),
            "add_sub_neg": -(w1 + w2) - (w1 - 1.5) + 2.0}


@pytest.mark.parametrize("name", ["qddot", "w1", "stack", "zero_pad",
                                  "matmul", "rows", "add_sub_neg"])
def test_affine_algebra_matches_reference(name):
    x = np.arange(10.0, dtype=np.float32)
    jexpr = _affine_cases(JOptvar(SEGMENTS), JAffine.zero,
                          2.0 * jnp.eye(3))[name]
    texpr = _affine_cases(Optvar(SEGMENTS, device="cpu"),
                          lambda n, k: AffineExpr.zero(n, k, device="cpu"),
                          2.0 * torch.eye(3))[name]
    assert (texpr.size, texpr.input_size) == (jexpr.size, jexpr.input_size)
    want = np.asarray(jexpr.value(jnp.asarray(x)))
    got = texpr.value(torch.as_tensor(x)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_optvar_slices_names_and_numpy_composition():
    jopt, opt = JOptvar(SEGMENTS), Optvar(SEGMENTS, device="cpu")
    assert opt.names() == jopt.names() == ["qddot", "w1", "w2"]
    for n in opt.names():
        assert opt.slice_of(n) == jopt.slice_of(n)
    # a numpy matrix composes on the left like a tensor
    S = np.array([[1.0, 0.0, 2.0]])
    got = (S @ opt["w2"]).value(torch.arange(10.0)[None])[0].numpy()
    want = np.asarray((jnp.asarray(S) @ jopt["w2"]).value(jnp.arange(10.0)))
    np.testing.assert_array_equal(got, want)


def test_constraint_row_order_matches_reference():
    kw = dict(contact_links=FEET, waist_link="pelvis",
              use_friction_cones=True, mu=0.5)
    jplug = JForceAcc(jzoo.quadruped(), **kw)
    plug = ForceAccPlugin(zoo.quadruped(device="cpu"), **kw)
    want = jplug.stack.constraint_row_order()
    assert plug.stack.constraint_row_order() == want
    kinds = [c.is_equality for c in plug.stack._ordered()]
    assert kinds == sorted(kinds, reverse=True) and any(kinds)


@pytest.fixture(scope="module")
def dual_arm_solve():
    """The port's dual-arm QPPVM stack built and solved at home."""
    model = zoo.dual_arm(device="cpu")
    plugin = QPPVMPlugin(model, iters=30)
    state = model.home_state()
    refs, warm, _ = plugin.on_start(state)
    data = dynamics.compute_model_data(model, state, need_binv=True)
    sd = plugin.stack.build(model, data, state, refs, nx=model.nj,
                            dtype=plugin.dtype)
    x, _, infos = hierarchy.solve(sd, warm, eps=plugin.eps, iters=30)
    return plugin, sd, x, infos


def _jax_stack(sd):
    """The port's batch-1 StackData as the reference's."""
    j = lambda t: jnp.asarray(t[0].numpy())  # noqa: E731
    return jhier.StackData(
        levels=tuple(jhier.LevelData(A=j(lv.A), b=j(lv.b))
                     for lv in sd.levels),
        C=j(sd.C), lC=j(sd.lC), uC=j(sd.uC), lb=j(sd.lb), ub=j(sd.ub),
        n_eq=sd.n_eq)


def test_stack_log_matches_reference(tmp_path, dual_arm_solve):
    plugin, sd, x, infos = dual_arm_solve
    jinfos = tuple(jqp.QPInfo(prim_res=jnp.asarray(i.prim_res[0].numpy()),
                              dual_res=jnp.asarray(i.dual_res[0].numpy()),
                              obj=jnp.asarray(i.obj[0].numpy()))
                   for i in infos)
    jtrace = jlogger.TraceBuffer(str(tmp_path / "jax"), capacity=4)
    JAutoStack.log(None, jtrace, _jax_stack(sd), x=jnp.asarray(x[0].numpy()),
                   infos=jinfos)
    trace = TraceBuffer(str(tmp_path / "port"), capacity=4)
    plugin.stack.log(trace, sd, x=x, infos=infos)
    want, got = jtrace.data(), trace.data()
    assert sorted(got) == sorted(want)
    assert "stack/level1_residual" in got and "solver/level0_obj" in got
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert np.isfinite(np.load(trace.flush())["solver/level0_prim_res"][0])


def test_stack_log_refuses_a_batch(tmp_path, dual_arm_solve):
    plugin, sd, x, infos = dual_arm_solve
    two = lambda t: torch.cat([t, t])  # noqa: E731
    sd2 = dataclasses.replace(
        sd, levels=tuple(hierarchy.LevelData(A=two(lv.A), b=two(lv.b))
                         for lv in sd.levels),
        C=two(sd.C), lC=two(sd.lC), uC=two(sd.uC), lb=two(sd.lb),
        ub=two(sd.ub))
    with pytest.raises(ValueError):
        plugin.stack.log(TraceBuffer(str(tmp_path / "b"), 4), sd2, x=two(x))


URDF_TOOL = """
<robot name="two_link_tool">
  <link name="base"/>
  <link name="l1"><inertial><mass value="1"/><origin xyz="0 0 0.2"/>
    <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/>
  </inertial></link>
  <link name="l2"><inertial><mass value="0.5"/><origin xyz="0 0 0.15"/>
    <inertia ixx="0.005" iyy="0.005" izz="0.005" ixy="0" ixz="0" iyz="0"/>
  </inertial></link>
  <link name="tool"/>
  <joint name="j1" type="revolute"><parent link="base"/><child link="l1"/>
    <origin xyz="0 0 0.1"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2" effort="50" velocity="5"/></joint>
  <joint name="j2" type="revolute"><parent link="l1"/><child link="l2"/>
    <origin xyz="0 0 0.4"/><axis xyz="1 0 0"/>
    <limit lower="-2" upper="2" effort="30" velocity="5"/></joint>
  <joint name="tool_mount" type="fixed"><parent link="l2"/>
    <child link="tool"/><origin xyz="0 0 0.3"/></joint>
</robot>
"""


def test_is_frame_and_state_astype_match_reference():
    jm = jload_urdf(URDF_TOOL)
    m = load_urdf(URDF_TOOL, device="cpu")
    for name in ("base", "l1", "l2", "tool", "nowhere"):
        assert m.is_frame(name) == jm.is_frame(name), name
    assert m.is_frame("tool") and not m.is_frame("l2")
    q = np.array([0.3, -0.7], np.float32)
    js = jm.home_state()
    js = dataclasses.replace(js, q=jnp.asarray(q)).astype(jnp.float64)
    st = m.home_state()
    st = dataclasses.replace(st, q=torch.as_tensor(q)[None])
    st64 = st.astype(torch.float64)
    for f in dataclasses.fields(st64):
        got = getattr(st64, f.name)
        assert got.dtype == torch.float64, f.name
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.asarray(getattr(js, f.name)))
    assert st64.astype(torch.float32).q.dtype == torch.float32


def _random_qps(rng, B=3, n=6, m=8):
    M = rng.normal(size=(B, n, n))
    P = M @ np.transpose(M, (0, 2, 1)) + n * np.eye(n)
    A = rng.normal(size=(B, m, n))
    l = -1.0 - rng.random((B, m))
    u = 1.0 + rng.random((B, m))
    return P, rng.normal(size=(B, n)), A, l, u


def test_solve_batch_is_solve_and_matches_reference():
    P, q, A, l, u = _random_qps(np.random.default_rng(3))
    opts = dict(iters=40, polish_rounds=0, refine=0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    prob = qp.QPProblem(P=t(P), q=t(q), A=t(A), l=t(l), u=t(u))
    x, st, info = qp.solve_batch(prob, **opts)
    x2, st2, info2 = qp.solve(prob, **opts)
    assert torch.equal(x, x2) and torch.equal(st.y, st2.y)
    assert torch.equal(info.prim_res, info2.prim_res)
    jprob = jqp.QPProblem(P=jnp.asarray(P), q=jnp.asarray(q),
                          A=jnp.asarray(A), l=jnp.asarray(l),
                          u=jnp.asarray(u))
    jx, _, _ = jax.jit(lambda p: jqp.solve_batch(p, **opts))(jprob)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-6)


def _lin_body(xp, to):
    """A 2-state linear tick on package ``xp`` (jnp or torch)."""
    Amat = to([[0.9, 0.1], [-0.2, 0.95]])

    def body(c, _):
        c = Amat @ c + to([0.01, -0.02])
        return c, {"c": c, "sum": xp.sum(c)}
    return body


def test_scan_with_stream_matches_reference(tmp_path):
    jtrace = jlogger.TraceBuffer(str(tmp_path / "jax"), capacity=8)
    jbody = _lin_body(jnp, lambda a: jnp.asarray(a, jnp.float64))
    jlogger.scan_with_stream(jbody, jnp.asarray([1.0, -1.0]), 8, jtrace,
                             chunk=4)
    trace = TraceBuffer(str(tmp_path / "port"), capacity=8)
    body = _lin_body(torch, lambda a: torch.tensor(a, dtype=torch.float64))
    scan_with_stream(body, torch.tensor([1.0, -1.0], dtype=torch.float64), 8,
                     trace, chunk=4)
    want, got = jtrace.data(), trace.data()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    with pytest.raises(ValueError):
        scan_with_stream(body, torch.zeros(2, dtype=torch.float64), 6,
                         trace, chunk=4)


def test_scan_with_stream_matches_host_dispatch(tmp_path):
    model = zoo.quadruped(device="cpu")
    plugin = ForceAccPlugin(model, contact_links=FEET, waist_link="pelvis",
                            iters=15, use_friction_cones=True, mu=0.5,
                            foot_tasks_6d=False)
    st0 = ri.standing_state(model, FEET)
    robot = ri.SimRobot(model, state=st0, dt=1e-3, substeps=1,
                        contact_links=FEET)
    refs, warm, _ = plugin.on_start(robot.state)
    zk = torch.zeros(model.nj)

    def tick(carry, _):
        st, anchors, w = carry
        tau, w, aux = plugin._step_impl(st, refs, w)
        st, anchors = robot.step(st, anchors, tau, st.q, zk, zk)
        return (st, anchors, w), {
            "tau_qp": tau[0], "prim_res": aux.prim_res[0],
            "fz": aux.wrenches[0, :, 2], "base_z": st.base_pos[0, 2]}

    T, CHUNK = 16, 8
    carry0 = (robot.state, robot._anchors, warm)
    streamed = TraceBuffer(str(tmp_path / "dev"), capacity=T)
    telemetry.reset("logger.host_copy")
    carry_s = scan_with_stream(tick, carry0, T, streamed, chunk=CHUNK)
    assert telemetry.counts()["logger.host_copy"] == T // CHUNK

    host = TraceBuffer(str(tmp_path / "host"), capacity=T)
    c = carry0
    for _ in range(T):
        c, ch = tick(c, None)
        for k, v in ch.items():
            host.add(k, v)
    got, want = streamed.data(), host.data()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape == (T,) + want[k].shape[1:]
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.max(got["prim_res"]) < plugin.RT_FAIL_TOL
    assert torch.equal(carry_s[0].q, c[0].q)
    assert np.load(streamed.flush())["tau_qp"].shape == (T, model.nj)
