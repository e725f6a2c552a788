"""The port's runtime on the CPU, alone (no JAX): the plugin registry,
``ControlLoop`` driving the QPPVM plugin on the 7-DoF arm (config 1) with
both failure policies, ``TraceBuffer`` and the session checkpoint."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from qppvm_tpu_torch import tree as trees
from qppvm_tpu_torch.model import dynamics, zoo
from qppvm_tpu_torch.plugins.qppvm import QPPVMPlugin
from qppvm_tpu_torch.runtime import checkpoint, logger
from qppvm_tpu_torch.runtime.logger import TraceBuffer
from qppvm_tpu_torch.runtime.plugin import (ControlLoop, Handle, get_plugin,
                                            register_plugin,
                                            registered_plugins)
from qppvm_tpu_torch.runtime.robot_interface import SimRobot

torch.set_num_threads(1)
FAIL_TICKS = {10, 11, 12}


@pytest.fixture(scope="module")
def arm():
    model = zoo.arm7(device="cpu")
    return model, QPPVMPlugin(model, left_ee="arm1_7", right_ee="arm1_7",
                              iters=30)


def test_plugin_registry():
    assert "QPPVMPlugin" not in registered_plugins()   # callers register

    @register_plugin("TestPlugin")
    class _P:
        pass

    assert get_plugin("TestPlugin") is _P
    assert "TestPlugin" in registered_plugins()
    with pytest.raises(KeyError):
        get_plugin("NoSuchPlugin")
    assert Handle(robot=None).config_path is None


def test_control_loop_runs_and_logs(arm, tmp_path):
    model, plugin = arm
    robot = SimRobot(model, dt=1e-3, substeps=1)
    trace = TraceBuffer(str(tmp_path / "loop_log"), capacity=1000)
    stats = ControlLoop(plugin, robot, period=1e-3, trace=trace).run(0.05)
    assert stats.latencies_s.shape == (50,)
    assert 0 < stats.p50_ms <= stats.p99_ms and stats.mean_ms > 0
    assert stats.solver_failures == stats.skipped_actuations == 0
    d = trace.data()
    assert d["tau_desired"].shape == (50, 1, model.nj)
    assert d["q"].shape == d["qd"].shape == (50, 1, model.nj)
    np.testing.assert_allclose(d["time_matlogger"], np.arange(50) * 1e-3)
    assert np.all(d["solver_failed"] == 0.0)
    assert os.path.exists(str(tmp_path / "loop_log.npz"))   # run() closes
    # the arm holds its home posture
    assert float((robot.state.q - model.q_home).abs().max()) < 0.05


class FailInjector:
    """Delegates to a plugin and reports its solve failed on FAIL_TICKS,
    under the given failure policy. ``fail_solve`` makes the plugin's own
    solve fail there (its failure gate trips); otherwise the injector
    replaces the output by zeros, as a faulty plugin would."""

    def __init__(self, plugin, policy, fail_solve):
        self._p = plugin
        self.failure_policy = policy
        self._fail_solve = fail_solve
        self._tick = 0

    def on_start(self, state):
        return self._p.on_start(state)

    def control_loop(self, state, refs, warm):
        fail = self._tick in FAIL_TICKS
        self._tick += 1
        if fail and self._fail_solve:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(self._p, "FAIL_TOL", -1.0)
                return self._p.control_loop(state, refs, warm)
        tau, warm, aux = self._p.control_loop(state, refs, warm)
        if fail:
            aux = dataclasses.replace(aux, solver_failed=torch.ones_like(
                aux.solver_failed))
            tau = torch.zeros_like(tau)
        return tau, warm, aux


def _spy(robot):
    """Record each (tau_ref, state) the loop commands."""
    commands = []
    orig = robot.set_reference

    def set_spy(tau_ref=None, q_ref=None):
        commands.append((tau_ref.clone(), robot.state))
        orig(tau_ref=tau_ref, q_ref=q_ref)

    robot.set_reference = set_spy
    return commands


def test_failure_skip_actuation_holds_previous_command(arm):
    """Under "skip_actuation" a failed tick commands nothing: the drives
    hold the previous reference, and no zero torque reaches the robot."""
    model, plugin = arm
    robot = SimRobot(model, dt=1e-3, substeps=1)
    commands = _spy(robot)
    loop = ControlLoop(FailInjector(plugin, "skip_actuation", False), robot,
                       period=1e-3)
    stats = loop.run(seconds=0.03)
    assert stats.solver_failures == stats.skipped_actuations == len(FAIL_TICKS)
    assert len(commands) == 30 - len(FAIL_TICKS)
    assert not any(bool((c == 0).all()) for c, _ in commands)


def test_failure_command_policy_commands_gravity_compensation(arm):
    """QPPVM's own policy, "command": every tick is commanded; on a tick
    whose solve failed the plugin's output is tau_qp = 0 plus h, gravity
    and Coriolis compensation at the tick's state. The EE reference rides
    the sinusoid half a second ahead, so a solved tick's tau_qp is not
    0."""
    model, plugin = arm

    def ahead(t, ctx):
        return dict(ctx["refs"],
                    LEFT_ARM=plugin.make_refs(ctx["start"], t, t0=-0.5))

    robot = SimRobot(model, dt=1e-3, substeps=1)
    commands = _spy(robot)
    injector = FailInjector(plugin, QPPVMPlugin.failure_policy, True)
    stats = ControlLoop(injector, robot, period=1e-3,
                        ref_generator=ahead).run(seconds=0.03)
    assert stats.solver_failures == len(FAIL_TICKS)
    assert stats.skipped_actuations == 0
    assert len(commands) == 30
    for k, (tau, state) in enumerate(commands):
        h = dynamics.nonlinear_term(model, state)
        if k in FAIL_TICKS:
            torch.testing.assert_close(tau, h, rtol=0.0, atol=0.0)
        else:
            assert float((tau - h).abs().max()) > 1e-3


def test_control_loop_close_flushes_trace_once(arm, tmp_path):
    model, plugin = arm
    robot = SimRobot(model, dt=1e-3, substeps=1)
    path = str(tmp_path / "close_log")
    trace = TraceBuffer(path, capacity=100)
    flushes = []
    orig_flush = trace.flush
    trace.flush = lambda: flushes.append(1) or orig_flush()
    closed = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(plugin, "close", lambda: closed.append(True))
        loop = ControlLoop(plugin, robot, period=1e-3, trace=trace)
        loop.run(seconds=0.01)
        loop.close()    # idempotent
    assert closed == [True] and flushes == [1]
    data = np.load(path + ".npz")
    assert data["tau_desired"].shape[0] == 10
    assert os.path.exists(path + ".mat")


def test_trace_buffer(tmp_path):
    tb = TraceBuffer(str(tmp_path / "cap"), capacity=5)
    for i in range(20):
        tb.add("x", float(i))
        tb.add("v", torch.full((3,), float(i)))
    tb.add_block("blk", np.arange(12.0).reshape(4, 3))
    tb.add_block("blk", np.arange(12.0).reshape(4, 3))
    d = tb.data()
    assert d["x"].shape == (5,) and d["v"].shape == (5, 3)
    np.testing.assert_array_equal(d["x"], np.arange(5.0))
    assert d["blk"].shape == (5, 3)
    np.testing.assert_array_equal(d["blk"][4], [0.0, 1.0, 2.0])
    out = tb.flush()
    assert np.load(out)["v"].shape == (5, 3)
    assert logger.get_logger("x") is logger.get_logger("x")


def test_trace_flush_raises_when_the_mat_write_fails(tmp_path):
    """Only a missing scipy skips the .mat file; a failed write raises."""
    import scipy.io

    tb = TraceBuffer(str(tmp_path / "bad"), capacity=5)
    tb.add("x", 1.0)

    def broken(*a, **k):
        raise OSError("disk full")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scipy.io, "savemat", broken)
        with pytest.raises(OSError, match="disk full"):
            tb.flush()


def test_session_checkpoint_resumes_bit_identically(arm, tmp_path):
    model, plugin = arm
    robot = SimRobot(model)
    refs, warm, _ = plugin.on_start(robot.state)
    for _ in range(5):   # populate the warm state
        tau, warm, _ = plugin.control_loop(robot.state, refs, warm)
        robot.set_reference(tau_ref=tau)
        robot.move()
    path = checkpoint.save_session(str(tmp_path / "session"),
                                   state=robot.state, refs=refs, warm=warm)
    assert path.endswith(".npz")
    zero = lambda tree: trees.rebuild(  # noqa: E731
        tree, {k: torch.zeros_like(v)
               for k, v in trees.leaves(tree)})
    state2, refs2, warm2 = checkpoint.load_session(
        path, state=zero(robot.state), refs=zero(refs), warm=zero(warm))
    tau_a, warm_a, _ = plugin.control_loop(robot.state, refs, warm)
    tau_b, warm_b, _ = plugin.control_loop(state2, refs2, warm2)
    assert torch.equal(tau_a, tau_b)
    for a, b in zip(warm_a, warm_b):
        assert torch.equal(a.x, b.x) and torch.equal(a.Kinv, b.Kinv)
        assert torch.equal(a.rho_scale, b.rho_scale)


def test_checkpoint_rejects_missing_leaves_and_shape_mismatch(tmp_path):
    path = checkpoint.save(str(tmp_path / "ck"), {"q": torch.zeros(2, 7)})
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.load(path, {"q": torch.zeros(3)})
    with pytest.raises(KeyError, match="qd"):
        checkpoint.load(path, {"q": torch.zeros(2, 7),
                               "qd": torch.zeros(2, 7)})
    out = checkpoint.load(path, {"q": torch.ones(2, 7, dtype=torch.float64)})
    assert out["q"].dtype == torch.float64 and not bool(out["q"].any())
