"""The program's spans and counters (``qppvm_tpu_torch/telemetry.py``), on
the CPU:

- off, ``span`` is one shared null context: nothing recorded, no
  ``record_function`` entered;
- after ``enable()``: nesting, parents, unit ids (a ``tick`` or ``plan``
  root opens one, the plant takes the tick's), self time = duration less
  the children's, a bounded store that counts what it drops, spans of two
  threads kept apart;
- under ``torch.profiler`` the tracer is on and the profiler's events
  carry the ``qppvm::`` names;
- one ForceAcc tick of the zoo humanoid and its plant period record every
  layer of the tick, and so do one QPPVM tick of the zoo dual arm (the
  level kernel's profile, the mass matrix's inverse in the model update)
  and its plant period;
- counters: always counted, per unit while on, reset by name, no update
  lost between threads; ``cascade.level`` and ``cascade.fallback`` count
  every level and every level outside the kernel's profile, which is every
  level that does not reach ``level_qp.solve_level``.
"""
from __future__ import annotations

import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import zoo
from qppvm_tpu_torch.opt import hierarchy, level_qp
from qppvm_tpu_torch.plugins.qppvm import QPPVMPlugin
from qppvm_tpu_torch.runtime import rt_loop
from qppvm_tpu_torch.runtime.robot_interface import SimRobot

TICK_CHILDREN = ("model_update", "stack", "cascade", "torque", "aux")
MODEL_STAGES = ("fk", "mass_matrix", "nonlinear", "jacobians", "velocities",
                "bias", "com")
RT = dict(iters=12, rho_updates=0, refine=2, polish_rounds=0,
          assume_warm_kinv=True, warm_kinv_iters=4, cold_ns_iters=10,
          scale_iters=2, pinv_ns_iters=5, rho_adapt_tol=1e-3,
          rho_scale_min=0.1, eps=1e4, eps_abs_scale=1e-5)


@pytest.fixture(autouse=True)
def fresh():
    telemetry.enable(False)
    telemetry.reset()
    yield
    telemetry.enable(False)
    telemetry.reset()


@pytest.fixture
def clock(monkeypatch):
    """A host clock that advances 10 ns a reading."""
    ticks = iter(range(10, 10 ** 9, 10))
    monkeypatch.setattr(telemetry, "time",
                        types.SimpleNamespace(perf_counter_ns=lambda: next(
                            ticks)))


def self_ns(recs):
    """Each record's duration less its children's."""
    own = [r[4] - r[3] for r in recs]
    for r in recs:
        if r[1] >= 0:
            own[r[1]] -= r[4] - r[3]
    return own


def test_off_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) while off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert telemetry.span("tick") is telemetry.span("plant")
    with telemetry.span("tick"):
        with telemetry.span("model_update"):
            telemetry.count("level_qp.launch")
    assert telemetry.records() == []
    assert telemetry.counts()["level_qp.launch"] == 1   # counted all the same
    assert telemetry.counts(1) == {}


def test_nesting_parents_and_units(clock):
    telemetry.enable()
    for _ in range(2):
        with telemetry.span("tick"):
            with telemetry.span("model_update"):
                with telemetry.span("model_update.fk"):
                    pass
            with telemetry.span("stack"):
                pass
        with telemetry.span("plant"):
            with telemetry.span("plant.substep"):
                pass
    with telemetry.span("plan"):
        with telemetry.span("rollout.step"):
            pass
    recs = telemetry.records()
    names = [r[0] for r in recs]
    assert names == ["tick", "model_update", "model_update.fk", "stack",
                     "plant", "plant.substep"] * 2 + ["plan", "rollout.step"]
    parents = [r[1] for r in recs]
    assert parents == [-1, 0, 1, 0, -1, 4, -1, 6, 7, 6, -1, 10, -1, 12]
    # the plant period takes the id of the tick that commanded it
    assert [r[2] for r in recs] == [1] * 6 + [2] * 6 + [3] * 2
    for r in recs:
        assert r[3] < r[4]
        if r[1] >= 0:
            p = recs[r[1]]
            assert p[3] < r[3] and r[4] < p[4]


def test_self_time_is_duration_less_children(clock):
    telemetry.enable()
    with telemetry.span("tick"):             # t0 10
        with telemetry.span("cascade"):      # t0 20
            with telemetry.span("cascade.level"):   # 30 .. 40
                pass
            with telemetry.span("cascade.level"):   # 50 .. 60
                pass
        with telemetry.span("aux"):          # 80 .. 90
            pass
    recs = telemetry.records()
    assert [(r[3], r[4]) for r in recs] == [(10, 100), (20, 70), (30, 40),
                                           (50, 60), (80, 90)]
    own = self_ns(recs)
    assert own == [90 - 50 - 10, 50 - 10 - 10, 10, 10, 10]
    # the self times of a unit sum to its root's duration
    assert sum(own) == recs[0][4] - recs[0][3]


@pytest.mark.parametrize("capacity, spans", [(1, 5), (4, 10), (8, 8)])
def test_store_counts_what_it_drops(monkeypatch, capacity, spans):
    monkeypatch.setattr(telemetry, "CAPACITY", capacity)
    telemetry.enable()
    for _ in range(spans):
        with telemetry.span("tick"):
            telemetry.count("level_qp.launch")
    assert len(telemetry.records()) == min(capacity, spans)
    assert telemetry.dropped() == max(0, spans - capacity)
    # counts by unit for the first CAPACITY units, the total for all
    assert [telemetry.counts(u)["level_qp.launch"]
            for u in range(1, spans + 1)] == [1] * min(capacity, spans) + [
        0] * max(0, spans - capacity)
    assert telemetry.counts()["level_qp.launch"] == spans
    telemetry.reset()
    assert telemetry.records() == [] and telemetry.dropped() == 0


def test_span_open_across_a_reset_is_not_stored():
    telemetry.enable()
    with telemetry.span("tick"):
        telemetry.reset()
        with telemetry.span("stack"):
            pass
    recs = telemetry.records()
    assert [(r[0], r[1]) for r in recs] == [("stack", -1)]


def test_profiler_turns_the_tracer_on_and_carries_the_names():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("tick"):
            with telemetry.span("torque"):
                torch.ones(3).sum()
            telemetry.count("level_qp.launch", 2)
    names = {e.name for e in prof.events()}
    assert {"qppvm::tick", "qppvm::torque"} <= names
    assert [r[0] for r in telemetry.records()] == ["tick", "torque"]
    assert telemetry.counts(1)["level_qp.launch"] == 2
    # and off again once the profiler has stopped
    assert telemetry.span("tick") is telemetry.span("torque")


def test_counts_per_unit_while_on_and_reset_by_name():
    telemetry.count("ns_inverse.launch")            # off: total only
    telemetry.enable()
    for k in (1, 2):
        with telemetry.span("tick"):
            telemetry.count("level_qp.launch", k)
        with telemetry.span("plant"):
            telemetry.count("ns_inverse.launch")
    assert telemetry.counts(1) == {"level_qp.launch": 1,
                                   "ns_inverse.launch": 1}
    assert telemetry.counts(2) == {"level_qp.launch": 2,
                                   "ns_inverse.launch": 1}
    assert telemetry.counts() == {"level_qp.launch": 3,
                                  "ns_inverse.launch": 3}
    telemetry.reset("ns_inverse.launch")
    assert telemetry.counts() == {"level_qp.launch": 3}
    assert telemetry.counts()["ns_inverse.launch"] == 0


def test_threads_lose_no_count_and_nest_apart():
    n_threads, per = 8, 1000
    telemetry.enable()
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait(timeout=30)
        with telemetry.span("plan"):
            for _ in range(per):
                with telemetry.span("rollout.step"):
                    telemetry.count("level_qp.launch")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert telemetry.counts()["level_qp.launch"] == n_threads * per
    recs = telemetry.records()
    roots = [i for i, r in enumerate(recs) if r[0] == "plan"]
    assert sorted(recs[i][2] for i in roots) == list(range(1, n_threads + 1))
    for r in recs:
        if r[0] == "rollout.step":
            assert recs[r[1]][0] == "plan" and recs[r[1]][2] == r[2]
    per_unit = [telemetry.counts(u)["level_qp.launch"]
                for u in range(1, n_threads + 1)]
    assert per_unit == [per] * n_threads


@pytest.fixture(scope="module")
def humanoid():
    torch.manual_seed(0)
    return rt_loop.humanoid_loop(device="cpu")


def assert_one_unit(recs, stages, substeps):
    """A tick and its plant period recorded as unit 1: every layer of the
    tick under ``tick``, the model update's ``stages``, two cascade levels,
    the plant's ``substeps``, the level counts, and self times that sum to
    the roots' durations."""
    names = [r[0] for r in recs]
    assert all(r[4] is not None for r in recs)
    assert [r[2] for r in recs] == [1] * len(recs)
    tick = names.index("tick")
    assert recs[tick][1] == -1
    assert [r[0] for r in recs if r[1] == tick] == list(TICK_CHILDREN)
    mu = names.index("model_update")
    assert [r[0] for r in recs if r[1] == mu] == [
        f"model_update.{s}" for s in stages]
    cascade = names.index("cascade")
    assert [r[0] for r in recs if r[1] == cascade] == ["cascade.level"] * 2
    plant = names.index("plant")
    assert recs[plant][1] == -1
    assert [r[0] for r in recs if r[1] == plant] == [
        "plant.substep"] * substeps
    counted = telemetry.counts(1)
    assert counted["cascade.level"] == 2 and counted["cascade.fallback"] == 0
    own = self_ns(recs)
    roots = sum(r[4] - r[3] for r in recs if r[1] == -1)
    assert sum(own) == roots and min(own) >= 0


def test_forceacc_tick_and_plant_record_every_layer(humanoid):
    loop = humanoid
    robot = loop.robot
    telemetry.enable()
    state = robot.state
    tau, _, aux = loop.plugin.control_loop(state, loop.refs, loop.warm)
    robot.set_reference(tau_ref=tau, q_ref=state.q)
    robot.move()
    telemetry.enable(False)
    assert len(loop.plugin.stack.levels) == 2
    assert_one_unit(telemetry.records(), MODEL_STAGES, robot.substeps)
    assert bool(torch.isfinite(tau).all()) and not aux.solver_failed.any()


def test_qppvm_tick_and_plant_record_every_layer():
    model = zoo.dual_arm(device="cpu")
    plugin = QPPVMPlugin(model, iters=60, solver_opts=dict(
        rho_updates=0, warm_kinv_iters=12, scale_iters=5, pinv_ns_iters=7))
    robot = SimRobot(model, dt=1e-3, substeps=2)
    refs, warm, start = plugin.on_start(robot.state)
    refs = dict(refs, LEFT_ARM=plugin.make_refs(start, 1e-3))
    telemetry.enable()
    state = robot.state
    tau, _, aux = plugin.control_loop(state, refs, warm)
    robot.set_reference(tau_ref=tau, q_ref=state.q)
    robot.move()
    telemetry.enable(False)
    assert_one_unit(telemetry.records(), MODEL_STAGES + ("binv",),
                    robot.substeps)
    assert bool(torch.isfinite(tau).all()) and not aux.solver_failed.any()


def _stack():
    g = np.random.default_rng(3)
    B, n = 2, 6
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    levels = tuple(hierarchy.LevelData(A=t(g.standard_normal((B, k, n))),
                                       b=t(g.standard_normal((B, k))))
                   for k in (3, 3))
    C = t(g.standard_normal((B, 4, n)))
    return hierarchy.StackData(levels=levels, C=C, lC=t(np.full((B, 4), -1.0)),
                               uC=t(np.full((B, 4), 1.0)),
                               lb=t(np.full((B, n), -1e20)),
                               ub=t(np.full((B, n), 1e20)), has_box=False)


@pytest.mark.parametrize("case, levels, fallbacks", [
    ("in_profile", 2, 0), ("polished", 2, 2), ("cold", 2, 2)])
def test_cascade_counters_on_the_kernel_backend(case, levels, fallbacks,
                                                monkeypatch):
    stack = _stack()
    warm = None if case == "cold" else hierarchy.warm_start_init(stack)
    opts = dict(RT, polish_rounds=2) if case == "polished" else RT
    hierarchy.solve(stack, warm, **opts)
    counted = telemetry.counts()
    assert counted["cascade.level"] == levels
    assert counted["cascade.fallback"] == fallbacks
    # the routing rule: a level not counted as a fallback is one the level
    # solver took
    taken, real = [], level_qp.solve_level
    monkeypatch.setattr(level_qp, "solve_level",
                        lambda *a: taken.append(1) or real(*a))
    telemetry.reset()
    hierarchy.solve(stack, warm, **opts)
    assert len(taken) == levels - fallbacks
    assert telemetry.counts()["cascade.fallback"] == fallbacks
