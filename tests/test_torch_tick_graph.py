"""The control tick's CUDA graph (qppvm_tpu_torch/runtime/tick_graph.py) on
the CPU, where it never engages: the routing rule, the key of a layout,
the copy of a tick's outputs and of its inputs, the held
counts, the constants the tick builds once per device instead of copying
them from the host every tick, and the settings whose change drops them
and every captured graph. No JAX; a few seconds.

The graph itself, captured and replayed, is held to the eager tick on the
card in tests/test_torch_cuda.py.
"""
import dataclasses
import gc
from types import SimpleNamespace

import warnings

import numpy as np
import pytest
import torch

from qppvm_tpu_torch import device as device_lib
from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import kinematics, zoo
from qppvm_tpu_torch.opt import qp
from qppvm_tpu_torch.plugins.qppvm import QPPVMPlugin
from qppvm_tpu_torch.runtime import tick_graph
from qppvm_tpu_torch.tasks import torque
from qppvm_tpu_torch.tasks.base import AssembleCtx, take_rows
from qppvm_tpu_torch.tasks.force import ForceReg
from qppvm_tpu_torch.tasks.generic import FrictionCone
from qppvm_tpu_torch.opt.variables import Optvar

GRAPH = ("tick_graph.capture", "tick_graph.replay")


@pytest.fixture(scope="module")
def arm():
    """QPPVM on the 7-joint arm on the CPU, its on_start done."""
    model = zoo.arm7(device="cpu")
    plugin = QPPVMPlugin(model, left_ee="arm1_7", right_ee="arm1_4",
                         iters=20, solver_opts=dict(rho_updates=0))
    st = model.home_state()
    refs, warm, _ = plugin.on_start(st)
    return model, plugin, st, refs, warm


def _inputs(B=1, dtype=torch.float32, extra=None):
    st = dict(q=torch.zeros(B, 3, dtype=dtype), qd=torch.ones(B, 3))
    refs = {"task": {"p": torch.zeros(B, 3), "w": torch.ones(B)}}
    if extra is not None:
        refs.update(extra)
    warm = (qp.QPState.zero(B, 4, 5, device="cpu"),)
    return st, refs, warm


@pytest.mark.parametrize("case", ["cpu", "float64", "grad"])
def test_the_graph_takes_no_cpu_float64_or_grad_tick(arm, case):
    """The routing rule refuses each, and the tick runs the body eagerly:
    the same outputs as ``_tick_body``, no capture and no replay."""
    model, plugin, st, refs, warm = arm
    leaves = tick_graph.layout(st, refs, warm)[1]
    if case == "float64":
        leaves = [t.double() for t in leaves]
        want = "float64"
    elif case == "grad":
        leaves = [t.clone().requires_grad_() for t in leaves]
        want = "gradient"
    else:
        want = "CUDA"
    assert want in tick_graph.refusal(leaves)
    telemetry.reset(*GRAPH)
    tau, warm1, aux = plugin.control_loop(st, refs, warm)
    tau2, _, _ = plugin.control_loop(st, refs, warm)
    tau_body, warm_body, _ = plugin._tick_body(st, refs, warm)
    assert torch.equal(tau, tau_body) and torch.equal(tau2, tau_body)
    assert torch.equal(warm1[-1].x, warm_body[-1].x)
    assert telemetry.counts()["tick_graph.replay"] == 0
    assert telemetry.counts()["tick_graph.capture"] == 0
    assert not plugin._graph._graphs and not plugin._graph._seen


def test_the_rule_refuses_tensors_on_two_devices():
    a, b = torch.zeros(2), torch.zeros(2, device="meta")
    assert "CUDA" in tick_graph.refusal([a, b])
    assert tick_graph.refusal([]) == "no tensor"


def test_equal_inputs_give_the_same_key():
    k1, leaves1 = tick_graph.layout(*_inputs())
    k2, leaves2 = tick_graph.layout(*_inputs())
    assert k1 == k2 and hash(k1) == hash(k2)
    assert len(leaves1) == len(leaves2) == 2 + 2 + 5


@pytest.mark.parametrize("change", ["structure", "shape", "dtype", "value",
                                    "key_order"])
def test_each_layout_change_gives_a_new_key(change):
    base = tick_graph.layout(*_inputs())[0]
    if change == "structure":
        st, refs, warm = _inputs(extra={"contacts": {"active":
                                                     torch.ones(1, 4)}})
    elif change == "shape":
        st, refs, warm = _inputs(B=2)
    elif change == "dtype":
        st, refs, warm = _inputs(dtype=torch.float64)
    elif change == "value":
        st, refs, warm = _inputs(extra={"gain": 2.0})
        other = tick_graph.layout(*_inputs(extra={"gain": 3.0}))[0]
        assert tick_graph.layout(st, refs, warm)[0] != other
    else:
        st, refs, warm = _inputs()
        refs = {"task": dict(reversed(list(refs["task"].items())))}
    assert tick_graph.layout(st, refs, warm)[0] != base


def test_an_unhashable_leaf_gives_no_key():
    st, refs, warm = _inputs(extra={"table": np.zeros(3)})
    assert tick_graph.layout(st, refs, warm)[0] is None


def _flat(tree):
    out = []
    tick_graph._flatten(tree, out)
    return out


def test_outputs_unpack_exactly_and_own_their_memory():
    """The kept outputs of mixed dtypes, a 0-dim, an empty and a
    non-contiguous tensor come back equal to what was kept, contiguous
    and in memory of their own at every call."""
    g = torch.Generator().manual_seed(0)
    base = torch.randn(4, 6, generator=g)
    outs = (base[:, 1:4],
            (qp.QPInfo(prim_res=torch.randn(3, generator=g),
                       dual_res=torch.tensor(2.5), obj=torch.zeros(0)),),
            {"failed": torch.tensor([True, False, True]),
             "idx": torch.arange(5), "note": "kept", "none": None})
    graph = tick_graph._Graph([])
    graph.keep(outs)
    got, again = graph.outputs(), graph.outputs()
    flat_a, flat_b = [], []
    tick_graph._flatten(outs, flat_a)
    assert tick_graph._flatten(got, flat_b) == tick_graph._flatten(outs, [])
    for a, b in zip(flat_a, flat_b):
        assert b.dtype == a.dtype and b.shape == a.shape
        assert torch.equal(a, b) and b.is_contiguous()
    for a, b, c in zip(flat_a, flat_b, _flat(again)):
        if a.numel():
            assert len({a.data_ptr(), b.data_ptr(), c.data_ptr()}) == 3
    assert got[2]["note"] == "kept" and got[2]["none"] is None


def test_inputs_copy_into_the_static_buffers():
    """Contiguous, strided and expanded inputs land in the static buffers
    by value; the expanded one's buffer is contiguous."""
    g = torch.Generator().manual_seed(1)
    leaves = [torch.randn(2, 3, generator=g),
              torch.randn(4, 6, generator=g)[:, ::2],
              torch.randn(1, 5, generator=g).expand(3, 5)]
    graph = tick_graph._Graph(leaves)
    assert graph.static[2].is_contiguous()
    fresh = [t + 1.0 for t in leaves[:2]] + [leaves[2] * 2.0]
    graph.copy_in(fresh)
    for s, t in zip(graph.static, fresh):
        assert torch.equal(s, t)


def test_held_counts_go_to_the_hold_alone():
    telemetry.reset("held.test")
    with telemetry.held() as held:
        telemetry.count("held.test", 3)
        with telemetry.held() as inner:
            telemetry.count("held.test")
    telemetry.count("held.test", 2)
    assert held["held.test"] == 3 and inner["held.test"] == 1
    assert telemetry.counts()["held.test"] == 2


def test_friction_cone_bounds_are_made_once():
    opt = Optvar([("f", 3)], device="cpu")
    cone = FrictionCone("cone", opt["f"], mu=0.6, f_min=10.0, f_max=900.0)
    lb, ub = cone.bounds(torch.float32, torch.device("cpu"))
    again = cone.bounds(torch.float32, torch.device("cpu"))
    assert again[0] is lb and again[1] is ub
    assert torch.equal(lb, torch.tensor([-1e20] * 4 + [10.0]))
    assert torch.equal(ub, torch.tensor([0.0] * 4 + [900.0]))
    assert cone.bounds(torch.float64, torch.device("cpu"))[0].dtype == \
        torch.float64


def test_force_reg_targets_are_made_once():
    opt = Optvar([("a", 3), ("b", 6)], device="cpu")
    reg = ForceReg("reg", [opt["a"], opt["b"]], w_tan=0.1, w_norm=0.05)
    ups, row_w = reg.targets(torch.float32, torch.device("cpu"))
    assert reg.targets(torch.float32, torch.device("cpu"))[1] is row_w
    assert [u.tolist() for u in ups] == [[0, 0, 1], [0, 0, 1, 0, 0, 0]]
    assert torch.allclose(row_w, torch.tensor([0.1, 0.1, 0.05, 0.1, 0.1,
                                               0.05, 0.1, 0.1, 0.1]))


def test_torque_gains_convert_once_per_change(arm):
    """A gain held in another dtype converts once, the same tensor across
    ticks, and again after it changes in place; a gain already in place is
    handed back as it is."""
    model, plugin, st, refs, warm = arm
    ctx = AssembleCtx(model=model, data=None, state=st, refs=refs, nx=7,
                      dtype=torch.float64)
    Kc = torch.eye(6) * 700.0
    task = torque.CartesianImpedanceCtrl("t", "arm1_7", stiffness=Kc,
                                         damping=5.0)
    first = torque._gain(task, "Kc", ctx)
    assert first.dtype == torch.float64
    assert torque._gain(task, "Kc", ctx) is first
    Kc.mul_(2.0)
    second = torque._gain(task, "Kc", ctx)
    assert second is not first and float(second[0, 0]) == 1400.0
    assert torque._gain(task, "Dc", ctx) is torque._gain(task, "Dc", ctx)
    assert float(torque._gain(task, "Dc", ctx)) == 5.0
    same = torch.ones(3, dtype=torch.float64)
    task.set_stiffness_damping(same, same)
    assert torque._gain(task, "Kc", ctx) is same


class _Owner:
    """Any object: its constants live in its dict."""


@pytest.mark.parametrize("indices,sliced", [([0, 1, 2], True),
                                            ([3, 4, 5], True),
                                            ([0, 2, 5], False),
                                            ([2, 1], False)])
def test_rows_take_what_a_list_index_takes(indices, sliced):
    t = torch.arange(2 * 6 * 4, dtype=torch.float32).reshape(2, 6, 4)
    owner = _Owner()
    assert torch.equal(take_rows(owner, indices, t), t[:, indices])
    (_, sel), = owner._constants.values()
    assert isinstance(sel, slice) == sliced
    take_rows(owner, indices, t)
    assert owner._constants[("rows", t.device)][1] is sel


def test_frame_offsets_are_made_once():
    """An extra frame's offsets: tensors of the tick's dtype, made once a
    model; a link has none."""
    E = np.eye(3)
    p = np.array([0.0, 0.1, 0.2])
    model = dataclasses.replace(zoo.arm7(device="cpu"),
                                frames=(("tool", 6, E, p),))
    like = torch.zeros(1, dtype=torch.float32)
    li, E_t, p_t = kinematics.frame_spec(model, "tool", like)
    assert li == 6 and E_t.dtype == torch.float32
    assert torch.equal(p_t, torch.as_tensor(p, dtype=torch.float32))
    assert kinematics.frame_spec(model, "tool", like)[2] is p_t
    assert kinematics.frame_spec(model, "tool", like.double())[2].dtype == \
        torch.float64
    assert kinematics.frame_spec(model, "arm1_7", like) is None


def test_assigning_a_setting_drops_its_constants():
    """A cone's bounds follow ``f_min`` and ``f_max`` assigned anew, and
    the assignment counts a change of a setting."""
    opt = Optvar([("f", 3)], device="cpu")
    cone = FrictionCone("cone", opt["f"], mu=0.6, f_min=10.0, f_max=900.0)
    lb, ub = cone.bounds(torch.float32, torch.device("cpu"))
    before = device_lib.generation()
    cone.f_min, cone.f_max = 20.0, 500.0
    assert device_lib.generation() == before + 2
    lb2, ub2 = cone.bounds(torch.float32, torch.device("cpu"))
    assert float(lb2[4]) == 20.0 and float(ub2[4]) == 500.0
    assert float(lb[4]) == 10.0 and float(ub[4]) == 900.0


def test_solver_options_change_only_by_assignment(arm):
    """A plugin's solver options refuse a change in place, which a
    captured tick would not see; assigned anew, they count a change."""
    model, plugin, st, refs, warm = arm
    with pytest.raises(TypeError):
        plugin.solver_opts["rho_updates"] = 1
    before = device_lib.generation()
    plugin.solver_opts = plugin.solver_opts
    assert device_lib.generation() == before + 1


def test_a_plugin_tick_changes_no_setting(arm):
    """Ticks assign no setting: a change would drop the graph every
    tick."""
    model, plugin, st, refs, warm = arm
    plugin._step_impl(st, refs, warm)
    before = device_lib.generation()
    for _ in range(2):
        tau, warm, aux = plugin._step_impl(st, refs, warm)
    assert device_lib.generation() == before


def test_stack_additions_count_a_change(arm):
    model, plugin, st, refs, warm = arm
    stack = plugin.ee_left / plugin.joint_task
    before = device_lib.changes(stack)
    stack << plugin.torque_limits
    after = device_lib.changes(stack)
    assert after != before and after[0][1] == before[0][1] + 1
    assert [i for i, _ in after] == [i for i, _ in before] + [
        id(plugin.torque_limits)]


class _StandInGraph:
    """torch.cuda.CUDAGraph on the CPU: the capture runs the body eagerly,
    a replay does nothing, so the outputs read the capture's values. It
    drives TickGraph's control flow, not a card."""

    replays = 0

    def replay(self):
        _StandInGraph.replays += 1


class _StandInCapture:
    fail = False
    collecting = []              # gc.isenabled() at each capture's start

    def __init__(self, graph, capture_error_mode=None):
        assert capture_error_mode == "thread_local"

    def __enter__(self):
        _StandInCapture.collecting.append(gc.isenabled())
        return self

    def __exit__(self, *exc):
        if _StandInCapture.fail and exc[0] is None:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return False


@pytest.fixture
def stand_in(monkeypatch):
    """TickGraph on CPU tensors with a stand-in for the CUDA graph, and a
    body that counts its calls and a launch."""
    monkeypatch.setattr(tick_graph, "refusal", lambda leaves: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _StandInCapture)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(torch.cuda, "set_stream", lambda s: None)
    _StandInGraph.replays, _StandInCapture.fail = 0, False
    _StandInCapture.collecting = []
    calls = []

    def body(state, refs, warm):
        calls.append(1)
        telemetry.count("stand_in.launch", 2)
        x = state["q"] * 2.0 + refs["task"]["p"]
        return x, (qp.QPInfo(prim_res=x.sum(-1), dual_res=x[:, 0],
                             obj=x[:, 1]),), {"failed": x[:, 0] > 1.0}

    telemetry.reset(*GRAPH, "stand_in.launch")
    return tick_graph.TickGraph(body), calls


def test_stand_in_second_tick_captures_later_ticks_replay(stand_in):
    """Tick 1 of a layout eager, tick 2 captured and replayed, ticks 3 to
    5 replayed; the body runs twice, its counts read once a tick."""
    graph, calls = stand_in
    st, refs, warm = _inputs()
    outs = [graph(st, refs, warm) for _ in range(5)]
    counted = telemetry.counts()
    assert len(calls) == 2 and _StandInGraph.replays == 4
    assert (counted["tick_graph.capture"], counted["tick_graph.replay"]) == \
        (1, 4)
    assert counted["stand_in.launch"] == 2 * 5
    for out in outs:
        assert torch.equal(out[0], outs[0][0]) and out[2]["failed"].dtype == \
            torch.bool
    assert outs[1][0].data_ptr() != outs[2][0].data_ptr()


@pytest.mark.parametrize("fail", [False, True])
def test_stand_in_no_collection_inside_a_capture(stand_in, fail):
    """The garbage collector is off while a tick is captured (a graph it
    freed there would release memory, which a capture forbids) and on
    again after, whether the capture held or failed."""
    graph, calls = stand_in
    _StandInCapture.fail = fail
    assert gc.isenabled()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(2):
            graph(*_inputs())
    assert _StandInCapture.collecting == [False] and gc.isenabled()


def test_stand_in_new_layout_ticks_eagerly_then_captures(stand_in):
    graph, calls = stand_in
    st, refs, warm = _inputs()
    for _ in range(3):
        graph(st, refs, warm)
    wide = _inputs(B=2)
    for _ in range(3):
        graph(*wide)
    graph(st, refs, warm)
    counted = telemetry.counts()
    assert len(calls) == 4
    assert (counted["tick_graph.capture"], counted["tick_graph.replay"]) == \
        (2, 5)


def test_stand_in_failed_capture_leaves_the_layout_eager(stand_in):
    graph, calls = stand_in
    _StandInCapture.fail = True
    st, refs, warm = _inputs()
    with pytest.warns(RuntimeWarning, match="capture failed"):
        for _ in range(4):
            graph(st, refs, warm)
    counted = telemetry.counts()
    assert len(calls) == 5       # eager, the failed capture, then 3 eager
    assert counted["tick_graph.capture"] == counted["tick_graph.replay"] == 0
    assert counted["stand_in.launch"] == 2 * 4


def test_stand_in_keeps_capacity_graphs(stand_in):
    graph, calls = stand_in
    for B in range(1, tick_graph.CAPACITY + 2):
        for _ in range(2):
            graph(*_inputs(B=B))
    assert len(graph._graphs) == tick_graph.CAPACITY
    graph(*_inputs(B=1))         # dropped: captured again, no eager tick
    assert telemetry.counts()["tick_graph.capture"] == tick_graph.CAPACITY + 2


def test_stand_in_dispatch_mode_runs_eagerly(stand_in):
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Seen.ops += 1
            return func(*args, **(kwargs or {}))

    graph, calls = stand_in
    st, refs, warm = _inputs()
    for _ in range(3):
        graph(st, refs, warm)
    with Seen():
        graph(st, refs, warm)
    assert len(calls) == 3 and Seen.ops > 0   # eager, capture, the mode's
    assert telemetry.counts()["tick_graph.replay"] == 2


@pytest.mark.parametrize("robot", ["qppvm_arm", "force_acc_quadruped"])
def test_stand_in_packs_a_plugin_tick(stand_in, robot):
    """A plugin's tick through the stand-in: the captured tick's outputs
    (ForceAccAux or QPPVMAux, the warm QPStates) come back equal
    to ``_tick_body`` on the same inputs, contiguous, in memory of their
    own."""
    from qppvm_tpu_torch.mpc.rollout import standing_state
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin

    if robot == "qppvm_arm":
        model = zoo.arm7(device="cpu")
        plugin = QPPVMPlugin(model, left_ee="arm1_7", right_ee="arm1_4",
                             iters=20, solver_opts=dict(rho_updates=0))
        st = model.home_state()
    else:
        model = zoo.quadruped(device="cpu")
        plugin = ForceAccPlugin(model, iters=12, use_friction_cones=True,
                                solver_opts=dict(rho_updates=0))
        st = standing_state(model, plugin.contact_links)
    refs, warm, _ = plugin.on_start(st)
    plugin._step_impl(st, refs, warm)                 # eager
    got = plugin._step_impl(st, refs, warm)           # captured
    want = plugin._tick_body(st, refs, warm)
    assert telemetry.counts()["tick_graph.capture"] == 1
    assert tick_graph._flatten(got, []) == tick_graph._flatten(want, [])
    a, b = [], []
    tick_graph._flatten(got, a)
    tick_graph._flatten(want, b)
    for x, y in zip(a, b):
        assert torch.equal(x, y) and x.is_contiguous()
    assert type(got[2]) is type(want[2])


def test_stand_in_a_changed_setting_captures_anew(stand_in):
    """A setting of the graph's settings, or of an object they hold,
    assigned between replays drops its graphs: the next tick runs eagerly,
    the one after captures again. A change elsewhere drops nothing."""
    graph, calls = stand_in
    limits = torque.JointLimits()
    owner = torque.TorqueLimits()
    owner.parts = [limits]
    graph = tick_graph.TickGraph(graph.body, settings=owner)
    st, refs, warm = _inputs()
    for _ in range(3):
        graph(st, refs, warm)
    torque.JointLimits().margin = 0.1            # not held by ``owner``
    graph(st, refs, warm)
    assert len(calls) == 2
    limits.margin = 0.1
    for _ in range(3):
        graph(st, refs, warm)
    counted = telemetry.counts()
    assert len(calls) == 4       # eager, capture; eager, capture
    assert (counted["tick_graph.capture"], counted["tick_graph.replay"]) == \
        (2, 5)


def test_stand_in_a_source_changed_in_place_drops_its_graph(stand_in):
    """A graph whose constant came from a host tensor since changed in
    place is dropped: that tick runs eagerly and makes the constant anew,
    the next captures again; the graph kept the source and its version."""
    _, calls = stand_in
    owner = torque.JointLimits()
    gain = torch.ones(3, dtype=torch.float64)
    made = []

    def body(state, refs, warm):
        calls.append(1)
        k = device_lib.constant(owner, "k", lambda: made.append(1) or
                                gain.to(torch.float32), source=gain)
        return state["q"] * k, warm

    graph = tick_graph.TickGraph(body)
    st, refs, warm = _inputs()
    for _ in range(3):
        graph(st, refs, warm)
    (captured,) = graph._graphs.values()
    assert [(t is gain, v) for t, v in captured.sources] == \
        [(True, gain._version)]
    gain.mul_(2.0)
    out = graph(st, refs, warm)
    assert not graph._graphs and torch.equal(out[0], st["q"] * 2.0)
    graph(st, refs, warm)
    counted = telemetry.counts()
    assert len(calls) == 4 and len(made) == 2
    assert (counted["tick_graph.capture"], counted["tick_graph.replay"]) == \
        (2, 3)


def test_stand_in_graph_keeps_what_its_settings_held(stand_in):
    """A captured graph keeps the settings' attributes of its capture: a
    gain assigned anew, and the constant made from the old one, stay
    alive while the graph does."""
    graph, calls = stand_in
    limits = torque.JointLimits(gain_k=torch.ones(3, dtype=torch.float64))
    graph = tick_graph.TickGraph(graph.body, settings=limits)
    st, refs, warm = _inputs()
    ctx = AssembleCtx(model=None, data=None, refs=refs, nx=3,
                      state=SimpleNamespace(q=st["q"]), dtype=torch.float32)
    old, made = limits.k, torque._gain(limits, "k", ctx)
    for _ in range(2):
        graph(st, refs, warm)
    (captured,) = graph._graphs.values()
    limits.set_gains(2.0 * old, limits.d)
    kept = captured.kept[0]
    assert kept["k"] is old
    assert any(v[1] is made for v in kept["_constants"].values())
