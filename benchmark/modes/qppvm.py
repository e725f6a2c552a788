"""Mode ``qppvm``: QPPVMPlugin's real-time loop at batch 1 on a fixed-base
robot, closed over the simulated plant in ``runtime/plugin.py::
ControlLoop``'s tick order for the failure policy "command": read the
robot's state, take the tick's references (the left end effector on the
plugin's moving sinusoid at t = tick index x the control period, every
other reference on_start's), ``QPPVMPlugin.control_loop``, wait for the
torques; then ``SimRobot.set_reference`` and ``SimRobot.move`` (one control
period of the plant) on every tick, failed or not: a failed solve commands
h, gravity compensation. Free-running: the next tick starts once the plant
has stepped.

Inputs: the robot's home configuration, at rest, with the joints perturbed
by ``q_std`` N(0, 1) drawn from the seed on the card; the plugin's on_start
there (both end effectors' poses and the joints captured as references).

Timed: each tick from reading the state to its torques computed, ending
with a synchronize, as ControlLoop times it; the plant's steps lie outside.
``tick_p50_ms`` and ``tick_p95_ms`` are the median and 95th percentile over
every tick of the window. A unit is one tick and its plant period; a tick
fails when its solver-failure flag is set or its torques are not finite.

Check: each tick is sampled with probability ``sample_rate`` (the first
always); a sampled tick's input state, carried warm state, references and
outputs, and the velocity after its plant period, are copied. After the
window the reference (``reference/qppvm_scenario.py``) recomputes every
sampled tick from the same input, carry and references, and every sampled
plant period from the same state and torques, in float32 with
full-precision products, and compares the largest relative gaps of
tau_desired (``tau``), ``tau_qp``, the new carry (``carry``, the last
level's warm x and z: ``tick_outputs`` says why) and the two end
effectors' spring-damper wrenches (``aux``), the largest gap of the
joint velocity after the plant period (``plant``), and the gap of
on_start's warm solution (``start``). ``tau`` and ``tau_qp`` are compared
on the sampled ticks whose torques float32 determines (``determined``);
the others are compared on every sampled tick. The chain: the warm-up ticks, the
first of the loop from on_start, go through the same call; the reference
runs its own closed loop from the same start state and its own on_start,
and the largest gaps of tau and of the joint velocity over that stretch
are compared too (``chain_tau``, ``chain_plant``).

Faults this mode's cells can have (``FAULTS``): ``keep_state`` and
``altered_tau`` on ``QPPVMPlugin._step_impl``, and ``faults.still_plant``.
Their readings at a cell's own size on the card::

    python3 -c "import sys; sys.path.insert(0, '.'); \\
      from benchmark import calibrate, harness; \\
      [calibrate.reading('<cell>', 1, 5, fault=f) \\
       for f in harness.mode('qppvm').FAULTS]"
"""
from __future__ import annotations

import math
import time

import torch

from benchmark import faults, harness, wbc
from benchmark.reference import qppvm_scenario as qscen
from benchmark.reference.model import dynamics as refdyn
from benchmark.reference.model import zoo as refzoo


def _plugin_cls():
    from qppvm_tpu_torch.plugins.qppvm import QPPVMPlugin
    return QPPVMPlugin


def keep_state(patch):
    """The tick hands back the warm state it was given."""
    cls = _plugin_cls()
    orig = cls._step_impl

    def step(self, state, refs, warm):
        tau, _, aux = orig(self, state, refs, warm)
        return tau, warm, aux
    patch(cls, "_step_impl", step)


def altered_tau(patch):
    """The tick's first commanded torque altered by 0.5 N m."""
    cls = _plugin_cls()
    orig = cls._step_impl

    def step(self, state, refs, warm):
        tau, warm_new, aux = orig(self, state, refs, warm)
        bump = torch.zeros_like(tau)
        bump[:, 0] = 0.5
        return tau + bump, warm_new, aux
    patch(cls, "_step_impl", step)


FAULTS = (faults.still_plant, keep_state, altered_tau)
# The largest condition number of level 0's task matrix (both end
# effectors' inertia-weighted impedance rows) at which a tick's torques are
# compared. The sinusoid takes the left end effector's reference out of the
# arm's reach after about 1.4 s of simulated time; the task matrix's
# condition then grows from 3.4 at rest past 20, and the float32 answer
# with it. On an H100, over 3,000 ticks on two seeds, the reference in
# float32 departed from itself in float64 by at most 2.5e-6 of |tau| up to
# a condition of 14 and by up to 1.6e-4 beyond 17, as far as the control
# (TF32 products) did: no float32 limit holds there, and those ticks are
# held by ``carry``, ``aux`` and ``plant`` alone.
COND_MAX = 10.0
# mode ``loop``, whose window, units, FLOP count and release this mode shares
LOOP = harness.mode("loop")


def take_tree(tree, idx):
    """Rows ``idx`` of every tensor of a nested mapping, copied."""
    if isinstance(tree, dict):
        return {k: take_tree(v, idx) for k, v in tree.items()}
    return wbc.take(tree, idx)


def to_tree(tree, dtype, device):
    """Every tensor of a nested mapping on ``device`` in ``dtype``."""
    if isinstance(tree, dict):
        return {k: to_tree(v, dtype, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


def tick_outputs(tau, warm_new, aux) -> dict:
    """The compared outputs of a tick. ``carry`` is the last level's warm
    x and z: z holds x's box rows and the locks, the earlier levels' task
    values A_k x_k. An earlier level's own x is left out: its component in
    the null space of its tasks is pinned only by the proximal term (eps 1
    x 1e-8), so float32 roundoff moves it by as much as TF32 does."""
    last = warm_new[-1]
    return {"tau": tau, "tau_qp": aux.tau_qp,
            "carry": torch.cat([last.x, last.z], dim=-1),
            "aux": torch.cat([aux.ee_left_err, aux.ee_right_err], dim=-1)}


class QPPVMLoop(LOOP.Loop):
    """Mode ``loop``'s window and units over QPPVM's tick, plant and
    reference."""

    def __init__(self, run: harness.Run):
        from qppvm_tpu_torch import config as cfglib
        from qppvm_tpu_torch.model import dynamics
        from qppvm_tpu_torch.opt import hierarchy
        from qppvm_tpu_torch.runtime.robot_interface import SimRobot
        from qppvm_tpu_torch.stack.autostack import AutoStack

        w = run.workload
        self.run = run
        self.period = float(run.cfg.sim.dt)
        self.model, self.plugin = wbc.program(run)
        self.left = self.plugin.ee_left.name
        self.robot = cfglib.build_sim(run.cfg, self.model)
        raw = wbc.raw_scenario(run)
        home = refzoo.by_name(raw["robot"]["zoo"], dtype=torch.float64,
                              device=run.device).home_state()
        start = wbc.state_dict(home)
        g = run.generator(1)
        start["q"] = start["q"] + float(w["q_std"]) * torch.randn(
            start["q"].shape, generator=g, device=run.device,
            dtype=start["q"].dtype)
        self.start = start
        self.robot.state = wbc.as_program_state(start)
        self.refs, self.warm, self.pose = self.plugin.on_start(
            self.robot.state)
        self.start_x = wbc.warm_x(self.warm).clone()
        self.ticks = 0
        self.rng = run.sampler(2)
        self.idx = torch.zeros(1, dtype=torch.int64, device=run.device)
        self.records = []
        self.spans = {"model_update": (dynamics, "compute_model_data"),
                      "stack": (AutoStack, "build"),
                      "cascade": (hierarchy, "solve"),
                      "plant": (SimRobot, "move")}
        self.chain = [self._tick(True)[2]
                      for _ in range(int(w["warmup_units"]))]
        run.sync()

    def _tick(self, sample: bool):
        """One tick in ControlLoop's order: (latency s, bad, the record or
        None)."""
        robot, idx, plugin = self.robot, self.idx, self.plugin
        t = self.ticks * self.period
        t0 = time.perf_counter()
        state = robot.state
        refs = dict(self.refs, **{self.left: plugin.make_refs(self.pose, t)})
        tau, warm_new, aux = plugin.control_loop(state, refs, self.warm)
        self.run.sync()
        lat = time.perf_counter() - t0
        rec = None
        if sample:
            rec = {"in": dict(wbc.record_inputs(state, self.warm, idx),
                              refs=take_tree(refs, idx)),
                   "out": take_tree(tick_outputs(tau, warm_new, aux), idx)}
        self.warm = warm_new
        failed, finite = (bool(v) for v in torch.stack(
            [aux.solver_failed.any(), torch.isfinite(tau).all()]).tolist())
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        self.ticks += 1
        if sample:
            rec["plant"] = robot.state.qd.clone()
        return lat, failed or not finite, rec

    def _reference(self, dtype, device):
        raw = wbc.raw_scenario(self.run)
        model, plugin = qscen.build_plugin(raw, dtype, device)
        return plugin, qscen.Plant(raw, model)

    def _reference_unit(self, plugin, plant, b):
        st = wbc.as_ref_state({f: wbc.expand_tree(v, b) for f, v in
                               self.start.items()}, torch.float32, "cpu")
        refs, warm, pose = plugin.on_start(st)
        refs = dict(refs, **{self.left: plugin.make_refs(pose, 0.0)})

        def unit():
            tau, _, _ = plugin._step_impl(st, refs, warm)
            plant.move(st, tau, st.q)
        return unit

    def _count(self):
        if not hasattr(self, "_counted"):
            plugin, plant = self._reference(torch.float32, "cpu")
            self._counted = wbc.count_unit(
                lambda b: self._reference_unit(plugin, plant, b), 1)
        return self._counted

    def _side(self, inputs, taus, dtype, device):
        """One side's ticks and plant periods from the recorded inputs:
        (on_start's warm x, tick outputs, joint velocities after the
        periods, its own closed loop over the warm-up stretch)."""
        plugin, plant = self._reference(dtype, device)
        st0 = wbc.as_ref_state(self.start, dtype, device)
        refs, warm, pose = plugin.on_start(st0)
        start_x = wbc.warm_x(warm)
        st = wbc.as_ref_state(inputs["state"], dtype, device)
        out = tick_outputs(*plugin._step_impl(
            st, to_tree(inputs["refs"], dtype, device),
            wbc.as_ref_warm(inputs["warm"], dtype, device)))
        u = plant.move(st, taus.to(device=device, dtype=dtype), st.q).qd
        chain, st = [], st0
        for k in range(len(self.chain)):
            refs_k = dict(refs, **{self.left: plugin.make_refs(
                pose, k * self.period)})
            tau, warm, _ = plugin._step_impl(st, refs_k, warm)
            st = plant.move(st, tau, st.q)
            chain.append({"tau": tau, "plant": st.qd})
        return start_x, out, u, chain

    def determined(self, inputs, device) -> torch.Tensor:
        """(rows,) bool: the sampled ticks whose level 0 task matrix, built
        by the reference in float64 from the tick's input state and
        references, has a condition number of at most ``COND_MAX``."""
        plugin, _ = self._reference(torch.float64, device)
        model = plugin.model
        st = wbc.as_ref_state(inputs["state"], torch.float64, device)
        data = refdyn.compute_model_data(model, st, need_binv=True)
        stack = plugin.stack.build(
            model, data, st, to_tree(inputs["refs"], torch.float64, device),
            nx=model.nj, dtype=torch.float64)
        sv = torch.linalg.svdvals(stack.levels[0].A)
        return sv[:, 0] <= COND_MAX * sv[:, -1]

    def check(self, control: bool = False):
        dev, f32 = self.run.device, torch.float32
        inputs = wbc.cat_records([r["in"] for r in self.records])
        taus = torch.cat([r["out"]["tau"] for r in self.records])
        with harness.tf32(False):
            ref_x, ref, ref_u, ref_chain = self._side(inputs, taus, f32, dev)
        if control:
            with harness.tf32(True):
                start_x, out, u, chain = self._side(inputs, taus, f32, dev)
        else:
            start_x = self.start_x
            out = wbc.cat_records([r["out"] for r in self.records])
            u = torch.cat([r["plant"] for r in self.records])
            chain = [{"tau": r["out"]["tau"], "plant": r["plant"]}
                     for r in self.chain]
        rows = self.determined(inputs, dev)
        numbers = {k: (harness.rel_gap(out[k][rows], ref[k][rows])
                       if bool(rows.any()) else math.inf)
                   for k in ("tau", "tau_qp")}
        numbers.update({k: harness.rel_gap(out[k], ref[k])
                        for k in ("carry", "aux")})
        numbers.update(start=harness.rel_gap(start_x, ref_x),
                       plant=harness.rel_gap(u, ref_u),
                       **wbc.chain_gaps(chain, ref_chain, ("tau", "plant")))
        return numbers, self.run.workload["limits"]


def setup(run: harness.Run) -> QPPVMLoop:
    return QPPVMLoop(run)
