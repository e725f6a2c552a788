"""Mode ``loop``: a robot's real-time control loop at batch 1, closed over
the simulated plant in ``runtime/plugin.py::ControlLoop``'s tick order:
read the robot's state, ``ForceAccPlugin.control_loop``, wait for the
torques; then, unless the solve failed, ``SimRobot.set_reference`` and
``SimRobot.move`` (one control period of the plant). Free-running: the
next tick starts once the plant has stepped.

Inputs: the configuration's standing state (feet on the ground) with the
joints perturbed by ``q_std`` N(0, 1) drawn from the seed on the card; the
plugin's on_start there.

Timed: each tick from reading the state to its torques computed, ending
with a synchronize, as ControlLoop times it; the plant's steps lie outside.
``tick_p50_ms`` and ``tick_p95_ms`` are the median and 95th percentile over
every tick of the window. A unit is one tick and its plant period; a tick
fails when its solver-failure flag is set or its torques are not finite.

Check: each tick is sampled with probability ``sample_rate`` (the first
always); a sampled tick's input state, carried warm state, outputs, and the
plant's state and stiction anchors around its period are copied. After the
window the reference recomputes every sampled tick from the same input and
carry, and every sampled plant period from the same state, anchors and
torques, in float32 with full-precision products, and compares the largest
relative gaps of tau, qddot, the contact forces and the new carry, the
largest gap of the generalized velocity after the plant period, and the gap
of on_start's warm solution. The chain: the warm-up ticks, the first of
the loop from on_start, go through the same call; the reference runs its
own closed loop from the same start state, its own on_start and the
plant's anchors at the standing state, and the largest gaps of tau and of
the generalized velocity over that stretch are compared too
(``chain_tau``, ``chain_plant``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness, wbc
from benchmark.reference import scenario as refscen
from benchmark.reference.runtime import robot_interface as ref_ri


class Loop:
    def __init__(self, run: harness.Run):
        from qppvm_tpu_torch import config as cfglib
        from qppvm_tpu_torch.model import dynamics
        from qppvm_tpu_torch.opt import hierarchy
        from qppvm_tpu_torch.runtime.robot_interface import SimRobot
        from qppvm_tpu_torch.stack.autostack import AutoStack

        w = run.workload
        self.run = run
        self.model, self.plugin = wbc.program(run)
        self.robot = cfglib.build_sim(run.cfg, self.model)
        rmodel, _ = wbc.reference(run)
        links = self.plugin.contact_links
        start = wbc.state_dict(ref_ri.standing_state(
            rmodel, links, run.cfg.sim.ground_z))
        self.standing = dict(start)
        g = run.generator(1)
        start["q"] = start["q"] + float(w["q_std"]) * torch.randn(
            start["q"].shape, generator=g, device=run.device,
            dtype=start["q"].dtype)
        self.start = start
        self.robot.state = wbc.as_program_state(start)
        self.refs, self.warm, _ = self.plugin.on_start(self.robot.state)
        self.start_x = wbc.warm_x(self.warm).clone()
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
        robot, idx = self.robot, self.idx
        t0 = time.perf_counter()
        state = robot.state
        tau, warm_new, aux = self.plugin.control_loop(state, self.refs,
                                                      self.warm)
        self.run.sync()
        lat = time.perf_counter() - t0
        if sample:
            rec = {"in": wbc.record_inputs(state, self.warm, idx),
                   "out": wbc.record_outputs(tau, warm_new, aux, idx)}
        self.warm = warm_new
        failed, finite = (bool(v) for v in torch.stack(
            [aux.solver_failed.any(), torch.isfinite(tau).all()]).tolist())
        if not failed:
            anchors = robot._anchors.clone() if sample else None
            robot.set_reference(tau_ref=tau, q_ref=state.q)
            robot.move()
            if sample:
                rec["plant"] = {"anchors": anchors,
                                "after": wbc.state_dict(robot.state)}
        if sample:
            rec["u"] = torch.cat([robot.state.base_vel, robot.state.qd],
                                 dim=-1)
        return lat, failed or not finite, rec if sample else None

    def unit(self):
        self._tick(False)

    def window(self, seconds: float):
        rate = float(self.run.workload["sample_rate"])
        lats, bad = [], 0
        self.run.sync()
        t0 = time.perf_counter()
        while True:
            lat, b, rec = self._tick(not lats or self.rng.random() < rate)
            if rec is not None:
                self.records.append(rec)
            lats.append(lat)
            bad += int(b)
            if time.perf_counter() - t0 >= seconds:
                break
        self.run.sync()
        window_s = time.perf_counter() - t0
        ms = np.asarray(lats) * 1e3
        return ({"tick_p50_ms": float(np.percentile(ms, 50)),
                 "tick_p95_ms": float(np.percentile(ms, 95)),
                 "window_s": window_s}, len(lats), bad, len(lats))

    def _reference_unit(self, plugin, plant, b):
        st = wbc.as_ref_state({f: wbc.expand_tree(v, b) for f, v in
                               self.start.items()}, torch.float32, "cpu")
        refs, warm, _ = plugin.on_start(st)
        anchors = ref_ri.init_anchors(plant.model, st, plant.idx,
                                      plant.offsets)

        def unit():
            tau, _, _ = plugin._step_impl(st, refs, warm)
            plant.move(st, anchors, tau, st.q)
        return unit

    def flops_per_unit(self):
        return self._count()[0]

    def level_bounds_ms(self):
        return self._count()[1]

    def _count(self):
        if not hasattr(self, "_counted"):
            model, plugin = wbc.reference(self.run, torch.float32, "cpu")
            plant = refscen.Plant(wbc.raw_scenario(self.run), model)
            self._counted = wbc.count_unit(
                lambda b: self._reference_unit(plugin, plant, b), 1)
        return self._counted

    def release(self):
        del self.plugin, self.model, self.robot, self.warm, self.refs
        torch.cuda.empty_cache()

    def _side(self, inputs, plant_in, dtype, device):
        """One side's ticks and plant periods from the recorded inputs:
        (on_start's warm x, tick outputs, velocities after the periods,
        its own closed loop over the warm-up stretch)."""
        raw = wbc.raw_scenario(self.run)
        model, plugin = wbc.reference(self.run, dtype, device)
        plant = refscen.Plant(raw, model)
        refs, warm = wbc.on_start_ref(plugin, self.start, dtype, device)
        out = wbc.reference_ticks(plugin, refs, inputs, dtype, device)
        u = None
        if plant_in is not None:
            st = wbc.as_ref_state(plant_in["state"], dtype, device)
            after, _ = plant.move(
                st, plant_in["anchors"].to(device=device, dtype=dtype),
                plant_in["tau"].to(device=device, dtype=dtype), st.q)
            u = torch.cat([after.base_vel, after.qd], dim=-1)
        start_x = wbc.warm_x(warm)
        st = wbc.as_ref_state(self.start, dtype, device)
        anchors = ref_ri.init_anchors(
            model, wbc.as_ref_state(self.standing, dtype, device), plant.idx,
            plant.offsets)
        chain = []
        for _ in self.chain:
            tau, warm, aux = plugin._step_impl(st, refs, warm)
            if not bool(aux.solver_failed.any()):
                st, anchors = plant.move(st, anchors, tau, st.q)
            chain.append({"tau": tau,
                          "plant": torch.cat([st.base_vel, st.qd], dim=-1)})
        return start_x, out, u, chain

    def check(self, control: bool = False):
        dev, f32 = self.run.device, torch.float32
        inputs = wbc.cat_records([r["in"] for r in self.records])
        moved = [r for r in self.records if "plant" in r]
        plant_in = None
        if moved:
            plant_in = {"state": wbc.cat_records(
                [r["in"]["state"] for r in moved]),
                "anchors": torch.cat([r["plant"]["anchors"] for r in moved]),
                "tau": torch.cat([r["out"]["tau"] for r in moved])}
        with harness.tf32(False):
            ref_x, ref, ref_u, ref_chain = self._side(inputs, plant_in, f32,
                                                      dev)
        if control:
            with harness.tf32(True):
                start_x, out, u, chain = self._side(inputs, plant_in, f32,
                                                    dev)
        else:
            start_x = self.start_x
            out = wbc.cat_records([r["out"] for r in self.records])
            chain = [{"tau": r["out"]["tau"], "plant": r["u"]}
                     for r in self.chain]
            u = None
            if moved:
                after = wbc.cat_records([r["plant"]["after"] for r in moved])
                u = torch.cat([after["base_vel"], after["qd"]], dim=-1)
        numbers = dict(wbc.tick_gaps(out, ref),
                       start=harness.rel_gap(start_x, ref_x),
                       plant=(harness.rel_gap(u, ref_u) if moved
                              else float("inf")),
                       **wbc.chain_gaps(chain, ref_chain, ("tau", "plant")))
        return numbers, self.run.workload["limits"]


def setup(run: harness.Run) -> Loop:
    return Loop(run)
