"""Mode ``plan``: receding-horizon sampling MPC (MPPI) over whole-body
rollouts, ``SamplingMPC.update`` from the program's ``config.build_mpc``:
every sample's rollout runs the ForceAcc tick with the rollout's profile
against domain-randomized contact dynamics for the horizon, and the plans
are averaged by exp(-(cost - min) / lambda). After each plan U_nom <-
``shift_plan(U_new)``.

Inputs: the configuration's robot standing in the rollout's static
equilibrium and the plugin's on_start there; each plan's noise and
scenario, drawn by the benchmark from the seed on the card with the
configuration's ``mpc`` parameters, as ``SamplingMPC.sample`` draws them:
U = U_nom + noise_std N(0, 1), pushes push_std N(0, 1) N, mass scales
exp(mass_scale_std N(0, 1)), friction scales 1 - mu_scale_range U(0, 1).

Timed: each plan ends with U_new read on the host; ``plan_ms`` is the
window's seconds over the plans completed. A unit is one plan; its K
rollouts each fail when the rollout's solver-failure flag is set or its
cost is not finite (priced at the failure penalty), and all K when U_new
is not finite.

Check: each plan is sampled with probability ``sample_rate`` (the first
always), its samples, scenario and outputs kept. After the window the
reference runs each sampled plan on the same samples (its own on_start,
float32 with full-precision products) and compares the largest relative
gap of the K costs (failure penalties included, so a failure flag that
differs shows) and the largest gap of U_new, with the gap of on_start's
warm solution. The chain: the warm-up plans, the first of the receding
chain from the initial plan, go through the same call; the reference runs
its own chain from the initial plan over the same noise and scenarios
(U = its own shifted U_new + the noise), and the largest gap of U_new over
that stretch is compared too (``chain_U``).
"""
from __future__ import annotations

import time

import torch

from benchmark import harness, wbc
from benchmark.reference import scenario as refscen
from benchmark.reference.mpc.rollout import standing_state


class Plan:
    def __init__(self, run: harness.Run):
        from qppvm_tpu_torch import config as cfglib
        from qppvm_tpu_torch.model import dynamics
        from qppvm_tpu_torch.opt import hierarchy
        from qppvm_tpu_torch.stack.autostack import AutoStack

        w = run.workload
        self.run = run
        self.model, self.plugin = wbc.program(run)
        self.mpc = cfglib.build_mpc(run.cfg, self.plugin)
        m = run.cfg.mpc
        self.K, self.H, self.nu = m.n_samples, m.horizon, self.mpc.mppi.nu
        self.penalty = self.mpc.mppi.fail_penalty
        rmodel, _ = wbc.reference(run)
        self.start = wbc.state_dict(standing_state(
            rmodel, self.plugin.contact_links))
        self.st0 = wbc.as_program_state(self.start)
        self.refs, self.warm, _ = self.plugin.on_start(self.st0)
        self.start_x = wbc.warm_x(self.warm).clone()
        self.U_nom = self.mpc.init_plan()
        self.g = run.generator(1)
        self.rng = run.sampler(2)
        self.records = []
        self.spans = {"model_update": (dynamics, "compute_model_data"),
                      "stack": (AutoStack, "build"),
                      "cascade": (hierarchy, "solve"),
                      "plant": (dynamics, "forward_dynamics")}
        self.chain = [self._plan(True)[2]
                      for _ in range(int(w["warmup_units"]))]
        run.sync()

    def _draw(self):
        m, K, H = self.run.cfg.mpc, self.K, self.H
        kw = dict(generator=self.g, device=self.run.device,
                  dtype=torch.float32)
        noise = m.noise_std * torch.randn(K, H, self.nu, **kw)
        scen = {"push": m.push_std * torch.randn(K, H, 3, **kw),
                "mass_scale": torch.exp(m.mass_scale_std
                                        * torch.randn(K, **kw)),
                "mu_scale": 1.0 - m.mu_scale_range * torch.rand(K, **kw)}
        return noise, scen

    def _plan(self, sample: bool):
        """One plan: (failed rollouts, U_new finite, the record or None)."""
        noise, scen = self._draw()
        U = self.U_nom[None] + noise
        U_new, info = self.mpc.update(self.st0, self.refs, self.warm, U, scen)
        U_host = U_new.cpu()
        costs, failed = info["costs"], info["solver_failed"]
        bad = (failed | ~(costs < self.penalty)).sum()
        rec = None
        if sample:
            rec = {"U": U, "noise": noise, "scen": scen, "U_new": U_host,
                   "costs": costs.clone()}
        self.U_nom = self.mpc.shift_plan(U_new)
        return bad, bool(torch.isfinite(U_host).all()), rec

    def unit(self):
        self._plan(False)

    def window(self, seconds: float):
        rate = float(self.run.workload["sample_rate"])
        plans = []
        self.run.sync()
        t0 = time.perf_counter()
        while True:
            bad, finite, rec = self._plan(not plans
                                          or self.rng.random() < rate)
            if rec is not None:
                self.records.append(rec)
            plans.append((bad, finite))
            if time.perf_counter() - t0 >= seconds:
                break
        self.run.sync()
        window_s = time.perf_counter() - t0
        n = len(plans)
        failed = sum(int(bad) if finite else self.K for bad, finite in plans)
        return ({"plan_ms": window_s / n * 1e3, "window_s": window_s},
                self.K * n, failed, n)

    def _reference_mpc(self, dtype, device):
        raw = wbc.raw_scenario(self.run)
        _, plugin = wbc.reference(self.run, dtype, device)
        refs, warm = wbc.on_start_ref(plugin, self.start, dtype, device)
        return refscen.build_mpc(raw, plugin), refs, warm

    def flops_per_unit(self):
        return self._count()[0]

    def level_bounds_ms(self):
        return self._count()[1]

    def _count(self):
        if not hasattr(self, "_counted"):
            mpc, refs, warm = self._reference_mpc(torch.float32, "cpu")
            st = wbc.as_ref_state(self.start, torch.float32, "cpu")
            rec = self.records[0]

            def make(b):
                U = rec["U"][:b].cpu()
                scen = {k: v[:b].cpu() for k, v in rec["scen"].items()}
                return lambda: mpc.update(st, refs, warm, U, scen)
            self._counted = wbc.count_unit(make, self.K)
        return self._counted

    def release(self):
        del self.mpc, self.plugin, self.model, self.warm, self.refs
        torch.cuda.empty_cache()

    def _side(self, dtype, device):
        """One side's on_start warm x, its plans on the recorded samples,
        and its own receding chain over the warm-up plans' draws."""
        mpc, refs, warm = self._reference_mpc(dtype, device)
        st = wbc.as_ref_state(self.start, dtype, device)
        outs = []
        for rec in self.records:
            scen = {k: v.to(dtype) for k, v in rec["scen"].items()}
            U_new, info = mpc.update(st, refs, warm, rec["U"].to(dtype), scen)
            outs.append((U_new, info["costs"]))
        chain, U_nom = [], torch.zeros(self.H, self.nu, dtype=dtype,
                                       device=device)
        for rec in self.chain:
            scen = {k: v.to(dtype) for k, v in rec["scen"].items()}
            U_new, _ = mpc.update(st, refs, warm,
                                  U_nom[None] + rec["noise"].to(dtype), scen)
            chain.append(U_new)
            U_nom = mpc.shift_plan(U_new)
        return wbc.warm_x(warm), outs, chain

    def check(self, control: bool = False):
        dev, f32 = self.run.device, torch.float32
        with harness.tf32(False):
            ref_x, ref, ref_chain = self._side(f32, dev)
        if control:
            with harness.tf32(True):
                start_x, out, chain = self._side(f32, dev)
        else:
            start_x = self.start_x
            out = [(r["U_new"], r["costs"]) for r in self.records]
            chain = [r["U_new"] for r in self.chain]
        cost, u = 0.0, 0.0
        for (U_o, c_o), (U_r, c_r) in zip(out, ref):
            cost = max(cost, harness.rel_gap(c_o[:, None], c_r[:, None]))
            u = max(u, harness.rel_gap(U_o[None], U_r[None]))
        numbers = {"cost": cost, "U_new": u,
                   "start": harness.rel_gap(start_x, ref_x),
                   "chain_U": max(harness.rel_gap(U_o[None], U_r[None])
                                  for U_o, U_r in zip(chain, ref_chain))}
        return numbers, self.run.workload["limits"]


def setup(run: harness.Run) -> Plan:
    return Plan(run)
