"""Mode ``batch``: the ForceAcc tick (``ForceAccPlugin._step_impl``) chained
at batch B, the warm state carried from tick to tick, as a batched
evaluation of many robot states runs it.

Inputs: the standing state of the configuration's robot (the rollout's
static equilibrium), the references and warm state from the plugin's
``on_start`` there, expanded to B; each tick's states are a pool entry, the
standing state with q perturbed by ``q_std`` N(0, 1), drawn from the seed
on the card at set-up (``pool`` batches, used in turn).

Timed: ticks are queued back to back and the window ends with a
synchronize, so every tick counted has finished; ``wbc_solves_per_s`` is B
times the ticks over the window's seconds. A unit is one tick; an item
fails when its solver-failure flag is set or its torques are not finite.

Check: each tick is sampled with probability ``sample_rate`` (the first
always), and at a sampled tick ``sample_items`` items, one from each of as
many equal strata of the batch (index sets drawn at set-up, used in
turn); their input states and carried warm state and their outputs are
copied. After the window the reference recomputes those ticks from the
same inputs and carry, as one batch in float32 with full-precision
products (the configuration's precision), and the largest relative gaps
of tau, qddot, the contact forces and the new carry are compared, with
the gap of on_start's warm solution. The chain: the warm-up ticks, the
first of the chain from on_start, go through the same call; the reference
runs its own chain from its own on_start over the same input states for
the first index set's items, and the largest gaps of tau and of the carry
over that stretch are compared too (``chain_tau``, ``chain_carry``).
"""
from __future__ import annotations

import time

import torch

from benchmark import harness, wbc
from benchmark.reference.mpc.rollout import standing_state

INDEX_SETS = 64


class Batch:
    def __init__(self, run: harness.Run):
        from qppvm_tpu_torch.model import dynamics
        from qppvm_tpu_torch.opt import hierarchy
        from qppvm_tpu_torch.stack.autostack import AutoStack

        w = run.workload
        self.run, self.B = run, int(w["batch"])
        self.model, self.plugin = wbc.program(run)
        rmodel, _ = wbc.reference(run)
        self.links = self.plugin.contact_links
        self.start = wbc.state_dict(standing_state(rmodel, self.links))
        st0 = wbc.as_program_state(self.start)
        refs, warm, _ = self.plugin.on_start(st0)
        self.start_x = wbc.warm_x(warm).clone()
        self.refs = wbc.expand_tree(refs, self.B)
        self.warm = tuple(type(s)(**{f: wbc.expand_tree(getattr(s, f), self.B)
                                     for f in wbc.QP_FIELDS}) for s in warm)
        g = run.generator(1)
        nj = self.model.nj
        self.pool = []
        for _ in range(int(w["pool"])):
            q = st0.q + float(w["q_std"]) * torch.randn(
                self.B, nj, generator=g, device=run.device, dtype=st0.q.dtype)
            fields = {f: wbc.expand_tree(getattr(st0, f), self.B)
                      for f in wbc.STATE_FIELDS}
            fields["q"] = q
            self.pool.append(wbc.as_program_state(fields))
        self.k = 0
        self.rng = run.sampler(2)
        S = int(w["sample_items"])
        self.idx_sets = [torch.tensor(
            [self.rng.randrange(s * self.B // S, (s + 1) * self.B // S)
             for s in range(S)], device=run.device)
            for _ in range(INDEX_SETS)]
        self.records = []
        self.spans = {"model_update": (dynamics, "compute_model_data"),
                      "stack": (AutoStack, "build"),
                      "cascade": (hierarchy, "solve")}
        self.chain = [self._tick(self.idx_sets[0])[2]
                      for _ in range(int(w["warmup_units"]))]
        run.sync()

    def _tick(self, idx=None):
        """One tick: (tau, aux, the record at items ``idx`` or None)."""
        st = self.pool[self.k % len(self.pool)]
        inp = wbc.record_inputs(st, self.warm, idx) if idx is not None \
            else None
        tau, warm_new, aux = self.plugin._step_impl(st, self.refs, self.warm)
        rec = None
        if idx is not None:
            rec = (inp, wbc.record_outputs(tau, warm_new, aux, idx))
        self.warm = warm_new
        self.k += 1
        return tau, aux, rec

    def unit(self):
        self._tick()

    def window(self, seconds: float):
        rate = float(self.run.workload["sample_rate"])
        bad = torch.zeros((), dtype=torch.int64, device=self.run.device)
        n = 0
        self.run.sync()
        t0 = time.perf_counter()
        while True:
            idx = None
            if n == 0 or self.rng.random() < rate:
                idx = self.idx_sets[len(self.records) % INDEX_SETS]
            tau, aux, rec = self._tick(idx)
            if rec is not None:
                self.records.append(rec)
            bad += (aux.solver_failed | ~torch.isfinite(tau).all(-1)).sum()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.run.sync()
        window_s = time.perf_counter() - t0
        return ({"wbc_solves_per_s": self.B * n / window_s,
                 "window_s": window_s}, self.B * n, int(bad), n)

    def flops_per_unit(self):
        return self._count()[0]

    def level_bounds_ms(self):
        return self._count()[1]

    def _count(self):
        if not hasattr(self, "_counted"):
            _, rplug = wbc.reference(self.run, torch.float32, "cpu")

            def make(b):
                st = wbc.as_ref_state({f: wbc.expand_tree(v, b) for f, v in
                                       self.start.items()}, torch.float32,
                                      "cpu")
                refs, warm, _ = rplug.on_start(st)
                return lambda: rplug._step_impl(st, refs, warm)
            self._counted = wbc.count_unit(make, self.B)
        return self._counted

    def release(self):
        del self.plugin, self.model, self.pool, self.warm, self.refs
        torch.cuda.empty_cache()

    def _side(self, inputs, chain_states, dtype, device):
        """One side's on_start warm x, ticks from the recorded inputs, and
        its own chain over the warm-up ticks' input states."""
        _, plugin = wbc.reference(self.run, dtype, device)
        refs, warm = wbc.on_start_ref(plugin, self.start, dtype, device)
        out = wbc.reference_ticks(plugin, refs, inputs, dtype, device)
        chain = wbc.reference_chain(plugin, refs, warm, chain_states, dtype,
                                    device)
        return wbc.warm_x(warm), out, chain

    def check(self, control: bool = False):
        dev, f32 = self.run.device, torch.float32
        inputs = wbc.cat_records([r[0] for r in self.records])
        chain_states = [r[0]["state"] for r in self.chain]
        with harness.tf32(False):
            ref_x, ref, ref_chain = self._side(inputs, chain_states, f32, dev)
        if control:
            with harness.tf32(True):
                start_x, out, chain = self._side(inputs, chain_states, f32,
                                                 dev)
        else:
            out = wbc.cat_records([r[1] for r in self.records])
            chain = [r[1] for r in self.chain]
            start_x = self.start_x
        numbers = dict(wbc.tick_gaps(out, ref),
                       start=harness.rel_gap(start_x, ref_x),
                       **wbc.chain_gaps(chain, ref_chain))
        return numbers, self.run.workload["limits"]


def setup(run: harness.Run) -> Batch:
    return Batch(run)
