"""What the ForceAcc modes share: the program and the reference built from
one scenario, the inputs the benchmark makes for both, the records a
sampled tick leaves, and the comparison of ticks with the reference.

The program is built by its own builders (``qppvm_tpu_torch.config``); the
reference by ``reference/scenario.py`` from the same file. The benchmark
makes the start states with the reference's functions in float64 and hands
both sides the same values.
"""
from __future__ import annotations

import functools
from typing import Dict, List

import torch
import yaml

from benchmark import accounting, harness
from benchmark.reference.model.robot import RobotState as RefState
from benchmark.reference.opt import level_qp as ref_level_qp
from benchmark.reference.opt.qp import QPState as RefQP
from benchmark.reference import scenario as refscen

STATE_FIELDS = ("q", "qd", "base_rot", "base_pos", "base_vel")
QP_FIELDS = ("x", "z", "y", "Kinv", "rho_scale")


def raw_scenario(run: harness.Run) -> dict:
    """The configuration file as a mapping, with the run's overrides."""
    with open(harness.BENCH / "configs" / f"{run.workload['config']}.yaml") as f:
        raw = yaml.safe_load(f)
    for section, values in run.scenario_overrides.items():
        raw[section].update(values)
    return raw


def program(run: harness.Run):
    """(model, plugin) through the program's own builders."""
    from qppvm_tpu_torch import config as cfglib
    model = cfglib.build_model(run.cfg, run.device)
    return model, cfglib.build_plugin(run.cfg, model)


def reference(run: harness.Run, dtype=torch.float64, device=None):
    return refscen.build_plugin(raw_scenario(run), dtype=dtype,
                                device=device or run.device)


def state_dict(state) -> Dict[str, torch.Tensor]:
    return {f: getattr(state, f) for f in STATE_FIELDS}


def as_program_state(fields: Dict[str, torch.Tensor], dtype=torch.float32):
    from qppvm_tpu_torch.model.robot import RobotState
    return RobotState(**{f: fields[f].to(dtype).contiguous()
                         for f in STATE_FIELDS})


def as_ref_state(fields: Dict[str, torch.Tensor], dtype, device):
    return RefState(**{f: fields[f].to(device=device, dtype=dtype)
                       for f in STATE_FIELDS})


def as_ref_warm(levels: List[Dict[str, torch.Tensor]], dtype, device):
    return tuple(RefQP(**{f: lv[f].to(device=device, dtype=dtype)
                          for f in QP_FIELDS}) for lv in levels)


def take(tensor, idx):
    """Rows ``idx`` of ``tensor``, copied (the program may reuse it)."""
    return tensor.index_select(0, idx).clone()


def record_inputs(state, warm, idx) -> dict:
    return {"state": {f: take(getattr(state, f), idx) for f in STATE_FIELDS},
            "warm": [{f: take(getattr(s, f), idx) for f in QP_FIELDS}
                     for s in warm]}


def record_outputs(tau, warm_new, aux, idx) -> dict:
    return {"tau": take(tau, idx), "qddot": take(aux.qddot, idx),
            "wrenches": take(aux.wrenches, idx),
            "carry": torch.cat([take(s.x, idx) for s in warm_new], dim=-1)}


def cat_records(records: List[dict]) -> dict:
    """Records of several ticks as one batch."""
    def cat(items):
        first = items[0]
        if isinstance(first, dict):
            return {k: cat([it[k] for it in items]) for k in first}
        if isinstance(first, list):
            return [cat([it[i] for it in items]) for i in range(len(first))]
        return torch.cat(items, dim=0)
    return cat(records)


def reference_ticks(ref_plugin, refs, inputs: dict, dtype, device) -> dict:
    """The reference's tick from each recorded input state and carry, as
    one batch."""
    st = as_ref_state(inputs["state"], dtype, device)
    warm = as_ref_warm(inputs["warm"], dtype, device)
    B = st.q.shape[0]
    refs_b = expand_tree(refs, B)
    tau, warm_new, aux = ref_plugin._step_impl(st, refs_b, warm)
    return {"tau": tau, "qddot": aux.qddot, "wrenches": aux.wrenches,
            "carry": torch.cat([s.x for s in warm_new], dim=-1)}


def reference_chain(ref_plugin, refs, warm, states: List[dict], dtype,
                    device) -> List[dict]:
    """The reference's own chain of ticks from ``warm`` (its on_start's,
    batch 1) over the input states ``states``, the warm state carried from
    tick to tick: each tick's tau and new carry."""
    out = []
    for fields in states:
        st = as_ref_state(fields, dtype, device)
        B = st.q.shape[0]
        warm = tuple(RefQP(**{f: expand_tree(getattr(s, f), B)
                              for f in QP_FIELDS}) for s in warm)
        tau, warm, _ = ref_plugin._step_impl(st, expand_tree(refs, B), warm)
        out.append({"tau": tau, "carry": warm_x(warm)})
    return out


def chain_gaps(out: List[dict], ref: List[dict],
               keys=("tau", "carry")) -> Dict[str, float]:
    """The largest gap of each of ``keys`` over a chain of ticks."""
    return {f"chain_{k}": max(harness.rel_gap(o[k], r[k])
                              for o, r in zip(out, ref))
            for k in keys}


def expand_tree(tree, B: int):
    if isinstance(tree, dict):
        return {k: expand_tree(v, B) for k, v in tree.items()}
    return tree.expand(B, *tree.shape[1:]).contiguous()


def tick_gaps(out: dict, ref: dict) -> Dict[str, float]:
    """Each tick quantity's largest relative gap over the sampled items
    (``harness.rel_gap``: N m, m/s^2 or rad/s^2, N; floors of 1)."""
    return {k: harness.rel_gap(out[k], ref[k]) for k in
            ("tau", "qddot", "wrenches", "carry")}


def warm_x(warm) -> torch.Tensor:
    return torch.cat([s.x for s in warm], dim=-1)


def on_start_ref(ref_plugin, start_fields, dtype, device):
    """The reference's on_start from the start state: (refs, warm)."""
    refs, warm, _ = ref_plugin.on_start(as_ref_state(start_fields, dtype,
                                                     device))
    return refs, warm


class LevelLog:
    """The level solves of a reference call: (cfg, n, m) of each."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._orig = ref_level_qp.solve_level

        @functools.wraps(self._orig)
        def logged(cfg, P, q, A, *rest):
            self.calls.append((cfg, P.shape[-1], A.shape[1]))
            return self._orig(cfg, P, q, A, *rest)
        ref_level_qp.solve_level = logged
        return self

    def __exit__(self, *exc):
        ref_level_qp.solve_level = self._orig


def count_unit(make, batch: int):
    """(FLOPs, level-kernel bound ms) of a unit at ``batch`` items.
    ``make(b)`` gives a call of the reference's unit at b items. The count
    is affine in the batch (a few products act on the model's constants
    once a tick), so it is taken at 1 and 2 items and extended; each level
    solve's bound is taken at the full batch."""
    with LevelLog() as log:
        one = accounting.count_flops(make(1))
    two = accounting.count_flops(make(2))
    bound = sum(accounting.bound_ms(*accounting.level_qp_cost(
        cfg, batch, n, m))[0] for cfg, n, m in log.calls)
    return one + (batch - 1) * (two - one), bound


