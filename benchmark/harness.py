"""What every cell of the benchmark shares: finding a cell's files by name,
a run's seeded draws, tracing a few units, the comparison with the plain
reference, and the result line.

A cell is ``workloads/<cell>.json``: its configuration's name (the scenario
``configs/<config>.yaml`` that the program's own loader reads), its mode
(``modes/<mode>.py``), the traffic's parameters and the limits of the
comparison. A mode's ``setup(run)`` returns an object with:

- ``window(seconds)`` -> ``(metrics, attempted, failed, units)``: the timed
  units, each carried from the last, until ``seconds`` have passed;
- ``unit()``: one more unit, as the window runs it, for the traced passes;
- ``spans``: ``{span: (module, function name)}`` of the program's layers
  that the traced run times (host clock plus synchronize) and labels;
- ``flops_per_unit()`` and ``level_bounds_ms()``: the work of one unit,
  counted on the plain reference (``accounting.py``);
- ``release()``: drop the program's state once the window has closed;
- ``check(control=False)`` -> ``(numbers, limits)``: the program's sampled
  answers against the reference (float32, TF32 off), each number a gap;
  with ``control`` the reference in float32 with TF32 products put in the
  program's place.

Per-layer metrics are ``metrics/<name>.py`` (the part of the metric's name
before its first dot), each with ``read(trace) -> float or None``.
"""
from __future__ import annotations

import contextlib
import functools
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path
from typing import Dict, List

import torch

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qppvm_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in file ``path``, imported under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name: str) -> dict:
    return load_json(BENCH / "workloads" / f"{name}.json")


def scenario(config: str):
    """The configuration as the program loads it (``config.load_scenario``)."""
    from qppvm_tpu_torch import config as cfglib
    return cfglib.load_scenario(str(BENCH / "configs" / f"{config}.yaml"))


def mode(name: str):
    return load_module(BENCH / "modes" / f"{name}.py", f"bench_mode_{name}")


def metric_reader(metric: str):
    base = metric.split(".")[0]
    return load_module(BENCH / "metrics" / f"{base}.py", f"bench_metric_{base}")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``qppvm_tpu_torch`` is not ``qppvm_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class Run:
    """One run of one cell: its arguments, its workload and configuration,
    and the device it measures."""

    def __init__(self, cell: str, seed: int, device, overrides=None,
                 scenario_overrides=None):
        self.cell = cell
        self.seed = int(seed)
        self.device = torch.device(device)
        self.workload = dict(workload(cell), **(overrides or {}))
        self.cfg = scenario(self.workload["config"])
        self.scenario_overrides = scenario_overrides or {}
        for section, values in self.scenario_overrides.items():
            for k, v in values.items():
                setattr(getattr(self.cfg, section), k, v)

    def generator(self, stream: int) -> torch.Generator:
        """A generator on the run's device seeded from the run's seed and a
        stream number, so that each kind of draw has its own sequence."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + stream) % (2 ** 63 - 1))
        return g

    def sampler(self, stream: int):
        """A host-side random source for choosing what the check samples."""
        return random.Random(self.seed * 7919 + stream)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


# --- comparison -----------------------------------------------------------

def rel_gap(a, r, floor: float = 1.0) -> float:
    """Largest gap of ``a`` from the reference ``r`` over the items of a
    batch, each item's gap ``max |a - r|`` over ``max(max |r|, floor)``;
    inf where ``a`` is not finite."""
    a = a.to(torch.float64).reshape(a.shape[0], -1)
    r = r.to(torch.float64).reshape(r.shape[0], -1).to(a.device)
    if not bool(torch.isfinite(a).all()):
        return math.inf
    scale = torch.clamp(r.abs().amax(dim=1), min=floor)
    return float(((a - r).abs().amax(dim=1) / scale).max())


@contextlib.contextmanager
def tf32(enabled: bool):
    """float32 products in TF32 (the control's precision) or in full
    float32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """``[(name, value, limit)]`` for every limit, and whether each value
    lies within its limit (a number that is not finite never does)."""
    rows = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return rows, ok


# --- tracing --------------------------------------------------------------

@contextlib.contextmanager
def patched(targets: Dict[str, tuple], wrap):
    """Replace each ``module.function`` of ``targets`` by ``wrap(span,
    function)`` for the duration."""
    saved = []
    try:
        for span, (mod, attr) in targets.items():
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, wrap(span, fn))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _labelled(span, fn):
    @functools.wraps(fn)
    def inner(*a, **k):
        with torch.profiler.record_function(f"bench::{span}"):
            return fn(*a, **k)
    return inner


def span_times(cell, run: Run, units: int) -> Dict[str, float]:
    """Host-clock ms a unit in each of ``cell.spans``, each call wrapped in
    synchronizes, over ``units`` units (outermost calls only)."""
    totals = {s: 0.0 for s in cell.spans}
    depth = {s: 0 for s in cell.spans}

    def timed(span, fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            if depth[span]:
                return fn(*a, **k)
            depth[span] += 1
            run.sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                run.sync()
                totals[span] += time.perf_counter() - t0
                depth[span] -= 1
        return inner

    with patched(cell.spans, timed):
        for _ in range(units):
            cell.unit()
        run.sync()
    return {s: v / units * 1e3 for s, v in totals.items()}


def _union_us(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between them as (start, end)."""
    busy, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy, gaps


def profile_units(cell, run: Run, units: int) -> dict:
    """``units`` units under torch.profiler, the program's layers labelled:
    device busy seconds (the union of device events) and the traced
    window's seconds, launch API calls, device time by kernel name, and the
    breakdown (device operations by time; idle gaps by the innermost
    benchmark label, else host operator, running at the gap's middle)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run.sync()
    with patched(cell.spans, _labelled):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(units):
                cell.unit()
            run.sync()
            window_s = time.perf_counter() - t0
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    busy_us, gaps = _union_us([(e.time_range.start, e.time_range.end)
                               for e in dev])
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + (e.time_range.end - e.time_range.start) * 1e-6)
    launches = sum(1 for e in host if "LaunchKernel" in e.name)

    def label(t):
        best, best_len = None, math.inf
        for e in host:
            if e.time_range.start <= t <= e.time_range.end:
                n = e.time_range.end - e.time_range.start
                key = (not e.name.startswith("bench::"), n)
                if best is None or key < best_len:
                    best, best_len = e.name, key
        return best or "host"

    longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
    idle = [[label(0.5 * (s + e)).replace("bench::", ""), (e - s) * 1e-6]
            for s, e in longest]
    ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": window_s, "units": units,
            "launches": launches, "kernel_s": by_name,
            "breakdown": {"device_ops": [[k, v] for k, v in ops],
                          "idle_gaps": idle}}


# --- the result -----------------------------------------------------------

def card() -> dict:
    props = torch.cuda.get_device_properties(0)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_total_bytes": props.total_memory}


def print_checks(rows) -> None:
    for name, value, limit in rows:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)


def metric_entry(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}
