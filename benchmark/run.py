"""Run one cell of the benchmark of ``qppvm_tpu_torch`` once, on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: loads the cell (``workloads/<cell>.json``),
sets the program up and warms up the cell's shapes, runs the timed window
for ``--seconds``, and with ``--trace 1`` then traces a few more units for
the per-layer metrics. After the window it reads the peak memory, drops the
program's state and holds the program's sampled answers to the plain
reference (``reference/``). Prints each compared number beside its limit
as the last lines of standard error, and one JSON object as the last line
of standard output. Exits non-zero, printing no result, without a CUDA
card, when the program is not the checkout's own, or when JAX or the JAX
package were loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def fail(code: int, msg: str):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def applies(metric: dict, cell: str, reported=()) -> bool:
    """Whether a metric of BENCHMARK.json is reported by ``cell``: it lists
    the cell, or lists no cells and (per-layer) moves a metric the cell
    reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec_path = ROOT / "BENCHMARK.json"
    if not spec_path.exists():
        fail(2, f"no {spec_path}")
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        fail(2, f"no cell {args.workload!r} in BENCHMARK.json")
    chips = cells[args.workload]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(3, f"needs {chips} CUDA card(s), found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    sys.path.insert(0, str(ROOT))
    try:
        import qppvm_tpu_torch
    except ImportError as e:
        fail(3, f"the program does not import: {e}")
    if Path(qppvm_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail(3, "qppvm_tpu_torch is not the checkout's own")
    torch.set_num_threads(4)
    result, rows = measure(spec, args.workload, args.seed, args.seconds,
                           args.trace, "cuda:0")
    from benchmark import harness
    harness.print_checks(rows)
    print(json.dumps(result))


def measure(spec: dict, name: str, seed: int, seconds: float, trace: int,
            device, overrides=None, scenario_overrides=None):
    """One run of cell ``name`` on ``device``: (the result object, the
    compared numbers as (name, value, limit)). ``overrides`` replace
    workload parameters and ``scenario_overrides`` configuration values
    (the benchmark's own tests run it small on the CPU with them)."""
    import torch
    from benchmark import harness

    run = harness.Run(name, seed, device, overrides, scenario_overrides)
    cell = harness.mode(run.workload["mode"]).setup(run)
    run.sync()
    setup_s = time.perf_counter() - T_START

    metrics, attempted, failed, units = cell.window(seconds)
    run.sync()
    found = harness.forbidden_modules()
    if found:
        fail(4, f"modules loaded that the port must not load: {found}")

    e2e = [m for m in spec["end_to_end"] if applies(m, name)]
    values = dict(metrics, setup_s=setup_s)
    missing = [m["name"] for m in e2e if m["name"] not in values]
    if missing:
        fail(5, f"cell {name} does not measure {missing}")
    out, extra, breakdown = {}, {}, None
    if trace == 0:
        out = {m["name"]: harness.metric_entry(values[m["name"]], m["unit"])
               for m in e2e}
    else:
        w = run.workload
        prof = harness.profile_units(cell, run, w["profile_units"])
        spans = harness.span_times(cell, run, w["span_units"])
        tr = dict(prof, spans_ms=spans, window=metrics,
                  unit_s=metrics["window_s"] / units,
                  flops_per_unit=cell.flops_per_unit(),
                  level_bounds_ms=cell.level_bounds_ms())
        reported = {m["name"] for m in e2e}
        for m in spec["per_layer"]:
            if not applies(m, name, reported):
                continue
            v = harness.metric_reader(m["name"]).read(tr)
            if v is not None:
                out[m["name"]] = harness.metric_entry(v, m["unit"])
        extra = {"busy_s": prof["busy_s"], "window_s": prof["window_s"]}
        breakdown = prof["breakdown"]
        found = harness.forbidden_modules()
        if found:
            fail(4, f"modules loaded that the port must not load: {found}")

    if run.device.type == "cuda":
        device_info = dict(harness.card(),
                           memory_peak_bytes=torch.cuda.max_memory_allocated(),
                           **extra)
    else:
        device_info = dict(platform="cpu", kind="cpu", count=1,
                           memory_peak_bytes=0, **extra)
    cell.release()
    rows, ok = harness.judge(*cell.check())
    result = {"correct": ok, "attempted": attempted, "failed": failed,
              "metrics": out, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result, rows


if __name__ == "__main__":
    main()
