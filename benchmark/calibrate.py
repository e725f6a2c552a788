"""The readings that a cell's limits of ``correct`` are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 5 \
        [--control 3] [--faults 1]

For each seed, in one process: set the cell up at its own size, run its
window for ``--seconds``, and print the compared numbers of the program
against the reference, each judged against the cell's limits; for the
first ``--control`` seeds also the control's, the reference in float32
with TF32 products put in the program's place, on the same recorded
inputs. With ``--faults`` the first that many seeds are run again once
for each fault the cell's mode can have (``faults.py``), planted in the
program, and judged the same way. One JSON line a run.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def reading(workload, seed, seconds, control=False, fault=None):
    import torch
    from benchmark import faults, harness

    t0 = time.perf_counter()
    run = harness.Run(workload, seed, "cuda:0")
    with faults.planted(fault) if fault else contextlib.nullcontext():
        cell = harness.mode(run.workload["mode"]).setup(run)
        metrics, attempted, failed, units = cell.window(seconds)
    cell.release()
    numbers, limits = cell.check()
    line = {"seed": seed, "fault": fault.__name__ if fault else None,
            "metrics": metrics, "attempted": attempted, "failed": failed,
            "units": units, "program": numbers,
            "correct": harness.judge(numbers, limits)[1], "limits": limits}
    if control:
        numbers = cell.check(control=True)[0]
        line["control"] = numbers
        line["control_correct"] = harness.judge(numbers, limits)[1]
    line["seconds"] = time.perf_counter() - t0
    print(json.dumps(line), flush=True)
    del cell
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("calibrate: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from benchmark import faults, harness

    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        reading(args.workload, seed, args.seconds, control=i < args.control)
    mode = harness.workload(args.workload)["mode"]
    for seed in seeds[:args.faults]:
        for fault in faults.BY_MODE[mode]:
            reading(args.workload, seed, args.seconds, fault=fault)


if __name__ == "__main__":
    main()
