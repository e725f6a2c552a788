"""The control of ``correct``, on the card: the plain reference computed in
float32 with TF32 products (the precision below the configurations'
float32 with full-precision products), put in the program's place, fails
at least one of each cell's limits, while the program's own answers keep
within all of them. At small batches, on three seeds; the readings the
limits were set from are in PERF.md.

Marked ``cuda``: skipped where there is no card.

    python3 -m pytest benchmark/tests/test_bench_control.py -q -m cuda
"""
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

SMALL = {
    "humanoid-loop-b1": ({"sample_rate": 0.3}, {}),
    "centaur-batch-b1024": ({"batch": 64, "sample_items": 16}, {}),
    "humanoid-mppi-k4096-h16": ({"warmup_units": 1, "sample_rate": 1.0},
                                {"mpc": {"n_samples": 256}}),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 102, 103])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_and_program_passes(cell, seed, card):
    ov, sov = SMALL[cell]
    run = harness.Run(cell, seed, card, ov, sov)
    c = harness.mode(run.workload["mode"]).setup(run)
    c.window(2.0)
    c.release()
    numbers, limits = c.check()
    _, ok = harness.judge(numbers, limits)
    assert ok, numbers
    control, _ = c.check(control=True)
    over = [k for k in limits
            if not (math.isfinite(control[k]) and control[k] <= limits[k])]
    assert over, control
