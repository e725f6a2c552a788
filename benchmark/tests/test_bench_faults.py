"""The comparison that decides ``correct`` catches a broken timed path.

Each test drives a whole run of a cell (``run.measure``: set-up, window,
check) on the CPU at a small size, past the harness's look for a card,
with the program broken underneath, and sees ``correct`` come out false;
and a sound run comes out true. The faults, each where the cell's mode
can have it, are ``benchmark/faults.py``'s; the cells run on one card, so
there is no exchange between cards to leave out.

    python -m pytest benchmark/tests -q
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import faults, harness  # noqa: E402
from benchmark import run as bench_run  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = {
    "humanoid-loop-b1": ({"sample_rate": 0.5}, {}),
    "centaur-batch-b1024": ({"batch": 8, "pool": 2, "sample_items": 4,
                             "sample_rate": 0.5}, {}),
    "humanoid-mppi-k4096-h16": ({"warmup_units": 2, "sample_rate": 1.0},
                                {"mpc": {"n_samples": 8, "horizon": 8}}),
}
FAULTS = [(cell, fault) for cell in sorted(SMALL)
          for fault in faults.BY_MODE[harness.workload(cell)["mode"]]]


def measure(cell, seconds=1.0):
    ov, sov = SMALL[cell]
    result, rows = bench_run.measure(SPEC, cell, 2 ** 31 + 99, seconds, 0,
                                     "cpu", ov, sov)
    return result


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch.setattr)
    result = measure(cell)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    result = measure(cell)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
