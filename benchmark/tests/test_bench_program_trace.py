"""The readers of the program's own spans and counters
(``program_trace.py`` and the metrics that use it) on a hand-built store:
each layer's self time a traced unit, each counter a traced unit, only
the last ``trace["units"]`` units, and nothing where the program has no
``telemetry`` module or the store holds too few units.

    python -m pytest benchmark/tests -q
"""
import collections
import json
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000   # ns


def unit_records(u, first, mu_end):
    """One tick and its plant period of unit ``u``, from index ``first``,
    times in ms: tick 0-100 > model_update 10-``mu_end`` (> fk 12-20),
    stack, cascade 60-80 (> two levels of 5), torque, aux; plant 100-130
    (> two substeps of 10)."""
    t, m, c, p = first, first + 1, first + 4, first + 9
    spans = [("tick", -1, 0, 100), ("model_update", t, 10, mu_end),
             ("model_update.fk", m, 12, 20), ("stack", t, 50, 60),
             ("cascade", t, 60, 80), ("cascade.level", c, 62, 67),
             ("cascade.level", c, 68, 73), ("torque", t, 80, 90),
             ("aux", t, 90, 95), ("plant", -1, 100, 130),
             ("plant.substep", p, 105, 115), ("plant.substep", p, 115, 125)]
    return [(n, par, u, (200 * u + a) * MS, (200 * u + b) * MS)
            for n, par, a, b in spans]


class Store:
    """Three units: unit 1 (untraced) with a model update of 40 ms, units 2
    and 3 (traced) of 30 and 40 ms; 2 and 4 level launches, 2 NS launches a
    traced unit."""

    def __init__(self):
        self.recs = []
        for u, mu_end in ((1, 50), (2, 40), (3, 50)):
            self.recs += unit_records(u, len(self.recs), mu_end)
        self.by_unit = {1: {"level_qp.launch": 10},
                        2: {"level_qp.launch": 2, "ns_inverse.launch": 2},
                        3: {"level_qp.launch": 4, "ns_inverse.launch": 2}}

    def records(self):
        return list(self.recs)

    def counts(self, unit=None):
        return collections.Counter(self.by_unit.get(unit, {}))


@pytest.fixture
def store(monkeypatch):
    from qppvm_tpu_torch import telemetry
    s = Store()
    monkeypatch.setattr(telemetry, "records", s.records)
    monkeypatch.setattr(telemetry, "counts", s.counts)
    return s


# per traced unit, units 2 and 3: model update 30 and 40 (self + fk),
# the tick's own time 100 - 35 - 10 - 20 - 10 - 5 and 100 - 40 - ...
EXPECTED = {"host_model_update_ms": 35.0, "host_stack_ms": 10.0,
            "host_cascade_ms": 20.0, "host_torque_ms": 10.0,
            "host_aux_ms": 5.0, "host_plant_ms": 30.0,
            "host_tick_self_ms": 20.0, "level_launches": 3.0,
            "ns_launches": 2.0}
SPAN_METRICS = [m for m in EXPECTED if m.startswith("host_")]


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_hand_built_store(store, metric):
    assert harness.metric_reader(metric).read({"units": 2}) == pytest.approx(
        EXPECTED[metric], rel=1e-12)


def test_layers_sum_to_the_tick_and_plant(store):
    tick = sum(harness.metric_reader(m).read({"units": 2})
               for m in SPAN_METRICS if m != "host_plant_ms")
    assert tick == pytest.approx(100.0, rel=1e-12)


@pytest.mark.parametrize("units", [3, 1])
def test_only_the_last_units_are_read(store, units):
    read = harness.metric_reader("host_model_update_ms").read
    assert read({"units": units}) == pytest.approx(
        {3: (40 + 30 + 40) / 3, 1: 40.0}[units], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_nothing_without_the_module_or_units(monkeypatch, store, metric):
    read = harness.metric_reader(metric).read
    assert read({"units": 4}) is None            # fewer units than traced
    store.recs, store.by_unit = [], {}
    assert read({"units": 2}) is None            # an empty store
    import qppvm_tpu_torch
    monkeypatch.delattr(qppvm_tpu_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "qppvm_tpu_torch.telemetry", None)
    assert read({"units": 2}) is None            # a program without it


def test_benchmark_json_lists_the_new_readers():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bases = {m["name"].split(".")[0] for m in spec["per_layer"]}
    assert set(EXPECTED) <= bases
