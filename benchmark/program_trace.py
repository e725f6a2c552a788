"""What the readers of the program's own spans and counters share
(``qppvm_tpu_torch/telemetry.py``): the traced units, a layer's host self
time a unit, and a counter a unit.

The program records spans, and counts by unit, only while a profiler
records (or after ``telemetry.enable()``, which the benchmark never
calls), so in a run only ``harness.profile_units`` leaves records: its
``trace["units"]`` units are the last unit ids in the store. A span's self
time is its duration less its children's, read on the host clock under
the profiler, with no synchronize. A program without the module (a
checkout from before it) gives nothing, and each reader returns None.
"""
from __future__ import annotations

from typing import List, Optional


def _telemetry():
    try:
        from qppvm_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry


def _units(trace, telemetry) -> List[int]:
    """The last ``trace["units"]`` unit ids of the program's store, or
    none where it holds fewer (or there is no store)."""
    if telemetry is None:
        return []
    ids = sorted({r[2] for r in telemetry.records() if r[4] is not None})
    n = int(trace["units"])
    return ids[-n:] if n > 0 and len(ids) >= n else []


def layer_ms(trace, layer: str) -> Optional[float]:
    """Host ms a traced unit in the spans named ``layer`` or
    ``layer.<stage>``, each by its self time; None where there are none."""
    telemetry = _telemetry()
    units = set(_units(trace, telemetry))
    if not units:
        return None
    recs = telemetry.records()
    own = [None if r[4] is None else r[4] - r[3] for r in recs]
    for r in recs:
        if r[1] >= 0 and r[4] is not None and own[r[1]] is not None:
            own[r[1]] -= r[4] - r[3]
    mine = [own[i] for i, r in enumerate(recs)
            if r[2] in units and own[i] is not None
            and (r[0] == layer or r[0].startswith(layer + "."))]
    if not mine:
        return None
    return sum(mine) / len(units) * 1e-6


def count_per_unit(trace, name: str) -> Optional[float]:
    """Counter ``name`` a traced unit; None where no unit was traced."""
    telemetry = _telemetry()
    units = _units(trace, telemetry)
    if not units:
        return None
    return sum(telemetry.counts(u)[name] for u in units) / len(units)
