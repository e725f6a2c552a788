"""Spans and counters of the program's host path: the one place where the
program records where a tick's host time goes and what it counted.

A span is a named interval of host time (``time.perf_counter_ns``), nested
under the span open around it on the same thread. ``span(name)`` is a
context manager:

- off (the default), it checks one module flag and whether a
  ``torch.profiler`` is recording, and returns one shared null context: it
  records nothing and enters no ``record_function``;
- it is on after ``enable()``, and whenever a ``torch.profiler`` records.
  Then it stores ``(name, parent, unit, t0_ns, t1_ns)`` in a preallocated
  store of ``CAPACITY`` records (``parent`` is the index of the enclosing
  span's record, -1 for a root); past the capacity it adds to ``dropped()``
  instead. Under a recording profiler it also enters
  ``record_function("qppvm::" + name)``, so the profiler's trace carries
  the program's layer names on its own clock.

Units: a root span named ``tick`` or ``plan`` opens a new unit id; any
other root takes its thread's latest id (the plant period after a tick
belongs to that tick), and a nested span takes its parent's.

``count(name, k)`` always adds ``k`` to the process's total of ``name``
(``counts()``; ``reset(name)`` sets it back to 0). While the tracer is on
it also adds ``k`` to the count of the current unit (``counts(unit)``),
for the first ``CAPACITY`` units that count. Under ``held()`` a thread's
counts go to the counter that ``held`` yields instead, and nowhere else:
a CUDA graph's capture holds back what its body counts, and each replay
adds it again (``runtime/tick_graph.py``), so a count reads the launches
that ran.

The tracer runs no tensor operation, records no CUDA event and reads
nothing from the card: it puts no work on the device, so it costs no
launch and may run inside a CUDA graph capture.

The program's spans (PERF.md, section 3): ``tick`` (root, a control tick:
``ForceAccPlugin._step_impl`` or ``QPPVMPlugin.control_loop``) >
``tick.graph`` (a tick through its CUDA graph: the inputs' copy in, the
capture where there is one, the replay and the outputs' copy out; the
layers below then run only while a graph is captured) >
``model_update`` (> ``model_update.sweep`` where the model-sweep kernel
runs, else ``model_update.fk``, ``.nonlinear`` and ``.bias``; then
``.mass_matrix``, ``.jacobians``, ``.velocities``, ``.com``, ``.binv``),
``stack``, ``cascade`` (> ``cascade.level``), ``torque`` (ForceAcc: qddot,
the wrenches, sum J_c^T f_c and B qddot + h; QPPVM: the failure gate and
tau_qp + h),
``aux`` (the tick's other outputs); ``plant`` (root) > ``plant.substep``;
``plan`` (root, an MPPI update) > ``rollout.step``. Its counters: ``level_qp.launch``,
``ns_inverse.launch``, ``model_sweep.launch``, ``cascade.level``,
``cascade.fallback``, ``model.plain_inverse``, ``model.plain_sweep``,
``logger.host_copy``, ``tick_graph.capture`` (a tick's CUDA graph
captured) and ``tick_graph.replay`` (a tick replayed through one).
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

# records the store holds; later spans are dropped (``dropped()``)
CAPACITY = 1 << 16
# root spans that open a new unit id
UNIT_ROOTS = ("tick", "plan")

_on = False
_profiling = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_thread = threading.local()   # .stack: open spans; .unit: latest unit id

_names: List[Optional[str]] = [None] * CAPACITY
_parents = [-1] * CAPACITY
_units = [0] * CAPACITY
_t0s = [0] * CAPACITY
_t1s: List[Optional[int]] = [None] * CAPACITY
_n = 0            # slots handed out since the last reset
_last_unit = 0    # the last unit id opened, on any thread
_generation = 0   # bumped by reset(): spans open across it are not stored
_totals: Dict[str, int] = {}
_by_unit: Dict[int, Dict[str, int]] = {}


def enable(on: bool = True) -> None:
    """Turn the tracer on (or off) without a profiler."""
    global _on
    _on = bool(on)


def _open_spans() -> list:
    stack = getattr(_thread, "stack", None)
    if stack is None:
        stack = _thread.stack = []
    return stack


class _Span:
    __slots__ = ("name", "slot", "unit", "generation", "rf", "stack")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _n, _last_unit
        stack = self.stack = _open_spans()
        with _lock:
            if stack:
                top = stack[-1]
                parent = top.slot if top.generation == _generation else -1
                self.unit = top.unit
            else:
                parent = -1
                if self.name in UNIT_ROOTS:
                    _last_unit += 1
                    _thread.unit = _last_unit
                self.unit = getattr(_thread, "unit", 0)
            self.slot, self.generation = _n, _generation
            _n += 1
        stack.append(self)
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function("qppvm::" + self.name)
            self.rf.__enter__()
        if self.slot < CAPACITY:
            i = self.slot
            _names[i], _parents[i], _units[i] = self.name, parent, self.unit
            _t1s[i] = None
            _t0s[i] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.slot < CAPACITY and self.generation == _generation:
            _t1s[self.slot] = t1
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.stack.pop()
        return False


def span(name: str):
    """A context manager timing ``name`` while the tracer is on; the
    shared null context while it is off."""
    if _on or _profiling():
        return _Span(name)
    return _NULL


@contextlib.contextmanager
def held():
    """Hold back this thread's counts for the duration: each goes to the
    ``collections.Counter`` yielded, not to the totals or to a unit."""
    outer = getattr(_thread, "held", None)
    _thread.held = collections.Counter()
    try:
        yield _thread.held
    finally:
        _thread.held = outer


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to counter ``name``, and while the tracer is on to the
    current unit's count of it; under ``held()`` to its counter alone."""
    hold = getattr(_thread, "held", None)
    if hold is not None:
        hold[name] += k
        return
    with _lock:
        _totals[name] = _totals.get(name, 0) + k
    if _on or _profiling():
        stack = getattr(_thread, "stack", None)
        unit = stack[-1].unit if stack else getattr(_thread, "unit", 0)
        with _lock:
            per = _by_unit.get(unit)
            if per is None and len(_by_unit) < CAPACITY:
                per = _by_unit[unit] = {}
            if per is not None:   # past CAPACITY units, totals only
                per[name] = per.get(name, 0) + k


def counts(unit: Optional[int] = None) -> collections.Counter:
    """A copy of the counters' totals, or of unit ``unit``'s counts (those
    made while the tracer was on); a name never counted reads 0."""
    with _lock:
        if unit is None:
            return collections.Counter(_totals)
        return collections.Counter(_by_unit.get(unit, ()))


def records() -> List[Tuple[str, int, int, int, Optional[int]]]:
    """The stored spans since the last reset, in the order they opened:
    ``(name, parent, unit, t0_ns, t1_ns)``, ``parent`` the index of the
    enclosing span's record in this list (-1 for a root), ``t1_ns`` None
    for a span still open."""
    with _lock:
        return list(zip(_names, _parents, _units, _t0s,
                        _t1s[:min(_n, CAPACITY)]))


def dropped() -> int:
    """Spans not stored since the last reset: the store was full."""
    return max(0, _n - CAPACITY)


def reset(*names: str) -> None:
    """Set the named counters back to 0; with no name, empty the store,
    the per-unit counts and every counter, and start unit ids again at 0.
    Spans open across a reset are not stored."""
    global _n, _last_unit, _generation
    with _lock:
        if names:
            for name in names:
                _totals.pop(name, None)
            return
        _n, _last_unit = 0, 0
        _generation += 1
        _totals.clear()
        _by_unit.clear()
        _thread.unit = 0
