"""Plugin lifecycle and the control-loop executor (port of
qppvm_tpu/runtime/plugin.py).

The reference's plugins implement ``on_start`` / ``control_loop`` /
``close`` and register under a name; ``ControlLoop`` drives one against a
robot backend (``runtime/robot_interface.py::SimRobot``, or a hardware
bridge with its interface): sense -> control -> actuate, with trace logging
and latency accounting against the 1 ms budget. The package registers no
plugin itself; callers do.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from qppvm_tpu_torch.runtime.logger import TraceBuffer, get_logger

_PLUGIN_REGISTRY: Dict[str, type] = {}


def register_plugin(name: str):
    """Class decorator registering a plugin under ``name``."""
    def deco(cls):
        _PLUGIN_REGISTRY[name] = cls
        return cls
    return deco


def get_plugin(name: str) -> type:
    return _PLUGIN_REGISTRY[name]


def registered_plugins():
    return dict(_PLUGIN_REGISTRY)


@dataclasses.dataclass
class Handle:
    """What a plugin's initialisation receives: the robot, a config path
    and the shared memory."""

    robot: Any
    config_path: Optional[str] = None
    shared_memory: Any = None


@dataclasses.dataclass
class LoopStats:
    """Tick latencies against the 1 ms budget, and the failure accounting:
    every solver failure is counted; under the "skip_actuation" policy each
    one also skips the command."""

    latencies_s: np.ndarray
    solver_failures: int = 0
    skipped_actuations: int = 0

    @property
    def p50_ms(self) -> float:
        return float(np.percentile(self.latencies_s, 50) * 1e3)

    @property
    def p99_ms(self) -> float:
        return float(np.percentile(self.latencies_s, 99) * 1e3)

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self.latencies_s) * 1e3)

    def deadline_misses(self, budget_s: float = 1e-3) -> int:
        return int(np.sum(self.latencies_s > budget_s))


def _wait(t: torch.Tensor) -> None:
    """Return once the device has computed ``t``."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class ControlLoop:
    """Periodic executor: sense -> control -> actuate, with trace logging
    and latency stats. ``realtime`` False free-runs; True paces each tick to
    ``period``. ``ref_generator(t, {"refs": refs, "start": start})`` gives
    the tick's references from on_start's."""

    def __init__(self, plugin, robot, *, period: float = 1e-3,
                 trace: Optional[TraceBuffer] = None, realtime: bool = False,
                 ref_generator: Optional[Callable[[float, Dict], Dict]] = None):
        self.plugin = plugin
        self.robot = robot
        self.period = period
        self.trace = trace
        self.realtime = realtime
        self.ref_generator = ref_generator
        self.log = get_logger("control_loop")
        self._closed = False

    def close(self) -> None:
        """Call the plugin's ``close`` (where it has one) and flush the
        trace, once: the reference flushes its logger in its close hook."""
        if self._closed:
            return
        self._closed = True
        plugin_close = getattr(self.plugin, "close", None)
        if callable(plugin_close):
            plugin_close()
        if self.trace is not None:
            path = self.trace.flush()
            self.log.info("trace flushed to %s", path)

    def run(self, seconds: float, close_on_exit: bool = True) -> LoopStats:
        """Run the loop for ``seconds``; on exit, normal or by an exception,
        call :meth:`close` unless ``close_on_exit`` is False (a caller that
        runs several segments closes once itself)."""
        try:
            return self._run(seconds)
        finally:
            if close_on_exit:
                self.close()

    def _run(self, seconds: float) -> LoopStats:
        robot, plugin = self.robot, self.plugin
        refs, warm, start_ctx = plugin.on_start(robot.state)
        n = int(round(seconds / self.period))
        lat = np.zeros(n)
        n_failures = n_skipped = 0
        # The plugin's failure policy:
        #  - "skip_actuation" (ForceAcc's): a failed solve commands nothing,
        #    and the drives hold the previous reference;
        #  - "command" (QPPVM's): the plugin's output is commanded on every
        #    tick; QPPVM's is h, gravity compensation, on a failed solve.
        policy = getattr(plugin, "failure_policy", "skip_actuation")
        for i in range(n):
            t = i * self.period
            t0 = time.perf_counter()
            state = robot.state
            refs_t = (self.ref_generator(t, {"refs": refs, "start": start_ctx})
                      if self.ref_generator else refs)
            tau, warm, aux = plugin.control_loop(state, refs_t, warm)
            _wait(tau)
            lat[i] = time.perf_counter() - t0

            failed = bool(aux.solver_failed.any())
            if failed:
                n_failures += 1
                self.log.error("SOLVER ERROR at t=%.3f", t)
            if failed and policy == "skip_actuation":
                n_skipped += 1
            else:
                robot.set_reference(tau_ref=tau, q_ref=state.q)
                robot.move()

            if self.trace is not None:
                self.trace.add("time_matlogger", t)
                self.trace.add("tau_desired", tau)
                self.trace.add("q", state.q)
                self.trace.add("qd", state.qd)
                self.trace.add("solver_failed", float(failed))

            if self.realtime:
                sleep = self.period - (time.perf_counter() - t0)
                if sleep > 0:
                    time.sleep(sleep)
        return LoopStats(latencies_s=lat, solver_failures=n_failures,
                         skipped_actuations=n_skipped)
