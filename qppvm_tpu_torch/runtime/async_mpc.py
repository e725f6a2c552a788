"""Asynchronous plan/act pipeline: act on plan k while plan k+1 computes
(port of qppvm_tpu/runtime/async_mpc.py).

A sampling-MPC plan step takes hundreds of ms while the WBC tick runs at
1 kHz, so a deployed loop cannot block on the planner. The reference gets
its pipeline from JAX's asynchronous dispatch. Here a plan's host dispatch
is itself hundreds of ms of eager launches, so each plan runs on one
worker thread, on a CUDA stream of its own, and ends by recording an
event. ``tick`` commits a plan only when the worker's future is done and
that event has completed: it never blocks.

Cross-stream safety. The inputs a plan reads are cloned on the tick's
stream and the side stream waits on an event recorded after the clones;
tensors that cross streams are marked with ``record_stream`` so the
caching allocator does not hand their memory out while the other stream
still uses it; the tick's stream waits on the plan's event before it reads
the committed plan. Both host threads share the interpreter lock, so a
plan in flight slows the tick's host work.

The plan is consumed time-shifted: a plan snapshotted at tick s maps
control row (tick - s) // ticks_per_step to the current tick.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch


def _is_ready(future, event) -> bool:
    """Whether a launched plan may commit: its host work is done and, on
    the card, its stream has passed the plan's end."""
    return future.done() and (event is None or event.query())


def _tensors(x):
    """Every tensor of a nest of dicts, tuples, lists and dataclasses."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def _clone(x):
    """A copy of a nest with every tensor cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _clone(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    return x


class AsyncPlanner:
    """Non-blocking MPC wrapper around ``SamplingMPC``.

    Call :meth:`tick` once a control tick. It (a) commits a finished plan,
    (b) launches a re-plan at the configured cadence when the planner is
    free, and (c) returns the committed plan's control row for this tick,
    without waiting on the planner.

    ``replan_ticks``: least control ticks between plan launches.
    ``ticks_per_step``: control ticks a plan step (rollout dt / control
    dt), for the time-shifted consumption. ``generator``: the plans'
    random draws (default: seeded 0 on the plugin's device); the worker
    draws from it one plan at a time.
    """

    def __init__(self, mpc, *, replan_ticks: int, ticks_per_step: int,
                 generator: Optional[torch.Generator] = None):
        self.mpc = mpc
        self.replan_ticks = int(replan_ticks)
        self.ticks_per_step = int(ticks_per_step)
        self.device = torch.device(mpc.plugin.device)
        self._gen = (generator if generator is not None else
                     torch.Generator(device=self.device).manual_seed(0))
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="planner")
        self._pending = None     # (future, done event, snapshot tick)
        self._committed = None   # (U, snapshot tick)
        self._last_launch = None
        # pipeline telemetry
        self.n_launch = 0
        self.n_commit = 0
        self.commit_latency_ticks = []   # launch -> commit tick distances
        self.infos = []                  # the committed plans' infos

    def _launch(self, state, refs, warm, U_nom):
        """Start one plan on the worker: (future, done event)."""
        args = _clone((state, refs, warm, U_nom))
        if self._stream is None:
            return self._pool.submit(self.mpc.plan, self._gen, *args), None
        side = self._stream
        inputs_ready = torch.cuda.Event()
        inputs_ready.record()
        for t in _tensors(args):
            t.record_stream(side)
        done = torch.cuda.Event()

        def work():
            with torch.cuda.stream(side):
                side.wait_event(inputs_ready)
                out = self.mpc.plan(self._gen, *args)
                done.record(side)
            return out

        return self._pool.submit(work), done

    def _commit(self, tick: Optional[int]):
        """Take the pending plan; ``tick`` None skips the latency
        bookkeeping, as the reference's flush does."""
        future, done, snap = self._pending
        U, info = future.result()
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            for t in _tensors((U, info)):
                t.record_stream(stream)
        self._committed = (U, snap)
        self.infos.append(info)
        self.n_commit += 1
        if tick is not None:
            self.commit_latency_ticks.append(tick - snap)
        self._pending = None

    def tick(self, tick: int, state, refs, warm):
        """Advance the pipeline; returns (u (nu,), plan_age_ticks): the
        committed plan's row for this tick (zeros before the first commit)
        and the age of its state snapshot (-1 before the first commit)."""
        # 1) commit a finished plan (a poll, never a wait)
        if self._pending is not None and _is_ready(*self._pending[:2]):
            self._commit(tick)
        # 2) launch a re-plan if free and due, seeded from the committed
        # plan so successive plans refine it
        due = (self._last_launch is None
               or tick - self._last_launch >= self.replan_ticks)
        if self._pending is None and due:
            U_nom = (self._committed[0] if self._committed is not None
                     else self.mpc.init_plan())
            self._pending = (*self._launch(state, refs, warm, U_nom), tick)
            self._last_launch = tick
            self.n_launch += 1
        # 3) act on the committed plan, time-shifted to now
        if self._committed is None:
            return torch.zeros((self.mpc.mppi.nu,), dtype=torch.float32,
                               device=self.device), -1
        U, snap = self._committed
        row = min((tick - snap) // self.ticks_per_step, U.shape[0] - 1)
        return U[row], tick - snap

    def flush(self):
        """Wait for the plan in flight, if any, and commit it: for an
        orderly shutdown or checkpoint, not for the control loop. Like the
        reference's, it records no commit latency (ROADMAP section 3)."""
        if self._pending is not None:
            future, done, _ = self._pending
            future.result()
            if done is not None:
                done.synchronize()
            self._commit(None)

    def close(self):
        """Flush, then stop the worker thread."""
        try:
            self.flush()
        finally:
            self._pool.shutdown(wait=True)
