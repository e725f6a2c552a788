"""Task/constraint protocol and aggregation (port of qppvm_tpu/tasks/base.py).

A task emits ``(A (B, k, nx), b (B, k))`` with ``min ||A x - b||^2``
semantics; a constraint emits a box on x or rows ``l <= C x <= u``. ``+``
aggregates tasks, ``/`` stacks priorities and ``<<`` attaches constraints,
building an ``AutoStack``. Task objects hold only static configuration,
their settings (``device.Settings``); references live in the batched
``refs`` dict passed to every tick.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch

from qppvm_tpu_torch import device as device_lib
from qppvm_tpu_torch.model.dynamics import ModelData
from qppvm_tpu_torch.model.robot import RobotModel, RobotState


@dataclasses.dataclass
class AssembleCtx:
    """Everything a task may consume during assembly (one batched tick)."""

    model: RobotModel
    data: ModelData
    state: RobotState
    refs: Dict[str, Any]
    nx: int
    dtype: Any = torch.float32

    @property
    def batch(self) -> int:
        return self.state.q.shape[0]


class Task(device_lib.Settings):
    """Base task. Subclasses set ``name`` and implement ``assemble``."""

    name: str = "task"
    weight: float = 1.0

    def assemble(self, ctx: AssembleCtx):
        """Return (A (B, k, nx), b (B, k)), rows already weighted."""
        raise NotImplementedError

    def ref_init(self, model: RobotModel, data: ModelData, state: RobotState):
        """Default batched reference dict captured at start."""
        return {}

    def __add__(self, other: "Task") -> "AggregatedTask":
        mine = self.tasks if isinstance(self, AggregatedTask) else [self]
        theirs = other.tasks if isinstance(other, AggregatedTask) else [other]
        return AggregatedTask(mine + theirs)

    def __truediv__(self, other):
        from qppvm_tpu_torch.stack.autostack import AutoStack
        return AutoStack([self]) / other

    def __lshift__(self, constraint):
        from qppvm_tpu_torch.stack.autostack import AutoStack
        return AutoStack([self]) << constraint

    def base_tasks(self):
        return [self]


class AggregatedTask(Task):
    """``t1 + t2``: row-stacked tasks at the same priority."""

    def __init__(self, tasks: Sequence[Task]):
        self.tasks = list(tasks)
        self.name = "+".join(t.name for t in self.tasks)

    def assemble(self, ctx: AssembleCtx):
        As, bs = zip(*(t.assemble(ctx) for t in self.tasks))
        return torch.cat(As, dim=1), torch.cat(bs, dim=1)

    def base_tasks(self):
        return [bt for t in self.tasks for bt in t.base_tasks()]


def take_rows(owner, indices: Sequence[int], t: torch.Tensor):
    """``t[:, indices]`` with no copy from the host: a slice where the rows
    are one ascending run, else an index tensor made once per device (a
    constant of ``owner``, whose setting ``indices`` is)."""
    def selection():
        rows = list(indices)
        lo = rows[0] if rows else 0
        if rows and rows == list(range(lo, lo + len(rows))):
            return slice(lo, lo + len(rows))
        return torch.tensor(rows, dtype=torch.int64, device=t.device)
    return t[:, device_lib.constant(owner, ("rows", t.device), selection)]


def ref_tensor(v, dtype, device) -> torch.Tensor:
    """A reference value as a tensor on ``device``: a tensor as it is (cast
    where it differs), a number filled on the device, anything else copied
    from the host."""
    if isinstance(v, (int, float)):
        return torch.full((), v, dtype=dtype, device=device)
    return torch.as_tensor(v, dtype=dtype, device=device)


class SubTask(Task):
    """Rows ``indices`` of another task (OpenSoT's SubTask)."""

    def __init__(self, task: Task, indices: Sequence[int],
                 name: Optional[str] = None):
        self.task = task
        self.indices = list(indices)
        self.name = name or f"{task.name}[{self.indices}]"

    def assemble(self, ctx: AssembleCtx):
        A, b = self.task.assemble(ctx)
        return (take_rows(self, self.indices, A),
                take_rows(self, self.indices, b))

    def ref_init(self, model, data, state):
        return self.task.ref_init(model, data, state)

    def base_tasks(self):
        return self.task.base_tasks()


class Indices:
    """OpenSoT's ``Indices::range``."""

    @staticmethod
    def range(lo: int, hi: int):
        """Inclusive range: ``range(0, 2)`` is rows 0, 1, 2."""
        return list(range(lo, hi + 1))


BOX = "box"
ROWS = "rows"


class Constraint(device_lib.Settings):
    """Base constraint; ``assemble`` returns (kind, C (B, k, nx) or None,
    lb (B, k), ub (B, k)). ``is_equality``: rows are always equalities
    (l == u), ordered first and eliminated by the solver."""

    name: str = "constraint"
    is_equality: bool = False

    def assemble(self, ctx: AssembleCtx):
        raise NotImplementedError
