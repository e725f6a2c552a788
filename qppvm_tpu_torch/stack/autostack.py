"""AutoStack: the ``+`` / ``/`` / ``<<`` task-stack DSL
(port of qppvm_tpu/stack/autostack.py). An AutoStack is static structure;
per tick it assembles the batched numeric ``StackData``; ``log`` is the
reference's autostack->log / solver->log self-logging hook."""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from qppvm_tpu_torch import device as device_lib
from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model.dynamics import ModelData
from qppvm_tpu_torch.model.robot import RobotModel, RobotState
from qppvm_tpu_torch.opt import hierarchy
from qppvm_tpu_torch.tasks.base import BOX, ROWS, AssembleCtx, Constraint, Task


class AutoStack(device_lib.Settings):
    """Ordered priority levels + attached constraints: settings, so a level
    or a constraint added is a change of the stack (``device.changed``)."""

    def __init__(self, level0: Sequence[Task] | Task):
        if isinstance(level0, Task):
            level0 = [level0]
        self.levels: List[List[Task]] = [list(level0)]
        self.constraints: List[Constraint] = []

    def __truediv__(self, other) -> "AutoStack":
        """Append a lower-priority level."""
        device_lib.changed(self)
        if isinstance(other, AutoStack):
            self.constraints.extend(other.constraints)
            self.levels.extend(other.levels)
            return self
        self.levels.append([other] if isinstance(other, Task) else list(other))
        return self

    def __lshift__(self, constraint: Constraint) -> "AutoStack":
        """Attach a constraint."""
        device_lib.changed(self)
        self.constraints.append(constraint)
        return self

    def tasks(self) -> List[Task]:
        return [bt for lv in self.levels for t in lv for bt in t.base_tasks()]

    def ref_init(self, model: RobotModel, data: ModelData,
                 state: RobotState) -> Dict[str, Any]:
        """Initial (batched) references for every task."""
        return {t.name: t.ref_init(model, data, state) for t in self.tasks()}

    def _ordered(self) -> List[Constraint]:
        return ([c for c in self.constraints if c.is_equality]
                + [c for c in self.constraints if not c.is_equality])

    def build(self, model: RobotModel, data: ModelData, state: RobotState,
              refs: Dict[str, Any], nx: int, dtype=torch.float32
              ) -> hierarchy.StackData:
        """Assemble the batched StackData for one tick. Row constraints come
        equality-first, so the solver can eliminate the leading ``n_eq``
        structural equality rows; every row of an ``is_equality``
        constraint must have lb == ub (``validate`` checks it)."""
        with telemetry.span("stack"):
            ctx = AssembleCtx(model=model, data=data, state=state, refs=refs,
                              nx=nx, dtype=dtype)
            levels = []
            for lv in self.levels:
                As, bs = zip(*(t.assemble(ctx) for t in lv))
                levels.append(hierarchy.LevelData(A=torch.cat(As, dim=1),
                                                  b=torch.cat(bs, dim=1)))
            B, dev = ctx.batch, state.q.device
            lb = torch.full((B, nx), -1e20, dtype=dtype, device=dev)
            ub = torch.full((B, nx), 1e20, dtype=dtype, device=dev)
            C_rows, lC_rows, uC_rows = [], [], []
            n_eq = 0
            has_box = False
            for c in self._ordered():
                kind, C, lo, hi = c.assemble(ctx)
                if kind == BOX:
                    has_box = True
                    lb = torch.maximum(lb, lo.to(dtype))
                    ub = torch.minimum(ub, hi.to(dtype))
                elif kind == ROWS:
                    C_rows.append(C.to(dtype))
                    lC_rows.append(lo.to(dtype))
                    uC_rows.append(hi.to(dtype))
                    if c.is_equality:
                        n_eq += C.shape[1]
                else:
                    raise ValueError(f"unknown constraint kind {kind}")
            if C_rows:
                C, lC, uC = (torch.cat(C_rows, dim=1),
                             torch.cat(lC_rows, dim=1),
                             torch.cat(uC_rows, dim=1))
            else:
                C = torch.zeros((B, 0, nx), dtype=dtype, device=dev)
                lC = uC = torch.zeros((B, 0), dtype=dtype, device=dev)
            return hierarchy.StackData(levels=tuple(levels), C=C, lC=lC,
                                       uC=uC, lb=lb, ub=ub, n_eq=n_eq,
                                       has_box=has_box)

    @staticmethod
    def validate(stack_data: hierarchy.StackData, tol: float = 1e-6) -> None:
        """Host-side check that the leading ``n_eq`` rows of C are true
        equalities (u - l < tol) in every batch item."""
        n_eq = stack_data.n_eq
        if n_eq == 0:
            return
        gap = (stack_data.uC[:, :n_eq] - stack_data.lC[:, :n_eq]).cpu()
        bad = torch.nonzero(gap >= tol)
        if bad.numel():
            raise AssertionError(
                f"stack n_eq={n_eq} but (item, row) {bad.tolist()} have "
                f"u - l >= {tol}: not structural equalities")

    def constraint_row_order(self) -> List[str]:
        """The constraints' names in their effective order, equalities
        first: the order of C's rows, and so of a warm state's z and y
        (a checkpointed warm state is only valid under the same order)."""
        return [c.name for c in self._ordered()]

    @staticmethod
    def log(trace, stack_data: hierarchy.StackData, x=None,
            infos=None) -> None:
        """Write a batch-1 stack into ``trace`` (a TraceBuffer), on the
        reference's channels: each level's ``stack/level{i}_b`` and, with
        the solution x (1, n), its ``stack/level{i}_residual`` A x - b and
        ``stack/x``; with the solver's infos ``solver/level{i}_prim_res``,
        ``_dual_res`` and ``_obj``. A larger batch raises ValueError: one
        trace logs one robot."""
        batch = stack_data.lb.shape[0]
        if batch != 1:
            raise ValueError(f"AutoStack.log logs one robot; got a batch of "
                             f"{batch}")
        for i, lv in enumerate(stack_data.levels):
            trace.add(f"stack/level{i}_b", lv.b[0])
            if x is not None:
                trace.add(f"stack/level{i}_residual", lv.A[0] @ x[0] - lv.b[0])
        if x is not None:
            trace.add("stack/x", x[0])
        for i, info in enumerate(infos or ()):
            trace.add(f"solver/level{i}_prim_res", float(info.prim_res[0]))
            trace.add(f"solver/level{i}_dual_res", float(info.dual_res[0]))
            trace.add(f"solver/level{i}_obj", float(info.obj[0]))
