"""Hierarchical (prioritized) QP cascade (port of qppvm_tpu/opt/hierarchy.py).

One QP per priority level: level k minimizes its own task residual plus an
eps-regularization, subject to the stack's constraints AND equality locks
``A_j x = A_j x_j*`` for every higher level j < k. All tensors are batched;
the warm start is a per-level tuple of batched ``QPState``s.

``method`` picks the level algorithm: "admm" (warm-started first-order,
``opt/qp.py``; the real-time default) or "pdip" (the Mehrotra interior
point of ``opt/pdip.py``, cold, at a fixed ``pdip_iters``: the accurate
backstop for heavily saturated levels, where ADMM crawls). Under "admm"
``level_qp.solve`` routes each level: to the level kernel where it takes
the level (its plain version on the CPU), else to qp.solve, counted as a
``cascade.fallback``. Each level solve counts one ``cascade.level``
(``telemetry``). The solve is the span ``cascade``, each level's solver
call a span ``cascade.level`` in it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.opt import level_qp, pdip, qp


@dataclasses.dataclass(frozen=True)
class LevelData:
    """One priority level: minimize ||A x - b||^2 (rows pre-weighted)."""

    A: torch.Tensor  # (B, k, n)
    b: torch.Tensor  # (B, k)


@dataclasses.dataclass(frozen=True)
class StackData:
    """Numeric data of a whole prioritized stack for one batched tick."""

    levels: Tuple[LevelData, ...]
    C: torch.Tensor   # (B, mc, n) general constraint rows (may be 0-row)
    lC: torch.Tensor  # (B, mc)
    uC: torch.Tensor  # (B, mc)
    lb: torch.Tensor  # (B, n) box bounds on x
    ub: torch.Tensor  # (B, n)
    n_eq: int = 0         # the first n_eq rows of C are structural equalities
    has_box: bool = True  # False: no box constraint, identity rows dropped


def warm_start_init(stack: StackData) -> Tuple[qp.QPState, ...]:
    B, n = stack.lb.shape
    mc = stack.C.shape[1] + (n if stack.has_box else 0)
    states, extra = [], 0
    for lv in stack.levels:
        states.append(qp.QPState.zero(B, n, mc + extra, stack.lb.dtype,
                                      stack.lb.device))
        extra += lv.A.shape[1]
    return tuple(states)


def _solve_level(prob: qp.QPProblem, st: Optional[qp.QPState], opts: dict):
    telemetry.count("cascade.level")
    if opts.pop("method") == "pdip":
        x, info = pdip.solve(prob, iters=opts["pdip_iters"])
        if st is None:
            B, n = prob.q.shape
            st = qp.QPState.zero(B, n, prob.A.shape[1], prob.q.dtype,
                                 prob.q.device)
        z = torch.clamp((prob.A @ x[..., None])[..., 0], prob.l, prob.u)
        return x, dataclasses.replace(st, x=x, z=z), info
    opts.pop("pdip_iters")
    return level_qp.solve(prob, st, **opts)


def solve(stack: StackData, warm: Optional[Tuple[qp.QPState, ...]] = None, *,
          eps: float = 1.0, eps_abs_scale: float = 1e-8, iters: int = 80,
          refine: int = 2, rho: float = 0.1, rho_updates: int = 3,
          polish_rounds: int = 2, assume_warm_kinv: bool = False,
          polish_ns_iters: int = 24, warm_kinv_iters: int = 12,
          rho_adapt_tol: float = 0.0, rho_scale_min: float = 1e-2,
          cold_ns_iters: Optional[int] = None, scale_iters: int = 5,
          pinv_ns_iters: int = 7, reg_diag: Optional[torch.Tensor] = None,
          method: str = "admm", pdip_iters: int = 25,
          per_level_opts: Optional[Sequence[Optional[dict]]] = None,
          eq_elim: bool = True):
    """Solve the cascade for the batch. Returns (x (B, n), warm_states,
    infos). The Tikhonov weight is ``eps * eps_abs_scale * (mean(diag(A^T
    A)) + 1)``, shaped per variable by ``reg_diag`` and centred on the warm
    solution. ``per_level_opts[k]`` overrides solver keywords for level k.
    ``eq_elim`` eliminates the stack's leading ``n_eq`` equality rows and
    the cascade's locks by projection (ADMM only; PDIP keeps them as
    rows). ``method`` "pdip" solves each level cold in ``pdip_iters``
    interior-point iterations; its new state is the warm (or zero) state
    with x and z = clip(A x, l, u)."""
    with telemetry.span("cascade"):
        B, n = stack.lb.shape
        dtype, device = stack.lb.dtype, stack.lb.device
        global_opts = dict(
            eps=eps, eps_abs_scale=eps_abs_scale, iters=iters, refine=refine,
            rho=rho, rho_updates=rho_updates, polish_rounds=polish_rounds,
            assume_warm_kinv=assume_warm_kinv,
            polish_ns_iters=polish_ns_iters, warm_kinv_iters=warm_kinv_iters,
            rho_adapt_tol=rho_adapt_tol, rho_scale_min=rho_scale_min,
            cold_ns_iters=cold_ns_iters, scale_iters=scale_iters,
            pinv_ns_iters=pinv_ns_iters, method=method, pdip_iters=pdip_iters,
            eq_elim=eq_elim)
        locked_rows: List[torch.Tensor] = []
        locked_vals: List[torch.Tensor] = []
        new_states, infos = [], []
        x = None
        for k, lv in enumerate(stack.levels):
            opts = dict(global_opts)
            if per_level_opts is not None and k < len(per_level_opts):
                opts.update(per_level_opts[k] or {})
            lvl_eps = opts.pop("eps")
            lvl_eps_scale = opts.pop("eps_abs_scale")
            lvl_reg_diag = opts.pop("reg_diag", reg_diag)
            lvl_eq_elim = opts.pop("eq_elim")

            At = lv.A.transpose(-1, -2)
            P = At @ lv.A
            reg = lvl_eps * lvl_eps_scale * (
                torch.diagonal(P, dim1=-2, dim2=-1).sum(-1) / n + 1.0)
            shape = (torch.ones(n, dtype=dtype, device=device)
                     if lvl_reg_diag is None else lvl_reg_diag.to(dtype))
            rvec = reg[:, None] * shape
            P = P + torch.diag_embed(rvec)
            qv = -(At @ lv.b[..., None])[..., 0]
            if warm is not None:
                # proximal term centred on the warm solution, not on zero
                qv = qv - rvec * warm[k].x

            rows, lo, hi = [stack.C], [stack.lC], [stack.uC]
            if stack.has_box:
                eye = torch.eye(n, dtype=dtype,
                                device=device).expand(B, n, n)
                rows, lo, hi = rows + [eye], lo + [stack.lb], hi + [stack.ub]
            prob = qp.QPProblem(P=P, q=qv,
                                A=torch.cat(rows + locked_rows, dim=1),
                                l=torch.cat(lo + locked_vals, dim=1),
                                u=torch.cat(hi + locked_vals, dim=1))
            if lvl_eq_elim and opts["method"] != "pdip":
                # row order is [C; I(box); locks]: the stack's structural
                # equalities lead C, the cascade's locks trail
                opts["n_eq_head"] = stack.n_eq
                opts["n_eq_tail"] = sum(r.shape[1] for r in locked_rows)
            st = warm[k] if warm is not None else None
            with telemetry.span("cascade.level"):
                x, st_new, info = _solve_level(prob, st, opts)
            new_states.append(st_new)
            infos.append(info)
            locked_rows.append(lv.A)
            locked_vals.append((lv.A @ x[..., None])[..., 0])
        return x, tuple(new_states), tuple(infos)


def solve_failed(infos, tol: float = 1e-3) -> torch.Tensor:
    """(B,) bool: any level left a large relative primal residual or a
    non-finite objective."""
    bad = torch.zeros_like(infos[0].prim_res, dtype=torch.bool)
    for info in infos:
        bad = bad | (info.prim_res > tol) | ~torch.isfinite(info.obj)
    return bad
