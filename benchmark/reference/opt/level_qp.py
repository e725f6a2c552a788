"""One cascade level in the level kernel's profile, as plain PyTorch: the
function of the port's level kernel (``qp.solve`` with rho_updates 0, no
polish, Newton-Schulz inverses, a warm-started KKT inverse and at least one
inequality row), counted at the kernel's declared cost."""
from __future__ import annotations

import dataclasses
from typing import Optional

from benchmark import accounting
from benchmark.reference.opt import qp


@dataclasses.dataclass(frozen=True)
class LevelQPConfig:
    """Static solver profile of one level (fields as in qp.solve)."""

    iters: int = 12
    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    warm_kinv_iters: int = 4
    cold_ns_iters: Optional[int] = None   # None -> warm_kinv_iters
    scale_iters: int = 2
    pinv_ns_iters: int = 5
    rho_adapt_tol: float = 1e-3
    rho_scale_min: float = 0.1
    n_eq_head: int = 0
    n_eq_tail: int = 0
    eq_pin: float = 1.0
    z_clip: bool = True                   # qp.solve's refine > 0 final clip


def config_from_opts(opts: dict, *, n_eq_head: int, n_eq_tail: int,
                     iters: int) -> Optional[LevelQPConfig]:
    """Map hierarchy / qp.solve keywords onto a kernel config; None when
    the profile is outside the kernel's scope."""
    if opts.get("rho_updates", 3) != 0:
        return None
    if opts.get("polish_rounds", 2) != 0:
        return None
    if not opts.get("assume_warm_kinv", False):
        return None
    if opts.get("inv_method", "ns") != "ns":
        return None
    return LevelQPConfig(
        iters=iters, rho=opts.get("rho", 0.1), sigma=opts.get("sigma", 1e-6),
        alpha=opts.get("alpha", 1.6),
        warm_kinv_iters=opts.get("warm_kinv_iters", 12),
        cold_ns_iters=opts.get("cold_ns_iters", None),
        scale_iters=opts.get("scale_iters", 5),
        pinv_ns_iters=opts.get("pinv_ns_iters", 7),
        rho_adapt_tol=opts.get("rho_adapt_tol", 0.0),
        rho_scale_min=opts.get("rho_scale_min", 1e-2),
        n_eq_head=n_eq_head, n_eq_tail=n_eq_tail,
        eq_pin=opts.get("eq_pin", 1.0), z_clip=opts.get("refine", 2) > 0)


def _qp_opts(cfg: LevelQPConfig) -> dict:
    return dict(iters=cfg.iters, rho=cfg.rho, sigma=cfg.sigma,
                alpha=cfg.alpha, refine=(2 if cfg.z_clip else 0),
                rho_updates=0, scale_iters=cfg.scale_iters, inv_method="ns",
                polish_rounds=0, assume_warm_kinv=True,
                warm_kinv_iters=cfg.warm_kinv_iters,
                rho_adapt_tol=cfg.rho_adapt_tol,
                rho_scale_min=cfg.rho_scale_min, n_eq_head=cfg.n_eq_head,
                n_eq_tail=cfg.n_eq_tail, eq_pin=cfg.eq_pin,
                cold_ns_iters=cfg.cold_ns_iters,
                pinv_ns_iters=cfg.pinv_ns_iters)


def solve_level_reference(cfg: LevelQPConfig, P, q, A, l, u, wx, wz, wy, wK,
                          wr):
    """The kernel's function in plain PyTorch: qp.solve with the kernel's
    profile. All arguments batch-first: P (B,n,n), q (B,n), A (B,m,n),
    l/u (B,m), warm x (B,n), z/y (B,m), Kinv (B,n,n), rho_scale (B,).
    Returns (x, z, y, Kinv, rho_scale, prim, dual, obj)."""
    x, st, info = qp.solve(qp.QPProblem(P=P, q=q, A=A, l=l, u=u),
                           qp.QPState(x=wx, z=wz, y=wy, Kinv=wK, rho_scale=wr),
                           **_qp_opts(cfg))
    return (x, st.z, st.y, st.Kinv, st.rho_scale, info.prim_res,
            info.dual_res, info.obj)


def solve_level(cfg: LevelQPConfig, P, q, A, l, u, wx, wz, wy, wK, wr):
    """``solve_level_reference`` at the kernel's declared cost."""
    with accounting.declared(accounting.level_qp_cost, cfg, *P.shape[:2],
                             A.shape[1]):
        return solve_level_reference(cfg, P, q, A, l, u, wx, wz, wy, wK, wr)
