"""Batched dense QP solver: OSQP-style ADMM with a fixed iteration count
(port of qppvm_tpu/opt/qp.py).

    minimize   1/2 x^T P x + q^T x
    subject to l <= A x <= u        (equalities: l == u rows)

Every tensor carries a leading batch dimension B and each batch item is an
independent QP. Where the reference branches per problem (``lax.cond`` on
the warm-start guard, the polish acceptance), the port evaluates both sides
for the batch and selects per item with ``torch.where`` — the semantics the
reference has under ``vmap``.

Pieces, as in the reference: Ruiz equilibration of the inequality rows;
elimination of structural head/tail equality rows by nullspace projection
(NS-refined pseudo-inverse); per-row rho; a KKT inverse by Newton-Schulz,
hot-started from the carried inverse behind a contraction guard; rho
adaptation per chunk and across ticks; active-set polish; relative
residuals.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from qppvm_tpu_torch import device as devices
from qppvm_tpu_torch.opt import linalg


@dataclasses.dataclass(frozen=True)
class QPProblem:
    P: torch.Tensor  # (B, n, n) PSD
    q: torch.Tensor  # (B, n)
    A: torch.Tensor  # (B, m, n)
    l: torch.Tensor  # (B, m)
    u: torch.Tensor  # (B, m)


@dataclasses.dataclass(frozen=True)
class QPState:
    """Warm start carried across control ticks: the ADMM iterates, the
    scaled-space KKT inverse and the adapted rho scale."""

    x: torch.Tensor          # (B, n)
    z: torch.Tensor          # (B, m)
    y: torch.Tensor          # (B, m)
    Kinv: torch.Tensor       # (B, n, n)
    rho_scale: torch.Tensor  # (B,)

    @staticmethod
    def zero(batch: int, n: int, m: int, dtype=torch.float32,
             device=devices.DEFAULT) -> "QPState":
        # Kinv = 0 fails the contraction guard, so the first solve takes the
        # cold inverse.
        kw = dict(dtype=dtype, device=devices.resolve(device))
        return QPState(x=torch.zeros((batch, n), **kw),
                       z=torch.zeros((batch, m), **kw),
                       y=torch.zeros((batch, m), **kw),
                       Kinv=torch.zeros((batch, n, n), **kw),
                       rho_scale=torch.ones((batch,), **kw))


@dataclasses.dataclass(frozen=True)
class QPInfo:
    """Solver status per batch item; residuals are relative."""

    prim_res: torch.Tensor  # (B,)
    dual_res: torch.Tensor  # (B,)
    obj: torch.Tensor       # (B,)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    return (M.transpose(-1, -2) @ v[..., None])[..., 0]


def _vmax(v):
    """Max over the last dim; 0 for an empty dim (a level without inequality
    rows has empty scaled-space residual vectors)."""
    if v.shape[-1] == 0:
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    return torch.amax(v, dim=-1)


def _rho_vec(l, u, rho):
    """Per-row penalty: boost equality rows, damp fully-unbounded rows."""
    eq = (u - l) < 1e-8
    loose = (l < -1e12) & (u > 1e12)
    base = torch.where(eq, rho * 1e3, rho)
    return torch.where(loose, rho * 1e-6, base)


def _ruiz(P, A, iters: int = 5):
    """Ruiz equilibration of [[P, A^T], [A, 0]]; returns d (B, n), e (B, m)."""
    m = A.shape[1]
    d = torch.ones_like(P[..., 0])
    e = torch.ones_like(A[..., 0])
    Ps, As = P, A
    for _ in range(iters):
        cn = torch.amax(torch.abs(Ps), dim=1)
        if m > 0:
            cn = torch.maximum(cn, torch.amax(torch.abs(As), dim=1))
            rn = torch.amax(torch.abs(As), dim=2)
        else:
            rn = torch.zeros_like(e)
        sd = 1.0 / torch.sqrt(torch.clamp(cn, 1e-8, 1e8))
        se = 1.0 / torch.sqrt(torch.clamp(rn, 1e-8, 1e8))
        d = d * sd
        e = e * se
        Ps = sd[:, :, None] * Ps * sd[:, None, :]
        As = se[:, :, None] * As * sd[:, None, :]
    return d, e


def _rel_residuals(P, q, A, x, z, y, Pn=None):
    """Relative OSQP-style residuals (B,), (B,). With ``Pn`` the dual
    residual is projected onto the tangent space of the eliminated
    equalities."""
    Ax = _mv(A, x)
    Px = _mv(P, x)
    Aty = _mtv(A, y)
    prim = _vmax(torch.abs(Ax - z)) / (
        torch.maximum(_vmax(torch.abs(Ax)), _vmax(torch.abs(z))) + 1.0)
    stat = Px + q + Aty
    if Pn is not None:
        stat = _mv(Pn, stat)
    dual = _vmax(torch.abs(stat)) / (
        torch.maximum(torch.maximum(_vmax(torch.abs(Px)), _vmax(torch.abs(Aty))),
                      _vmax(torch.abs(q))) + 1.0)
    return prim, dual


def _ns_warm(K, X_guess, iters, cold_iters=None):
    """NS inverse hot-started from ``X_guess`` behind the contraction guard
    sqrt(||I - X K||_1 ||I - X K||_inf) < 0.9, with the Jacobi-prescaled cold
    start D^2 / ||D K D||_1 for items that fail it; never non-finite.
    ``cold_iters``: separate budget for guard-rejected items."""
    I = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    absE = torch.abs(I - X_guess @ K)
    err = torch.sqrt(torch.amax(torch.sum(absE, dim=-2), dim=-1)
                     * torch.amax(torch.sum(absE, dim=-1), dim=-1))
    err = torch.where(torch.isfinite(err), err, 2.0)
    dinv = 1.0 / torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1), min=1e-30)
    sq = torch.sqrt(dinv)
    Ks_norm1 = torch.amax(torch.sum(
        torch.abs(K) * sq[..., :, None] * sq[..., None, :], dim=-2), dim=-1)
    cold = torch.diag_embed(dinv / torch.clamp(Ks_norm1, min=1e-30)[..., None])
    warm_ok = (err < 0.9)[:, None, None]

    def run(X, length):
        for _ in range(length):
            X = X @ (2.0 * I - K @ X)
        return X

    if cold_iters is None or cold_iters == iters:
        X = run(torch.where(warm_ok, X_guess, cold), iters)
    else:
        X = torch.where(warm_ok, run(X_guess, iters), run(cold, cold_iters))
    finite = torch.isfinite(X).all(dim=-1).all(dim=-1)[:, None, None]
    return torch.where(finite, X, cold)


def solve(problem: QPProblem, state: Optional[QPState] = None, *,
          iters: int = 80, rho: float = 0.1, sigma: float = 1e-6,
          alpha: float = 1.6, refine: int = 2, rho_updates: int = 3,
          scale_iters: int = 5, inv_method: str = "ns",
          polish_rounds: int = 2, assume_warm_kinv: bool = False,
          warm_kinv_iters: int = 12, polish_ns_iters: int = 24,
          rho_adapt_tol: float = 0.0, rho_scale_min: float = 1e-2,
          n_eq_head: int = 0, n_eq_tail: int = 0, eq_pin: float = 1.0,
          cold_ns_iters: Optional[int] = None, pinv_ns_iters: int = 7):
    """Solve a batch of dense QPs. Returns (x, new_state, info).

    ``n_eq_head`` / ``n_eq_tail`` mark the first / last rows of A as
    structural equalities (l == u) that are eliminated by nullspace
    projection x = x_p + P_N xi instead of being penalized."""
    P0, q0, A0, l0, u0 = problem.P, problem.q, problem.A, problem.l, problem.u
    B, n = q0.shape
    m = A0.shape[1]
    dtype, device = P0.dtype, P0.device
    if state is None:
        state = QPState.zero(B, n, m, dtype, device)
    h, t = n_eq_head, n_eq_tail
    has_eq = (h + t) > 0
    if has_eq:
        E0 = torch.cat([A0[:, :h], A0[:, m - t:]], dim=1)
        b_e0 = torch.cat([l0[:, :h], l0[:, m - t:]], dim=1)
        A_in0, l_in0, u_in0 = A0[:, h:m - t], l0[:, h:m - t], u0[:, h:m - t]
    else:
        A_in0, l_in0, u_in0 = A0, l0, u0

    d, e = _ruiz(P0, A_in0, iters=scale_iters)
    P = d[:, :, None] * P0 * d[:, None, :]
    q = d * q0
    A = e[:, :, None] * A_in0 * d[:, None, :]
    l = e * l_in0
    u = e * u_in0
    I_n = torch.eye(n, dtype=dtype, device=device)

    if has_eq:
        Es_raw = E0 * d[:, None, :]
        R_eq = torch.rsqrt(torch.sum(Es_raw ** 2, dim=-1) + 1e-12)
        Es = R_eq[..., None] * Es_raw
        b_es = R_eq * b_e0
        I_eq = torch.eye(h + t, dtype=dtype, device=device)
        G = Es @ Es.transpose(-1, -2) + 1e-6 * I_eq
        EpT = Es.transpose(-1, -2) @ linalg.spd_inverse(G, method=inv_method)
        # NS pseudo-inverse refinement X <- X (2I - E X) from the
        # Gram-delta initializer (quadratic, always contractive)
        for _ in range(pinv_ns_iters):
            EpT = EpT @ (2.0 * I_eq - Es @ EpT)
        Pn = I_n - EpT @ Es
        x_p = _mv(EpT, b_es)
        x_p = x_p + _mv(EpT, b_es - _mv(Es, x_p))
        Ax_p = _mv(A, x_p)
        q_eff = _mv(Pn, q + _mv(P, x_p))
        l = l - Ax_p
        u = u - Ax_p
        x = _mv(Pn, state.x / d - x_p)
        z = e * state.z[:, h:m - t] - Ax_p
        y = state.y[:, h:m - t] / torch.clamp(e, min=1e-30)
    else:
        Pn = None
        q_eff = q
        x = state.x / d
        z = e * state.z
        y = state.y / torch.clamp(e, min=1e-30)

    rho_base = _rho_vec(l, u, torch.full((), rho, dtype=dtype, device=device))
    n_chunks = max(1, rho_updates + 1)
    chunk = max(1, iters // n_chunks)
    # the carried rho may adapt down across ticks but never carries an
    # increase; rho_scale_min floors it
    rho_scale = torch.clamp(state.rho_scale, rho_scale_min, 1.0)
    Kinv = None
    for chunk_i in range(n_chunks):
        rho_v = rho_base * rho_scale[:, None]
        AtR = A.transpose(-1, -2) * rho_v[:, None, :]
        if has_eq:
            M0 = P + AtR @ A
            pin = eq_pin * (torch.diagonal(M0, dim1=-2, dim2=-1).sum(-1) / n)
            K = Pn @ M0 @ Pn + sigma * I_n + pin[:, None, None] * (I_n - Pn)
        else:
            K = P + sigma * I_n + AtR @ A
        if assume_warm_kinv and chunk_i == 0 and inv_method == "ns":
            # hot start from last tick's inverse (chunk 0 only: later chunks
            # see a rho change and pay the full cold NS)
            Kinv = _ns_warm(K, state.Kinv, warm_kinv_iters, cold_ns_iters)
        else:
            kw = ({"iters": cold_ns_iters}
                  if (cold_ns_iters is not None and inv_method == "ns") else {})
            Kinv = linalg.spd_inverse(K, method=inv_method, **kw)

        for _ in range(chunk):
            rhs = sigma * x - q_eff + _mtv(A, rho_v * z - y)
            x_t = _mv(Kinv, rhs)
            if has_eq:
                x_t = _mv(Pn, x_t)   # keep drift out of null(P_N)
            z_t = _mv(A, x_t)
            x_n = alpha * x_t + (1 - alpha) * x
            z_r = alpha * z_t + (1 - alpha) * z
            z_n = torch.clamp(z_r + y / rho_v, l, u)
            y = y + rho_v * (z_r - z_n)
            x, z = x_n, z_n

        prim, dual = _rel_residuals(P, q_eff, A, x, z, y, Pn=Pn)
        factor = torch.clamp(torch.sqrt(prim / torch.clamp(dual, min=1e-12)),
                             0.1, 10.0)
        adapt = torch.maximum(prim, dual) > rho_adapt_tol
        factor = torch.where(adapt, factor, torch.ones_like(factor))
        rho_scale = torch.clamp(rho_scale * factor, rho_scale_min, 1e2)

    if has_eq:
        xs = x + x_p
        x = d * xs
        z_in = (z + Ax_p) / torch.clamp(e, min=1e-30)
        y_in = e * y
        # equality multipliers from stationarity, through (E^+)^T
        nu = -_mtv(EpT, _mv(P, xs) + q + _mtv(A, y))
        y_eq = R_eq * nu
        z = torch.cat([b_e0[:, :h], z_in, b_e0[:, h:]], dim=1)
        y = torch.cat([y_eq[:, :h], y_in, y_eq[:, h:]], dim=1)
    else:
        x = d * x
        z = z / torch.clamp(e, min=1e-30)
        y = e * y

    if refine > 0:
        for _ in range(polish_rounds):
            x, y = _polish(P0, q0, A0, l0, u0, x, y, steps=refine,
                           inv_method=inv_method, ns_iters=polish_ns_iters)
        z = torch.clamp(_mv(A0, x), l0, u0)

    prim, dual = _rel_residuals(P0, q0, A0, x, z, y)
    obj = torch.sum(((0.5 * x)[:, None, :] @ P0)[:, 0] * x, dim=-1) + \
        torch.sum(q0 * x, dim=-1)
    return x, QPState(x=x, z=z, y=y, Kinv=Kinv, rho_scale=rho_scale), \
        QPInfo(prim_res=prim, dual_res=dual, obj=obj)


def _polish(P, q, A, l, u, x, y, steps: int, eps_active: float = 1e-4,
            inv_method: str = "ns", ns_iters: int = 24):
    """Active-set polish: the candidate of ``_polish_candidate`` on the
    rows ``_polish_active`` picks, taken per item where ``_polish_accept``
    accepts it, else the old (x, y)."""
    lo_act, hi_act = _polish_active(A, l, u, x, y, eps_active)
    x_p, y_p = _polish_candidate(P, q, A, l, u, lo_act, hi_act, steps,
                                 inv_method, ns_iters)
    ok = _polish_accept(P, q, A, l, u, x, y, x_p, y_p)[:, None]
    return torch.where(ok, x_p, x), torch.where(ok, y_p, y)


def _polish_active(A, l, u, x, y, eps_active: float = 1e-4):
    """(lo_act, hi_act) (B, m) bool: rows near a bound by primal proximity
    or by the sign of their multiplier; equality rows are upper-active."""
    Ax = _mv(A, x)
    y_scale = (torch.amax(torch.abs(y), dim=-1) + 1e-12)[:, None]
    lo_act = ((Ax - l) < eps_active * (1.0 + torch.abs(l))) | (y < -1e-6 * y_scale)
    hi_act = ((u - Ax) < eps_active * (1.0 + torch.abs(u))) | (y > 1e-6 * y_scale)
    eq = (u - l) < 1e-12 * (1.0 + torch.abs(u))
    hi_act = hi_act | eq
    return lo_act & ~hi_act, hi_act


def _polish_candidate(P, q, A, l, u, lo_act, hi_act, steps: int,
                      inv_method: str = "ns", ns_iters: int = 24):
    """Polish candidate (x_p, y_p): the active rows become equalities of a
    Schur-complement KKT solve."""
    n = P.shape[-1]
    dtype = P.dtype
    act = lo_act | hi_act
    b_act = torch.where(hi_act, u, l)
    Aa = A * act[..., None].to(dtype)
    ba = torch.where(act, b_act, 0.0)
    delta = 1e-6 * (1.0 + torch.diagonal(P, dim1=-2, dim2=-1).sum(-1) / n)
    row_reg = torch.where(act, delta[:, None], 1.0)
    x_p, y_sol = linalg.kkt_solve_schur(P, Aa, -q, ba, delta, method=inv_method,
                                        refine=max(2, steps), row_reg=row_reg,
                                        ns_iters=ns_iters)
    return x_p, torch.where(act, y_sol, 0.0)


def _polish_accept(P, q, A, l, u, x, y, x_p, y_p):
    """(B,) bool: the candidate keeps every row feasible to 1e-6 relative,
    does not raise the dual residual and is finite."""
    Axp = _mv(A, x_p)
    scale_l = 1e-6 * (1.0 + torch.abs(l))
    scale_u = 1e-6 * (1.0 + torch.abs(u))
    feas = (Axp >= l - scale_l).all(-1) & (Axp <= u + scale_u).all(-1)
    dual_old = torch.amax(torch.abs(_mv(P, x) + q + _mtv(A, y)), dim=-1)
    dual_new = torch.amax(torch.abs(_mv(P, x_p) + q + _mtv(A, y_p)), dim=-1)
    return (feas & (dual_new <= dual_old + 1e-12)
            & torch.isfinite(x_p).all(-1))


def solve_batch(problems: QPProblem, states: Optional[QPState] = None, **kw):
    """The reference's ``vmap`` of ``solve`` over a leading batch axis.
    ``solve`` is batch-first already, so this is ``solve``: kept so that
    callers of the reference find it."""
    return solve(problems, states, **kw)
