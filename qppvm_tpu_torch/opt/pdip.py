"""Primal-dual interior-point QP solver, the accuracy backstop of the ADMM
path (port of qppvm_tpu/opt/pdip.py), batched over a leading dimension B.

Mehrotra predictor-corrector with a fixed iteration count for

    minimize   1/2 x^T P x + q^T x
    subject to l <= A x <= u

Rows with u - l < ``eq_tol`` are equalities (multiplier nu); the others get
two-sided log barriers (slacks sl = A x - l >= 0, su = u - A x >= 0). Each
iteration solves two regularized KKT systems through the matmul-only Schur
path (``linalg.kkt_solve_schur``). Every test is per batch item.
"""
from __future__ import annotations

import torch

from qppvm_tpu_torch.opt import linalg
from qppvm_tpu_torch.opt.qp import QPInfo, QPProblem, _mtv, _mv, _rel_residuals


def _max_step(v, dv, tau_frac):
    """(B,): the largest alpha in (0, 1] with v + alpha dv >= (1 - tau) v."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
    return torch.clamp(tau_frac * torch.amin(ratio, dim=-1), max=1.0)


def solve(problem: QPProblem, *, iters: int = 16, tau_frac: float = 0.99,
          inv_method: str = "ns", eq_tol: float = 1e-9):
    """Solve a batch of QPs. Returns (x (B, n), QPInfo)."""
    P, q, A, l, u = problem.P, problem.q, problem.A, problem.l, problem.u
    n = P.shape[-1]
    dtype = P.dtype

    is_eq = (u - l) < eq_tol
    ineq = ~is_eq
    ineq_f = ineq.to(dtype)
    b_eq = torch.where(is_eq, 0.5 * (l + u), 0.0)
    E = A * is_eq.to(dtype)[..., None]

    # infinite bounds clipped to a large finite window for the barriers
    BIG = 1e12
    l_c = torch.clamp(l, -BIG, BIG)
    u_c = torch.clamp(u, -BIG, BIG)

    # strictly interior start from x = 0
    x = torch.zeros_like(q)
    Ax = _mv(A, x)
    sl = torch.where(ineq, torch.clamp(Ax - l_c, min=1.0), 1.0)
    su = torch.where(ineq, torch.clamp(u_c - Ax, min=1.0), 1.0)
    zl = torch.ones_like(l)
    zu = torch.ones_like(l)
    nu = torch.zeros_like(l)

    n_ineq = torch.clamp(ineq_f.sum(-1), min=1.0)                  # (B,)
    delta = 1e-8 * (1.0 + torch.diagonal(P, dim1=-2, dim2=-1).sum(-1) / n)
    row_reg = torch.where(is_eq, delta[:, None], 1.0)

    def kkt_step(x, sl, su, zl, zu, nu, sigma_mu):
        """One Newton step on the perturbed KKT system, target sigma_mu
        (B, 1)."""
        Ax = _mv(A, x)
        r_dual = _mv(P, x) + q + _mtv(A, ineq_f * (zu - zl)) + _mtv(E, nu)
        r_eq = torch.where(is_eq, Ax - b_eq, 0.0)
        # slacks eliminated: sl zl = sigma_mu, su zu = sigma_mu
        d = torch.where(ineq, zl / sl + zu / su, 0.0)
        r_l = torch.where(ineq, Ax - l_c - sl, 0.0)
        r_u = torch.where(ineq, u_c - Ax - su, 0.0)
        g_l = torch.where(ineq, (sigma_mu - sl * zl) / sl, 0.0)
        g_u = torch.where(ineq, (sigma_mu - su * zu) / su, 0.0)
        w = g_l - g_u - (zl / sl) * r_l + (zu / su) * r_u
        H = P + (A.transpose(-1, -2) * d[:, None, :]) @ A
        rhs_x = -(r_dual - _mtv(A, ineq_f * w))
        dx, dnu = linalg.kkt_solve_schur(H, E, rhs_x, -r_eq, delta,
                                         method=inv_method, refine=2,
                                         row_reg=row_reg)
        dAx = _mv(A, dx)
        dsl = torch.where(ineq, dAx + r_l, 0.0)
        dsu = torch.where(ineq, -dAx + r_u, 0.0)
        dzl = torch.where(ineq, (sigma_mu - sl * zl - zl * dsl) / sl, 0.0)
        dzu = torch.where(ineq, (sigma_mu - su * zu - zu * dsu) / su, 0.0)
        return dx, dsl, dsu, dzl, dzu, dnu

    def step_len(sl, su, zl, zu, dsl, dsu, dzl, dzu):
        a_p = torch.minimum(_max_step(sl, dsl, tau_frac),
                            _max_step(su, dsu, tau_frac))
        a_d = torch.minimum(_max_step(zl, dzl, tau_frac),
                            _max_step(zu, dzu, tau_frac))
        return torch.minimum(a_p, a_d)[:, None]

    zero = torch.zeros_like(n_ineq)[:, None]
    for _ in range(iters):
        mu = torch.where(ineq, sl * zl + su * zu, 0.0).sum(-1) / (2 * n_ineq)
        # predictor (affine scaling, sigma = 0)
        dx, dsl, dsu, dzl, dzu, dnu = kkt_step(x, sl, su, zl, zu, nu, zero)
        a = step_len(sl, su, zl, zu, dsl, dsu, dzl, dzu)
        mu_aff = torch.where(
            ineq, (sl + a * dsl) * (zl + a * dzl)
            + (su + a * dsu) * (zu + a * dzu), 0.0).sum(-1) / (2 * n_ineq)
        sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3,
                            0.0, 1.0)
        # corrector
        dx, dsl, dsu, dzl, dzu, dnu = kkt_step(x, sl, su, zl, zu, nu,
                                               (sigma * mu)[:, None])
        a = step_len(sl, su, zl, zu, dsl, dsu, dzl, dzu)
        x = x + a * dx
        sl = torch.where(ineq, sl + a * dsl, 1.0)
        su = torch.where(ineq, su + a * dsu, 1.0)
        zl = torch.where(ineq, zl + a * dzl, 1.0)
        zu = torch.where(ineq, zu + a * dzu, 1.0)
        nu = nu + a * dnu

    y = ineq_f * (zu - zl) + torch.where(is_eq, nu, 0.0)
    z = torch.clamp(_mv(A, x), l, u)
    prim, dual = _rel_residuals(P, q, A, x, z, y)
    obj = 0.5 * (x * _mv(P, x)).sum(-1) + (q * x).sum(-1)
    return x, QPInfo(prim_res=prim, dual_res=dual, obj=obj)
