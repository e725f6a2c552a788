"""Matmul-only linear algebra (port of qppvm_tpu/opt/linalg.py), batched
over any leading dimensions.

Newton-Schulz (NS) iteration X <- X (2I - K X) inverts an SPD matrix with
batched matmuls only; ``method="chol"`` is the exact Cholesky path.
"""
from __future__ import annotations

import torch


def _eye(K):
    return torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)


def spd_inverse_chol(K):
    """Exact SPD inverse via Cholesky."""
    return torch.cholesky_inverse(torch.linalg.cholesky(K))


def spd_inverse_ns(K, iters: int = 24, refine: int = 2):
    """SPD inverse by Newton-Schulz with Jacobi pre-scaling and the 1-norm
    initial guess X0 = I / ||D K D||_1; ``iters + refine`` iterations."""
    I = _eye(K)
    dg = torch.diagonal(K, dim1=-2, dim2=-1)
    d = torch.rsqrt(torch.clamp(dg, min=1e-30))
    Ks = d[..., :, None] * K * d[..., None, :]
    norm1 = torch.amax(torch.sum(torch.abs(Ks), dim=-2), dim=-1)
    X = I * (1.0 / torch.clamp(norm1, min=1e-30))[..., None, None]
    for _ in range(iters + refine):
        X = X @ (2.0 * I - Ks @ X)
    return d[..., :, None] * X * d[..., None, :]


def ns_warm_inverse(K, X_guess, iters: int = 4):
    """NS inverse hot-started from ``X_guess`` (e.g. last step's inverse of
    a slowly drifting SPD matrix) behind the contraction guard
    sqrt(||I - X K||_1 ||I - X K||_inf) < 0.9, with the Jacobi-prescaled
    cold start D^2 / ||D K D||_1 for items that fail it; the cold start runs
    the same ``iters`` budget. Every test is per item of the leading
    dimensions: an item whose iterate goes non-finite restarts from its own
    cold start, and an item that ends non-finite returns its cold start."""
    I = _eye(K)
    absE = torch.abs(I - X_guess @ K)
    err = torch.sqrt(torch.amax(torch.sum(absE, dim=-2), dim=-1)
                     * torch.amax(torch.sum(absE, dim=-1), dim=-1))
    err = torch.where(torch.isfinite(err), err, 2.0)
    dinv = 1.0 / torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1), min=1e-30)
    sq = torch.sqrt(dinv)
    Ks_norm1 = torch.amax(torch.sum(
        torch.abs(K) * sq[..., :, None] * sq[..., None, :], dim=-2), dim=-1)
    cold = I * (dinv / torch.clamp(Ks_norm1, min=1e-30)[..., None])[..., None, :]
    X = torch.where((err < 0.9)[..., None, None], X_guess, cold)

    def finite(M):
        return torch.isfinite(M).all(dim=-1).all(dim=-1)[..., None, None]

    for _ in range(iters):
        Xn = X @ (2.0 * I - K @ X)
        X = torch.where(finite(Xn), Xn, cold)
    return torch.where(finite(X), X, cold)


def spd_inverse(K, method: str = "ns", **kw):
    if method == "chol":
        return spd_inverse_chol(K)
    return spd_inverse_ns(K, **kw)


def kkt_solve_schur(P, A_act, rhs_x, rhs_y, delta, method: str = "ns",
                    refine: int = 3, row_reg=None, ns_iters: int = 24):
    """Solve the regularized equality-KKT system

        [P + dI      A^T    ] [x]   [rhs_x]
        [A       -diag(r)   ] [y] = [rhs_y]

    by Schur complement with approximate inverses + iterative refinement.
    ``delta`` is a scalar or a per-batch (B,) tensor; zeroed (inactive) rows
    of ``A_act`` take O(1) entries of ``row_reg``."""
    n = P.shape[-1]
    dtype = P.dtype
    delta = torch.as_tensor(delta, dtype=dtype, device=P.device)
    if row_reg is None:
        row_norm = torch.amax(torch.abs(A_act), dim=-1)
        row_reg = torch.where(row_norm > 1e-12, delta[..., None], 1.0).to(dtype)
    Pd = P + delta[..., None, None] * torch.eye(n, dtype=dtype, device=P.device)
    kw = {"iters": ns_iters} if method == "ns" else {}
    Pinv = spd_inverse(Pd, method=method, **kw)
    At = A_act.transpose(-1, -2)
    S = A_act @ Pinv @ At + torch.diag_embed(row_reg)
    Sinv = spd_inverse(S, method=method, **kw)
    mv = lambda M, v: (M @ v[..., None])[..., 0]  # noqa: E731

    def solve_once(rx, ry):
        t = mv(Pinv, rx)
        y = mv(Sinv, mv(A_act, t) - ry)
        x = mv(Pinv, rx - mv(At, y))
        return x, y

    x, y = solve_once(rhs_x, rhs_y)
    for _ in range(refine):
        rx = rhs_x - (mv(Pd, x) + mv(At, y))
        ry = rhs_y - (mv(A_act, x) - row_reg * y)
        dx, dy = solve_once(rx, ry)
        x = x + dx
        y = y + dy
    return x, y
