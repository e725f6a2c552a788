"""iLQR / DDP trajectory optimizer (port of qppvm_tpu/mpc/ilqr.py).

Generic over (dynamics, cost, final cost), each a function of one state
(and control) written so that ``torch.func`` can differentiate it. One
``solve`` runs a fixed number of outer iterations, each of:

- the derivatives along the whole trajectory at once (``torch.func.jacfwd``,
  ``grad`` and ``hessian`` under ``vmap`` over the H steps);
- the backward pass, a Python loop over the horizon in reverse of small
  products; Q_uu's inverse goes through ``ns_inverse.spd_inverse``'s
  counted rule (the NS kernel for float32 on the card, one launch a step);
- a parallel line search: every step size in ``alphas`` rolled out at once
  as a leading dimension, the cheapest kept;
- Levenberg-Marquardt regularization carried across iterations.

Acceptance, argmin and the regularization update stay on the device
(``torch.where``): a solve reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.func import grad, hessian, jacfwd, vmap

from qppvm_tpu_torch.opt import ns_inverse

# Newton-Schulz iterations of Q_uu's inverse (the reference's 20 + 2
# refinement steps)
QUU_NS_ITERS = 22


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    iterations: int = 10
    alphas: tuple = (1.0, 0.6, 0.3, 0.1, 0.03, 0.0)  # 0.0 = keep current
    reg_init: float = 1e-6
    reg_up: float = 10.0
    reg_down: float = 0.5
    reg_min: float = 1e-9
    reg_max: float = 1e6
    u_min: Optional[float] = None   # optional box clamp on controls
    u_max: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ILQRResult:
    U: torch.Tensor      # (H, nu) optimized controls
    X: torch.Tensor      # (H+1, nx) optimized trajectory
    cost: torch.Tensor   # () final cost
    K: torch.Tensor      # (H, nu, nx) feedback gains (for tracking)
    k: torch.Tensor      # (H, nu) feedforward
    reg: torch.Tensor    # () final LM regularization


def _rollout(dyn, cost, final_cost, x0, U):
    X, cs = [x0], []
    for t in range(U.shape[0]):
        cs.append(cost(X[-1], U[t]))
        X.append(dyn(X[-1], U[t]))
    return torch.stack(X), torch.sum(torch.stack(cs)) + final_cost(X[-1])


def _rollout_feedback(dyn, cost, final_cost, x0, X_ref, U_ref, K, k, alphas,
                      u_min, u_max):
    """The feedback rollouts of every step size in ``alphas`` (A,) at once:
    (X (A, H+1, nx), U (A, H, nu), cost (A,))."""
    dyn_b, cost_b = vmap(dyn), vmap(cost)
    x = x0.expand(alphas.shape[0], -1)
    X, U, cs = [x], [], []
    for t in range(U_ref.shape[0]):
        u = (U_ref[t] + alphas[:, None] * k[t]
             + (K[t] @ (x - X_ref[t])[..., None])[..., 0])
        if u_min is not None or u_max is not None:
            u = torch.clamp(u, u_min, u_max)
        cs.append(cost_b(x, u))
        x = dyn_b(x, u)
        X.append(x)
        U.append(u)
    total = torch.sum(torch.stack(cs), dim=0) + vmap(final_cost)(x)
    return torch.stack(X, dim=1), torch.stack(U, dim=1), total


def _pick(batch, i):
    """``batch[i]`` for a device index tensor ``i`` (no host read)."""
    return torch.index_select(batch, 0, i.reshape(1))[0]


def make_solver(dyn: Callable, cost: Callable, final_cost: Callable,
                cfg: ILQRConfig = ILQRConfig()):
    """Returns solve(x0, U0) -> ILQRResult."""

    def step_derivatives(x, u):
        return (jacfwd(dyn, argnums=0)(x, u), jacfwd(dyn, argnums=1)(x, u),
                grad(cost, argnums=0)(x, u), grad(cost, argnums=1)(x, u),
                hessian(cost, argnums=0)(x, u),
                hessian(cost, argnums=1)(x, u),
                jacfwd(grad(cost, argnums=1), argnums=0)(x, u))

    derivatives = vmap(step_derivatives)

    def backward(X, U, reg):
        """Feedback gains K (H, nu, nx) and feedforward k (H, nu)."""
        A, Bm, lx, lu, lxx, luu, lux = derivatives(X[:-1], U)
        Vx, Vxx = grad(final_cost)(X[-1]), hessian(final_cost)(X[-1])
        eye = torch.eye(U.shape[1], dtype=U.dtype, device=U.device)
        K, k = [None] * U.shape[0], [None] * U.shape[0]
        for t in reversed(range(U.shape[0])):
            At, Bt = A[t], Bm[t]
            Qx = lx[t] + At.T @ Vx
            Qu = lu[t] + Bt.T @ Vx
            Qxx = lxx[t] + At.T @ Vxx @ At
            Quu = luu[t] + Bt.T @ Vxx @ Bt
            Qux = lux[t] + Bt.T @ Vxx @ At
            # matmul-only inverse; Quu + reg I is SPD by LM regularization
            Quu_inv = ns_inverse.spd_inverse(
                (Quu + reg * eye)[None].contiguous(), QUU_NS_ITERS)[0]
            k[t] = -(Quu_inv @ Qu)
            K[t] = -(Quu_inv @ Qux)
            Vx = Qx + K[t].T @ Quu @ k[t] + K[t].T @ Qu + Qux.T @ k[t]
            Vxx = Qxx + K[t].T @ Quu @ K[t] + K[t].T @ Qux + Qux.T @ K[t]
            Vxx = 0.5 * (Vxx + Vxx.T)
        return torch.stack(K), torch.stack(k)

    def solve(x0, U0) -> ILQRResult:
        X, c = _rollout(dyn, cost, final_cost, x0, U0)
        U = U0
        alphas = torch.tensor(cfg.alphas, dtype=X.dtype, device=X.device)
        reg = torch.tensor(cfg.reg_init, dtype=X.dtype, device=X.device)
        for _ in range(cfg.iterations):
            K, k = backward(X, U, reg)
            Xs, Us, costs = _rollout_feedback(
                dyn, cost, final_cost, x0, X, U, K, k, alphas, cfg.u_min,
                cfg.u_max)
            costs = torch.where(torch.isfinite(costs), costs, torch.inf)
            best = torch.argmin(costs)
            c_best = _pick(costs, best)
            improved = c_best < c - 1e-10
            X = torch.where(improved, _pick(Xs, best), X)
            U = torch.where(improved, _pick(Us, best), U)
            c = torch.where(improved, c_best, c)
            reg = torch.clamp(
                torch.where(improved, reg * cfg.reg_down, reg * cfg.reg_up),
                cfg.reg_min, cfg.reg_max)
        K, k = backward(X, U, reg)
        return ILQRResult(U=U, X=X, cost=c, K=K, k=k, reg=reg)

    return solve
