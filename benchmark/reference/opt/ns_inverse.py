"""Batched SPD inverse by Newton-Schulz, the plain function of the port's NS
kernel: Jacobi prescale, 1-norm start, ``iters`` steps X <- X (2I - Ks X)
(``linalg.spd_inverse_ns(K, iters, refine=0)``), counted at the kernel's
declared cost."""
from __future__ import annotations

from benchmark import accounting
from benchmark.reference.opt import linalg


def ns_inverse(K, iters: int = 26):
    """Inverse of each SPD matrix of K (B, n, n)."""
    with accounting.declared(accounting.ns_inverse_cost, *K.shape[:2],
                             iters):
        return linalg.spd_inverse_ns(K, iters=iters, refine=0)
