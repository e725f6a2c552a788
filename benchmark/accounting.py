"""The benchmark's frozen accounting: published peaks, the declared costs of
the level solve and the Newton-Schulz inverse, roofline bounds and a FLOP
count.

A frozen copy of ``qppvm_tpu_torch/bench_util.py`` as it stood when the
benchmark was defined, so that no change to the program can move the
yardstick. ``count_flops(fn)`` counts 2 M N K for every matrix product an
eager call dispatches; a level solve or an NS inverse run inside
``declared(...)`` counts at its declared cost instead and its own products
are not counted. The benchmark counts on its own plain reference
(``reference/``), never on the program.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet at its 700 W limit:
67 TFLOP/s float32 on the CUDA cores, 495 TFLOP/s dense TF32, 3.35 TB/s
of HBM3.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_F32_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES_S = 67e12, 495e12, 3.35e12
# Newton-Schulz iterations of the level solve's equality Gram inverse
GRAM_NS_ITERS = 26


def bound_ms(flops, nbytes, peak=PEAK_F32_FLOPS) -> Tuple[float, str]:
    """The least time for the work on one H100 at ``peak`` FLOP/s and what
    bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def level_qp_cost(cfg, B: int, n: int, m: int) -> Tuple[float, float]:
    """(flops, bytes) of one level solve, counted from the shapes with
    every item on the warm branch of the NS guard (the least work): the
    equality Gram inverse and pseudo-inverse refinement, the projected KKT
    matrix, the guard product, the warm NS iterations, the ADMM iterations
    and the final residuals; each input read once, each output written
    once. ``cfg`` needs ``n_eq_head``, ``n_eq_tail``, ``pinv_ns_iters``,
    ``warm_kinv_iters`` and ``iters``."""
    ne = cfg.n_eq_head + cfg.n_eq_tail
    mi = m - ne
    elim = 0
    if ne:
        elim = (2 * ne * ne * n + 4 * GRAM_NS_ITERS * ne ** 3
                + 2 * n * ne * ne + 4 * cfg.pinv_ns_iters * n * ne * ne
                + 2 * n * n * ne + 4 * n ** 3)
    flops = (elim + 2 * n * n * mi + 2 * n ** 3
             + 4 * cfg.warm_kinv_iters * n ** 3
             + cfg.iters * (4 * n * n + 4 * mi * n)
             + 6 * n * n + 6 * mi * n + 4 * m * n)
    words = (2 * n * n + m * n + 3 * n + 4 * m + 1) + (n * n + n + 2 * m + 4)
    return B * flops, 4 * B * words


def ns_inverse_cost(B: int, n: int, iters: int) -> Tuple[float, float]:
    """(flops, bytes) of one batched NS inverse: two n^3 products an
    iteration; K read once, the inverse written once."""
    return 4 * B * iters * n ** 3, 2 * B * n * n * 4


# the active counts, innermost last
_counts: list = []


class _Declared:
    """Adds a declared cost to every active count and stops them counting
    the products dispatched inside."""

    def __init__(self, flops: float):
        self.flops = flops

    def __enter__(self):
        for c in _counts:
            if c.depth == 0:
                c.flops += self.flops
            c.depth += 1

    def __exit__(self, *exc):
        for c in _counts:
            c.depth -= 1


def declared(cost: Callable, *args):
    """Context for a solve whose work counts as ``cost(*args)[0]`` FLOPs;
    free when no count is active."""
    if not _counts:
        return contextlib.nullcontext()
    return _Declared(cost(*args)[0])


def _mm_flops(args):          # mm, bmm: (.., M, K) x (.., K, N)
    a, b = args[-2], args[-1]
    return 2.0 * a.numel() * b.shape[-1]


def _mv_flops(args):          # mv, dot: (M, K) x (K,)
    return 2.0 * args[-2].numel()


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        aten = torch.ops.aten
        self.rules = {aten.mm: _mm_flops, aten.addmm: _mm_flops,
                      aten.bmm: _mm_flops, aten.baddbmm: _mm_flops,
                      aten.mv: _mv_flops, aten.addmv: _mv_flops,
                      aten.dot: _mv_flops, aten.vdot: _mv_flops}
        self.flops = 0.0
        self.depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rule = self.rules.get(func.overloadpacket)
        if rule is not None and self.depth == 0:
            self.flops += rule(args)
        return out


def count_flops(fn: Callable, *args, **kwargs) -> float:
    """Matrix-product FLOPs of one eager call of ``fn``, level solves and
    NS inverses at their declared costs. Elementwise work is left out, so
    an MFU from it is a lower bound."""
    count = _Count()
    _counts.append(count)
    try:
        with count:
            fn(*args, **kwargs)
    finally:
        _counts.remove(count)
    return count.flops
