"""Benchmark accounting on the card: FLOP counts, bounds and MFU (port of
qppvm_tpu/bench_util.py).

``matmul_flops(fn, *args)`` counts 2 M N K for every matrix product that an
eager call of ``fn`` dispatches (aten's mm, addmm, bmm, baddbmm, mv,
addmv, dot; matmul and einsum reach these as they lower), the counterpart
of the reference's jaxpr walk: a Python loop counts each trip as it runs,
as the walk multiplies a scan body by its trip count. Each level solve and
each NS inverse counts by its declared cost instead, whichever route runs
it (the kernel, or its plain version, whose own products are then not
counted), as the walk counts a ``pallas_call`` by its CostEstimate: the
count reads the same work whatever implements it. ``level_qp_cost`` and
``ns_inverse_cost`` are those declared costs, and with ``bound_ms`` the
kernels' rooflines in chip_smoke.py.

The reference's ``program_flops`` (XLA's cost analysis of a compiled
program) has no counterpart: torch compiles no whole program here, and its
own docstring says not to use it (the analysis undercounts loops).

Peaks are one NVIDIA H100 SXM's, from NVIDIA's data sheet at its 700 W
limit: 67 TFLOP/s in float32 on the CUDA cores, 495 TFLOP/s in TF32 on
the tensor cores, 3.35 TB/s of HBM. ``peak_flops`` gives the float32 one:
the port pins float32 products (precision.py turns TF32 off; the NS
kernel's 3xTF32 products keep float32 accuracy). The CPU has none.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_F32_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES_S = 67e12, 495e12, 3.35e12
_PEAK_FLOPS = (("h100", PEAK_F32_FLOPS),)


def peak_flops(device_name: str) -> Optional[float]:
    """Peak float32 FLOP/s of a card by its name
    (``torch.cuda.get_device_name``); None when unknown, the CPU among
    them."""
    name = device_name.lower()
    for key, peak in _PEAK_FLOPS:
        if key in name:
            return peak
    return None


def bound_ms(flops, nbytes, peak=PEAK_F32_FLOPS) -> Tuple[float, str]:
    """The least time for the work on one H100 at ``peak`` FLOP/s and what
    bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def level_qp_cost(cfg, B: int, n: int, m: int) -> Tuple[float, float]:
    """(flops, bytes) of one level solve (``opt/level_qp.py``), counted
    from the shapes with every item on the warm branch of the NS guard
    (the least work): the equality Gram inverse and pseudo-inverse
    refinement, the projected KKT matrix, the guard product, the warm NS
    iterations, the ADMM iterations and the final residuals; each input
    read once, each output written once."""
    from qppvm_tpu_torch.opt.level_qp import GRAM_NS_ITERS

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
    """(flops, bytes) of one batched NS inverse (``opt/ns_inverse.py``):
    two n^3 products an iteration; K read once, the inverse written once."""
    return 4 * B * iters * n ** 3, 2 * B * n * n * 4


# the active matmul_flops counts, innermost last
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
    """Context for a solve whose work counts as ``cost(*args)[0]`` FLOPs
    (a ``*_cost`` function above); free when no count is active."""
    if not _counts:
        return contextlib.nullcontext()
    return _Declared(cost(*args)[0])


def _mm_flops(args, _out):          # mm, bmm: (.., M, K) x (.., K, N)
    a, b = args[-2], args[-1]
    return 2.0 * a.numel() * b.shape[-1]


def _mv_flops(args, _out):          # mv, dot: (M, K) x (K,)
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
            self.flops += rule(args, out)
        return out


def matmul_flops(fn: Callable, *args, **kwargs) -> float:
    """Matrix-product FLOPs (2 M N K a product) of one eager call of
    ``fn(*args, **kwargs)``, with the level solves and NS inverses at their
    declared costs (module docstring). Elementwise work is left out, so the
    MFU from it is a lower bound, as the reference's."""
    count = _Count()
    _counts.append(count)
    try:
        with count:
            fn(*args, **kwargs)
    finally:
        _counts.remove(count)
    return count.flops


def mfu(flops_per_exec: Optional[float], seconds_per_exec: float,
        device_name: str, n_devices: int = 1) -> Optional[float]:
    """Model FLOPs utilization: FLOPs / time / the peak of the
    ``n_devices`` cards that ran them (a sharded plan's FLOPs divide over
    its cards). None when the FLOPs or the peak are unknown."""
    peak = peak_flops(device_name)
    if flops_per_exec is None or peak is None or seconds_per_exec <= 0:
        return None
    return flops_per_exec / seconds_per_exec / (peak * max(1, n_devices))
