"""Batched SPD inverse by Newton-Schulz through a hand-written CUDA kernel
(counterpart of qppvm_tpu/opt/pallas_linalg.py).

``ns_inverse`` inverts a batch K (B, n, n) of SPD matrices with the
arithmetic of ``linalg.spd_inverse_ns(K, iters, refine=0)``: Jacobi
prescale, 1-norm start, ``iters`` steps X <- X (2I - Ks X). On a CUDA tensor
it launches ``csrc/ns_inverse.cu`` (one thread block per matrix, Ks, X and
one temporary in shared memory, 3xTF32 products on the tensor cores) or
raises; on a CPU tensor it runs
``ns_inverse_reference``, the same function in plain PyTorch.

``spd_inverse`` is the routed inverse the program calls (mass matrices,
the DDP planner's Q_uu and SRBD inertia): a CUDA matrix the kernel takes
(``takes``) goes to it, any other CUDA matrix to the plain NS, counted as
``model.plain_inverse`` (``telemetry``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from qppvm_tpu_torch import bench_util, telemetry
from qppvm_tpu_torch.opt import linalg

# Shared memory a block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448

_lib = None


def ns_inverse_reference(K, iters: int = 26):
    """The kernel's function in plain PyTorch."""
    return linalg.spd_inverse_ns(K, iters=iters, refine=0)


def library() -> ctypes.CDLL:
    """The built kernel library (compiled from csrc/ns_inverse.cu on first
    use)."""
    global _lib
    if _lib is None:
        from qppvm_tpu_torch import build
        lib = build.load("ns_inverse")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ns_inverse_launch.argtypes = [p, p, i, i, i, p]
        lib.ns_inverse_launch.restype = i
        lib.ns_inverse_smem_bytes.argtypes = [i]
        lib.ns_inverse_smem_bytes.restype = i
        lib.ns_inverse_max_n.argtypes = []
        lib.ns_inverse_max_n.restype = i
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def max_n() -> int:
    """The largest n the kernel holds: its strips' width, and a block's
    shared memory (ns_inverse_smem_bytes grows with n)."""
    lib = library()
    n = lib.ns_inverse_max_n()
    while lib.ns_inverse_smem_bytes(n) > MAX_SMEM_BYTES:
        n -= 1
    return n


def takes(dtype, n: int, largest: int) -> bool:
    """Whether the kernel inverts a matrix of ``dtype`` and size n, given
    its largest size ``largest`` (``max_n()``)."""
    return dtype == torch.float32 and n <= largest


def _launch(K, iters: int):
    if K.dim() != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"K: need shape (B, n, n), got {tuple(K.shape)}")
    if not K.is_contiguous():
        raise ValueError("K must be contiguous")
    B, n, _ = K.shape
    if not takes(K.dtype, n, max_n()):
        raise ValueError(f"K: the kernel takes float32 up to n={max_n()} "
                         f"(a block's {MAX_SMEM_BYTES} bytes of shared "
                         f"memory), got {K.dtype} at n={n}")
    lib = library()
    out = torch.empty_like(K)
    with torch.cuda.device(K.device):
        stream = torch.cuda.current_stream(K.device).cuda_stream
        rc = lib.ns_inverse_launch(K.data_ptr(), out.data_ptr(), B, n,
                                   int(iters), stream)
    if rc != 0:
        raise RuntimeError(f"ns_inverse kernel launch failed: CUDA error {rc}")
    telemetry.count("ns_inverse.launch")
    return out


def ns_inverse(K, iters: int = 26):
    """Inverse of each SPD matrix of K (B, n, n): the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor; anything else raises.
    Either route counts at the kernel's declared cost in
    ``bench_util.matmul_flops``."""
    with bench_util.declared(bench_util.ns_inverse_cost, *K.shape[:2],
                             iters):
        if K.device.type == "cuda":
            return _launch(K, iters)
        if K.device.type == "cpu":
            return ns_inverse_reference(K, iters)
    raise ValueError(f"no NS inverse for device {K.device}")


def spd_inverse(K, iters: int = 24):
    """``iters`` Newton-Schulz iterations of ``linalg.spd_inverse_ns`` (its
    iters - 2 plus 2 refinement steps) on SPD matrices K (B, n, n). A CUDA
    tensor the kernel takes goes to it (``ns_inverse(K, iters)``, one
    launch); any other CUDA tensor runs the plain version and counts one
    ``model.plain_inverse`` (``telemetry``). A CPU tensor goes through
    ``ns_inverse``, which runs the same plain version."""
    if K.device.type == "cuda" and not takes(K.dtype, K.shape[-1], max_n()):
        telemetry.count("model.plain_inverse")
        return linalg.spd_inverse_ns(K, iters=iters - 2, refine=2)
    return ns_inverse(K, iters)
