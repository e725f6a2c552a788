"""Batched whole-level QP solve through a hand-written CUDA kernel
(counterpart of qppvm_tpu/opt/pallas_qp.py).

``solve_level`` solves one cascade level for every item of a batch. On a
CUDA tensor it launches ``csrc/level_qp.cu`` (one thread block per QP,
working set in shared memory) or raises; on a CPU tensor it runs
``solve_level_reference``, the same function in plain PyTorch.

``solve`` is the cascade's level solver and the one place that routes a
level: to ``solve_level`` when the kernel's profile holds it (the deployed
real-time one of qp.solve: rho_updates = 0, no polish, Newton-Schulz
inverses, a warm state with its KKT inverse, at least one inequality row)
and, on the card, its float32 working set fits a block's shared memory;
every other level runs qp.solve and counts one ``cascade.fallback``
(``telemetry``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from qppvm_tpu_torch import bench_util, telemetry
from qppvm_tpu_torch.opt import qp

# Newton-Schulz iterations of the equality Gram inverse: linalg.spd_inverse's
# default 24 + 2 refinement steps, which qp.solve uses.
GRAM_NS_ITERS = 26
# Shared memory a block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448


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


_lib = None


def library() -> ctypes.CDLL:
    """The built kernel library (compiled from csrc/level_qp.cu on first
    use)."""
    global _lib
    if _lib is None:
        from qppvm_tpu_torch import build
        lib = build.load("level_qp")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.level_qp_launch.argtypes = ([p] * 18 + [i] * 11 + [f] * 6
                                        + [i, p])
        lib.level_qp_launch.restype = ctypes.c_int
        lib.level_qp_smem_floats.argtypes = [i, i, i, i]
        lib.level_qp_smem_floats.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_profile(cfg: LevelQPConfig, n: int, m: int) -> None:
    ne = cfg.n_eq_head + cfg.n_eq_tail
    if m - ne <= 0:
        raise ValueError(
            f"level has m={m} rows, all {ne} of them equalities: the level "
            "solver needs at least one inequality row (route the level to "
            "qp.solve)")
    if ne > n:
        raise ValueError(f"{ne} equality rows exceed the {n} variables")


@functools.lru_cache(maxsize=None)
def _smem_bytes(n: int, m: int, h: int, t: int) -> int:
    return 4 * library().level_qp_smem_floats(n, m, h, t)


def _launch(cfg: LevelQPConfig, P, q, A, l, u, wx, wz, wy, wK, wr):
    B, n, _ = P.shape
    m = A.shape[1]
    shapes = dict(P=(B, n, n), q=(B, n), A=(B, m, n), l=(B, m), u=(B, m),
                  wx=(B, n), wz=(B, m), wy=(B, m), wK=(B, n, n), wr=(B,))
    args = dict(P=P, q=q, A=A, l=l, u=u, wx=wx, wz=wz, wy=wy, wK=wK, wr=wr)
    for name, t in args.items():
        if t.device != P.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: need float32 on {P.device}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, need "
                             f"{shapes[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = library()
    h, t_ = cfg.n_eq_head, cfg.n_eq_tail
    smem = _smem_bytes(n, m, h, t_)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"n={n}, m={m} needs {smem} bytes of shared memory "
                         f"per block, more than the {MAX_SMEM_BYTES} a block "
                         "can hold")
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=P.device)  # noqa: E731
    outs = (empty(B, n), empty(B, m), empty(B, m), empty(B, n, n), empty(B),
            empty(B), empty(B), empty(B))
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        rc = lib.level_qp_launch(
            *(a.data_ptr() for a in args.values()),
            *(o.data_ptr() for o in outs),
            B, n, m, h, t_, cfg.iters, cfg.warm_kinv_iters,
            -1 if cfg.cold_ns_iters is None else cfg.cold_ns_iters,
            cfg.scale_iters, cfg.pinv_ns_iters, GRAM_NS_ITERS, cfg.rho,
            cfg.sigma, cfg.alpha, cfg.rho_adapt_tol, cfg.rho_scale_min,
            cfg.eq_pin, int(cfg.z_clip), stream)
    if rc != 0:
        raise RuntimeError(f"level_qp kernel launch failed: CUDA error {rc}")
    telemetry.count("level_qp.launch")
    return outs


def solve_level(cfg: LevelQPConfig, P, q, A, l, u, wx, wz, wy, wK, wr):
    """Solve one level for the whole batch (same signature and outputs as
    ``solve_level_reference``): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; anything else raises. Either route counts at
    the kernel's declared cost in ``bench_util.matmul_flops``."""
    _check_profile(cfg, P.shape[-1], A.shape[1])
    with bench_util.declared(bench_util.level_qp_cost, cfg, *P.shape[:2],
                             A.shape[1]):
        if P.device.type == "cuda":
            return _launch(cfg, P, q, A, l, u, wx, wz, wy, wK, wr)
        if P.device.type == "cpu":
            return solve_level_reference(cfg, P, q, A, l, u, wx, wz, wy, wK,
                                         wr)
    raise ValueError(f"no level solver for device {P.device}")


def solve(prob: qp.QPProblem, st: Optional[qp.QPState], **opts):
    """One cascade level (qp.solve's arguments and outputs): through
    ``solve_level`` where the kernel takes the level, else qp.solve,
    counted as one ``cascade.fallback``."""
    h, t = opts.get("n_eq_head", 0), opts.get("n_eq_tail", 0)
    m, n = prob.A.shape[1:]
    cfg = None
    if st is not None and m - h - t > 0:
        cfg = config_from_opts(opts, n_eq_head=h, n_eq_tail=t,
                               iters=opts["iters"])
    if cfg is not None and prob.P.device.type == "cuda" and (
            prob.P.dtype != torch.float32
            or _smem_bytes(n, m, h, t) > MAX_SMEM_BYTES):
        cfg = None
    if cfg is None:
        telemetry.count("cascade.fallback")
        return qp.solve(prob, st, **opts)
    x, z, y, K, r, prim, dual, obj = solve_level(
        cfg, prob.P, prob.q, prob.A, prob.l, prob.u, st.x, st.z, st.y,
        st.Kinv, st.rho_scale)
    return (x, qp.QPState(x=x, z=z, y=y, Kinv=K, rho_scale=r),
            qp.QPInfo(prim_res=prim, dual_res=dual, obj=obj))
