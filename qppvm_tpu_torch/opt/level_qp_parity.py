"""The CUDA level kernel held against its plain version, on the card.

Shared by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``: WBC-shaped
random problems made as ``tests/test_pallas_qp.py`` makes them, and the
comparison of every kernel output with ``solve_level_reference`` at the
bars of ``tests/test_pallas_qp.py:72-88``, rho_scale excepted (see
``check_rho_scale``).
"""
from __future__ import annotations

import torch

from qppvm_tpu_torch.opt import level_qp

OUTPUTS = ("x", "z", "y", "Kinv", "rho_scale", "prim", "dual", "obj")
# rho_scale bar on the carried value (check_rho_scale): on most items the
# plain version's float32 and float64 results differ by up to about 2% at
# B = 1024
RHO_ATOL, RHO_RTOL = 1e-4, 2e-2


def random_problems(B, n, m, h, t, device, seed):
    """B problems (P, q, A, l, u) with h head and t tail equality rows."""
    g = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=device)  # noqa: E731
    ru = lambda *s: torch.rand(*s, generator=g, device=device)   # noqa: E731
    T = rn(B, n + 4, n) / n ** 0.5
    P = T.transpose(1, 2) @ T + 1e-3 * torch.eye(n, device=device)
    q = 0.3 * rn(B, n)
    A = rn(B, m, n) / n ** 0.5
    b = 0.1 * rn(B, m)
    lo, hi = b - 0.5 - ru(B, m), b + 0.5 + ru(B, m)
    eq = torch.zeros(m, dtype=torch.bool, device=device)
    eq[:h] = True
    if t:
        eq[m - t:] = True
    return P, q, A, torch.where(eq, b, lo), torch.where(eq, b, hi)


def zero_state(B, n, m, device):
    """Cold warm-start state (x, z, y, Kinv, rho_scale)."""
    z = lambda *s: torch.zeros(*s, device=device)  # noqa: E731
    return z(B, n), z(B, m), z(B, m), z(B, n, n), torch.ones(B, device=device)


def check_rho_scale(rho_min, r, r32, r64):
    """(B,) bool: the kernel's rho_scale ``r`` is within the bar of the plain
    version's float32 result ``r32`` or of its float64 result ``r64``.

    The next solve reads rho_scale only as clip(rho_scale, rho_min, 1)
    (qp.py's carried scale), so that carried value is compared. It is
    clip(rho_in * sqrt(prim / dual)) of the scaled residuals, or rho_in
    where max(prim, dual) <= rho_adapt_tol. Where dual sits near float32
    roundoff, or max(prim, dual) near the gate, any float32 solve is noisy
    (its float32 and float64 results can differ by tens of percent), so
    the kernel may side with either result; at the gate it may keep rho_in
    only where one of them did. A kernel that keeps rho_in where the solve
    adapts it fails."""
    c, c32, c64 = (v.double().clamp(rho_min, 1.0) for v in (r, r32, r64))
    bar = lambda ref: RHO_ATOL + RHO_RTOL * ref.abs()  # noqa: E731
    return ((c - c32).abs() <= bar(c32)) | ((c - c64).abs() <= bar(c64))


def check_level_outputs(cfg, prob, state, out):
    """Hold kernel outputs ``out`` for problems ``prob`` from ``state``
    against the plain version. Raises AssertionError naming the first
    output outside its bar. Returns the max abs error per output and of
    the carried rho_scale."""
    ref = level_qp.solve_level_reference(cfg, *prob, *state)
    ref64 = level_qp.solve_level_reference(
        cfg, *(a.double() for a in prob + tuple(state)))
    sc = float(ref[0].abs().max()) + 1.0
    bars = dict(x=(2e-4 * sc, 2e-4), z=(5e-4, 5e-4), y=(5e-4, 5e-4),
                Kinv=(5e-4, 5e-4), prim=(1e-5, 2e-2), obj=(1e-4, 1e-3))
    errs = {}
    for name, a, r in zip(OUTPUTS, out, ref):
        assert bool(torch.isfinite(a).all()), f"kernel {name} is not finite"
        errs[name] = float((a - r).abs().max())
        if name in bars:
            atol, rtol = bars[name]
            assert bool(torch.all((a - r).abs() <= atol + rtol * r.abs())), (
                f"kernel {name} differs from the plain version by "
                f"{errs[name]:.3g} (atol {atol:.3g}, rtol {rtol})")
    ok = check_rho_scale(cfg.rho_scale_min, out[4], ref[4], ref64[4])
    carried = [v.clamp(cfg.rho_scale_min, 1.0) for v in (out[4], ref[4])]
    errs["carried_rho_scale"] = float((carried[0] - carried[1]).abs().max())
    bad = (~ok).nonzero().flatten()[:4].tolist()
    assert not bad, (
        "kernel rho_scale outside its bar at items " + ", ".join(
            f"{i} (kernel {float(out[4][i]):.6g}, plain float32 "
            f"{float(ref[4][i]):.6g}, float64 {float(ref64[4][i]):.6g}, "
            f"in {float(state[4][i]):.6g})" for i in bad))
    return errs
