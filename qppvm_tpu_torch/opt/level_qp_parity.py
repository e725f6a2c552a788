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


def random_problems(B, n, m, h, t, device, seed, locks=False):
    """B problems (P, q, A, l, u) with h head and t tail equality rows.

    ``locks``: the tail rows are a cascade's locks, A_t x = A_t x0 at a
    point x0 (0.1 N(0, 1)) inside every inequality row's bounds, so each
    problem is feasible, as a cascade level is by construction. (Unlocked,
    6 random tail rows in 7 variables leave about a tenth of the problems
    infeasible, with multipliers diverging over the iterations.)"""
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
    if locks:
        Ax0 = (A @ (0.1 * rn(B, n))[..., None])[..., 0]
        b = torch.where(eq, Ax0, b)
        lo, hi = torch.minimum(lo, Ax0 - 0.1), torch.maximum(hi, Ax0 + 0.1)
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


def float32_undetermined(ref, ref64, bars):
    """(B,) bool: items whose plain float32 result lies outside the bars of
    its own float64 result in x, z, y or Kinv. Float32 does not determine
    them: at 6 equalities in 7 variables (the arm's QPPVM level 1) random
    equality blocks include near-singular ones, whose multipliers reach 1e5
    and move by 1e3 between float32 and float64."""
    bad = torch.zeros(ref[0].shape[0], dtype=torch.bool, device=ref[0].device)
    for name in ("x", "z", "y", "Kinv"):
        i = OUTPUTS.index(name)
        atol, rtol = bars[name]
        gap = (ref[i].double() - ref64[i]).abs()
        bad |= (gap > atol + rtol * ref64[i].abs()).flatten(1).any(1)
    return bad


def check_level_outputs(cfg, prob, state, out, excuse_undetermined=False):
    """Hold kernel outputs ``out`` for problems ``prob`` from ``state``
    against the plain version. Raises AssertionError naming the first
    output outside its bar. Returns the max abs error per output and of
    the carried rho_scale.

    With ``excuse_undetermined`` the items ``float32_undetermined`` finds
    (at most 1% of the batch, or one item) are held, in place of the bars,
    to the plain version's own float32 error: in x, z, y and Kinv the
    kernel's largest gap to the float64 result is at most 4 times the
    plain float32 result's plus the bar's atol (rho_scale is not held
    there). The count is returned as ``undetermined`` and the gaps are
    over the other items."""
    ref = level_qp.solve_level_reference(cfg, *prob, *state)
    ref64 = level_qp.solve_level_reference(
        cfg, *(a.double() for a in prob + tuple(state)))
    sc = float(ref[0].abs().max()) + 1.0
    bars = dict(x=(2e-4 * sc, 2e-4), z=(5e-4, 5e-4), y=(5e-4, 5e-4),
                Kinv=(5e-4, 5e-4), prim=(1e-5, 2e-2), obj=(1e-4, 1e-3))
    B = ref[0].shape[0]
    skip = torch.zeros(B, dtype=torch.bool, device=ref[0].device)
    if excuse_undetermined:
        skip = float32_undetermined(ref, ref64, bars)
        assert int(skip.sum()) <= max(1, B // 100), (
            f"{int(skip.sum())} of {B} items are float32-undetermined")
        for name in ("x", "z", "y", "Kinv"):
            i = OUTPUTS.index(name)
            worst = lambda a: (a.double() - ref64[i]).abs().flatten(1).amax(1)  # noqa: E731
            ok = worst(out[i]) <= 4.0 * worst(ref[i]) + bars[name][0]
            assert bool((ok | ~skip).all()), (
                f"kernel {name} on a float32-undetermined item is further "
                "from the float64 result than 4 times the plain version")
    keep = ~skip
    errs = {}
    for name, a, r in zip(OUTPUTS, out, ref):
        assert bool(torch.isfinite(a).all()), f"kernel {name} is not finite"
        errs[name] = float((a - r)[keep].abs().max()) if keep.any() else 0.0
        if name in bars:
            atol, rtol = bars[name]
            ok = ((a - r).abs() <= atol + rtol * r.abs()).reshape(B, -1).all(1)
            assert bool((ok | skip).all()), (
                f"kernel {name} differs from the plain version by "
                f"{errs[name]:.3g} (atol {atol:.3g}, rtol {rtol})")
    ok = check_rho_scale(cfg.rho_scale_min, out[4], ref[4], ref64[4])
    carried = [v.clamp(cfg.rho_scale_min, 1.0) for v in (out[4], ref[4])]
    errs["carried_rho_scale"] = float((carried[0] - carried[1]).abs().max())
    bad = (~ok & ~skip).nonzero().flatten()[:4].tolist()
    assert not bad, (
        "kernel rho_scale outside its bar at items " + ", ".join(
            f"{i} (kernel {float(out[4][i]):.6g}, plain float32 "
            f"{float(ref[4][i]):.6g}, float64 {float(ref64[4][i]):.6g}, "
            f"in {float(state[4][i]):.6g})" for i in bad))
    if excuse_undetermined:
        errs["undetermined"] = int(skip.sum())
    return errs
