"""Reference-trajectory generators (port of qppvm_tpu/runtime/trajectory.py).

The reference's moving end-effector sinusoid, min-jerk point-to-point
interpolation (with velocity and acceleration feedforward) and a
piecewise min-jerk waypoint spline. Points are tensors of any leading
shape; times are floats or tensors that broadcast against them.
"""
from __future__ import annotations

import torch


def _clip01(s):
    if isinstance(s, torch.Tensor):
        return torch.clamp(s, 0.0, 1.0)
    return min(max(float(s), 0.0), 1.0)


def qppvm_sinusoid(start_p, t, t0=0.0, amplitude: float = 0.15):
    """The reference's moving left-EE reference: y += A sin(t - t0),
    z += A (1 - cos(t - t0)); ``start_p`` (..., 3)."""
    t = torch.as_tensor(t - t0, dtype=start_p.dtype, device=start_p.device)
    dy = amplitude * torch.sin(t)
    dz = amplitude * (1.0 - torch.cos(t))
    zero = torch.zeros_like(dy)
    return start_p + torch.stack([zero, dy, dz], dim=-1)


def _blend(t, duration):
    s = _clip01(t / duration)
    return (10.0 * s ** 3 - 15.0 * s ** 4 + 6.0 * s ** 5,
            (30.0 * s ** 2 - 60.0 * s ** 3 + 30.0 * s ** 4) / duration,
            (60.0 * s - 180.0 * s ** 2 + 120.0 * s ** 3) / duration ** 2)


def min_jerk(p0, p1, t, duration):
    """Min-jerk interpolation p0 -> p1 over [0, duration], clamped outside:
    (position, velocity)."""
    blend, dblend, _ = _blend(t, duration)
    return p0 + (p1 - p0) * blend, (p1 - p0) * dblend


def min_jerk_pva(p0, p1, t, duration):
    """Min-jerk with acceleration feedforward: (p, v, a), the acceleration
    for acceleration-level tasks' ``refs[...]["a"]``."""
    blend, dblend, ddblend = _blend(t, duration)
    d = p1 - p0
    return p0 + d * blend, d * dblend, d * ddblend


def waypoint_spline(waypoints, times, t):
    """Piecewise min-jerk through ``waypoints`` (K, d) at knot ``times``
    (K,); ``t`` a float or a 0-d tensor. Returns (position, velocity)."""
    K = waypoints.shape[0]
    t = torch.as_tensor(t, dtype=times.dtype, device=times.device)
    idx = torch.clamp(torch.searchsorted(times, t.reshape(1),
                                         right=True)[0] - 1, 0, K - 2)
    t0, t1 = times[idx], times[idx + 1]
    return min_jerk(waypoints[idx], waypoints[idx + 1], t - t0,
                    torch.clamp(t1 - t0, min=1e-9))
