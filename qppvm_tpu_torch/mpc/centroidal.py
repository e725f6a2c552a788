"""Centroidal (single-rigid-body) dynamics for the DDP planner (port of
qppvm_tpu/mpc/centroidal.py).

State x = [p(3) CoM position; v(3) CoM velocity; th(3) small-angle
orientation; w(3) angular velocity]; control u = stacked per-contact world
forces (nc * 3):

    m v' = sum f_c + m g,   I w' = sum (r_c - p) x f_c,   p' = v,   th' = w

``dynamics_step`` and the cost are written functionally (no in-place
writes, no host reads), so ``torch.func`` differentiates and vmaps them.
The parameters describe one robot: unbatched tensors.
"""
from __future__ import annotations

import dataclasses

import torch

from qppvm_tpu_torch import device as devices
from qppvm_tpu_torch.model import dynamics
from qppvm_tpu_torch.opt import ns_inverse

NX = 12
# Newton-Schulz iterations of the SRBD inertia's inverse (the reference's
# 14 + 2 refinement steps)
INERTIA_NS_ITERS = 16


@dataclasses.dataclass(frozen=True)
class CentroidalParams:
    mass: torch.Tensor       # ()
    inertia: torch.Tensor    # (3, 3) body inertia about the CoM
    footholds: torch.Tensor  # (nc, 3) world foothold positions
    active: torch.Tensor     # (nc,) 0/1 contact gates
    gravity: torch.Tensor    # (3,)
    dt: torch.Tensor         # ()

    @property
    def nc(self) -> int:
        return self.footholds.shape[0]


def nu(params: CentroidalParams) -> int:
    return 3 * params.nc


def from_robot(model, data: dynamics.ModelData, contact_links, dt: float,
               active=None) -> CentroidalParams:
    """SRBD parameters of one robot from its batch-1 ModelData: the feet's
    world positions, the total mass and the generalized mass matrix's
    angular base block as the rotational inertia."""
    if data.B.shape[0] != 1:
        raise ValueError(f"from_robot takes one robot, got a batch of "
                         f"{data.B.shape[0]}")
    feet = torch.stack([dynamics.frame_data(model, data, c)[1][0]
                        for c in contact_links])
    kw = dict(dtype=feet.dtype, device=feet.device)
    return CentroidalParams(
        mass=data.total_mass[0], inertia=data.B[0, :3, :3], footholds=feet,
        active=(torch.ones(len(contact_links), **kw) if active is None
                else torch.as_tensor(active, **kw)),
        gravity=model.gravity.to(feet.dtype),
        dt=torch.as_tensor(dt, **kw))


def init_state(com_pos, com_vel=None, dtype=torch.float32,
               device=devices.DEFAULT):
    """x0 (12,) on ``device`` at ``com_pos`` with ``com_vel`` (default 0),
    at rest otherwise."""
    kw = dict(dtype=dtype, device=devices.resolve(device))
    p = torch.as_tensor(com_pos, **kw)
    v = (torch.zeros_like(p) if com_vel is None
         else torch.as_tensor(com_vel, **kw))
    return torch.cat([p, v, torch.zeros(6, **kw)])


def inertia_inverse(params: CentroidalParams):
    """The SRBD inertia's inverse by INERTIA_NS_ITERS Newton-Schulz
    iterations, through ``ns_inverse.spd_inverse``'s counted rule (the
    NS kernel for float32 on the card). It does not depend on (x, u):
    compute it once and pass it to ``dynamics_step``."""
    K = params.inertia[None].contiguous()
    return ns_inverse.spd_inverse(K, INERTIA_NS_ITERS)[0]


def dynamics_step(params: CentroidalParams, x, u, Iinv):
    """One semi-implicit Euler step of the SRBD model; ``Iinv`` the
    inertia's inverse (``inertia_inverse``)."""
    p, v, th, w = x[0:3], x[3:6], x[6:9], x[9:12]
    f = u.reshape(params.nc, 3) * params.active[:, None]
    F = torch.sum(f, dim=0) + params.mass * params.gravity
    r = params.footholds - p[None, :]
    tau = torch.sum(torch.linalg.cross(r, f, dim=-1), dim=0)
    # small angles: world inertia ~ body inertia (stance-phase MPC)
    v_n = v + params.dt * F / params.mass
    w_n = w + params.dt * (Iinv @ tau)
    p_n = p + params.dt * v_n
    th_n = th + params.dt * w_n
    return torch.cat([p_n, v_n, th_n, w_n])


def standing_cost(params: CentroidalParams, p_ref, w_pos=50.0, w_vel=1.0,
                  w_ang=20.0, w_rate=0.5, w_force=1e-5, w_slack=1e-3):
    """Quadratic tracking cost factory: (x, u) -> scalar. ``w_slack``
    penalizes tangential force (a soft friction-cone surrogate).
    ``w_rate`` is accepted and unused: the reference weighs it by 0."""
    p_ref = torch.as_tensor(p_ref)

    def cost(x, u):
        p, v, th, w = x[0:3], x[3:6], x[6:9], x[9:12]
        f = u.reshape(params.nc, 3)
        return (w_pos * torch.sum((p - p_ref) ** 2)
                + w_vel * torch.sum(v ** 2)
                + w_ang * (torch.sum(th ** 2) + 0.1 * torch.sum(w ** 2))
                + w_force * torch.sum(u ** 2)
                + w_slack * torch.sum(f[:, :2] ** 2))

    return cost


def gravity_feedforward(params: CentroidalParams):
    """The weight split over the active contacts, (nc * 3,): the iLQR's
    natural warm start."""
    active = params.active.to(params.footholds.dtype)
    n_act = torch.clamp(torch.sum(active), min=1.0)
    fz = -params.mass * params.gravity[2] / n_act
    zero = torch.zeros_like(active)
    return torch.stack([zero, zero, fz * active], dim=-1).reshape(-1)
