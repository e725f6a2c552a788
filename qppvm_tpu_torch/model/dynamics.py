"""Rigid-body dynamics: RNEA, mass matrix and the per-tick model data
(port of qppvm_tpu/model/dynamics.py), batched over a leading dimension B.

Generalized-vector layout (floating): ``[base(6, body-frame,
angular-first); joints(nj)]``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import kinematics, model_sweep, spatial
from qppvm_tpu_torch.model.robot import RobotModel, RobotState
from qppvm_tpu_torch.opt import linalg, ns_inverse


def _base_gravity_acc(model: RobotModel, state: RobotState):
    """Fictitious root acceleration implementing gravity (body coords)."""
    g = model.gravity.to(state.q.dtype)
    lin = -torch.einsum("bji,j->bi", state.base_rot, g)   # R^T (-g)
    return torch.cat([torch.zeros_like(lin), lin], dim=-1)


def rnea(model: RobotModel, state: RobotState, udot, gravity: bool = True,
         kin: Optional[kinematics.KinData] = None, ext_wrenches=None):
    """Recursive Newton-Euler: generalized forces (B, nv) for motion
    ``udot`` (B, nv). With udot = 0 this is h(q, qd). ``ext_wrenches``:
    optional (B, nj, 6) external wrenches at each link origin, world frame,
    linear-first."""
    dtype = state.q.dtype
    udot = udot.to(dtype)
    B = state.q.shape[0]
    zeros6 = torch.zeros((B, 6), dtype=dtype, device=state.q.device)
    if model.floating:
        base_udot, qdd, v_base = udot[:, :6], udot[:, 6:], state.base_vel
    else:
        base_udot, qdd, v_base = zeros6, udot, zeros6
    a_base = base_udot
    if gravity:
        a_base = a_base + _base_gravity_acc(model, state)

    E_loc, p_loc = kinematics.joint_local_all(model, state.q)
    v, a = kinematics.propagate_va(model, state.qd, qdd, v_base, a_base,
                                   E_loc, p_loc)
    # inertia (nj, 6, 6), or (B, nj, 6, 6) for a per-item scaled model
    inertia = model.inertia.to(dtype)
    Iv = (inertia @ v[..., None])[..., 0]
    f = (inertia @ a[..., None])[..., 0] + spatial.cross_force(v, Iv)
    if ext_wrenches is not None:
        if kin is None:
            kin = kinematics.fk(model, state)
        n_b = torch.einsum("bnji,bnj->bni", kin.R, ext_wrenches[..., 3:])
        f_b = torch.einsum("bnji,bnj->bni", kin.R, ext_wrenches[..., :3])
        f = f - torch.cat([n_b, f_b], dim=-1)

    # backward sweep, level-reversed: children are strictly deeper, so by the
    # time a level is processed all its descendants have been accumulated.
    # Siblings share a parent index, so the accumulation is an index_add:
    # advanced-index "+=" would keep only one sibling's contribution.
    S = kinematics.motion_subspace_all(model, dtype)
    tau = torch.zeros((B, model.nj), dtype=dtype, device=state.q.device)
    Ib = model.base_inertia.to(dtype)
    f_base = ((Ib @ a_base[..., None])[..., 0]
              + spatial.cross_force(v_base, (Ib @ v_base[..., None])[..., 0]))
    for idx, parc, root in reversed(kinematics.device_levels(model)):
        fi = f[:, idx]
        tau = tau.index_copy(1, idx, torch.einsum("ni,bni->bn", S[idx], fi))
        fp = spatial.xform_force_inv_apply(E_loc[:, idx], p_loc[:, idx], fi)
        f = f.index_add(1, parc, torch.where(root[:, None], 0.0, fp))
        f_base = f_base + torch.sum(torch.where(root[:, None], fp, 0.0), dim=1)

    tau = tau + model.armature.to(dtype) * qdd
    if model.floating:
        return torch.cat([f_base, tau], dim=-1)
    return tau


def nonlinear_term(model: RobotModel, state: RobotState,
                   kin: Optional[kinematics.KinData] = None):
    """h(q, qd) = C(q, qd) qd + g(q), (B, nv)."""
    udot = torch.zeros((state.q.shape[0], model.nv), dtype=state.q.dtype,
                       device=state.q.device)
    return rnea(model, state, udot, gravity=True, kin=kin)


def inverse_dynamics(model: RobotModel, state: RobotState, udot,
                     kin: Optional[kinematics.KinData] = None):
    """tau = ID(q, qd, udot), (B, nv): RNEA with gravity."""
    return rnea(model, state, udot, gravity=True, kin=kin)


def _rot6(R):
    """Block-diagonal diag(R, R) of (..., 3, 3) rotations."""
    Z = torch.zeros_like(R)
    return torch.cat([torch.cat([R, Z], -1), torch.cat([Z, R], -1)], -2)


def mass_matrix(model: RobotModel, state: RobotState,
                kin: Optional[kinematics.KinData] = None):
    """(B, nv, nv) joint-space inertia via the dense world-frame form
    B = sum_i J_i^T I_i^w J_i (batched matmuls)."""
    if kin is None:
        kin = kinematics.fk(model, state)
    Jpub = kinematics.all_link_jacobians(model, kin)          # (B, nj, 6, nv)
    J = torch.cat([Jpub[:, :, 3:], Jpub[:, :, :3]], dim=2)    # angular-first
    Rot6 = _rot6(kin.R)
    I_w = Rot6 @ model.inertia.to(J.dtype) @ Rot6.transpose(-1, -2)
    Bsz, nj, _, nv = J.shape
    IJ = (I_w @ J).reshape(Bsz, nj * 6, nv)
    M = J.reshape(Bsz, nj * 6, nv).transpose(1, 2) @ IJ
    if model.floating:
        Rb6 = _rot6(kin.base_R)
        Jb = torch.cat([Rb6, torch.zeros((Bsz, 6, nv - 6), dtype=J.dtype,
                                         device=J.device)], dim=-1)
        I_bw = Rb6 @ model.base_inertia.to(J.dtype) @ Rb6.transpose(-1, -2)
        M = M + Jb.transpose(-1, -2) @ I_bw @ Jb
    off = 6 if model.floating else 0
    arm = torch.nn.functional.pad(model.armature.to(M.dtype), (off, 0))
    return M + torch.diag_embed(arm)


def ns_kernel_takes(dtype, n: int, max_n: int) -> bool:
    """Whether the NS kernel inverts a matrix of ``dtype`` and size n, given
    its largest size ``max_n``."""
    return dtype == torch.float32 and n <= max_n


def mass_matrix_inverse(B, iters: int = 24, reg: float = 0.0):
    """``iters`` Newton-Schulz iterations of ``linalg.spd_inverse_ns`` (its
    iters - 2 plus 2 refinement steps) on SPD matrices B (B, n, n) (mass
    matrices; also the DDP planner's Q_uu and SRBD inertia), plus
    ``reg`` I where ``reg`` is not 0. A CUDA tensor the NS kernel takes goes
    to it (``ns_inverse.ns_inverse(K, iters)``, one launch); any other CUDA
    tensor runs the plain version and counts one ``model.plain_inverse``
    (``telemetry``). A CPU tensor goes through ``ns_inverse.ns_inverse``,
    which runs the same plain version."""
    K = B if reg == 0.0 else B + reg * torch.eye(B.shape[-1], dtype=B.dtype,
                                                  device=B.device)
    if K.device.type == "cuda" and not ns_kernel_takes(
            K.dtype, K.shape[-1], ns_inverse.library().ns_inverse_max_n()):
        telemetry.count("model.plain_inverse")
        return linalg.spd_inverse_ns(K, iters=iters - 2, refine=2)
    return ns_inverse.ns_inverse(K, iters=iters)


def forward_dynamics(model: RobotModel, state: RobotState, tau,
                     ext_wrenches=None,
                     kin: Optional[kinematics.KinData] = None,
                     method: str = "ns", B=None, binv=None):
    """udot = B^{-1} (S^T tau + tau_ext - h), (B, nv); ``tau`` (B, nj)
    actuated torques, ``ext_wrenches`` as for ``rnea``.

    ``method="ns"``: the Newton-Schulz inverse of B + 1e-9 I
    (``mass_matrix_inverse``) applied with two
    refinement steps against that matrix; ``"chol"``: an exact
    Cholesky solve. ``B``: the mass matrix at ``state`` when the caller has
    it; ``binv``: an approximate inverse of it (a warm inverse carried along
    a rollout), which replaces the cold NS inversion."""
    if kin is None:
        kin = kinematics.fk(model, state)
    zero = torch.zeros((state.q.shape[0], model.nv), dtype=state.q.dtype,
                       device=state.q.device)
    h = rnea(model, state, zero, gravity=True, kin=kin,
             ext_wrenches=ext_wrenches)
    if B is None:
        B = mass_matrix(model, state, kin=kin)
    tau = tau.to(state.q.dtype)
    tau_gen = (torch.cat([torch.zeros_like(tau[:, :6]), tau], dim=-1)
               if model.floating else tau)
    rhs = tau_gen - h
    Breg = B + 1e-9 * torch.eye(model.nv, dtype=B.dtype, device=B.device)
    if method == "chol":
        return torch.cholesky_solve(rhs[..., None],
                                    torch.linalg.cholesky(Breg))[..., 0]
    if binv is None:
        binv = mass_matrix_inverse(Breg)
    mv = lambda M, v: (M @ v[..., None])[..., 0]  # noqa: E731
    x = mv(binv, rhs)
    for _ in range(2):   # refinement against the true B
        x = x + mv(binv, rhs - mv(Breg, x))
    return x


def integrate(model: RobotModel, state: RobotState, udot, dt) -> RobotState:
    """Semi-implicit Euler; a floating-base pose is integrated on SE(3)."""
    if model.floating:
        base_vel = state.base_vel + dt * udot[:, :6]
        qd = state.qd + dt * udot[:, 6:]
        q = state.q + dt * qd
        base_rot = state.base_rot @ spatial.so3_exp(base_vel[:, :3] * dt)
        base_pos = state.base_pos + dt * torch.einsum(
            "bij,bj->bi", state.base_rot, base_vel[:, 3:])
        return RobotState(q=q, qd=qd, base_rot=base_rot, base_pos=base_pos,
                          base_vel=base_vel)
    qd = state.qd + dt * udot
    return RobotState(q=state.q + dt * qd, qd=qd, base_rot=state.base_rot,
                      base_pos=state.base_pos, base_vel=state.base_vel)


def kinetic_energy(model: RobotModel, state: RobotState,
                   kin: Optional[kinematics.KinData] = None):
    """(B,) kinetic energy 0.5 u^T B(q) u."""
    u = state.u if model.floating else state.qd
    M = mass_matrix(model, state, kin=kin)
    return 0.5 * torch.einsum("bi,bij,bj->b", u, M, u)


@dataclasses.dataclass(frozen=True)
class ModelData:
    """Everything tasks need, computed once per control step (batched)."""

    kin: kinematics.KinData
    B: torch.Tensor          # (B, nv, nv)
    h: torch.Tensor          # (B, nv)
    J_all: torch.Tensor      # (B, nj, 6, nv) world Jacobians at link origins
    vel_all: torch.Tensor    # (B, nj, 6) world link twists [v; w]
    bias_all: torch.Tensor   # (B, nj, 6) classical Jdot*u at link origins
    com_pos: torch.Tensor    # (B, 3)
    total_mass: torch.Tensor  # (B,)
    base_vel: torch.Tensor   # (B, 6) [w; v] body coords
    Binv: Optional[torch.Tensor] = None  # (B, nv, nv), with need_binv


def _root_motion(model: RobotModel, data: ModelData, R, dtype):
    """World twist and bias of the root link origin (linear-first)."""
    if not model.floating:
        z6 = torch.zeros((R.shape[0], 6), dtype=dtype, device=R.device)
        return z6, z6
    rot = lambda v: torch.einsum("bij,bj->bi", R, v)  # noqa: E731
    w_b, v_b = data.base_vel[:, :3], data.base_vel[:, 3:]
    vel = torch.cat([rot(v_b), rot(w_b)], dim=-1)
    bias = torch.cat([rot(torch.linalg.cross(w_b, v_b, dim=-1)),
                      torch.zeros_like(w_b)], dim=-1)
    return vel, bias


def _transfer(Rl, pl, Jl, vl, bl, E_off, p_off):
    """Rigid point transfer of link quantities to an attached frame."""
    E_off = torch.as_tensor(E_off, dtype=Rl.dtype, device=Rl.device)
    p_off = torch.as_tensor(p_off, dtype=pl.dtype, device=pl.device)
    R = Rl @ E_off
    p = pl + Rl @ p_off
    r = Rl @ p_off
    S = spatial.skew(r)
    J = torch.cat([Jl[:, :3] - S @ Jl[:, 3:], Jl[:, 3:]], dim=1)
    w = vl[:, 3:]
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)  # noqa: E731
    vel = torch.cat([vl[:, :3] + cross(w, r), w], dim=-1)
    bias_lin = bl[:, :3] + cross(bl[:, 3:], r) + cross(w, cross(w, r))
    return R, p, J, vel, torch.cat([bias_lin, bl[:, 3:]], dim=-1)


def frame_data(model: RobotModel, data: ModelData, name: str):
    """(R, p, J, vel, bias) of a link origin or an extra named frame, each
    with a leading batch dimension."""
    kin = data.kin
    spec = model.frame_spec(name)
    if spec is None:
        li = model.link_index(name)
        if li >= 0:
            return (kin.R[:, li], kin.p[:, li], data.J_all[:, li],
                    data.vel_all[:, li], data.bias_all[:, li])
        R, p = kin.base_R, kin.base_p
        J = kinematics.link_jacobian(model, kin, name)
        vel, bias = _root_motion(model, data, R, p.dtype)
        return R, p, J, vel, bias
    li, E_off, p_off = spec
    if li < 0:
        Rl, pl = kin.base_R, kin.base_p
        Jl = kinematics.link_jacobian(model, kin, model.root_name)
        vl, bl = _root_motion(model, data, Rl, pl.dtype)
        return _transfer(Rl, pl, Jl, vl, bl, E_off, p_off)
    return _transfer(kin.R[:, li], kin.p[:, li], data.J_all[:, li],
                     data.vel_all[:, li], data.bias_all[:, li], E_off, p_off)


def relative_frame_data(model: RobotModel, data: ModelData, distal: str,
                        base: str):
    """(R_rel, p_rel, J_rel, vel_rel, bias_rel) of frame ``distal`` relative
    to frame ``base``, expressed in the base frame."""
    R_d, p_d, J_d, v_d, b_d = frame_data(model, data, distal)
    R_b, p_b, J_b, v_b, b_b = frame_data(model, data, base)
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)  # noqa: E731
    r = p_d - p_b
    S_r = spatial.skew(r)
    w_b = v_b[:, 3:]
    Rt = R_b.transpose(-1, -2)
    rot = lambda v: torch.einsum("bij,bj->bi", Rt, v)  # noqa: E731

    R_rel = Rt @ R_d
    p_rel = rot(r)
    v_rel_w = v_d[:, :3] - v_b[:, :3] - cross(w_b, r)
    w_rel_w = v_d[:, 3:] - v_b[:, 3:]
    vel = torch.cat([rot(v_rel_w), rot(w_rel_w)], dim=-1)
    J_lin_w = J_d[:, :3] - J_b[:, :3] + S_r @ J_b[:, 3:]
    J_ang_w = J_d[:, 3:] - J_b[:, 3:]
    J_rel = torch.cat([Rt @ J_lin_w, Rt @ J_ang_w], dim=1)
    rdot = v_d[:, :3] - v_b[:, :3]
    bias_lin = rot(b_d[:, :3] - b_b[:, :3] - cross(b_b[:, 3:], r)
                   - cross(w_b, rdot) - cross(w_b, v_rel_w))
    bias_ang = rot(b_d[:, 3:] - b_b[:, 3:] - cross(w_b, w_rel_w))
    return R_rel, p_rel, J_rel, vel, torch.cat([bias_lin, bias_ang], dim=-1)


def compute_model_data(model: RobotModel, state: RobotState,
                       need_binv: bool = False,
                       plain_sweeps: bool = False) -> ModelData:
    """The tick's model data; with ``need_binv`` also the mass matrix's
    inverse, 18 + 2 Newton-Schulz iterations without regularization
    (``mass_matrix_inverse(B, 20)``: the NS kernel for float32 on the
    card).

    The recursive sweeps (fk, the nonlinear term, the bias accelerations)
    of a CUDA state the model-sweep kernel takes (``model_sweep.takes``)
    run in one launch (``model_sweep.sweep``, span ``model_update.sweep``);
    any other CUDA state (float64, a per-item inertia, a tensor that needs
    a gradient) runs the plain functions and counts one
    ``model.plain_sweep`` (``telemetry``), as a CPU state runs them.
    ``plain_sweeps`` sends a CUDA state to the plain functions too (and
    counts it): ``ForceAccPlugin.on_start`` passes it, because the
    centaur's on_start with friction cones is not determined in float32.
    Its two polished cold solves amplify the kernel's roundoff in h (about
    2e-7 of max |h|) into a warm solution 0.848 away from the plain
    sweeps' (on an H100, the benchmark's ``start`` check of
    centaur-batch-b1024, whose limit is 1e-4), and every chained tick
    starts from that solution."""
    span = telemetry.span
    cuda = state.q.device.type == "cuda"
    kernel = cuda and not plain_sweeps and model_sweep.takes(model, state)
    if cuda and not kernel:
        telemetry.count("model.plain_sweep")
    with span("model_update"):
        if kernel:
            with span("model_update.sweep"):
                kin, h, bias_all = model_sweep.sweep(model, state)
        else:
            with span("model_update.fk"):
                kin = kinematics.fk(model, state)
        with span("model_update.mass_matrix"):
            M = mass_matrix(model, state, kin=kin)
        if not kernel:
            with span("model_update.nonlinear"):
                h = nonlinear_term(model, state, kin=kin)
        with span("model_update.jacobians"):
            J_all = kinematics.all_link_jacobians(model, kin)
        with span("model_update.velocities"):
            vel_all = kinematics.link_velocities(model, kin, state, J_all)
        if not kernel:
            with span("model_update.bias"):
                bias_all = kinematics.bias_accelerations(model, kin, state)
        with span("model_update.com"):
            total_mass, com_pos = kinematics.com(model, kin)
        Binv = None
        if need_binv:
            with span("model_update.binv"):
                Binv = mass_matrix_inverse(M, 20)
        return ModelData(kin=kin, B=M, h=h, J_all=J_all, vel_all=vel_all,
                         bias_all=bias_all, com_pos=com_pos,
                         total_mass=total_mass, base_vel=state.base_vel,
                         Binv=Binv)
