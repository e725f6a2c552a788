"""The humanoid's real-time closed loop: the ForceAcc tick against the
contact-physics plant, state fed back every tick (the counterpart of
bench_rt_loop.py).

``humanoid_loop`` builds it: ``zoo.humanoid()``, contacts ``l_sole`` /
``r_sole`` with a 4-point foot patch, ``SimRobot``'s default contact
parameters at dt 1 ms in ``SUBSTEPS`` physics steps, and
``ForceAccPlugin(iters=12)`` with the real-time solver profile of bench.py.
``ClosedLoop.run`` drives T ticks eagerly and keeps every gate on the
device; ``ClosedLoop.run_sim`` drives the plant alone at zero torque. The
health gate (``check_health``) reads the result back after timing.
"""
from __future__ import annotations

import dataclasses

import torch

from qppvm_tpu_torch import device as devices
from qppvm_tpu_torch.model import zoo
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
from qppvm_tpu_torch.runtime import robot_interface as ri

CONTACTS = ("l_sole", "r_sole")
FOOT_PATCH = ((0.10, 0.05, 0.0), (0.10, -0.05, 0.0),
              (-0.06, 0.05, 0.0), (-0.06, -0.05, 0.0))
RT_PROFILE = dict(rho_updates=0, warm_kinv_iters=4, cold_ns_iters=10,
                  scale_iters=2, pinv_ns_iters=5)
# physics steps per 1 ms tick (bench_rt_loop.py's --substeps default)
SUBSTEPS = 2
# the stand must hold: final base height within this of the start (m)
MAX_BASE_DRIFT = 0.08


@dataclasses.dataclass
class LoopResult:
    state: ri.RobotState
    anchors: torch.Tensor
    warm: tuple
    n_fail: torch.Tensor    # () solver failures over the run
    prim_max: torch.Tensor  # () largest relative primal residual
    taus: list              # tau of the first ``record`` ticks


class ClosedLoop:
    """The tick plus ``substeps`` plant steps per tick, on the plugin's
    device; the loop's batch is the state's."""

    def __init__(self, plugin: ForceAccPlugin, robot: ri.SimRobot, refs,
                 warm):
        self.plugin = plugin
        self.robot = robot
        self.refs = refs
        self.warm = warm
        self.zero_kd = torch.zeros(plugin.model.nj, dtype=plugin.dtype,
                                   device=plugin.device)

    def run(self, ticks: int, record: int = 0) -> LoopResult:
        """``ticks`` closed-loop ticks from the robot's state and the warm
        state; no host read inside the loop. Keeps the torques of the first
        ``record`` ticks."""
        st, anchors, w = self.robot.state, self.robot._anchors, self.warm
        n_fail = torch.zeros((), dtype=torch.int64, device=st.q.device)
        prim = torch.zeros((), dtype=st.q.dtype, device=st.q.device)
        taus = []
        for k in range(ticks):
            tau, w, aux = self.plugin._step_impl(st, self.refs, w)
            for _ in range(self.robot.substeps):
                st, anchors = self.robot.step(st, anchors, tau, st.q,
                                              self.zero_kd, self.zero_kd)
            n_fail = n_fail + aux.solver_failed.sum()
            prim = torch.maximum(prim, aux.prim_res.max())
            if k < record:
                taus.append(tau)
        return LoopResult(st, anchors, w, n_fail, prim, taus)

    def run_sim(self, ticks: int):
        """The plant alone at zero torque for ``ticks`` control periods."""
        st, anchors = self.robot.state, self.robot._anchors
        tau0 = torch.zeros_like(st.q)
        for _ in range(ticks):
            for _ in range(self.robot.substeps):
                st, anchors = self.robot.step(st, anchors, tau0, st.q,
                                              self.zero_kd, self.zero_kd)
        return st, anchors

    def check_health(self, result: LoopResult) -> dict:
        """The gate of bench_rt_loop.py, read back after timing: zero
        solver failures and a finite base height within MAX_BASE_DRIFT of
        the start, on every item. Raises RuntimeError otherwise."""
        n_fail = int(result.n_fail)
        z0 = self.robot.state.base_pos[:, 2]
        z1 = result.state.base_pos[:, 2]
        drift = float((z1 - z0).abs().max())
        if n_fail > 0:
            raise RuntimeError(f"{n_fail} solver failures in the loop")
        if not bool(torch.isfinite(z1).all()) or drift > MAX_BASE_DRIFT:
            raise RuntimeError(f"robot did not hold its stand (z "
                               f"{z0.tolist()} -> {z1.tolist()})")
        return {"solver_failures": n_fail,
                "prim_res_max": float(result.prim_max),
                "base_drift_m": float((z1 - z0).max())}


def humanoid_loop(device=devices.DEFAULT) -> ClosedLoop:
    """The humanoid standing on a 4-point foot patch per sole under the
    RT-profile ForceAcc tick (its levels in the level kernel's profile),
    warm state from the plugin's on_start."""
    model = zoo.humanoid(device=device)
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=12,
                            solver_opts=dict(RT_PROFILE))
    st0 = ri.standing_state(model, CONTACTS)
    robot = ri.SimRobot(model, state=st0, dt=1e-3, substeps=SUBSTEPS,
                        contact_links=CONTACTS, ground_z=0.0,
                        contact_offsets={c: FOOT_PATCH for c in CONTACTS})
    refs, warm, _ = plugin.on_start(robot.state)
    return ClosedLoop(plugin, robot, refs, warm)
