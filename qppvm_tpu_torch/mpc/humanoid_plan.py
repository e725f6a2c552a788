"""The humanoid's sampling-MPC plan step (the counterpart of
bench_mpc.py's set-up): ``zoo.humanoid()`` standing in rollout
equilibrium, ``ForceAccPlugin(iters=20)`` with its default profile for
on_start, MPPI with 30 N pushes, and rollouts at qp_iters 12 with 8 warm
KKT Newton-Schulz iterations.
"""
from __future__ import annotations

import dataclasses

from qppvm_tpu_torch import device as devices
from qppvm_tpu_torch.model import zoo
from qppvm_tpu_torch.mpc.rollout import RolloutConfig, standing_state
from qppvm_tpu_torch.mpc.sampling import MPPIConfig, SamplingMPC
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin

CONTACTS = ("l_sole", "r_sole")
# bench_mpc.py's defaults (--samples, --horizon, --qp-iters,
# --warm-kinv-iters)
N_SAMPLES, HORIZON = 512, 8
QP_ITERS, WARM_KINV_ITERS = 12, 8


@dataclasses.dataclass
class HumanoidPlan:
    mpc: SamplingMPC
    state: object   # RobotState, batch 1
    refs: dict
    warm: tuple

    def plan(self, generator, U_nom):
        return self.mpc.plan(generator, self.state, self.refs, self.warm,
                             U_nom)

    def update(self, U, scenario):
        return self.mpc.update(self.state, self.refs, self.warm, U, scenario)


def humanoid_plan(device=devices.DEFAULT) -> HumanoidPlan:
    model = zoo.humanoid(device=device)
    plugin = ForceAccPlugin(model, contact_links=CONTACTS,
                            waist_link="pelvis", iters=20)
    st = standing_state(model, CONTACTS)
    refs, warm, _ = plugin.on_start(st)
    mppi = MPPIConfig(n_samples=N_SAMPLES, horizon=HORIZON, push_std=30.0)
    rcfg = RolloutConfig(horizon=HORIZON, qp_iters=QP_ITERS,
                         qp_warm_kinv_iters=WARM_KINV_ITERS)
    return HumanoidPlan(SamplingMPC(plugin, mppi, rcfg), st, refs, warm)
