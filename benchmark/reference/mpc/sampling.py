"""The MPPI update (frozen copy of the port's ``mpc/sampling.py`` without
its mesh and its footstep-recovery channel): roll every sample out as one
batch, price a failed rollout by the failure penalty, and average the
sampled plans with weights exp(-(cost - min) / lambda)."""
from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.model.robot import RobotState
from benchmark.reference.mpc.rollout import (RolloutConfig, default_cost,
                                             make_rollout_fn)
from benchmark.reference.opt.qp import QPState


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    n_samples: int = 256
    horizon: int = 16
    lambda_: float = 1.0
    noise_std: float = 0.15
    push_std: float = 0.0
    mass_scale_std: float = 0.0
    mu_scale_range: float = 0.0
    nu: int = 3
    fail_penalty: float = 1e6


def expand_batch(state: RobotState, refs, warm, K: int):
    """A batch-1 state, references and warm state repeated for K samples."""
    rep = lambda a: a.expand(K, *a.shape[1:]).contiguous()  # noqa: E731

    def tree(t):
        return ({k: tree(v) for k, v in t.items()} if isinstance(t, dict)
                else rep(t))

    state = RobotState(**{f.name: rep(getattr(state, f.name))
                          for f in dataclasses.fields(state)})
    warm = tuple(QPState(**{f.name: rep(getattr(s, f.name))
                            for f in dataclasses.fields(s)}) for s in warm)
    return state, tree(refs), warm


class SamplingMPC:
    def __init__(self, plugin, mppi: MPPIConfig, rollout_cfg: RolloutConfig,
                 contact_offsets=None):
        self.plugin = plugin
        self.mppi = mppi
        self.rollout = make_rollout_fn(plugin, rollout_cfg, default_cost,
                                       contact_offsets=contact_offsets)

    def update(self, state, refs, warm, U, scenario):
        """(U_new (H, nu), info) from samples U (K, H, nu) and
        ``scenario``; ``info["costs"]`` (K,) with the failure penalty,
        ``info["solver_failed"]`` (K,)."""
        m = self.mppi
        st, rf, w = expand_batch(state, refs, warm, U.shape[0])
        costs, health = self.rollout(st, rf, w, U, scenario)
        failed = health["solver_failed"]
        costs = torch.where(torch.isfinite(costs), costs,
                            torch.full_like(costs, m.fail_penalty))
        costs = costs + m.fail_penalty * failed.to(costs.dtype)
        beta = torch.amin(costs)
        wts = torch.exp(-(costs - beta) / m.lambda_)
        wts = wts / torch.sum(wts)
        U_new = torch.einsum("k,khu->hu", wts, U)
        return U_new, {"costs": costs, "solver_failed": failed,
                       "prim_res_max": health["prim_res_max"]}

    @staticmethod
    def shift_plan(U):
        return torch.cat([U[1:], U[-1:]], dim=0)
