"""The reference's own reading of a scenario file: the robot, the ForceAcc
plugin, the plant's parameters and the MPPI planner, built from the YAML
mapping with the reference's modules. Every key the cells use is read from
the file; a missing one raises rather than falling back to a default."""
from __future__ import annotations

import torch

from benchmark.reference.model import zoo
from benchmark.reference.mpc.rollout import RolloutConfig
from benchmark.reference.mpc.sampling import MPPIConfig, SamplingMPC
from benchmark.reference.plugins.force_acc import ForceAccPlugin
from benchmark.reference.runtime import robot_interface as ri

# SimRobot's tangential stiction stiffness, which a scenario does not set
CONTACT_KT = 2e4

_PLUGIN_KEYS = {"contact_links", "waist_link", "fz_min", "use_friction_cones",
                "mu", "wrench_dim", "switchable_contacts", "waist_kp",
                "postural_kp", "type"}


def build_plugin(raw: dict, dtype=torch.float64, device="cpu"):
    """(model, ForceAccPlugin) of the scenario mapping ``raw``."""
    p, s = raw["plugin"], raw["solver"]
    if p["type"] != "force_acc":
        raise ValueError(f"the reference has no plugin {p['type']!r}")
    model = zoo.by_name(raw["robot"]["zoo"], dtype=dtype, device=device)
    extra = {k: v for k, v in p.items() if k not in _PLUGIN_KEYS}
    plugin = ForceAccPlugin(
        model, contact_links=tuple(p["contact_links"]),
        waist_link=p["waist_link"], eps=float(s["eps"]),
        iters=int(s["iters"]), fz_min=float(p["fz_min"]),
        use_friction_cones=bool(p["use_friction_cones"]), mu=float(p["mu"]),
        wrench_dim=int(p["wrench_dim"]),
        switchable_contacts=bool(p["switchable_contacts"]),
        waist_kp=float(p["waist_kp"]), postural_kp=float(p["postural_kp"]),
        dtype=dtype, solver_opts=dict(s["opts"]), **extra)
    return model, plugin


class Plant:
    """The scenario's plant: ``substeps`` steps of ``_sim_step`` a control
    period, the drive PD at zero gains (the SimRobot a ControlLoop drives
    is never given any)."""

    def __init__(self, raw: dict, model):
        sim, links = raw["sim"], tuple(raw["plugin"]["contact_links"])
        self.model = model
        self.substeps = int(sim["substeps"])
        self.h = float(sim["dt"]) / self.substeps
        self.idx = tuple(model.link_index(c) for c in links)
        self.offsets = ri.contact_offsets_for(links, sim["contact_offsets"])
        self.params = (float(sim["ground_z"]), float(sim["contact_kp"]),
                       float(sim["contact_kd"]), float(sim["mu"]), CONTACT_KT)

    def move(self, state, anchors, tau_ref, q_ref):
        zero = torch.zeros_like(tau_ref)
        for _ in range(self.substeps):
            state, anchors = ri._sim_step(
                self.model, self.h, self.idx, self.offsets, *self.params,
                state, anchors, tau_ref, q_ref, zero, zero)
        return state, anchors


def build_mpc(raw: dict, plugin) -> SamplingMPC:
    """MPPI over the plugin's rollouts as the scenario's ``mpc`` section
    sets it, the rollouts' other settings the rollout's defaults."""
    m = raw["mpc"]
    mppi = MPPIConfig(n_samples=int(m["n_samples"]),
                      horizon=int(m["horizon"]),
                      noise_std=float(m["noise_std"]),
                      push_std=float(m["push_std"]),
                      mass_scale_std=float(m["mass_scale_std"]),
                      mu_scale_range=float(m["mu_scale_range"]),
                      lambda_=float(m["lambda_"]))
    rcfg = RolloutConfig(horizon=int(m["horizon"]), qp_iters=int(m["qp_iters"]))
    return SamplingMPC(plugin, mppi, rcfg)
