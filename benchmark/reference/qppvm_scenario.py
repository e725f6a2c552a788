"""The reference's own reading of a QPPVM scenario file: the fixed-base
robot, the QPPVM plugin and the plant, built from the YAML mapping with the
reference's modules. Every key the cell uses is read from the file; a
missing one raises rather than falling back to a default."""
from __future__ import annotations

import torch

from benchmark.reference.model import zoo
from benchmark.reference.plugins.qppvm import QPPVMPlugin
from benchmark.reference.runtime import robot_interface as ri


def build_plugin(raw: dict, dtype=torch.float64, device="cpu"):
    """(model, QPPVMPlugin) of the scenario mapping ``raw``."""
    p, s = raw["plugin"], raw["solver"]
    if p["type"] != "qppvm":
        raise ValueError(f"not a QPPVM scenario: plugin {p['type']!r}")
    model = zoo.by_name(raw["robot"]["zoo"], dtype=dtype, device=device)
    plugin = QPPVMPlugin(
        model, left_ee=p["left_ee"], right_ee=p["right_ee"],
        cart_stiffness=float(p["cart_stiffness"]),
        cart_damping=float(p["cart_damping"]),
        joint_stiffness=float(p["joint_stiffness"]),
        joint_damping=float(p["joint_damping"]), eps=float(s["eps"]),
        iters=int(s["iters"]), dtype=dtype, sine_ref=bool(p["sine_ref"]),
        solver_opts=dict(s["opts"]))
    return model, plugin


class Plant:
    """The scenario's plant for a fixed-base robot: ``substeps`` steps of
    ``_sim_step`` a control period, no contact point, the drive PD at zero
    gains (the SimRobot a ControlLoop drives is never given any)."""

    def __init__(self, raw: dict, model):
        sim = raw["sim"]
        if model.floating:
            raise ValueError("the QPPVM plant is a fixed-base robot's")
        self.model = model
        self.substeps = int(sim["substeps"])
        self.h = float(sim["dt"]) / self.substeps

    def move(self, state, tau_ref, q_ref):
        """The state after one control period under ``tau_ref``."""
        zero = torch.zeros_like(tau_ref)
        for _ in range(self.substeps):
            # no contact: the ground's parameters and the anchors are unused
            state, _ = ri._sim_step(self.model, self.h, (), (), 0.0, 0.0, 0.0,
                                    0.0, 0.0, state, None, tau_ref, q_ref,
                                    zero, zero)
        return state
