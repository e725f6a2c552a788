"""Scenario configuration: one declarative file per control scenario (port of
qppvm_tpu/config.py).

A scenario names everything a run needs: the robot (a zoo name or a URDF
file), the plugin and its gains, solver options, the simulated robot and
the MPC layer. The five BASELINE configurations ship as
``configs/config{1..5}_*.yaml``.

Build chain: ScenarioConfig -> build_scenario(cfg, device) -> (model,
plugin, robot) for ``runtime.plugin.ControlLoop``, or build_mpc for
``mpc.sampling.SamplingMPC`` (its samples sharded over a mesh of ranks
when one is given) or ``mpc.ddp_mpc.CentroidalMPC``. The model is built on
``device``, the card by default, and the rest on the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from qppvm_tpu_torch import device as devices


@dataclasses.dataclass
class RobotConfig:
    """Where the model comes from: a zoo name or a URDF file."""

    zoo: Optional[str] = None          # arm7 | dual_arm | quadruped | biped | humanoid
    urdf: Optional[str] = None         # path to a URDF file
    floating: Optional[bool] = None    # URDF only; zoo models decide themselves

    def validate(self):
        if (self.zoo is None) == (self.urdf is None):
            raise ValueError("RobotConfig needs exactly one of zoo= or urdf=")


@dataclasses.dataclass
class SolverConfig:
    """Hierarchical-QP options. ``opts`` pass through to the plugin's
    solver_opts: any hierarchy.solve keyword, e.g. {"rho_updates": 0}
    (the level kernel's profile) or {"method": "pdip"}."""

    eps: float = 1.0
    iters: int = 100
    opts: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PluginConfig:
    """Which control law and its gains.

    type="qppvm": the torque-level impedance stack (QPPVMPlugin).
    type="force_acc": the floating-base x = [qddot; f] stack (ForceAcc).
    Other keys land in ``extra`` and pass through to the plugin.
    """

    type: str = "qppvm"
    # qppvm gains
    left_ee: str = "arm1_7"
    right_ee: str = "arm2_7"
    cart_stiffness: float = 700.0
    cart_damping: float = 70.0
    joint_stiffness: float = 5.0
    joint_damping: float = 2.0
    sine_ref: bool = False
    # force_acc
    contact_links: Tuple[str, ...] = ()
    waist_link: str = "pelvis"
    fz_min: float = 10.0
    use_friction_cones: bool = False
    mu: float = 0.7
    wrench_dim: int = 3
    switchable_contacts: bool = False
    waist_kp: float = 100.0
    postural_kp: float = 25.0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SimConfig:
    """SimRobot options (the ground contact model)."""

    dt: float = 1e-3
    substeps: int = 4
    ground_z: float = 0.0
    contact_kp: float = 2e4
    contact_kd: float = 300.0
    mu: float = 0.8
    standing: bool = False            # start with the feet on the ground
    # link -> (K, 3) local contact points (flat-foot patch); default origin
    contact_offsets: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MPCConfig:
    """The MPC layer (config 5): sampling MPPI, or the centroidal iLQR
    (``horizon``, and ``qp_iters`` as its iterations)."""

    enabled: bool = False
    type: str = "sampling"             # sampling (MPPI) | ilqr
    n_samples: int = 64
    horizon: int = 8
    noise_std: float = 0.05
    push_std: float = 0.0
    # domain randomization: true-model mass scale and ground-friction scale
    mass_scale_std: float = 0.0
    mu_scale_range: float = 0.0
    # footstep-recovery decision channel (rollout.make_swing_primitive)
    step_recovery: bool = False
    lambda_: float = 1.0
    qp_iters: int = 10
    mesh_axis: str = "rollout"         # the samples' axis of a mesh of ranks


@dataclasses.dataclass
class ScenarioConfig:
    name: str = "scenario"
    description: str = ""
    robot: RobotConfig = dataclasses.field(default_factory=RobotConfig)
    plugin: PluginConfig = dataclasses.field(default_factory=PluginConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    mpc: MPCConfig = dataclasses.field(default_factory=MPCConfig)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ScenarioConfig":
        def sub(cls, key):
            got = dict(d.get(key, {}) or {})
            fields = {f.name for f in dataclasses.fields(cls)}
            if cls is PluginConfig:
                extra = {k: got.pop(k) for k in list(got)
                         if k not in fields}
                if "contact_links" in got:
                    got["contact_links"] = tuple(got["contact_links"])
                obj = cls(**got)
                obj.extra.update(extra)
                return obj
            unknown = set(got) - fields
            if unknown:
                raise ValueError(f"unknown {key} config keys: {sorted(unknown)}")
            if cls is SolverConfig:
                # a scenario file may still name the level kernel, which
                # takes every level it holds unasked: read, then dropped
                opts = got["opts"] = dict(got.get("opts") or {})
                if opts.pop("backend", "kernel") != "kernel":
                    raise ValueError("solver.opts.backend: only 'kernel' is "
                                     "read (and dropped)")
            return cls(**got)

        cfg = ScenarioConfig(
            name=d.get("name", "scenario"),
            description=d.get("description", ""),
            robot=sub(RobotConfig, "robot"),
            plugin=sub(PluginConfig, "plugin"),
            solver=sub(SolverConfig, "solver"),
            sim=sub(SimConfig, "sim"),
            mpc=sub(MPCConfig, "mpc"),
        )
        cfg.robot.validate()
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def load_scenario(path: str) -> ScenarioConfig:
    """Load a scenario YAML file."""
    import yaml
    with open(path) as f:
        d = yaml.safe_load(f) or {}
    return ScenarioConfig.from_dict(d)


def build_model(cfg: ScenarioConfig, device=devices.DEFAULT):
    """The scenario's robot model on ``device``."""
    if cfg.robot.zoo is not None:
        from qppvm_tpu_torch.model import zoo
        return zoo.by_name(cfg.robot.zoo, device=devices.resolve(device))
    from qppvm_tpu_torch.model.urdf import load_urdf
    return load_urdf(cfg.robot.urdf, floating=cfg.robot.floating,
                     device=device)


def build_plugin(cfg: ScenarioConfig, model):
    """The scenario's plugin, on the model's device."""
    p, s = cfg.plugin, cfg.solver
    if p.type == "qppvm":
        from qppvm_tpu_torch.plugins.qppvm import QPPVMPlugin
        return QPPVMPlugin(
            model, left_ee=p.left_ee, right_ee=p.right_ee,
            cart_stiffness=p.cart_stiffness, cart_damping=p.cart_damping,
            joint_stiffness=p.joint_stiffness, joint_damping=p.joint_damping,
            eps=s.eps, iters=s.iters, sine_ref=p.sine_ref,
            solver_opts=dict(s.opts) or None, **p.extra)
    if p.type == "force_acc":
        from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
        return ForceAccPlugin(
            model, contact_links=p.contact_links, waist_link=p.waist_link,
            eps=s.eps, iters=s.iters, fz_min=p.fz_min,
            use_friction_cones=p.use_friction_cones, mu=p.mu,
            wrench_dim=p.wrench_dim,
            switchable_contacts=p.switchable_contacts,
            waist_kp=p.waist_kp, postural_kp=p.postural_kp,
            solver_opts=dict(s.opts) or None, **p.extra)
    raise ValueError(f"unknown plugin type {p.type!r}")


def build_sim(cfg: ScenarioConfig, model):
    """The scenario's SimRobot, on the model's device."""
    from qppvm_tpu_torch.runtime.robot_interface import SimRobot, standing_state
    state = (standing_state(model, cfg.plugin.contact_links,
                            cfg.sim.ground_z)
             if cfg.sim.standing and cfg.plugin.contact_links else None)
    return SimRobot(
        model, state=state, dt=cfg.sim.dt, substeps=cfg.sim.substeps,
        contact_links=cfg.plugin.contact_links, ground_z=cfg.sim.ground_z,
        contact_kp=cfg.sim.contact_kp, contact_kd=cfg.sim.contact_kd,
        mu=cfg.sim.mu, contact_offsets=cfg.sim.contact_offsets or None)


def build_mpc(cfg: ScenarioConfig, plugin, mesh=None):
    """The scenario's planner on the plugin's device: the centroidal iLQR
    (``mpc.type: ilqr``), else sampling MPC with its rollouts' levels
    through the level kernel (its plain version on CPU tensors), its
    samples sharded over ``mesh`` (parallel/mesh.py) when one is given."""
    if not cfg.mpc.enabled:
        raise ValueError(f"scenario {cfg.name!r} has no mpc section enabled")
    m = cfg.mpc
    if m.type == "ilqr":
        from qppvm_tpu_torch.mpc.ddp_mpc import (CentroidalMPC,
                                                 CentroidalMPCConfig)
        return CentroidalMPC(
            plugin.model, plugin.contact_links,
            CentroidalMPCConfig(horizon=m.horizon, iterations=m.qp_iters))
    from qppvm_tpu_torch.mpc.rollout import RolloutConfig
    from qppvm_tpu_torch.mpc.sampling import MPPIConfig, SamplingMPC
    mppi = MPPIConfig(n_samples=m.n_samples, horizon=m.horizon,
                      noise_std=m.noise_std, push_std=m.push_std,
                      mass_scale_std=m.mass_scale_std,
                      mu_scale_range=m.mu_scale_range,
                      step_recovery=m.step_recovery,
                      lambda_=m.lambda_)
    rcfg = RolloutConfig(horizon=m.horizon, qp_iters=m.qp_iters)
    return SamplingMPC(plugin, mppi, rcfg, mesh=mesh)


def build_scenario(cfg: ScenarioConfig, device=devices.DEFAULT):
    """(model, plugin, robot) ready for a ControlLoop, on ``device``."""
    model = build_model(cfg, device)
    plugin = build_plugin(cfg, model)
    robot = build_sim(cfg, model)
    return model, plugin, robot
