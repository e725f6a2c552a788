"""Contact-switch (single-support) reference scheduler (port of
qppvm_tpu/runtime/contact_switch.py) for one robot (batch 1).

The static-walk primitive on top of the gated wrench constraints: weight
shift over the remaining support polygon -> gate-ramped unload -> swing
lift -> hold -> lower -> gate-ramped reload. Everything is expressed
through the references of a ForceAccPlugin stack (pose, velocity and
acceleration feedforward, runtime task weights ``w``, servo gains
``kp`` / ``kd``, postural per-joint weights, contact gates), so phases
change values, never shapes.

The geometry (support polygon, CoM, foot positions) is read once at the
start state in float64 on the host, as the reference does; the references
are float32 tensors of batch 1 on the plugin's device.

Tuning notes (the reference's, measured on the zoo quadruped): the gate
ramp must fully unload the foot before the lift starts; min-jerk with
velocity and acceleration feedforward lets a 300 ms swing track at
moderate servo gains; the swing foot task needs a higher kp and weight
than the stance feet, and the swing leg's postural rows must be
deweighted or the postural task drags the leg back home.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from qppvm_tpu_torch.model import kinematics
from qppvm_tpu_torch.runtime.trajectory import min_jerk_pva


@dataclasses.dataclass
class LegLiftPhases:
    """Phase durations in ticks."""

    settle: int = 150
    shift: int = 400
    dwell: int = 150
    unload: int = 150
    lift: int = 250
    hold: int = 250
    lower: int = 250
    reload: int = 250

    @property
    def total(self) -> int:
        return (self.settle + self.shift + self.dwell + self.unload +
                self.lift + self.hold + self.lower + self.reload)


def chain_joints(model, link_name: str) -> list:
    """Joint indices on the kinematic chain from the base to ``link_name``
    (the swing leg, for postural deweighting), ascending."""
    li = model.link_index(link_name)
    out = []
    while li >= 0:
        out.append(int(li))
        li = int(model.parent[li])
    return sorted(out)


def _host(x) -> np.ndarray:
    """A batch-1 tensor or an array as a flat float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64).reshape(-1)


class LegLiftScript:
    """Per-tick references for one swing of ``foot`` while the other
    contacts stay planted. Drive with::

        script = LegLiftScript(model, plugin, refs, initial_waist,
                               "foot_fl", state=state)
        for i in range(script.total):
            tau, warm, aux = plugin.control_loop(robot.state,
                                                 script.refs_at(i), warm)
    """

    def __init__(self, model, plugin, refs, initial_waist, foot: str, *,
                 state=None, phases: Optional[LegLiftPhases] = None,
                 margin: float = 0.08, lift_height: float = 0.05,
                 touch_depth: float = 0.005, swing_kp: float = 150.0,
                 swing_w: float = 4.0, postural_deweight: float = 0.05,
                 stance_kp: float = None, stance_w: float = None,
                 dt: float = 1e-3, foothold_offset=(0.0, 0.0),
                 shift_mode: str = "edge"):
        """``foothold_offset``: (dx, dy) world displacement of the re-plant
        target from the lift-off point (a stride; the swing goes lift-off ->
        apex at half the offset and ``lift_height`` -> target).
        ``shift_mode``: "edge" puts the CoM ``margin`` inside the support
        polygon, normal to the edge that separates the swing corner;
        "centroid" shifts it to the support centroid. ``state``: the start
        RobotState (batch 1), whose geometry the script reads."""
        if state is None:
            raise ValueError("pass the start RobotState (for FK geometry)")
        if state.batch != 1:
            raise ValueError(f"LegLiftScript drives one robot; the state "
                             f"has batch {state.batch}")
        self.model = model
        self.plugin = plugin
        self.refs = refs
        self.foot = foot
        self.ph = phases or LegLiftPhases()
        self.dt = dt
        self._kw = dict(dtype=torch.float32, device=state.q.device)
        self.swing_kp = swing_kp
        self.swing_kd = 2.0 * float(np.sqrt(swing_kp))
        self.swing_w = swing_w
        # stance gains / weight for every foot (a lightly loaded stance foot
        # at the feet tasks' kp 25 is dragged by the rest of the stack)
        self.stance_kp = stance_kp
        self.stance_w = stance_w
        contacts = list(plugin.contact_links)
        self.foot_i = contacts.index(foot)
        self.support = [c for c in contacts if c != foot]
        self.key = foot + "_cartesian"

        # geometry at the start state, float64 on the host
        kin0 = kinematics.fk(model, state)
        p_links = kin0.p[0].detach().cpu().numpy().astype(np.float64)
        sup_xy = np.stack([p_links[model.link_index(c)][:2]
                           for c in self.support])
        com3 = _host(kinematics.com(model, kin0)[1])
        com0 = com3[:2]
        waist0 = _host(initial_waist)
        if shift_mode == "centroid":
            shift = sup_xy.mean(axis=0) - com0
        elif len(self.support) >= 3:
            shift = self._edge_shift(sup_xy, com0,
                                     p_links[model.link_index(foot)][:2],
                                     margin)
        else:
            shift = sup_xy.mean(axis=0) - com0
        self.w0 = self._row(waist0)
        self.w1 = self._row(waist0 + np.r_[shift, 0.0])
        # the CoM-task channel (plugins with use_com_task) tracks the same
        # min-jerk transfer of the measured CoM; the intended CoM is kept
        # either way (com_ref_at)
        self.has_com = bool(getattr(plugin, "use_com_task", False)) \
            and "COM" in refs
        self.c0 = self._row(com3)
        self.c1 = self._row(com3 + np.r_[shift, 0.0])

        p0 = _host(refs[self.key]["p"])
        dx, dy = float(foothold_offset[0]), float(foothold_offset[1])
        self.pf0 = self._row(p0)
        self.pf_up = self._row(p0 + [0.5 * dx, 0.5 * dy, lift_height])
        self.pf_dn = self._row(p0 + [dx, dy, -touch_depth])
        self.swing_joints = [j for j in chain_joints(model, foot)
                             if j < model.nj]
        self.postural_deweight = postural_deweight
        wv = np.ones(model.nj, np.float32)
        wv[self.swing_joints] = postural_deweight
        self._swing_postural_w = torch.tensor(wv[None], **self._kw)
        self._gate_on = torch.ones((1, len(contacts)), **self._kw)

        p = self.ph
        self.t_shift0 = p.settle
        self.t_dwell0 = self.t_shift0 + p.shift
        self.t_unload0 = self.t_dwell0 + p.dwell
        self.t_lift0 = self.t_unload0 + p.unload
        self.t_hold0 = self.t_lift0 + p.lift
        self.t_lower0 = self.t_hold0 + p.hold
        self.t_reload0 = self.t_lower0 + p.lower
        self.total = p.total

    @staticmethod
    def _edge_shift(sup_xy, com0, p_foot, margin):
        """The CoM shift ``margin`` inside the support polygon, normal to the
        longest edge that has the swing foot on its outer side; the
        centroid shift when no edge separates (degenerate support)."""
        best, best_len = None, -1.0
        for a in range(len(sup_xy)):
            for b in range(a + 1, len(sup_xy)):
                inside = [i for i in range(len(sup_xy)) if i not in (a, b)]
                d = sup_xy[b] - sup_xy[a]
                n = np.array([d[1], -d[0]])
                n /= max(np.linalg.norm(n), 1e-9)
                if np.dot(sup_xy[inside[0]] - sup_xy[a], n) < 0:
                    n = -n
                edge_len = float(np.linalg.norm(d))
                if np.dot(p_foot - sup_xy[a], n) < 0 and edge_len > best_len:
                    best, best_len = (a, n), edge_len
        if best is None:
            return sup_xy.mean(axis=0) - com0
        a, n = best
        return (margin - np.dot(com0 - sup_xy[a], n)) * n

    # -- helpers ---------------------------------------------------------
    def _row(self, v) -> torch.Tensor:
        """A float64 vector as a float32 (1, d) tensor on the device."""
        return torch.tensor(np.asarray(v, np.float64)[None], **self._kw)

    def _scalar(self, v) -> torch.Tensor:
        return torch.full((1,), float(v), **self._kw)

    def _twist(self, lin) -> torch.Tensor:
        """(1, 6) with ``lin`` (1, 3) in the linear rows."""
        return torch.cat([lin, torch.zeros_like(lin)], dim=-1)

    def com_ref_at(self, i: int):
        """The script's intended CoM (position, velocity), each (1, 3), at
        tick ``i``: the min-jerk clock the waist follows."""
        t_shift = float(np.clip((i - self.t_shift0) * self.dt, 0.0,
                                self.ph.shift * self.dt))
        p, v, _ = min_jerk_pva(self.c0, self.c1, t_shift,
                               self.ph.shift * self.dt)
        return p, v

    def _gate(self, g: float) -> torch.Tensor:
        gate = self._gate_on.clone()
        gate[0, self.foot_i] = g
        return gate

    def _set_cart(self, r, key, p, v, a, w=None, kp=None, kd=None):
        tr = dict(r[key], p=p, v=self._twist(v), a=self._twist(a))
        if w is not None:
            tr["w"] = self._scalar(w)
        if kp is not None:
            tr["kp"] = self._scalar(kp)
            tr["kd"] = self._scalar(kd)
        r[key] = tr
        return r

    def _swing_refs(self, r, p, v, a):
        r = self._set_cart(r, self.key, p, v, a, w=self.swing_w,
                           kp=self.swing_kp, kd=self.swing_kd)
        r["POSTURAL"] = dict(r["POSTURAL"], w=self._swing_postural_w)
        return r

    # -- the schedule ----------------------------------------------------
    def refs_at(self, i: int) -> Dict:
        """The references of tick ``i``."""
        ph, dt = self.ph, self.dt
        r = dict(self.refs)
        if self.stance_kp is not None or self.stance_w is not None:
            # every foot, the swing foot too until its lift (planted but
            # nearly unloaded it is flung at kp 25 otherwise)
            for c in self.support + [self.foot]:
                tr = dict(r[c + "_cartesian"])
                if self.stance_kp is not None:
                    tr["kp"] = self._scalar(self.stance_kp)
                    tr["kd"] = self._scalar(
                        2.0 * float(np.sqrt(self.stance_kp)))
                if self.stance_w is not None:
                    tr["w"] = self._scalar(self.stance_w)
                r[c + "_cartesian"] = tr
        t_shift = float(np.clip((i - self.t_shift0) * dt, 0.0,
                                ph.shift * dt))
        wp, wv, wa = min_jerk_pva(self.w0, self.w1, t_shift, ph.shift * dt)
        r = self._set_cart(r, "waist_task", wp, wv, wa)
        if self.has_com:
            cp, cv, ca = min_jerk_pva(self.c0, self.c1, t_shift,
                                      ph.shift * dt)
            r["COM"] = dict(r["COM"], p=cp, v=cv, a=ca)
        gate = self._gate_on
        z3 = torch.zeros((1, 3), **self._kw)
        if self.t_unload0 <= i < self.t_lift0:
            gate = self._gate(float(1.0 - (i - self.t_unload0)
                                    / max(ph.unload, 1)))
        elif self.t_lift0 <= i < self.t_hold0:
            gate = self._gate(0.0)
            t = float((i - self.t_lift0) * dt)
            r = self._swing_refs(r, *min_jerk_pva(self.pf0, self.pf_up, t,
                                                  ph.lift * dt))
        elif self.t_hold0 <= i < self.t_lower0:
            gate = self._gate(0.0)
            r = self._swing_refs(r, self.pf_up, z3, z3)
        elif self.t_lower0 <= i < self.t_reload0:
            gate = self._gate(0.0)
            t = float((i - self.t_lower0) * dt)
            r = self._swing_refs(r, *min_jerk_pva(self.pf_up, self.pf_dn, t,
                                                  ph.lower * dt))
        elif i >= self.t_reload0:
            gate = self._gate(float(np.clip(
                (i - self.t_reload0) / max(ph.reload, 1), 0.0, 1.0)))
            r = self._swing_refs(r, self.pf_dn, z3, z3)
        r["contacts"] = {"active": gate}
        return r
