"""Sustained gait: single-support cycles chained into an N-stride walk
(port of qppvm_tpu/runtime/gait.py) for one robot (batch 1).

Each stride is one ``LegLiftScript`` cycle with a forward foothold offset.
The stride geometry (support centroid, swing start pose) is re-derived from
the robot's actual state at each stride boundary: the script is open loop
within a stride and closed loop across strides, so tracking drift does not
accumulate. Every phase change is a value in the references (gates,
weights, gains, min-jerk references); the tick's shapes never change.

As in ``LegLiftScript``, geometry is read in float64 on the host and the
references are float32 tensors of batch 1 on the plugin's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from qppvm_tpu_torch.model import kinematics
from qppvm_tpu_torch.runtime.contact_switch import (LegLiftPhases,
                                                    LegLiftScript, _host)


class GaitScript:
    """N-stride static walk (crawl gait: one swing foot at a time).

    Drive it like ``LegLiftScript``, passing the current state so stride
    boundaries can re-anchor::

        gait = GaitScript(model, plugin, refs, initial_waist,
                          order=("foot_hl", "foot_fl", "foot_hr", "foot_fr"),
                          stride=(0.06, 0.0), n_strides=8)
        for i in range(gait.total):
            tau, warm, aux = plugin.control_loop(
                state, gait.refs_at(i, state), warm)

    ``order``: the feet's swing order (a hind foot before its ipsilateral
    front foot keeps the CoM inside the advancing support triangle).
    ``stride``: (dx, dy) world foothold displacement of each swing.
    """

    def __init__(self, model, plugin, refs, initial_waist, *,
                 order: Sequence[str] = ("foot_hl", "foot_fl",
                                         "foot_hr", "foot_fr"),
                 stride: Tuple[float, float] = (0.06, 0.0),
                 n_strides: int = 4,
                 phases: Optional[LegLiftPhases] = None,
                 shift_mode: str = "centroid",
                 shift_a_max: Optional[float] = None,
                 shift_v_max: float = 0.25,
                 shift_ticks_max: Optional[int] = None,
                 unload_gate: Optional[Dict] = None,
                 com_servo=None,
                 com_servo_max: float = 0.15,
                 relative_replant: bool = False,
                 tail: int = 300, **lift_kw):
        """Options, with the reference's defaults:

        - ``phases``: each stride's schedule (default: the leg-lift
          schedule with a shorter settle and no hold);
        - ``shift_a_max`` (``shift_v_max``, ``shift_ticks_max``): pace each
          stride's weight shift from the actual CoM-to-support distance D,
          T >= sqrt(5.77 D / a_max) and >= 1.875 D / v_max, floored at
          ``phases.shift`` and capped at ``shift_ticks_max`` (default
          4 x phases.shift); None keeps fixed durations;
        - ``unload_gate`` {"tol_p", "tol_v", "max_extra"}: pause the script
          clock at the unload boundary until the measured CoM is over the
          remaining support and slow along the transfer direction, for at
          most ``max_extra`` ticks;
        - ``com_servo`` (True, or a dict of kp, kd, ki, max): a PD + I loop
          from the measured CoM to the waist reference's xy;
          ``com_servo_max`` is stored and never read: the servo clips at
          its own "max", as the reference's does;
        - ``relative_replant``: re-aim each touchdown's y at the nominal
          spacing from the live support at the lower phase's entry;
        - ``tail``: ticks of the settled hold after the last stride;
        - ``lift_kw``: passed to each stride's ``LegLiftScript``."""
        self.model = model
        self.plugin = plugin
        self.refs = dict(refs)
        self._waist = _host(initial_waist)
        self._kw = dict(dtype=torch.float32, device=plugin.device)
        # Each swing lands at its foot's nominal y (captured here) instead
        # of keeping the lateral drift of the stance phase: re-anchoring
        # at the actual y ratchets cone-limited stance slip inward until
        # the support polygon degenerates (the reference measured it).
        self._y_nom = {c: float(_host(refs[c + "_cartesian"]["p"])[1])
                       for c in plugin.contact_links}
        self.order = list(order)
        self.stride = (float(stride[0]), float(stride[1]))
        self.n_strides = int(n_strides)
        self.phases = phases or LegLiftPhases(
            settle=100, shift=350, dwell=100, unload=150,
            lift=250, hold=0, lower=250, reload=200)
        self.shift_mode = shift_mode
        self.shift_a_max = shift_a_max
        self.shift_v_max = float(shift_v_max)
        if unload_gate is not None:
            self.unload_gate = dict(tol_p=0.02, tol_v=0.05, max_extra=1500)
            self.unload_gate.update(unload_gate)
        else:
            self.unload_gate = None
        if com_servo:
            self.com_servo = dict(kp=1.0, kd=0.4, ki=1.0, max=0.12)
            if isinstance(com_servo, dict):
                self.com_servo.update(com_servo)
        else:
            self.com_servo = None
        # kept for parity and never read: the servo clips at
        # com_servo["max"] (ROADMAP section 3)
        self.com_servo_max = float(com_servo_max)
        # the servo's integrator, zeroed once here and never between
        # strides, as the reference's (ROADMAP section 3)
        self._wint = np.zeros(2, np.float64)
        self.relative_replant = bool(relative_replant)
        self._extra = 0
        self.lift_kw = lift_kw
        self.dt = float(lift_kw.get("dt", 1e-3))
        self.stride_ticks = self.phases.total
        self.shift_ticks_max = int(shift_ticks_max
                                   if shift_ticks_max is not None
                                   else 4 * self.phases.shift)
        self.tail = int(tail)
        # upper bound of the walk's length: with adaptive pacing or the
        # unload gate each stride is at most this long, and the ticks not
        # spent go to the tail's settled hold
        max_stride = (self.stride_ticks if shift_a_max is None
                      else self.stride_ticks - self.phases.shift
                      + self.shift_ticks_max)
        if self.unload_gate is not None:
            max_stride += self.unload_gate["max_extra"]
        self.total = self.n_strides * max_stride + self.tail
        self._script: Optional[LegLiftScript] = None
        self._k = -1
        self._t0 = 0

    def swing_foot(self, k: int) -> str:
        return self.order[k % len(self.order)]

    def _links_xy(self, kin, links) -> np.ndarray:
        """(len(links), 2) float64 world xy of ``links`` at ``kin``."""
        p = kin.p[0].detach().cpu().numpy().astype(np.float64)
        return np.stack([p[self.model.link_index(c)][:2] for c in links])

    def _transfer_dir(self):
        """Unit xy direction of the script's CoM transfer c0 -> c1."""
        c0 = _host(self._script.c0)[:2]
        c1 = _host(self._script.c1)[:2]
        d = c1 - c0
        n = np.linalg.norm(d)
        return c1, (d / n if n > 1e-6 else np.array([0.0, 1.0]))

    def _start_stride(self, k: int, state, t0: int) -> None:
        kin = kinematics.fk(self.model, state)
        p_links = kin.p[0].detach().cpu().numpy().astype(np.float64)
        # Re-anchor each foot reference in x and z at its actual pose
        # (absorbing the previous stride's touchdown error) but pin its y
        # at the nominal: with y pinned the stance tasks keep pushing
        # creeping feet back out.
        z6 = torch.zeros((1, 6), **self._kw)
        for c in self.plugin.contact_links:
            key = c + "_cartesian"
            p_act = p_links[self.model.link_index(c)]
            self.refs[key] = dict(self.refs[key], p=torch.tensor(
                [[p_act[0], self._y_nom[c], p_act[2]]], **self._kw),
                v=z6, a=z6)
        foot = self.swing_foot(k)
        p0y = float(_host(self.refs[foot + "_cartesian"]["p"])[1])
        offset = (self.stride[0],
                  self.stride[1] + (self._y_nom[foot] - p0y))
        phases = self.phases
        if self.shift_a_max is not None:
            # pace this stride's shift from the actual CoM -> support
            # centroid distance (min-jerk peak acceleration 5.77 D / T^2 <=
            # a_max, peak velocity 1.875 D / T <= v_max)
            sup_xy = self._links_xy(kin, [c for c in self.plugin.contact_links
                                          if c != foot])
            com0 = _host(kinematics.com(self.model, kin)[1])[:2]
            D = float(np.linalg.norm(sup_xy.mean(axis=0) - com0))
            T = max(np.sqrt(5.77 * D / self.shift_a_max),
                    1.875 * D / self.shift_v_max)
            ticks = int(np.ceil(T / self.dt))
            phases = dataclasses.replace(
                self.phases, shift=int(np.clip(ticks, self.phases.shift,
                                               self.shift_ticks_max)))
        self._script = LegLiftScript(
            self.model, self.plugin, self.refs, self._waist,
            foot, state=state, phases=phases,
            foothold_offset=offset, shift_mode=self.shift_mode,
            **self.lift_kw)
        self._waist = _host(self._script.w1)
        self._k = k
        self._t0 = int(t0)
        self._extra = 0

    def _com(self, state, kin):
        """Measured CoM position and velocity xy, float64."""
        _, com_p = kinematics.com(self.model, kin)
        vel_all = kinematics.link_velocities(self.model, kin, state)
        com_v = kinematics.com_velocity(self.model, kin, state, vel_all)
        return _host(com_p)[:2], _host(com_v)[:2]

    def _com_settled(self, state):
        """(settled, retargeted CoM xy): the measured CoM over the remaining
        support and slow, both along the transfer direction only (the
        standing CoM sits at a fixed fore/aft offset from the foot
        origins, so a full-norm test could never pass). The target is the
        transfer component of the live support centroid, so a pausing gate
        does not hold a target the stance foot has crept away from."""
        kin = kinematics.fk(self.model, state)
        com_p, com_v = self._com(state, kin)
        cent = self._links_xy(kin, self._script.support).mean(axis=0)
        c1, d = self._transfer_dir()
        err = abs(float(np.dot(cent - com_p, d)))
        spd = abs(float(np.dot(com_v, d)))
        g = self.unload_gate
        cr = c1 + d * float(np.dot(cent - c1, d))
        return (err <= g["tol_p"] and spd <= g["tol_v"]), cr

    def refs_at(self, i: int, state) -> Dict:
        """The references of tick ``i`` (drive with increasing ``i``).
        ``state``: the current (estimated) RobotState of batch 1, read at
        stride boundaries and by the gate, the replant and the servo.
        Ticks past the last stride hold its settled references."""
        if state.batch != 1:
            raise ValueError(f"GaitScript drives one robot; the state has "
                             f"batch {state.batch}")
        if self._script is None:
            # no strides (n_strides 0): the base references are already a
            # settled hold with every gate on
            if self.n_strides == 0:
                return self.refs
            self._start_stride(0, state, t0=i)
        while (self._k + 1 < self.n_strides
               and i >= self._t0 + self._script.total + self._extra):
            self._start_stride(self._k + 1, state,
                               t0=self._t0 + self._script.total
                               + self._extra)
        j = i - self._t0 - self._extra
        pause_cent = None
        if (self.unload_gate is not None
                and j == self._script.t_unload0
                and self._extra < self.unload_gate["max_extra"]):
            settled, cent = self._com_settled(state)
            if not settled:
                # pause the clock at the unload boundary: keep the settled
                # pre-unload references and retarget the servo at the live
                # support until the CoM has arrived
                self._extra += 1
                j -= 1
                pause_cent = cent
        if self.relative_replant and j == self._script.t_lower0:
            # re-aim the touchdown's y at the nominal spacing from the live
            # support; the lower min-jerk still starts at pf_up
            s = self._script
            kin_r = kinematics.fk(self.model, state)
            sup_y = float(np.mean(self._links_xy(kin_r, s.support)[:, 1]))
            nom_gap = self._y_nom[s.foot] - float(np.mean(
                [self._y_nom[c] for c in s.support]))
            pf = _host(s.pf_dn)
            pf[1] = sup_y + nom_gap
            s.pf_dn = s._row(pf)
        jj = min(j, self._script.total - 1)  # the tail holds the last refs
        r = self._script.refs_at(jj)
        if self.com_servo is not None:
            g = self.com_servo
            kin = kinematics.fk(self.model, state)
            com_p, com_v = self._com(state, kin)
            cr_p, cr_v = self._script.com_ref_at(jj)
            cr_xy = _host(cr_p)[:2]
            if pause_cent is not None:
                cr_xy = pause_cent
            elif jj >= self._script.t_unload0:
                # single support: follow the live support centroid along
                # the transfer direction, not the stride-start target
                cent = self._links_xy(kin, self._script.support).mean(axis=0)
                c1, d = self._transfer_dir()
                cr_xy = c1 + d * float(np.dot(cent - c1, d))
            e = cr_xy - com_p
            edot = _host(cr_v)[:2] - com_v
            self._wint = np.clip(self._wint + g["ki"] * self.dt * e,
                                 -g["max"], g["max"])
            corr = np.clip(g["kp"] * e + g["kd"] * edot + self._wint,
                           -g["max"], g["max"])
            r = dict(r)
            wt = dict(r["waist_task"])
            wt["p"] = wt["p"] + torch.tensor(np.r_[corr, 0.0][None],
                                             **self._kw)
            r["waist_task"] = wt
        return r
