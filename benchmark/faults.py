"""Faults planted in the program's timed path, to show that the comparison
deciding ``correct`` catches them. Each takes ``patch(owner, name,
value)``, which replaces an attribute for as long as the caller keeps it
(pytest's ``monkeypatch.setattr``, or ``planted`` below):

- ``keep_state``: a step that returns its state unchanged: the tick hands
  back the warm state it was given;
- ``still_plant``: the plant's integration returns the state it was given
  (the loop's plant, the rollouts' simulation);
- ``half_batch``: the tick computes the first half of its items and copies
  it over the rest;
- ``half_samples``: the plan rolls out the first half of its samples and
  copies their costs over the rest;
- ``altered_tau``, ``altered_plan``: an answer altered where it is
  produced: the tick's first torque by 0.5 N m, U_new by 0.01.

The cells run on one card, so there is no exchange between cards to leave
out.
"""
from __future__ import annotations

import contextlib

import torch


def _plugin_cls():
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
    return ForceAccPlugin


def keep_state(patch):
    cls = _plugin_cls()
    orig = cls._step_impl

    def step(self, state, refs, warm):
        tau, _, aux = orig(self, state, refs, warm)
        return tau, warm, aux
    patch(cls, "_step_impl", step)


def still_plant(patch):
    from qppvm_tpu_torch.model import dynamics
    patch(dynamics, "integrate", lambda model, state, udot, dt: state)


def half_batch(patch):
    cls = _plugin_cls()
    orig = cls._step_impl

    def step(self, state, refs, warm):
        tau, warm_new, aux = orig(self, state, refs, warm)
        h = tau.shape[0] // 2
        fill = lambda t: torch.cat([t[:h], t[:h]])  # noqa: E731
        return fill(tau), warm_new, type(aux)(
            **{k: fill(v) for k, v in vars(aux).items()})
    patch(cls, "_step_impl", step)


def half_samples(patch):
    from qppvm_tpu_torch.mpc.sampling import SamplingMPC
    orig = SamplingMPC.update

    def update(self, state, refs, warm, U, scenario, theta=None):
        h = U.shape[0] // 2
        U_new, info = orig(self, state, refs, warm, U[:h],
                           {k: v[:h] for k, v in scenario.items()})
        info = dict(info, costs=torch.cat([info["costs"]] * 2),
                    solver_failed=torch.cat([info["solver_failed"]] * 2))
        return U_new, info
    patch(SamplingMPC, "update", update)


def altered_tau(patch):
    cls = _plugin_cls()
    orig = cls._step_impl

    def step(self, state, refs, warm):
        tau, warm_new, aux = orig(self, state, refs, warm)
        bump = torch.zeros_like(tau)
        bump[:, 0] = 0.5
        return tau + bump, warm_new, aux
    patch(cls, "_step_impl", step)


def altered_plan(patch):
    from qppvm_tpu_torch.mpc.sampling import SamplingMPC
    orig = SamplingMPC.update

    def update(self, *args, **kwargs):
        U_new, info = orig(self, *args, **kwargs)
        return U_new + 0.01, info
    patch(SamplingMPC, "update", update)


# the faults each mode's cells can have
BY_MODE = {
    "loop": (still_plant, keep_state, altered_tau),
    "batch": (keep_state, half_batch, altered_tau),
    "plan": (still_plant, half_samples, altered_plan),
}


@contextlib.contextmanager
def planted(fault):
    """``fault`` planted for the duration, every patch undone on exit."""
    saved = []

    def patch(owner, name, value):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)
    try:
        fault(patch)
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)
