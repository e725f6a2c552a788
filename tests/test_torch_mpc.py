"""Parity of the port's sampling-MPC rollouts and MPPI update with
qppvm_tpu, on the humanoid at bench_mpc.py's profile (ForceAccPlugin
iters 20, rollouts at qp_iters 12 with 8 warm KKT iterations).

- ``make_rollout_fn`` over 2 samples x 3 steps, with the foot patch, base
  pushes and per-sample mass and friction scales, against ``jax.vmap`` of
  the reference's rollout: cost, prim_res_max and solver_failed;
- ``SamplingMPC.update`` from fixed samples against the reference's plan
  step fed the same samples (its draws replaced by the numpy ones).

Both sides start from the port's on_start (its references and warm state
carried across), so the rollouts are held alone and no JAX on_start is
compiled; tests/test_torch_force_acc.py holds on_start itself. The
reference's two programs (the vmapped rollout and the plan step) compile
once, side by side on two threads, in the module fixture. The reference
runs its "xla" level solver (the Pallas kernel in
interpret mode would take minutes to compile here; tests/test_pallas_qp.py
pins the two together); the port's levels, in the level kernel's
profile, run its plain version on CPU tensors.

Tolerances: float32 on both sides, sums in another order, through 3 steps
of contact dynamics each fed by a 2-level 12-iteration QP cascade: costs,
plans and MPPI weights to 1e-3 relative; prim_res_max to the level-kernel
bar of tests/test_pallas_qp.py (1e-5 + 2e-2 relative), since a residual
near roundoff moves by percents. A wrong contact, push or cost term moves
the cost by far more (a 30 N push changes it by O(1) of itself).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qppvm_tpu.model import zoo as jzoo
from qppvm_tpu.mpc import rollout as jrollout
from qppvm_tpu.mpc import sampling as jsampling
from qppvm_tpu.model.robot import RobotState as JRobotState
from qppvm_tpu.opt.qp import QPState as JQPState
from qppvm_tpu.plugins.force_acc import ForceAccPlugin as JForceAcc
from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import convert, zoo
from qppvm_tpu_torch.mpc import rollout, sampling
from qppvm_tpu_torch.opt import level_qp
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
from qppvm_tpu_torch.runtime.rt_loop import FOOT_PATCH

torch.set_num_threads(1)
CONTACTS = ("l_sole", "r_sole")
PATCH = {c: FOOT_PATCH for c in CONTACTS}
K, H = 2, 3


def _cfg():
    return dict(horizon=H, qp_iters=12, qp_warm_kinv_iters=8)


def _close(actual, desired, rtol=1e-3, floor=1e-3):
    desired = np.asarray(desired, np.float64)
    scale = float(np.max(np.abs(desired))) + 1.0
    np.testing.assert_allclose(np.asarray(actual, np.float64), desired,
                               rtol=rtol, atol=floor * scale)


MPPI_KW = dict(n_samples=3, horizon=H, push_std=30.0)


def _rollout_inputs():
    rng = np.random.default_rng(0)
    controls = (0.15 * rng.normal(size=(K, H, 3))).astype(np.float32)
    scen = {"push": (30.0 * rng.normal(size=(K, H, 3))).astype(np.float32),
            "mass_scale": np.array([1.0, 1.08], np.float32),
            "mu_scale": np.array([1.0, 0.7], np.float32)}
    return controls, scen


def _mppi_inputs():
    rng = np.random.default_rng(1)
    unit = [rng.normal(size=(3, H, 3)).astype(np.float32) for _ in range(2)]
    U_nom = (0.05 * rng.normal(size=(H, 3))).astype(np.float32)
    return unit, U_nom


@pytest.fixture(scope="module")
def sides():
    """The port's on_start on the humanoid, carried across to the
    reference; the reference's rollout and plan step, compiled on two
    threads. The plan step is traced with jax.random.normal answering the
    fixed draws (the plan noise, then the pushes)."""
    tplugin = ForceAccPlugin(zoo.humanoid(device="cpu"),
                             contact_links=CONTACTS, waist_link="pelvis",
                             iters=20)
    tst = rollout.standing_state(tplugin.model, CONTACTS)
    trefs, twarm, _ = tplugin.on_start(tst)
    item0 = lambda t: ({k: item0(v) for k, v in t.items()}  # noqa: E731
                       if isinstance(t, dict) else jnp.asarray(t[0].numpy()))
    st = JRobotState(**{k: item0(getattr(tst, k))
                        for k in convert.STATE_FIELDS})
    refs = item0(trefs)
    warm = tuple(JQPState(**{f: item0(getattr(lv, f))
                             for f in convert.QPSTATE_FIELDS})
                 for lv in twarm)
    jplugin = JForceAcc(jzoo.humanoid(), contact_links=CONTACTS,
                        waist_link="pelvis", iters=20)
    jroll = jrollout.make_rollout_fn(
        jplugin, jrollout.RolloutConfig(**_cfg()),
        jrollout.default_cost, contact_offsets=PATCH)
    roll_fn = jax.jit(jax.vmap(lambda U, sc: jroll(st, refs, warm, U, sc)))
    jmpc = jsampling.SamplingMPC(jplugin, jsampling.MPPIConfig(**MPPI_KW),
                                 jrollout.RolloutConfig(**_cfg()))
    controls, scen = _rollout_inputs()
    unit, U_nom = _mppi_inputs()
    step_args = (jax.random.PRNGKey(0), st, refs, warm, jnp.asarray(U_nom))
    draws = iter(unit)   # the reference draws the plan noise, then pushes
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, dtype=None:
                   jnp.asarray(next(draws)))
        with ThreadPoolExecutor(2) as pool:
            roll = pool.submit(lambda: roll_fn.lower(controls,
                                                     scen).compile())
            step = pool.submit(lambda: jax.jit(jmpc._step_impl).lower(
                *step_args).compile())
            roll, step = roll.result(), step.result()
    return dict(tplugin=tplugin, tst=tst, trefs=trefs, twarm=twarm,
                rollout_ref=roll(controls, scen), mppi_ref=step(*step_args))


def test_rollout_matches_reference(sides):
    controls, scen = _rollout_inputs()
    cost_ref, health_ref = sides["rollout_ref"]

    troll = rollout.make_rollout_fn(
        sides["tplugin"], rollout.RolloutConfig(**_cfg()),
        rollout.default_cost, contact_offsets=PATCH)
    # every step's levels are in the level kernel's profile
    assert level_qp.config_from_opts(troll.solver_opts, n_eq_head=0,
                                     n_eq_tail=0, iters=12) is not None
    tst, trefs, twarm = sampling.expand_batch(sides["tst"], sides["trefs"],
                                              sides["twarm"], K)
    telemetry.reset("cascade.fallback")
    cost, health = troll(tst, trefs, twarm, torch.tensor(controls),
                         {k: torch.tensor(v) for k, v in scen.items()})
    # every level in the kernel's profile
    assert telemetry.counts()["cascade.fallback"] == 0
    assert cost.shape == (K,)
    _close(cost, cost_ref)
    _close(health["prim_res_max"], health_ref["prim_res_max"], rtol=2e-2,
           floor=1e-5)
    np.testing.assert_array_equal(health["solver_failed"].numpy(),
                                  np.asarray(health_ref["solver_failed"]))


def test_mppi_update_matches_reference_on_fixed_samples(sides):
    unit, U_nom = _mppi_inputs()
    U_ref, info_ref = sides["mppi_ref"]
    m = sampling.MPPIConfig(**MPPI_KW)
    tmpc = sampling.SamplingMPC(sides["tplugin"], m,
                                rollout.RolloutConfig(**_cfg()))
    U = torch.tensor(U_nom)[None] + m.noise_std * torch.tensor(unit[0])
    U_new, info = tmpc.update(sides["tst"], sides["trefs"], sides["twarm"],
                              U, {"push": m.push_std * torch.tensor(unit[1])})
    _close(U_new, U_ref, floor=1e-4)
    for k in ("cost_min", "cost_mean", "ess"):
        _close(info[k], info_ref[k])
    _close(info["U_best"], info_ref["U_best"], floor=1e-4)
    assert float(info["solver_fail_frac"]) == float(
        info_ref["solver_fail_frac"]) == 0.0
    _close(info["prim_res_max"], info_ref["prim_res_max"], rtol=2e-2,
           floor=1e-5)
