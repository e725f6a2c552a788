"""Parity of the port's sampling-MPC rollouts and MPPI update with
qppvm_tpu, on the humanoid at bench_mpc.py's profile (ForceAccPlugin
iters 20, rollouts at qp_iters 12 with 8 warm KKT iterations).

- ``make_rollout_fn`` over 2 samples x 3 steps, with the foot patch, base
  pushes and per-sample mass and friction scales, against ``jax.vmap`` of
  the reference's rollout: cost, prim_res_max and solver_failed;
- ``SamplingMPC.update`` from fixed samples against the reference's plan
  step fed the same samples (its draws replaced by the numpy ones);
- the parts not ported yet raise NotImplementedError.

Both sides start from the reference's on_start, so the rollouts are held
alone. The reference runs its "xla" level solver (the Pallas kernel in
interpret mode would take minutes to compile here; tests/test_pallas_qp.py
pins the two together); the port runs "kernel", which on CPU tensors is
the level kernel's plain version.

Tolerances: float32 on both sides, sums in another order, through 3 steps
of contact dynamics each fed by a 2-level 12-iteration QP cascade: costs,
plans and MPPI weights to 1e-3 relative; prim_res_max to the level-kernel
bar of tests/test_pallas_qp.py (1e-5 + 2e-2 relative), since a residual
near roundoff moves by percents. A wrong contact, push or cost term moves
the cost by far more (a 30 N push changes it by O(1) of itself).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from qppvm_tpu.model import zoo as jzoo
from qppvm_tpu.mpc import rollout as jrollout
from qppvm_tpu.mpc import sampling as jsampling
from qppvm_tpu.plugins.force_acc import ForceAccPlugin as JForceAcc
from qppvm_tpu.stack.autostack import AutoStack as JAutoStack
from qppvm_tpu_torch.model import convert, zoo
from qppvm_tpu_torch.mpc import rollout, sampling
from qppvm_tpu_torch.opt import hierarchy
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
from qppvm_tpu_torch.runtime.rt_loop import FOOT_PATCH

torch.set_num_threads(1)
CONTACTS = ("l_sole", "r_sole")
PATCH = {c: FOOT_PATCH for c in CONTACTS}
K, H = 2, 3


def _cfg(backend):
    return dict(horizon=H, qp_iters=12, qp_warm_kinv_iters=8,
                qp_backend=backend)


def _close(actual, desired, rtol=1e-3, floor=1e-3):
    desired = np.asarray(desired, np.float64)
    scale = float(np.max(np.abs(desired))) + 1.0
    np.testing.assert_allclose(np.asarray(actual, np.float64), desired,
                               rtol=rtol, atol=floor * scale)


@pytest.fixture(scope="module")
def sides():
    jm = jzoo.humanoid()
    jplugin = JForceAcc(jm, contact_links=CONTACTS, waist_link="pelvis",
                        iters=20)
    st = jax.jit(lambda: jrollout.standing_state(jm, CONTACTS))()
    with pytest.MonkeyPatch.context() as mp:
        # validate() reads the stack on the host, which jit cannot
        mp.setattr(JAutoStack, "validate", staticmethod(lambda *a, **k: None))
        refs, warm, _ = jax.jit(jplugin.on_start)(st)
    tplugin = ForceAccPlugin(zoo.humanoid(device="cpu"),
                             contact_links=CONTACTS, waist_link="pelvis",
                             iters=20)
    one = lambda t: jax.tree.map(lambda a: np.asarray(a)[None], t)  # noqa
    tst = convert.robot_state(one({k: getattr(st, k) for k in
                                   convert.STATE_FIELDS}), device="cpu")
    trefs = convert.refs(one(refs), device="cpu")
    twarm = convert.qp_states([{f: np.asarray(getattr(lv, f))[None]
                                for f in convert.QPSTATE_FIELDS}
                               for lv in warm], device="cpu")
    return dict(jplugin=jplugin, st=st, refs=refs, warm=warm,
                tplugin=tplugin, tst=tst, trefs=trefs, twarm=twarm)


def test_rollout_matches_reference(sides):
    rng = np.random.default_rng(0)
    controls = (0.15 * rng.normal(size=(K, H, 3))).astype(np.float32)
    scen = {"push": (30.0 * rng.normal(size=(K, H, 3))).astype(np.float32),
            "mass_scale": np.array([1.0, 1.08], np.float32),
            "mu_scale": np.array([1.0, 0.7], np.float32)}
    jroll = jrollout.make_rollout_fn(
        sides["jplugin"], jrollout.RolloutConfig(**_cfg("xla")),
        jrollout.default_cost, contact_offsets=PATCH)
    st, refs, warm = sides["st"], sides["refs"], sides["warm"]
    cost_ref, health_ref = jax.jit(jax.vmap(
        lambda U, sc: jroll(st, refs, warm, U, sc)))(
        jnp.asarray(controls), {k: jnp.asarray(v) for k, v in scen.items()})

    troll = rollout.make_rollout_fn(
        sides["tplugin"], rollout.RolloutConfig(**_cfg("pallas")),
        rollout.default_cost, contact_offsets=PATCH)
    assert troll.solver_opts["backend"] == "kernel"
    tst, trefs, twarm = sampling.expand_batch(sides["tst"], sides["trefs"],
                                              sides["twarm"], K)
    hierarchy.fallbacks = 0
    cost, health = troll(tst, trefs, twarm, torch.tensor(controls),
                         {k: torch.tensor(v) for k, v in scen.items()})
    assert hierarchy.fallbacks == 0   # every level in the kernel's profile
    assert cost.shape == (K,)
    _close(cost, cost_ref)
    _close(health["prim_res_max"], health_ref["prim_res_max"], rtol=2e-2,
           floor=1e-5)
    np.testing.assert_array_equal(health["solver_failed"].numpy(),
                                  np.asarray(health_ref["solver_failed"]))


def test_mppi_update_matches_reference_on_fixed_samples(sides, monkeypatch):
    mppi_kw = dict(n_samples=3, horizon=H, push_std=30.0)
    rng = np.random.default_rng(1)
    unit = [rng.normal(size=(3, H, 3)).astype(np.float32) for _ in range(2)]
    U_nom = (0.05 * rng.normal(size=(H, 3))).astype(np.float32)

    draws = iter(unit)   # the reference draws the plan noise, then pushes
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=None: jnp.asarray(
                            next(draws)))
    jmpc = jsampling.SamplingMPC(sides["jplugin"],
                                 jsampling.MPPIConfig(**mppi_kw),
                                 jrollout.RolloutConfig(**_cfg("xla")))
    U_ref, info_ref = jax.jit(jmpc._step_impl)(
        jax.random.PRNGKey(0), sides["st"], sides["refs"], sides["warm"],
        jnp.asarray(U_nom))
    monkeypatch.undo()

    m = sampling.MPPIConfig(**mppi_kw)
    tmpc = sampling.SamplingMPC(sides["tplugin"], m,
                                rollout.RolloutConfig(**_cfg("kernel")))
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


def test_unported_options_raise(sides):
    plugin = sides["tplugin"]
    cfg = rollout.RolloutConfig(**_cfg("kernel"))
    for kw in (dict(swing=lambda *a: None),
               dict(terminal_cost=lambda *a: None)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            rollout.make_rollout_fn(plugin, cfg, rollout.default_cost, **kw)
    roll = rollout.make_rollout_fn(plugin, cfg, rollout.default_cost)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        roll(sides["tst"], sides["trefs"], sides["twarm"],
             torch.zeros(1, H, 3), {"push": torch.zeros(1, H, 3),
                                    "gate_seq": torch.ones(1, H, 2)})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sampling.SamplingMPC(plugin, sampling.MPPIConfig(step_recovery=True))
    with pytest.raises(ValueError, match="qp_backend"):
        rollout.make_rollout_fn(plugin, rollout.RolloutConfig(
            qp_backend="cuda"), rollout.default_cost)
