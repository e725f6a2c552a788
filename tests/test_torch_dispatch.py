"""The port's solver dispatch: no JAX in the package, loud fallbacks.

- importing every module of qppvm_tpu_torch loads no ``jax``;
- a level in the level solver's profile goes to ``level_qp.solve_level``
  (its plain version on CPU tensors, the same arithmetic as qp.solve) and
  a level outside it runs qp.solve and adds one to ``cascade.fallback`` in
  ``telemetry``; no caller names the route: the cascade, ``ForceAccPlugin``
  and the rollouts of a default ``RolloutConfig`` take the level solver;
- a level whose rows are all equalities is routed to qp.solve (counted),
  and ``solve_level`` itself raises on it;
- ``solve_level`` raises on a device that is neither CPU nor CUDA;
- the entry points default to the card, and raise where there is none.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.opt import hierarchy, level_qp, qp

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
RT = dict(iters=12, rho_updates=0, polish_rounds=0, assume_warm_kinv=True,
          warm_kinv_iters=4, cold_ns_iters=10, scale_iters=2, pinv_ns_iters=5,
          rho_adapt_tol=1e-3, rho_scale_min=0.1)


def test_package_imports_no_jax():
    code = ("import importlib, pkgutil, sys, qppvm_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'qppvm_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'qppvm_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _stack(B=3, n=8, n_eq=2, n_ineq=3, level_rows=(2, 3), seed=0):
    """A random two-level stack: ``n_eq`` equality rows then ``n_ineq``
    bounded rows in C, no box."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    mc = n_eq + n_ineq
    C = rng.normal(size=(B, mc, n))
    lC = np.concatenate([np.zeros((B, n_eq)), -np.ones((B, n_ineq))], 1)
    uC = np.concatenate([np.zeros((B, n_eq)), np.ones((B, n_ineq))], 1)
    levels = tuple(hierarchy.LevelData(A=t(rng.normal(size=(B, k, n))),
                                       b=t(rng.normal(size=(B, k))))
                   for k in level_rows)
    return hierarchy.StackData(levels=levels, C=t(C), lC=t(lC), uC=t(uC),
                               lb=t(np.full((B, n), -1e20)),
                               ub=t(np.full((B, n), 1e20)), n_eq=n_eq,
                               has_box=False)


def _spy_solve_level(monkeypatch):
    """The config of every ``level_qp.solve_level`` call."""
    calls, real = [], level_qp.solve_level

    def spy(cfg, *args):
        calls.append(cfg)
        return real(cfg, *args)
    monkeypatch.setattr(level_qp, "solve_level", spy)
    return calls


def test_kernel_backend_routes_and_counts_fallbacks(monkeypatch):
    stack = _stack()
    warm = hierarchy.warm_start_init(stack)
    with monkeypatch.context() as mp:   # every level through qp.solve
        mp.setattr(level_qp, "solve", qp.solve)
        x_ref, warm_ref, _ = hierarchy.solve(stack, warm, **RT)
    calls = _spy_solve_level(monkeypatch)
    telemetry.reset("cascade.fallback")
    # in profile: both levels go to the level solver, nothing counted, and
    # on CPU it is exactly qp.solve's arithmetic
    x, warm_k, infos = hierarchy.solve(stack, warm, **RT)
    assert len(calls) == 2 and telemetry.counts()["cascade.fallback"] == 0
    assert torch.equal(x, x_ref)
    assert all(torch.equal(a.Kinv, b.Kinv) for a, b in zip(warm_k, warm_ref))
    # outside the profile (a polished solve; no warm state): one per level
    hierarchy.solve(stack, warm, **dict(RT, polish_rounds=2))
    assert telemetry.counts()["cascade.fallback"] == 2
    hierarchy.solve(stack, None, **RT)
    assert telemetry.counts()["cascade.fallback"] == 4 and len(calls) == 2
    # the rule is per level: level 1 leaves the profile, level 0 stays
    hierarchy.solve(stack, warm, per_level_opts=[None, dict(rho_updates=1)],
                    **RT)
    assert telemetry.counts()["cascade.fallback"] == 5 and len(calls) == 3


def test_default_callers_take_the_level_solver(monkeypatch):
    """A ForceAccPlugin and a default RolloutConfig's rollout, built without
    naming a route, send every level of their real-time profile through
    ``level_qp.solve_level``; the tick is qp.solve's to the bit."""
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.mpc import rollout
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
    from qppvm_tpu_torch.runtime.rt_loop import FOOT_PATCH, RT_PROFILE

    feet = ("l_sole", "r_sole")
    model = zoo.humanoid(device="cpu")
    plugin = ForceAccPlugin(model, contact_links=feet, waist_link="pelvis",
                            iters=12, solver_opts=RT_PROFILE)
    st = rollout.standing_state(model, feet, batch=2)
    refs, warm, _ = plugin.on_start(st)
    with monkeypatch.context() as mp:
        mp.setattr(level_qp, "solve", qp.solve)
        tau_ref, _, _ = plugin._step_impl(st, refs, warm)
    calls = _spy_solve_level(monkeypatch)
    telemetry.reset("cascade.fallback")
    tau, _, _ = plugin._step_impl(st, refs, warm)
    assert len(calls) == 2 and torch.equal(tau, tau_ref)
    roll = rollout.make_rollout_fn(plugin, rollout.RolloutConfig(horizon=2),
                                   rollout.default_cost,
                                   contact_offsets={f: FOOT_PATCH
                                                    for f in feet})
    args = (st, refs, warm, torch.zeros(2, 2, 3),
            {"push": torch.zeros(2, 2, 3)})
    cost, _ = roll(*args)
    assert len(calls) == 2 + 2 * 2
    assert telemetry.counts()["cascade.fallback"] == 0
    monkeypatch.setattr(level_qp, "solve", qp.solve)
    assert torch.equal(cost, roll(*args)[0])
    assert bool(torch.isfinite(cost).all())


def test_all_equality_level_is_routed_and_rejected_by_the_kernel():
    """Level 0 of a stack whose C rows are all equalities has no inequality
    row: the hierarchy routes it to qp.solve and counts it; level 1 (with
    the level-0 locks as tail equalities) is likewise all-equality."""
    stack = _stack(n_eq=3, n_ineq=0, level_rows=(2, 2))
    warm = hierarchy.warm_start_init(stack)
    telemetry.reset("cascade.fallback")
    x, _, infos = hierarchy.solve(stack, warm, **RT)
    assert telemetry.counts()["cascade.fallback"] == 2
    eq_res = (stack.C @ x[..., None])[..., 0] - stack.lC
    assert float(eq_res.abs().max()) < 1e-4
    cfg = level_qp.config_from_opts(RT, n_eq_head=3, n_eq_tail=0, iters=12)
    P = torch.eye(8).expand(3, 8, 8).contiguous()
    z3 = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="inequality"):
        level_qp.solve_level(cfg, P, torch.zeros(3, 8), stack.C, z3, z3,
                             torch.zeros(3, 8), z3, z3, torch.zeros(3, 8, 8),
                             torch.ones(3))


def test_solve_level_raises_off_cpu_and_cuda():
    cfg = level_qp.config_from_opts(RT, n_eq_head=0, n_eq_tail=0, iters=12)
    B, n, m = 2, 4, 3
    args = [torch.empty(s, device="meta") for s in
            ((B, n, n), (B, n), (B, m, n), (B, m), (B, m), (B, n), (B, m),
             (B, m), (B, n, n), (B,))]
    with pytest.raises(ValueError, match="device"):
        level_qp.solve_level(cfg, *args)


def test_config_from_opts_scope():
    """The level solver's profile: rho_updates 0, no polish, warm KKT
    inverse, Newton-Schulz; anything else maps to None."""
    ok = level_qp.config_from_opts(RT, n_eq_head=6, n_eq_tail=6, iters=12)
    assert ok == level_qp.LevelQPConfig(n_eq_head=6, n_eq_tail=6,
                                        cold_ns_iters=10)
    for bad in (dict(rho_updates=1), dict(polish_rounds=2),
                dict(assume_warm_kinv=False), dict(inv_method="chol")):
        assert level_qp.config_from_opts(dict(RT, **bad), n_eq_head=0,
                                         n_eq_tail=0, iters=12) is None
    assert qp.QPState.zero(2, 3, 4, device="cpu").Kinv.shape == (2, 3, 3)


def test_entry_points_default_to_the_card():
    from qppvm_tpu_torch.model import convert, zoo
    from qppvm_tpu_torch.mpc.humanoid_plan import humanoid_plan
    from qppvm_tpu_torch.opt.variables import Optvar
    from qppvm_tpu_torch.runtime.rt_loop import humanoid_loop
    calls = (zoo.humanoid, lambda: qp.QPState.zero(1, 2, 3),
             lambda: Optvar([("x", 2)]), lambda: convert.refs({"a": [1.0]}),
             humanoid_loop, humanoid_plan)
    if torch.cuda.is_available():
        assert zoo.humanoid().device.type == "cuda"
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_chip_smoke_level_error_leaves_out_the_raw_rho_scale(monkeypatch,
                                                             capsys):
    """chip_smoke.py's level phases report, for the kernels line, the
    largest gap over x, z, y, Kinv and the carried rho_scale; the raw
    rho_scale's gap, which the bars excuse, is printed and not counted."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    from qppvm_tpu_torch.opt import level_qp_parity as parity

    gaps = dict(x=1e-5, z=2e-5, y=3e-5, Kinv=4e-5, rho_scale=0.04,
                prim=0.5, dual=0.5, obj=0.5, carried_rho_scale=5e-5)
    monkeypatch.setattr(parity, "check_level_outputs",
                        lambda *a: dict(gaps))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    cfg = level_qp.LevelQPConfig(n_eq_head=2)
    prob = parity.random_problems(2, 6, 5, 2, 0, "cpu", seed=0)
    err, _ = chip_smoke.check_level_phase(
        torch, parity, level_qp, cfg, prob,
        parity.zero_state(2, 6, 5, "cpu"), "toy")
    assert err == 5e-5
    assert "rho_scale=0.04" in capsys.readouterr().out
