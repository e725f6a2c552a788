"""Parity of the port's deployment layer with qppvm_tpu: ``config.py``
(every ``configs/*.yaml``), ``run.py`` (the CLI), ``runtime/async_mpc.py``
(the plan/act pipeline) and ``runtime/native.py`` (the paced executor, the
trace ring and the shared-memory channel).

The reference's ``run.main`` on config 1 is the one JAX program of this
file. It runs on a thread from the module's start, beside the port-only
cases, with its QPPVM on_start jitted (eagerly it takes 18 s here; the
jitted one computes the same references and warm start). Its final
``q`` norm after 10 ticks is held to the port's within 1e-4 (both print
it rounded to 4 decimals).

The pipeline is held against the reference's with stub planners and a
scripted readiness, so the launch, commit, age and row sequence is exact.
The native runtime is built from ``native/rt_runtime.cpp`` into the port's
``_build/``; its cases are those of tests/test_native_runtime.py, with
channel names of their own.
"""
import glob
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu import config as jconfig
from qppvm_tpu import run as jrun
from qppvm_tpu.plugins.qppvm import QPPVMPlugin as JQPPVM
from qppvm_tpu.runtime import async_mpc as jasync
from qppvm_tpu_torch import config, run
from qppvm_tpu_torch.mpc.ddp_mpc import CentroidalMPC
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
from qppvm_tpu_torch.plugins.qppvm import QPPVMPlugin
from qppvm_tpu_torch.runtime import async_mpc, native

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
LOOP_KEYS = {"scenario", "seconds", "p50_ms", "p99_ms", "deadline_misses",
             "final_q_norm"}
MPC_KEYS = {"scenario", "mpc_steps", "n_samples", "horizon", "devices",
            "plan_norm"}


def _config(n):
    return next(p for p in CONFIGS
                if os.path.basename(p).startswith(f"config{n}_"))


def _jax_run_main(argv):
    """The reference's run.main on ``argv``: the dict it prints."""
    printed = []
    dumps = jrun.json.dumps
    orig_on_start = JQPPVM.on_start
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrun, "json", SimpleNamespace(
            dumps=lambda obj: printed.append(obj) or dumps(obj)))
        mp.setattr(JQPPVM, "on_start", lambda self, st: jax.jit(
            lambda s: orig_on_start(self, s))(st))
        jrun.main(argv)
    return printed[-1]


@pytest.fixture(scope="module")
def jax_config1():
    """The reference's run.main on config 1 for 10 ticks, on a thread."""
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(_jax_run_main, ["--config", _config(1), "--seconds",
                                      "0.01", "--cpu"])
    yield fut
    pool.shutdown(wait=True)


@pytest.fixture(scope="module", autouse=True)
def _start_reference(jax_config1):
    """Start the reference's run at the module's start."""


# ---- config.py -----------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_loads_like_reference(path):
    got = config.load_scenario(path)
    assert got.to_dict() == jconfig.load_scenario(path).to_dict()
    assert config.ScenarioConfig.from_dict(got.to_dict()) == got


def _arm_urdf(tmp_path):
    """A 7-link chain whose links are named as zoo.arm7's (arm1_1 ...
    arm1_7), written to a file."""
    links = "".join(f"""<link name="arm1_{i}"><inertial><origin xyz="0 0 0.1"/>
      <mass value="1.0"/><inertia ixx="0.01" iyy="0.01" izz="0.005"/>
      </inertial></link>""" for i in range(1, 8))
    joints = "".join(f"""<joint name="j{i}" type="revolute">
      <parent link="{'base' if i == 1 else f'arm1_{i - 1}'}"/>
      <child link="arm1_{i}"/><origin xyz="0 0 0.2"/>
      <axis xyz="{'0 0 1' if i % 2 else '0 1 0'}"/></joint>"""
                     for i in range(1, 8))
    path = tmp_path / "arm.urdf"
    path.write_text(f'<robot name="arm"><link name="base"/>{links}{joints}'
                    '</robot>')
    return path


def test_config_checks(tmp_path):
    with pytest.raises(ValueError, match="unknown"):
        config.ScenarioConfig.from_dict({"robot": {"zoo": "arm7", "bogus": 1}})
    with pytest.raises(ValueError, match="exactly one"):
        config.ScenarioConfig.from_dict({"robot": {}})
    cfg = config.ScenarioConfig.from_dict(
        {"robot": {"urdf": str(_arm_urdf(tmp_path)), "floating": True}})
    model = config.build_model(cfg, device="cpu")
    assert model.floating and model.nj == 7
    assert model.link_names[-1] == "arm1_7"
    assert model.device == torch.device("cpu")
    cfg = config.ScenarioConfig.from_dict({
        "robot": {"zoo": "arm7"},
        "plugin": {"type": "qppvm", "left_ee": "arm1_7",
                   "right_ee": "arm1_7", "extra_key_passes": 1},
        "solver": {"iters": 40, "opts": {"rho_updates": 0,
                                         "backend": "kernel"}}})
    # the key "backend" is read only as "kernel", and dropped
    assert cfg.solver.opts == {"rho_updates": 0}
    assert cfg.plugin.extra == {"extra_key_passes": 1}
    cfg.plugin.extra = {}
    plugin = config.build_plugin(cfg, config.build_model(cfg, device="cpu"))
    assert plugin.solver_opts["rho_updates"] == 0
    assert "backend" not in plugin.solver_opts
    with pytest.raises(ValueError, match="solver.opts.backend"):
        config.ScenarioConfig.from_dict(
            {"robot": {"zoo": "arm7"},
             "solver": {"opts": {"backend": "torch"}}})
    cfg.plugin.type = "bogus"
    with pytest.raises(ValueError, match="unknown plugin type"):
        config.build_plugin(cfg, plugin.model)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_build_scenario_on_cpu(n):
    cfg = config.load_scenario(_config(n))
    model, plugin, robot = config.build_scenario(cfg, device="cpu")
    assert plugin.model is model and robot.model is model
    assert model.device == torch.device("cpu")
    assert isinstance(plugin, {"qppvm": QPPVMPlugin,
                               "force_acc": ForceAccPlugin}[cfg.plugin.type])
    assert robot.contact_links == cfg.plugin.contact_links
    assert robot.substeps == cfg.sim.substeps
    with pytest.raises(ValueError, match="no mpc"):
        config.build_mpc(cfg, plugin)


def test_build_mpc_on_cpu():
    cfg = config.load_scenario(_config(5))
    assert cfg.mpc.enabled and cfg.mpc.n_samples == 4096
    cfg.mpc.n_samples, cfg.mpc.horizon = 4, 2
    model = config.build_model(cfg, device="cpu")
    mpc = config.build_mpc(cfg, config.build_plugin(cfg, model))
    assert mpc.init_plan().shape == (2, mpc.mppi.nu)
    assert (mpc.mppi.push_std, mpc.mppi.mass_scale_std,
            mpc.mppi.mu_scale_range, mpc.rcfg.qp_iters) == (40.0, 0.08,
                                                            0.25, 12)
    cfg.mpc.type = "ilqr"
    ddp = config.build_mpc(cfg, mpc.plugin)
    assert isinstance(ddp, CentroidalMPC) and ddp.model is model
    assert (ddp.cfg.horizon, ddp.cfg.iterations) == (2, 12)
    assert ddp.contact_links == cfg.plugin.contact_links


# ---- run.py --------------------------------------------------------------

def test_run_mpc_and_unported_scenarios(tmp_path, monkeypatch):
    out = run.main(["--config", _config(5), "--samples", "4", "--horizon",
                    "2", "--cpu"])
    assert set(out) == MPC_KEYS | {"device"}
    assert (out["n_samples"], out["horizon"], out["devices"],
            out["device"]) == (4, 2, 1, "cpu")
    assert np.isfinite(out["plan_norm"])
    # a URDF robot runs like a zoo one
    urdf = tmp_path / "urdf.yaml"
    urdf.write_text(open(_config(1)).read().replace(
        "zoo: arm7", f"urdf: {_arm_urdf(tmp_path)}"))
    out = run.main(["--config", str(urdf), "--seconds", "0.002", "--cpu"])
    assert set(out) == LOOP_KEYS | {"device"}
    assert np.isfinite(out["final_q_norm"])
    # the reference's runner calls the iLQR planner's init_plan without the
    # state it needs: TypeError before any plan, copied (on_start stubbed,
    # the fault is after it)
    ilqr = tmp_path / "ilqr.yaml"
    ilqr.write_text(open(_config(5)).read().replace(
        "enabled: true", "enabled: true\n  type: ilqr"))
    monkeypatch.setattr(ForceAccPlugin, "on_start",
                        lambda self, st: (None,) * 3)
    with pytest.raises(TypeError, match="init_plan.*state"):
        run.main(["--config", str(ilqr), "--cpu"])
    if not torch.cuda.is_available():
        # without --cpu the entry point runs on the card, and raises here
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.main(["--config", _config(1), "--seconds", "0.001"])


def test_run_loop_matches_reference(jax_config1, tmp_path):
    """Config 1, 10 ticks: the reference's keys, and its final q norm."""
    trace = str(tmp_path / "trace")
    out = run.main(["--config", _config(1), "--seconds", "0.01", "--cpu",
                    "--trace", trace])
    ref = jax_config1.result()
    assert set(ref) == LOOP_KEYS
    assert set(out) == LOOP_KEYS | {"device", "trace"}
    assert out["device"] == "cpu" and out["scenario"] == ref["scenario"]
    assert abs(out["final_q_norm"] - ref["final_q_norm"]) <= 1e-4, (out, ref)
    with np.load(out["trace"]) as data:
        assert data["tau_desired"].shape[0] == 10
    # a floating base adds its final height
    out = run.main(["--config", _config(3), "--seconds", "0.003", "--cpu"])
    assert set(out) == LOOP_KEYS | {"final_base_z", "device"}
    assert abs(out["final_base_z"] - 0.95) < 0.05


# ---- runtime/async_mpc.py ------------------------------------------------

H, NU = 4, 3
READY = {3, 4, 11, 17, 18, 30, 31, 32, 33, 47}


class _StubPlanner:
    """A planner whose plan n returns U_nom + (n + 1) R, R a fixed ramp,
    and info {"n": n}; ``lib`` is torch or jax.numpy."""

    def __init__(self, lib, zeros):
        self.lib, self._zeros, self.n = lib, zeros, 0
        self.mppi = SimpleNamespace(nu=NU)
        self.plugin = SimpleNamespace(device="cpu")
        self.ramp = 0.01 * np.arange(H * NU, dtype=np.float32).reshape(H, NU)

    def init_plan(self):
        return self._zeros((H, NU))

    def plan(self, key, state, refs, warm, U_nom):
        n, self.n = self.n, self.n + 1
        return U_nom + (n + 1) * self.lib.asarray(self.ramp), {"n": n}


def test_async_planner_matches_reference(monkeypatch):
    """Tick by tick: launches, commits, ages, rows and the commit
    latencies, with readiness scripted; then flush, which commits
    without recording a latency on both sides (the reference's fault)."""
    ready = {"now": False}
    monkeypatch.setattr(jasync, "_is_ready", lambda x: ready["now"])
    monkeypatch.setattr(async_mpc, "_is_ready", lambda f, e: ready["now"])
    jp = jasync.AsyncPlanner(
        _StubPlanner(jnp, lambda s: jnp.zeros(s, jnp.float32)),
        replan_ticks=5, ticks_per_step=3)
    tp = async_mpc.AsyncPlanner(_StubPlanner(torch, torch.zeros),
                                replan_ticks=5, ticks_per_step=3)
    state, refs, warm = (torch.zeros(2), {"a": torch.ones(1)},
                         (torch.zeros(1),))
    for i in range(50):
        ready["now"] = i in READY
        u, age = tp.tick(i, state, refs, warm)
        ju, jage = jp.tick(i, None, None, None)
        assert age == jage, i
        np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
        assert (tp.n_launch, tp.n_commit) == (jp.n_launch, jp.n_commit), i
    assert tp.commit_latency_ticks == jp.commit_latency_ticks
    assert [i["n"] for i in tp.infos] == [i["n"] for i in jp.infos]
    assert tp.n_commit >= 4 and tp._pending is not None
    tp.close()
    jp.flush()
    assert (tp.n_commit, tp.commit_latency_ticks, len(tp.infos)) == (
        jp.n_commit, jp.commit_latency_ticks, len(jp.infos))
    assert len(tp.commit_latency_ticks) == tp.n_commit - 1


def test_async_planner_runs_on_a_worker():
    """Unscripted: plans run on the worker thread, each from the committed
    plan, with the planner's own generator."""
    stub = _StubPlanner(torch, torch.zeros)
    seen = []
    plan = stub.plan

    def spy(gen, *args):
        import threading
        seen.append((threading.current_thread().name, gen))
        return plan(gen, *args)

    stub.plan = spy
    tp = async_mpc.AsyncPlanner(stub, replan_ticks=1, ticks_per_step=1)
    u, age = tp.tick(0, torch.zeros(1), {}, ())
    assert age == -1 and torch.equal(u, torch.zeros(NU))
    tp._pending[0].result()
    u, age = tp.tick(1, torch.zeros(1), {}, ())
    assert (age, tp.n_commit, tp.n_launch) == (1, 1, 2)
    tp.close()
    assert all(name.startswith("planner") for name, _ in seen)
    assert all(g is tp._gen for _, g in seen)
    assert tp.n_commit == 2 and torch.allclose(
        tp._committed[0], torch.tensor(3 * stub.ramp))


# ---- runtime/native.py ---------------------------------------------------

def test_native_builds_into_the_port():
    assert native.available()
    path = native.library_path()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "qppvm_tpu_torch"


def test_executor_paces_and_counts():
    ex = native.NativeExecutor(period_s=1e-3)
    ticks = []
    n = ex.run(lambda tick, t_s: ticks.append((tick, t_s)) or True, 50)
    assert n == 50 and len(ticks) == 50
    assert ex.stats()["p99_s"] < 1e-3
    assert ticks[-1][1] >= 0.04


def test_executor_early_stop():
    ex = native.NativeExecutor(period_s=1e-4)
    assert ex.run(lambda tick, t: tick < 10, 1000) == 11
    # a callback that raises stops the run too
    assert ex.run(lambda tick, t: 1 / (tick - 3) is None or True, 1000) == 4


def test_ring_roundtrip_and_overflow():
    ring = native.NativeTraceRing(1 << 16)
    for i in range(10):
        assert ring.push(7, torch.full((4,), float(i)))
    out = []
    while (rec := ring.pop()) is not None:
        out.append(rec)
    assert len(out) == 10 and out[3][0] == 7
    np.testing.assert_allclose(out[3][1], 3.0)
    assert ring.dropped == 0
    ring = native.NativeTraceRing(256)
    for i in range(100):
        ring.push(1, np.full(8, float(i)))
    assert ring.dropped > 0
    seen = 0
    while (rec := ring.pop()) is not None:
        assert rec[0] == 1 and np.all(rec[1] == rec[1][0])   # intact
        seen += 1
    assert seen >= 1


def test_shm_channel_roundtrip():
    name = f"/qppvm_torch_shm_{os.getpid()}"
    pub = native.NativeSharedObject(name, size=6, create=True)
    sub = native.NativeSharedObject(name)
    assert sub.read()[0] == 0   # never written
    pub.write(torch.arange(1.0, 7.0))
    seq, v = sub.read()
    assert seq == 2
    np.testing.assert_allclose(v, [1, 2, 3, 4, 5, 6])
    pub.write(np.arange(6) * 0.5)
    seq, v = sub.read()
    assert seq == 4
    np.testing.assert_allclose(v, np.arange(6) * 0.5)
    sub.close()
    pub.close()
    with pytest.raises(ValueError, match="size"):
        native.NativeSharedObject(name, create=True)
