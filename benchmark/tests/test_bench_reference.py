"""The benchmark's plain reference against the program, on the CPU at small
sizes, and the frozen accounting.

On the CPU the program's kernels run their plain versions, so the
reference, a frozen copy of the plain path, does the same arithmetic: the
tick, the plant period and the MPPI update agree to float32 rounding (the
reference batches ticks that the program ran one by one, so products may
block differently).

    python -m pytest benchmark/tests -q
"""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import accounting, harness, wbc  # noqa: E402
from benchmark.reference import scenario as refscen  # noqa: E402
from benchmark.reference.mpc.rollout import standing_state  # noqa: E402
from benchmark.reference.runtime import robot_interface as ref_ri  # noqa: E402

# float32 through 12 ADMM iterations of two levels: a few ulps of |tau|
TICK_GAP = 1e-4


def setup_tick(cell, batch):
    run = harness.Run(cell, 7, "cpu")
    model, plugin = wbc.program(run)
    rmodel, rplug = wbc.reference(run, torch.float32, "cpu")
    start = wbc.state_dict(standing_state(rmodel, plugin.contact_links))
    g = run.generator(1)
    fields = {f: wbc.expand_tree(v, batch) for f, v in start.items()}
    fields["q"] = fields["q"] + 0.01 * torch.randn(
        fields["q"].shape, generator=g, dtype=fields["q"].dtype)
    return run, model, plugin, rplug, start, fields


@pytest.mark.parametrize("cell", ["humanoid-loop-b1",
                                  "centaur-batch-b1024"])
def test_tick_matches_program(cell):
    run, model, plugin, rplug, start, fields = setup_tick(cell, 3)
    refs, warm, _ = plugin.on_start(wbc.as_program_state(start))
    rrefs, rwarm = wbc.on_start_ref(rplug, start, torch.float32, "cpu")
    assert harness.rel_gap(wbc.warm_x(warm), wbc.warm_x(rwarm)) == 0.0
    st = wbc.as_program_state(fields)
    warm_b = tuple(type(s)(**{f: wbc.expand_tree(getattr(s, f), 3)
                              for f in wbc.QP_FIELDS}) for s in warm)
    idx = torch.arange(3)
    for _ in range(2):
        inputs = wbc.record_inputs(st, warm_b, idx)
        tau, warm_b, aux = plugin._step_impl(st, wbc.expand_tree(refs, 3),
                                             warm_b)
        out = wbc.record_outputs(tau, warm_b, aux, idx)
        ref = wbc.reference_ticks(rplug, rrefs, inputs, torch.float32, "cpu")
        gaps = wbc.tick_gaps(out, ref)
        assert max(gaps.values()) <= TICK_GAP, gaps


def test_plant_matches_program():
    from qppvm_tpu_torch import config as cfglib
    run = harness.Run("humanoid-loop-b1", 3, "cpu")
    model, plugin = wbc.program(run)
    robot = cfglib.build_sim(run.cfg, model)
    rmodel, _ = wbc.reference(run, torch.float32, "cpu")
    plant = refscen.Plant(wbc.raw_scenario(run), rmodel)
    g = torch.Generator().manual_seed(5)
    tau = 5.0 * torch.randn(1, model.nj, generator=g)
    st0 = wbc.state_dict(robot.state)
    anchors = robot._anchors.clone()
    robot.set_reference(tau_ref=tau, q_ref=robot.state.q)
    robot.move()
    rst = wbc.as_ref_state(st0, torch.float32, "cpu")
    after, ranchors = plant.move(rst, anchors, tau, rst.q)
    for f in wbc.STATE_FIELDS:
        assert torch.allclose(getattr(robot.state, f), getattr(after, f),
                              rtol=0, atol=1e-6), f
    assert torch.allclose(robot._anchors, ranchors, rtol=0, atol=1e-6)
    init = ref_ri.init_anchors(rmodel, rst, plant.idx, plant.offsets)
    assert torch.allclose(init, anchors, rtol=0, atol=1e-6)


def test_mppi_update_matches_program():
    from qppvm_tpu_torch import config as cfglib
    run = harness.Run("humanoid-mppi-k4096-h16", 4, "cpu",
                      scenario_overrides={"mpc": {"n_samples": 4,
                                                  "horizon": 3}})
    model, plugin = wbc.program(run)
    mpc = cfglib.build_mpc(run.cfg, plugin)
    rmodel, rplug = wbc.reference(run, torch.float32, "cpu")
    rmpc = refscen.build_mpc(wbc.raw_scenario(run), rplug)
    start = wbc.state_dict(standing_state(rmodel, plugin.contact_links))
    st = wbc.as_program_state(start)
    refs, warm, _ = plugin.on_start(st)
    rrefs, rwarm = wbc.on_start_ref(rplug, start, torch.float32, "cpu")
    g = torch.Generator().manual_seed(9)
    U = 0.1 * torch.randn(4, 3, 3, generator=g)
    scen = {"push": 40.0 * torch.randn(4, 3, 3, generator=g),
            "mass_scale": torch.exp(0.08 * torch.randn(4, generator=g)),
            "mu_scale": 1.0 - 0.25 * torch.rand(4, generator=g)}
    U_new, info = mpc.update(st, refs, warm, U, scen)
    rU, rinfo = rmpc.update(wbc.as_ref_state(start, torch.float32, "cpu"),
                            rrefs, rwarm, U, scen)
    assert harness.rel_gap(info["costs"][:, None], rinfo["costs"][:, None]) \
        <= TICK_GAP
    assert torch.equal(info["solver_failed"], rinfo["solver_failed"])
    assert harness.rel_gap(U_new[None], rU[None]) <= 1e-6


@pytest.mark.parametrize("cell", ["humanoid-loop-b1",
                                  "centaur-batch-b1024"])
def test_flop_count_is_affine_in_the_batch(cell):
    """Products over the items scale with the batch; a few act on the
    model's constants once a tick, so the count is affine, not linear."""
    run, model, plugin, rplug, start, fields = setup_tick(cell, 3)
    counts = {}
    for b in (1, 2, 3):
        st = wbc.as_ref_state({f: v[:b] for f, v in fields.items()},
                              torch.float32, "cpu")
        refs, warm, _ = rplug.on_start(st)
        counts[b] = accounting.count_flops(rplug._step_impl, st, refs, warm)
    per_item = counts[2] - counts[1]
    assert 0 < per_item and counts[3] == counts[1] + 2 * per_item
    assert counts[1] - per_item < 0.01 * per_item


def test_declared_costs_replace_the_plain_products():
    run, model, plugin, rplug, start, fields = setup_tick(
        "humanoid-loop-b1", 1)
    st = wbc.as_ref_state({f: v[:1] for f, v in fields.items()},
                          torch.float32, "cpu")
    refs, warm, _ = rplug.on_start(st)
    with wbc.LevelLog() as log:
        flops = accounting.count_flops(rplug._step_impl, st, refs, warm)
    assert len(log.calls) == 2
    declared = sum(accounting.level_qp_cost(cfg, 1, n, m)[0]
                   for cfg, n, m in log.calls)
    assert 0 < declared < flops
    # the bound of a level at B 1024 is set by its operations
    cfg, n, m = log.calls[0]
    ms, what = accounting.bound_ms(*accounting.level_qp_cost(cfg, 1024, n, m))
    assert what == "operations" and ms > 0
