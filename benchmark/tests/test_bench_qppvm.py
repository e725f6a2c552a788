"""The QPPVM cell on the CPU at small sizes: the plain reference's QPPVM
plugin and fixed-base plant against the program's, and the comparison that
decides ``correct`` against the faults of mode ``qppvm``.

On the CPU the program's kernels run their plain versions, so the
reference, a frozen copy of the plain path, does the same arithmetic: on
seeded perturbed states at B 1 and B 4 the tick (from a recorded input
state, carry and references), one plant period and on_start's warm
solution agree to float32 rounding; the torques are compared only on
ticks whose task matrix is well conditioned. Each of the mode's planted faults
(``modes/qppvm.py::FAULTS``), run through the mode with a short window,
comes out not correct, and a sound run correct. On the card (marked
``cuda``, skipped where there is none), as ``test_bench_control.py`` does
for the other cells: at the cell's size over a 2 s window on three seeds,
the program keeps within every limit and the control (the reference with
TF32 products) fails at least one.

    python -m pytest benchmark/tests/test_bench_qppvm.py -q
    python3 -m pytest benchmark/tests/test_bench_qppvm.py -q -m cuda
"""
import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, wbc  # noqa: E402
from benchmark import run as bench_run  # noqa: E402
from benchmark.reference import qppvm_scenario as qscen  # noqa: E402

CELL = "dual_arm-qppvm-b1"
MODE = harness.mode("qppvm")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
# float32 through 60 ADMM iterations of two levels: a few ulps of |tau|
TICK_GAP = 1e-4


def setup_side(batch, seed):
    """The program's and the reference's plugin, and a start state of
    ``batch`` items: home with 0.01 N(0, 1) on every joint."""
    run = harness.Run(CELL, seed, "cpu")
    model, plugin = wbc.program(run)
    raw = wbc.raw_scenario(run)
    rmodel, rplug = qscen.build_plugin(raw, torch.float32, "cpu")
    g = run.generator(1)
    start = wbc.state_dict(rmodel.home_state(batch))
    start["q"] = start["q"] + 0.01 * torch.randn(start["q"].shape,
                                                 generator=g)
    return run, model, plugin, raw, rmodel, rplug, start


@pytest.mark.parametrize("batch", [1, 4])
def test_tick_and_start_match_program(batch):
    run, model, plugin, raw, rmodel, rplug, start = setup_side(batch, 11)
    refs, warm, pose = plugin.on_start(wbc.as_program_state(start))
    rrefs, rwarm, rpose = rplug.on_start(
        wbc.as_ref_state(start, torch.float32, "cpu"))
    assert harness.rel_gap(wbc.warm_x(warm), wbc.warm_x(rwarm)) == 0.0
    assert torch.equal(pose["p"], rpose["p"])
    g = torch.Generator().manual_seed(batch)
    fields = dict(start)
    fields["q"] = fields["q"] + 0.01 * torch.randn(fields["q"].shape,
                                                   generator=g)
    fields["qd"] = 0.1 * torch.randn(fields["qd"].shape, generator=g)
    st = wbc.as_program_state(fields)
    idx = torch.arange(batch)
    left = plugin.ee_left.name
    for k in range(2):
        tick_refs = dict(refs, **{left: plugin.make_refs(pose, 0.3 + k)})
        inputs = dict(wbc.record_inputs(st, warm, idx),
                      refs=MODE.take_tree(tick_refs, idx))
        tau, warm, aux = plugin.control_loop(st, tick_refs, warm)
        out = MODE.tick_outputs(tau, warm, aux)
        ref = MODE.tick_outputs(*rplug._step_impl(
            wbc.as_ref_state(inputs["state"], torch.float32, "cpu"),
            MODE.to_tree(inputs["refs"], torch.float32, "cpu"),
            wbc.as_ref_warm(inputs["warm"], torch.float32, "cpu")))
        gaps = {n: harness.rel_gap(out[n], ref[n]) for n in out}
        assert max(gaps.values()) <= TICK_GAP, gaps


def test_plant_matches_program():
    from qppvm_tpu_torch import config as cfglib
    run, model, plugin, raw, rmodel, rplug, start = setup_side(1, 3)
    robot = cfglib.build_sim(run.cfg, model)
    robot.state = wbc.as_program_state(start)
    g = torch.Generator().manual_seed(5)
    tau = 5.0 * torch.randn(1, model.nj, generator=g)
    robot.set_reference(tau_ref=tau, q_ref=robot.state.q)
    robot.move()
    rst = wbc.as_ref_state(start, torch.float32, "cpu")
    after = qscen.Plant(raw, rmodel).move(rst, tau, rst.q)
    for f in wbc.STATE_FIELDS:
        assert torch.allclose(getattr(robot.state, f), getattr(after, f),
                              rtol=0, atol=1e-6), f


def test_ticks_out_of_reach_are_not_compared():
    """``tau`` and ``tau_qp`` are compared on a tick near home (level 0's
    task matrix at a condition of about 3) and not on one with the left arm
    stretched straight, where its position rows lose rank."""
    run = harness.Run(CELL, 5, "cpu", {"warmup_units": 1})
    cell = MODE.setup(run)
    idx = torch.zeros(1, dtype=torch.int64)
    refs = dict(cell.refs, **{cell.left: cell.plugin.make_refs(cell.pose,
                                                               0.0)})
    near = wbc.state_dict(cell.robot.state)
    straight = dict(near, q=near["q"].clone())
    straight["q"][:, [cell.model.dof_index(f"j_arm1_{k}")
                      for k in range(1, 8)]] = 0.0
    inputs = {"state": {f: torch.cat([near[f], straight[f]])
                        for f in wbc.STATE_FIELDS},
              "refs": wbc.expand_tree(MODE.take_tree(refs, idx), 2)}
    assert cell.determined(inputs, "cpu").tolist() == [True, False]


def measure(seconds=1.0):
    result, _ = bench_run.measure(SPEC, CELL, 2 ** 31 + 99, seconds, 0,
                                  "cpu", {"sample_rate": 0.5,
                                          "warmup_units": 3})
    return result


@pytest.mark.parametrize("fault", MODE.FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch.setattr)
    result = measure()
    assert result["correct"] is False, result["checks"]


def test_sound_run_is_correct():
    result = measure()
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 102, 103])
def test_control_fails_and_program_passes(seed, card):
    run = harness.Run(CELL, seed, card)
    c = MODE.setup(run)
    c.window(2.0)
    c.release()
    numbers, limits = c.check()
    _, ok = harness.judge(numbers, limits)
    assert ok, numbers
    control, _ = c.check(control=True)
    over = [k for k in limits
            if not (math.isfinite(control[k]) and control[k] <= limits[k])]
    assert over, control
