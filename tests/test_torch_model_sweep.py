"""The model-sweep kernel (``csrc/model_sweep.cu``, ``model/model_sweep.py``)
and the model update's dispatch to it.

On the CPU (fast, no JAX):

- ``model_sweep.takes`` sends a float32 model with one shared
  inertia to the kernel, and float64, an nj over the kernel's largest
  (``MAX_NJ``), a per-item inertia (the rollout's mass-scaled plant model)
  and a state or model that needs a gradient to the plain path;
- the topology array: each link's parent (the base is node nj), depth and
  children in ascending order, the roots the base's children;
- ``sweep`` raises on a CPU state, and ``compute_model_data`` on a CPU state
  runs the plain stages and counts neither ``model_sweep.launch`` nor
  ``model.plain_sweep``.

Marked ``cuda`` (each skips without a CUDA device), also run with

    python -m pytest tests/test_torch_model_sweep.py -q -m cuda --noconftest

- R, p, S_ang, h and bias_all of the kernel against ``sweep_reference``
  (the plain functions, on the card, float32, TF32 off) on the zoo
  humanoid, centaur, quadruped and the fixed-base dual arm at B 1, 7 and
  1024, from states far from home (q std 0.5, qd and base_vel std 1, a
  random base rotation), and on the humanoid with every third joint made
  prismatic. Each gap is ``max |a - r| / max(max |r|, 1)`` over an item,
  the largest over the batch; the bar is 5e-5 for every output: float32
  roundoff (2^-24 = 6e-8 relative) over ten depth levels in another
  summation order gives about 1e-6, and a dropped term gives 1e-2 or more;
- ``MAX_NJ`` is the built kernel's largest nj;
- a planted fault (the kernel built with ``MODEL_SWEEP_DROP_SIBLING``:
  a parent, or the base, with two or more children loses its last child's
  force) fails that bar on h;
- ``compute_model_data`` on the card: a float32 state goes through one
  launch (``model_sweep.launch``, span ``model_update.sweep``) and matches
  the plain path; a float64 state, and a float32 one with
  ``plain_sweeps`` (on_start's), run the plain path and count
  ``model.plain_sweep``; so does a state whose q needs a gradient, and
  its h carries the gradient of the plain functions; ``sweep`` raises on
  such a state.
"""
import dataclasses

import numpy as np
import pytest
import torch

from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import dynamics, model_sweep, spatial, zoo
from qppvm_tpu_torch.model.robot import PRISMATIC, RobotState

MODELS = ("humanoid", "centaur", "quadruped", "dual_arm")
BAR = 5e-5


def _state(model, B, seed, dtype=torch.float32):
    """A state far from home: q std 0.5 about home, qd and base_vel std 1,
    a random base rotation and position."""
    g = np.random.default_rng(seed)
    nj = model.nj
    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=model.device)
    return RobotState(
        q=t(model.q_home.cpu().numpy() + 0.5 * g.standard_normal((B, nj))),
        qd=t(g.standard_normal((B, nj))),
        base_rot=spatial.so3_exp(t(g.standard_normal((B, 3)))),
        base_pos=t(g.standard_normal((B, 3))),
        base_vel=t(g.standard_normal((B, 6))))


def _gap(a, r):
    """Largest over items of max |a - r| / max(max |r|, 1)."""
    a, r = a.reshape(a.shape[0], -1), r.reshape(r.shape[0], -1)
    scale = torch.clamp(r.abs().amax(dim=1), min=1.0)
    return float(((a - r).abs().amax(dim=1) / scale).max())


def _gaps(out, ref):
    (kin, h, bias), (kr, hr, br) = out, ref
    return {"R": _gap(kin.R, kr.R), "p": _gap(kin.p, kr.p),
            "S_ang": _gap(kin.S_ang, kr.S_ang), "h": _gap(h, hr),
            "bias_all": _gap(bias, br)}


# --- CPU ---------------------------------------------------------------------

def test_kernel_takes_float32_with_one_inertia_only(monkeypatch):
    model = zoo.humanoid(device="cpu")
    state = model.home_state(2)
    assert model_sweep.takes(model, state)
    assert not model_sweep.takes(
        zoo.humanoid(dtype=torch.float64, device="cpu"),
        state.astype(torch.float64))
    scaled = dataclasses.replace(
        model, inertia=model.inertia * torch.ones((2, 1, 1, 1)))
    assert not model_sweep.takes(scaled, state)
    monkeypatch.setattr(model_sweep, "MAX_NJ", model.nj - 1)
    assert not model_sweep.takes(model, state)


def test_kernel_declines_what_needs_a_gradient():
    model = zoo.quadruped(device="cpu")
    state = model.home_state(2)
    assert model_sweep.takes(model, state)
    assert not model_sweep.takes(model, dataclasses.replace(
        state, q=state.q.clone().requires_grad_()))
    assert not model_sweep.takes(model, dataclasses.replace(
        state, base_vel=state.base_vel.clone().requires_grad_()))
    assert not model_sweep.takes(dataclasses.replace(
        model, inertia=model.inertia.clone().requires_grad_()), state)


def test_topology_lists_each_tree():
    parent = (-1, 0, 1, 0, -1, 4, 4)
    topo = model_sweep.topology(parent, (0, 1, 0, 0, 0, 1, 0))
    nj = len(parent)
    np.testing.assert_array_equal(topo[:nj], [7, 0, 1, 0, 7, 4, 4])
    np.testing.assert_array_equal(topo[nj:2 * nj], [0, 1, 0, 0, 0, 1, 0])
    np.testing.assert_array_equal(topo[2 * nj:3 * nj], [0, 1, 2, 1, 0, 1, 1])
    start, child = topo[3 * nj:4 * nj + 2], topo[4 * nj + 2:]
    kids = [list(child[start[i]:start[i + 1]]) for i in range(nj + 1)]
    assert kids == [[1, 3], [2], [], [], [5, 6], [], [], [0, 4]]
    assert topo.dtype == np.int32


def test_cpu_state_runs_the_plain_stages():
    model = zoo.centaur(device="cpu")
    state = _state(model, 3, seed=1)
    with pytest.raises(ValueError, match="CUDA"):
        model_sweep.sweep(model, state)
    telemetry.reset("model_sweep.launch", "model.plain_sweep")
    data = dynamics.compute_model_data(model, state)
    kin, h, bias = model_sweep.sweep_reference(model, state)
    assert torch.equal(data.kin.R, kin.R) and torch.equal(data.kin.p, kin.p)
    assert torch.equal(data.h, h) and torch.equal(data.bias_all, bias)
    counted = telemetry.counts()
    assert counted["model_sweep.launch"] == counted["model.plain_sweep"] == 0


# --- on the card -------------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 1024])
@pytest.mark.parametrize("name", MODELS)
def test_kernel_matches_the_plain_sweeps(device, name, B):
    model = zoo.by_name(name, device=device)
    state = _state(model, B, seed=B)
    gaps = _gaps(model_sweep.sweep(model, state),
                 model_sweep.sweep_reference(model, state))
    torch.cuda.synchronize()
    assert max(gaps.values()) < BAR, gaps


@pytest.mark.cuda
def test_kernel_matches_with_prismatic_joints(device):
    model = zoo.humanoid(device=device)
    model = dataclasses.replace(model, joint_type=tuple(
        PRISMATIC if i % 3 == 1 else t
        for i, t in enumerate(model.joint_type)))
    state = _state(model, 7, seed=3)
    gaps = _gaps(model_sweep.sweep(model, state),
                 model_sweep.sweep_reference(model, state))
    assert max(gaps.values()) < BAR, gaps


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["humanoid", "quadruped"])
def test_planted_fault_fails_the_bar(device, name, monkeypatch):
    from qppvm_tpu_torch import build
    faulty = model_sweep.bind(
        build.load("model_sweep", ("MODEL_SWEEP_DROP_SIBLING",)))
    monkeypatch.setattr(model_sweep, "library", lambda: faulty)
    model = zoo.by_name(name, device=device)
    state = _state(model, 7, seed=4)
    gaps = _gaps(model_sweep.sweep(model, state),
                 model_sweep.sweep_reference(model, state))
    assert gaps["h"] > 100 * BAR, gaps


@pytest.mark.cuda
def test_model_update_dispatch_on_the_card(device):
    model = zoo.humanoid(device=device)
    state = _state(model, 7, seed=5)
    telemetry.reset()
    telemetry.enable()
    try:
        data = dynamics.compute_model_data(model, state)
    finally:
        telemetry.enable(False)
    names = [r[0] for r in telemetry.records()]
    assert "model_update.sweep" in names
    assert not {"model_update.fk", "model_update.nonlinear",
                "model_update.bias"} & set(names)
    counted = telemetry.counts()
    assert (counted["model_sweep.launch"], counted["model.plain_sweep"]) == (
        1, 0)
    kin, h, bias = model_sweep.sweep_reference(model, state)
    plain = {"B": dynamics.mass_matrix(model, state, kin=kin), "h": h,
             "bias_all": bias}
    for field, ref in plain.items():
        assert _gap(getattr(data, field), ref) < BAR, field

    telemetry.reset("model_sweep.launch", "model.plain_sweep")
    dynamics.compute_model_data(
        zoo.humanoid(dtype=torch.float64, device=device),
        state.astype(torch.float64))
    plain = dynamics.compute_model_data(model, state, plain_sweeps=True)
    assert _gap(plain.h, h) < BAR and _gap(plain.bias_all, bias) < BAR
    counted = telemetry.counts()
    assert (counted["model_sweep.launch"], counted["model.plain_sweep"]) == (
        0, 2)


@pytest.mark.cuda
def test_max_nj_is_the_kernels(device):
    assert model_sweep.library().model_sweep_max_nj() == model_sweep.MAX_NJ


@pytest.mark.cuda
def test_model_update_keeps_the_gradient_on_the_card(device):
    model = zoo.quadruped(device=device)
    state = _state(model, 3, seed=7)
    q = state.q.clone().requires_grad_()
    telemetry.reset("model_sweep.launch", "model.plain_sweep")
    data = dynamics.compute_model_data(model, dataclasses.replace(state, q=q))
    counted = telemetry.counts()
    assert (counted["model_sweep.launch"], counted["model.plain_sweep"]) == (
        0, 1)
    assert data.h.requires_grad and data.bias_all.requires_grad
    (grad,) = torch.autograd.grad(data.h.sum(), q)
    assert grad.shape == q.shape and bool(torch.isfinite(grad).all())
    assert float(grad.abs().max()) > 0.0
    _, h, _ = model_sweep.sweep(model, state)
    assert _gap(data.h.detach(), h) < BAR


@pytest.mark.cuda
def test_sweep_raises_on_what_it_does_not_take(device):
    model = zoo.quadruped(device=device)
    state = _state(model, 2, seed=6)
    with pytest.raises(ValueError, match="float32"):
        model_sweep.sweep(model, state.astype(torch.float64))
    with pytest.raises(ValueError, match="inertia"):
        model_sweep.sweep(dataclasses.replace(
            model, inertia=model.inertia.expand(2, -1, -1, -1)), state)
    with pytest.raises(ValueError, match="shapes"):
        model_sweep.sweep(model, dataclasses.replace(state, q=state.q[:, :3]))
    with pytest.raises(ValueError, match="gradient"):
        model_sweep.sweep(model, dataclasses.replace(
            state, q=state.q.clone().requires_grad_()))
