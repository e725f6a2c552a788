"""The port's FLOP accounting (qppvm_tpu_torch/bench_util.py) against the
reference's (qppvm_tpu/bench_util.py).

- ``matmul_flops`` equals ``jaxpr_matmul_flops`` on matched programs: a
  matrix product, a batched one, einsums (a batched product and a
  mat-vec), and a T-step Python loop against a ``lax.scan`` of length T
  (the walk multiplies the body by its trip count; the eager count sees
  every trip);
- a level solve and an NS inverse add exactly their declared cost by the
  plain route on the CPU (their own products are not counted), and the
  humanoid's RT tick counts the same whatever products run inside the
  level solver (the kernel's or the plain version's);
- ``mfu``'s arithmetic, ``peak_flops`` of an H100 and of the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu.bench_util import jaxpr_matmul_flops
from qppvm_tpu_torch import bench_util
from qppvm_tpu_torch.model import zoo
from qppvm_tpu_torch.mpc.rollout import standing_state
from qppvm_tpu_torch.opt import level_qp, ns_inverse
from qppvm_tpu_torch.opt import level_qp_parity as parity
from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin

torch.set_num_threads(1)
T = 6


def _programs(xp):
    """name -> (fn, shapes of its arguments) written for package xp."""
    def loop_torch(A, x):
        for _ in range(T):
            x = torch.tanh(A @ x)
        return x

    def loop_jax(A, x):
        return jax.lax.scan(lambda c, _: (jnp.tanh(A @ c), None), x, None,
                            length=T)[0]

    return {
        "mm": (lambda a, b: a @ b, [(5, 7), (7, 3)]),
        "batched": (lambda a, b: xp.matmul(a, b), [(4, 5, 6), (4, 6, 2)]),
        "einsum": (lambda a, b: xp.einsum("bij,bjk->bik", a, b),
                   [(3, 4, 5), (3, 5, 6)]),
        "matvec": (lambda a, v: xp.einsum("ij,j->i", a, v), [(8, 9), (9,)]),
        "loop": (loop_torch if xp is torch else loop_jax, [(7, 7), (7,)]),
    }


@pytest.mark.parametrize("name", ["mm", "batched", "einsum", "matvec",
                                  "loop"])
def test_matmul_flops_matches_jaxpr_walk(name):
    rng = np.random.default_rng(0)
    fn_t, shapes = _programs(torch)[name]
    fn_j, _ = _programs(jnp)[name]
    args = [rng.normal(size=s).astype(np.float32) for s in shapes]
    want = jaxpr_matmul_flops(fn_j, *(jnp.asarray(a) for a in args))
    got = bench_util.matmul_flops(fn_t, *(torch.as_tensor(a) for a in args))
    assert want > 0 and got == want


@pytest.mark.parametrize("n,m,h,t", [(44, 12, 6, 0), (44, 18, 6, 6)])
def test_level_solve_counts_its_declared_cost(n, m, h, t):
    B = 3
    cfg = level_qp.LevelQPConfig(n_eq_head=h, n_eq_tail=t, cold_ns_iters=10)
    prob = parity.random_problems(B, n, m, h, t, "cpu", seed=0)
    state = parity.zero_state(B, n, m, "cpu")
    got = bench_util.matmul_flops(level_qp.solve_level, cfg, *prob, *state)
    assert got == bench_util.level_qp_cost(cfg, B, n, m)[0]


def test_ns_inverse_counts_its_declared_cost():
    g = torch.Generator().manual_seed(0)
    M = torch.randn(5, 22, 22, generator=g)
    K = M @ M.transpose(1, 2) + 0.5 * torch.eye(22)
    got = bench_util.matmul_flops(ns_inverse.ns_inverse, K, 24)
    assert got == bench_util.ns_inverse_cost(5, 22, 24)[0] == 4 * 5 * 24 * 22 ** 3


def test_tick_counts_alike_through_either_level_solver(monkeypatch):
    model = zoo.humanoid(device="cpu")
    contacts = ("l_sole", "r_sole")
    st = standing_state(model, contacts)
    rt = dict(rho_updates=0, warm_kinv_iters=4, cold_ns_iters=10,
              scale_iters=2, pinv_ns_iters=5)
    plugin = ForceAccPlugin(model, contact_links=contacts,
                            waist_link="pelvis", iters=12, solver_opts=rt)
    refs, warm, _ = plugin.on_start(st)
    counts = {"kernel": bench_util.matmul_flops(plugin._step_impl, st, refs,
                                                warm)}
    # a level solver whose own products differ (here: the plain version
    # run twice) counts the same: the level is read at its declared cost
    real = level_qp.solve_level_reference
    monkeypatch.setattr(level_qp, "solve_level_reference",
                        lambda *a: real(*a) and real(*a))
    counts["torch"] = bench_util.matmul_flops(plugin._step_impl, st, refs,
                                              warm)
    assert counts["kernel"] == counts["torch"]
    # the two levels' declared costs are part of it
    cfg0 = level_qp.LevelQPConfig(iters=12, warm_kinv_iters=4,
                                  cold_ns_iters=10, n_eq_head=6)
    levels = bench_util.level_qp_cost(cfg0, 1, 44, 12)[0]
    assert counts["torch"] > levels


def test_mfu_and_peaks():
    assert bench_util.peak_flops("cpu") is None
    assert bench_util.peak_flops("NVIDIA H100 80GB HBM3") == 67e12
    assert bench_util.mfu(6.7e9, 1e-3, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(0.1)
    assert bench_util.mfu(6.7e9, 1e-3, "NVIDIA H100 80GB HBM3",
                          n_devices=4) == pytest.approx(0.025)
    assert bench_util.mfu(1e9, 1.0, "cpu") is None
    assert bench_util.mfu(None, 1.0, "NVIDIA H100 80GB HBM3") is None
    ms, by = bench_util.bound_ms(67e9, 1.0)
    assert ms == pytest.approx(1.0) and by == "operations"
