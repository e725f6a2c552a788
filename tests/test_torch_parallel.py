"""The port's parallel layer (qppvm_tpu_torch/parallel/) on 4 gloo ranks,
against a sequential loop and against qppvm_tpu's on the conftest's 8
virtual CPU devices.

One process group of 4 spawned ranks serves the whole file (module
fixture): rendezvous through a file under the test's temporary directory
(xdist workers never share a port), each collective bounded by a 30 s
group timeout and the ranks by a 180 s join, so a hung collective fails
the test instead of hanging the suite. The rank bodies are in
tests/torch_parallel_ranks.py, which imports no JAX.

- ``ring_rollout`` (float64, tests/test_ring_horizon.py's dynamics, T 16
  over 4 segments): exact at sweeps=None against a sequential loop and
  the reference's ``ring_rollout`` on ``make_mesh(4, "seg")``, atol 1e-12;
  defects non-increasing over sweeps 1 to 4 and equal to the reference's;
  a warm single sweep exact; each rank's slice of dU through the ring
  against sequential autograd and the reference's ``grad``, atol 1e-10,
  and zero outside its slice; a bad horizon and sweeps 0 raise;
- ``shard_batch``'s rows per rank, the all-reduce of shard sums (the
  counterpart of ``test_psum_collective_on_mesh``), a 2-D mesh's shape and
  coordinates, ``replicate`` and ``batch_spec``; a mesh of one rank in
  this process;
- the sharded quadruped plan at tests/test_mpc_parallel.py:101-118's
  settings (K 16, horizon 2, qp_iters 6) on the 1-D and the (2, 2) mesh:
  bitwise the same on every rank, and within atol 1e-4 (U) and rtol 1e-3
  (cost_mean) of the port's unsharded plan from the same generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_ranks as ranks
from qppvm_tpu.parallel import mesh as jmesh
from qppvm_tpu.parallel.ring_horizon import ring_rollout as jring
from qppvm_tpu_torch.parallel import mesh as meshlib

N, T, D = 4, 16, 5
L = T // N


def _jstep(c, u):
    x, v = c
    x2 = jnp.tanh(0.9 * x + 0.3 * u) + 0.05 * v
    v2 = 0.8 * v + 0.1 * jnp.sin(x) + u
    return (x2, v2), (x2, jnp.sum(v2))


def _inputs():
    rng = np.random.default_rng(0)
    U = 0.5 * rng.normal(size=(T, D))
    x0 = (np.linspace(-1.0, 1.0, D), np.zeros(D))
    return x0, U


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every rank's results of tests/torch_parallel_ranks.py::run."""
    x0, U = _inputs()
    init = tmp_path_factory.mktemp("rendezvous") / "file"
    return meshlib.run_ranks(ranks.run, N, (x0, U), timeout_s=180.0,
                             group_timeout_s=30.0, init_file=str(init))


@pytest.fixture(scope="module")
def sequential():
    """The sequential rollout in torch: final carry, outputs and dU of
    sum(final x ** 2)."""
    x0, U = _inputs()
    Ut = torch.tensor(U, requires_grad=True)
    c = tuple(torch.tensor(a) for a in x0)
    outs = []
    for t in range(T):
        c, o = ranks.step(c, Ut[t])
        outs.append(o)
    torch.sum(c[0] ** 2).backward()
    outs = tuple(torch.stack(o).detach().numpy() for o in zip(*outs))
    return tuple(a.detach().numpy() for a in c), outs, Ut.grad.numpy()


@pytest.fixture(scope="module")
def reference():
    """The reference's ring on 4 virtual devices (jitted): exact rollout,
    defects over sweeps 1 to 4, and dU."""
    x0, U = _inputs()
    x0, U = tuple(jnp.asarray(a) for a in x0), jnp.asarray(U)
    mesh = jmesh.make_mesh(4, axis="seg")

    def ring(u, sweeps=None):
        return jring(_jstep, x0, u, mesh, sweeps=sweeps)

    final, outs, _ = jax.jit(ring)(U)
    defects = [float(jax.jit(ring, static_argnums=1)(U, s)[2].defect)
               for s in (1, 2, 3, 4)]
    grad = jax.jit(jax.grad(lambda u: jnp.sum(ring(u)[0][0] ** 2)))(U)
    return (tuple(np.asarray(a) for a in final),
            tuple(np.asarray(a) for a in outs), defects, np.asarray(grad))


def test_ring_exact_matches_sequential_and_reference(group, sequential,
                                                     reference):
    seq_final, seq_outs, _ = sequential
    ref_final, ref_outs, _, _ = reference
    for r, res in enumerate(group):
        final, outs, defect = res["ring"]["exact"]
        seg = slice(r * L, (r + 1) * L)
        for a, b, c in zip(final, seq_final, ref_final):
            np.testing.assert_allclose(a, b, atol=1e-12)
            np.testing.assert_allclose(a, c, atol=1e-12)
        for a, b, c in zip(outs, seq_outs, ref_outs):
            np.testing.assert_allclose(a, b[seg], atol=1e-12)
            np.testing.assert_allclose(a, c[seg], atol=1e-12)
        assert defect < 1e-12


def test_ring_defect_does_not_grow_with_sweeps(group, reference):
    for res in group:
        d = res["ring"]["defects"]
        assert d[0] > d[-1] and d[-1] < 1e-12
        assert all(d2 <= d1 + 1e-12 for d1, d2 in zip(d, d[1:]))
        np.testing.assert_allclose(d, reference[2], atol=1e-12)


def test_ring_warm_single_sweep_is_exact(group, sequential):
    _, seq_outs, _ = sequential
    for r, res in enumerate(group):
        outs, defect = res["ring"]["warm"]
        assert defect < 1e-12
        for a, b in zip(outs, seq_outs):
            np.testing.assert_allclose(a, b[r * L:(r + 1) * L], atol=1e-12)


def test_ring_gradient_matches_sequential_and_reference(group, sequential,
                                                        reference):
    g_seq, g_ref = sequential[2], reference[3]
    for r, res in enumerate(group):
        g = res["ring"]["grad"]
        seg = slice(r * L, (r + 1) * L)
        np.testing.assert_allclose(g[seg], g_seq[seg], atol=1e-10)
        np.testing.assert_allclose(g[seg], g_ref[seg], atol=1e-10)
        rest = np.delete(g, np.arange(r * L, (r + 1) * L), axis=0)
        assert not np.any(rest)


def test_ring_rejects_bad_horizon_and_sweeps(group):
    for res in group:
        assert res["ring"]["bad_horizon"] and res["ring"]["bad_sweeps"]


def test_shard_batch_all_reduce_and_meshes(group):
    coords = set()
    for r, res in enumerate(group):
        m = res["mesh"]
        np.testing.assert_array_equal(
            m["rows"], np.arange(32.0).reshape(32, 1)[8 * r:8 * (r + 1)])
        assert m["indivisible"]
        assert m["psum"] == float(np.sum(np.arange(64.0)))
        shape, names, coord, share = m["mesh2d"]
        assert shape == (2, 2) and names == ("host", "rollout")
        assert coord == (r // 2, r % 2) and share == (r, 4)
        coords.add(coord)
        assert m["replicated"] == 10.0
        assert m["spec"] == (True, "rollout")
    assert len(coords) == 4


def test_one_rank_mesh_takes_the_same_code(sequential):
    x0, U = _inputs()
    torch.set_default_dtype(torch.float64)
    try:
        final, outs, defect, rows, size = ranks.one_rank(x0, U)
    finally:
        torch.set_default_dtype(torch.float32)
        dist.destroy_process_group()
    seq_final, seq_outs, _ = sequential
    assert size == 1 and defect == 0.0
    for a, b in zip(final + outs, seq_final + seq_outs):
        np.testing.assert_allclose(a, b, atol=1e-12)
    np.testing.assert_array_equal(rows, np.arange(8.0))


@pytest.mark.parametrize("tag", ["1d", "2d"])
def test_sharded_plan_matches_unsharded(group, tag):
    U1, cost1, fail1, costs1 = group[0]["plan"]["single"]
    assert fail1 == 0.0
    for res in group:
        U, cost, fail, costs = res["plan"][tag]
        np.testing.assert_array_equal(U, group[0]["plan"][tag][0])
        assert fail == 0.0 and res["plan"]["indivisible"]
        np.testing.assert_allclose(U, U1, atol=1e-4)
        np.testing.assert_allclose(cost, cost1, rtol=1e-3)
        np.testing.assert_allclose(costs, costs1, rtol=1e-3)
