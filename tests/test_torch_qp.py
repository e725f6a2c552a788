"""Parity of the PyTorch port's QP solvers with qppvm_tpu.

- ``qp.solve`` against the reference's ``qp.solve`` in two profiles: the
  cold default (3 rho updates, Newton-Schulz inverses, 2 polish rounds: what
  ``ForceAccPlugin.on_start`` runs) and the deployed real-time profile
  (single rho chunk, warm KKT inverse, no polish).
- ``level_qp.solve_level_reference`` (the plain version of the CUDA level
  kernel) against the TPU kernel ``pallas_qp.solve_batched`` run in Pallas
  interpret mode, at the cases and tolerances of tests/test_pallas_qp.py.
- ``linalg`` against the reference's Newton-Schulz inverse and Schur KKT
  solve.

Inputs are made with numpy from a seed and fed to both sides in float32
(the suite enables JAX x64, so the JAX side pins float32 explicitly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu.opt import linalg as jlinalg
from qppvm_tpu.opt import pallas_qp as jpallas
from qppvm_tpu.opt import qp as jqp
from qppvm_tpu_torch.opt import level_qp, linalg, qp

torch.set_num_threads(1)


def _problems(seed, B, n, m, h, t):
    """WBC-shaped problems as tests/test_pallas_qp.py makes them: PSD
    objective, head/tail equality rows, box-bounded affine rows."""
    rng = np.random.default_rng(seed)
    T = rng.normal(size=(B, n + 4, n)) / np.sqrt(n)
    P = np.einsum("bki,bkj->bij", T, T) + 1e-3 * np.eye(n)
    q = 0.3 * rng.normal(size=(B, n))
    A = rng.normal(size=(B, m, n)) / np.sqrt(n)
    b = 0.1 * rng.normal(size=(B, m))
    lo = b - 0.5 - rng.uniform(size=(B, m))
    hi = b + 0.5 + rng.uniform(size=(B, m))
    eq = np.zeros(m, bool)
    eq[:h] = True
    if t:
        eq[m - t:] = True
    return {k: v.astype(np.float32) for k, v in dict(
        P=P, q=q, A=A, l=np.where(eq, b, lo), u=np.where(eq, b, hi)).items()}


def _opts(h, t, cold_ns=None):
    """tests/test_pallas_qp.py::_opts: the deployed RT profile."""
    return dict(iters=12, refine=2, rho_updates=0, polish_rounds=0,
                assume_warm_kinv=True, warm_kinv_iters=4,
                cold_ns_iters=cold_ns, scale_iters=2, pinv_ns_iters=5,
                rho_adapt_tol=1e-3, rho_scale_min=0.1, n_eq_head=h,
                n_eq_tail=t)


def _jax_solve(probs, states, opts):
    prob = jqp.QPProblem(**{k: jnp.asarray(v) for k, v in probs.items()})
    st = jqp.QPState(**{k: jnp.asarray(v) for k, v in states.items()})
    out = jax.jit(jax.vmap(lambda p, s: jqp.solve(p, s, **opts)))(prob, st)
    return jax.tree.map(np.asarray, out)


def _torch_solve(probs, states, opts):
    prob = qp.QPProblem(**{k: torch.tensor(v) for k, v in probs.items()})
    st = qp.QPState(**{k: torch.tensor(v) for k, v in states.items()})
    return qp.solve(prob, st, **opts)


def _zero_states(B, n, m):
    return dict(x=np.zeros((B, n), np.float32), z=np.zeros((B, m), np.float32),
                y=np.zeros((B, m), np.float32),
                Kinv=np.zeros((B, n, n), np.float32),
                rho_scale=np.ones((B,), np.float32))


def _state_arrays(st):
    return {k: np.asarray(getattr(st, k), np.float32)
            for k in ("x", "z", "y", "Kinv", "rho_scale")}


def _assert_pallas_tolerances(x, z, y, K, r, prim, obj, ref):
    """The bars of tests/test_pallas_qp.py:72-88."""
    x_ref, st_ref, info_ref = ref
    sc = float(np.max(np.abs(x_ref))) + 1.0
    np.testing.assert_allclose(x, x_ref, atol=2e-4 * sc, rtol=2e-4)
    np.testing.assert_allclose(z, st_ref.z, atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(y, st_ref.y, atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(K, st_ref.Kinv, atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(r, st_ref.rho_scale, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(prim, info_ref.prim_res, atol=1e-5, rtol=2e-2)
    np.testing.assert_allclose(obj, info_ref.obj, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("h,t", [(3, 2), (0, 0)])
def test_qp_solve_deployed_profile_matches_reference(h, t):
    """Two chained RT-profile solves (cold, then warm from the first)."""
    B, n, m = 8, 20, 10
    probs = _problems(0, B, n, m, h, t)
    opts = _opts(h, t, cold_ns=10)
    states = _zero_states(B, n, m)
    jx, jst, jinfo = _jax_solve(probs, states, opts)
    tx, tst, tinfo = _torch_solve(probs, states, opts)
    _assert_pallas_tolerances(tx.numpy(), tst.z.numpy(), tst.y.numpy(),
                              tst.Kinv.numpy(), tst.rho_scale.numpy(),
                              tinfo.prim_res.numpy(), tinfo.obj.numpy(),
                              (jx, jst, jinfo))
    ref2 = _jax_solve(probs, _state_arrays(jst), opts)
    tx2, tst2, tinfo2 = _torch_solve(probs, _state_arrays(tst), opts)
    _assert_pallas_tolerances(tx2.numpy(), tst2.z.numpy(), tst2.y.numpy(),
                              tst2.Kinv.numpy(), tst2.rho_scale.numpy(),
                              tinfo2.prim_res.numpy(), tinfo2.obj.numpy(),
                              ref2)


def test_qp_solve_cold_polished_profile_matches_reference(monkeypatch):
    """The cold default profile (3 rho updates, 2 polish rounds), cut to 20
    ADMM iterations so that the first polish is accepted on one item and
    rejected on the other.

    The acceptance guard (feasible, and dual_new <= dual_old + 1e-12) can
    sit on a knife edge that summation order flips (it does in the
    humanoid's on_start, see test_torch_force_acc), so the seed is one
    whose decisions are the same in float32 and float64, and the test
    records the branch each item took on both sides: they agree, and the
    float32 solutions agree to the kernel bars. The carried rho_scale is a
    product of sqrt(prim / dual) ratios at rho_adapt_tol 0, which float32
    roundoff moves by up to 15% on either side, so it is held in float64,
    where both sides agree to 1e-6 with everything else."""
    B, n, m, h, t = 2, 20, 10, 3, 2
    probs = _problems(4, B, n, m, h, t)
    opts = dict(n_eq_head=h, n_eq_tail=t, iters=20)
    j_log, t_log = [], []
    orig_j, orig_t = jqp._polish, qp._polish

    def j_record(P, q, A, l, u, x, y, **kw):
        x_new, y_new = orig_j(P, q, A, l, u, x, y, **kw)
        jax.debug.callback(lambda a: j_log.append(bool(a)),
                           jnp.any(x_new != x), ordered=True)
        return x_new, y_new

    def t_record(P, q, A, l, u, x, y, **kw):
        x_new, y_new = orig_t(P, q, A, l, u, x, y, **kw)
        t_log.append((x_new != x).any(-1).numpy())
        return x_new, y_new

    def jax_solve(dtype):
        fn = jax.jit(lambda p: jqp.solve(p, None, **opts))
        outs = [fn(jqp.QPProblem(**{k: jnp.asarray(v[i], dtype)
                                    for k, v in probs.items()}))
                for i in range(B)]
        jax.effects_barrier()
        return jax.tree.map(lambda *a: np.stack([np.asarray(v) for v in a]),
                            *outs)

    monkeypatch.setattr(jqp, "_polish", j_record)
    monkeypatch.setattr(qp, "_polish", t_record)
    jx, jst, jinfo = jax_solve(jnp.float32)
    tx, tst, tinfo = _torch_solve(probs, _zero_states(B, n, m), opts)
    # JAX logs one entry per (item, round); the port one (B,) per round
    j_branch = np.asarray(j_log).reshape(B, -1).T
    t_branch = np.stack(t_log)
    np.testing.assert_array_equal(t_branch, j_branch)
    assert t_branch.any() and not t_branch.all(), "both branches are tested"
    sc = float(np.max(np.abs(jx))) + 1.0
    np.testing.assert_allclose(tx.numpy(), jx, atol=2e-4 * sc, rtol=2e-4)
    for ours, ref in ((tst.z, jst.z), (tst.y, jst.y)):
        np.testing.assert_allclose(ours.numpy(), ref, atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(tinfo.obj.numpy(), jinfo.obj, atol=1e-4,
                               rtol=1e-3)

    monkeypatch.setattr(jqp, "_polish", orig_j)
    monkeypatch.setattr(qp, "_polish", orig_t)
    jx, jst, jinfo = jax_solve(jnp.float64)
    prob = qp.QPProblem(**{k: torch.tensor(v, dtype=torch.float64)
                           for k, v in probs.items()})
    tx, tst, tinfo = qp.solve(prob, None, **opts)
    for ours, ref in ((tx, jx), (tst.z, jst.z), (tst.y, jst.y),
                      (tst.rho_scale, jst.rho_scale), (tinfo.obj, jinfo.obj)):
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6,
                                   atol=1e-9 * (np.max(np.abs(ref)) + 1.0))


@pytest.mark.parametrize("h,t,cold_ns", [(3, 2, None), (3, 2, 10), (0, 0, None)])
def test_level_reference_matches_pallas_kernel(h, t, cold_ns):
    """The level kernel's plain version against the TPU kernel (interpret
    mode), from the warm state a first reference solve leaves."""
    B, n, m = 8, 20, 10
    probs = _problems(0, B, n, m, h, t)
    opts = _opts(h, t, cold_ns=cold_ns)
    _, warm, _ = _jax_solve(probs, _zero_states(B, n, m), opts)
    warm = _state_arrays(warm)
    jcfg = jpallas.config_from_opts(opts, n_eq_head=h, n_eq_tail=t, iters=12,
                                    interpret=True)
    ref = jpallas.solve_batched(
        jcfg, *(jnp.asarray(probs[k]) for k in "PqAlu"),
        *(jnp.asarray(warm[k]) for k in ("x", "z", "y", "Kinv", "rho_scale")))
    x_k, z_k, y_k, K_k, r_k, prim_k, _, obj_k = map(np.asarray, ref)
    cfg = level_qp.config_from_opts(opts, n_eq_head=h, n_eq_tail=t, iters=12)
    out = level_qp.solve_level_reference(
        cfg, *(torch.tensor(probs[k]) for k in "PqAlu"),
        *(torch.tensor(warm[k]) for k in ("x", "z", "y", "Kinv", "rho_scale")))
    x, z, y, K, r, prim, _, obj = (o.numpy() for o in out)
    ref_tuple = (x_k, jqp.QPState(x=x_k, z=z_k, y=y_k, Kinv=K_k, rho_scale=r_k),
                 jqp.QPInfo(prim_res=prim_k, dual_res=prim_k, obj=obj_k))
    _assert_pallas_tolerances(x, z, y, K, r, prim, obj, ref_tuple)


def test_level_solver_warm_chain_converges():
    """tests/test_pallas_qp.py's scan chain: five warm-started level solves
    carrying the state (incl. the KKT inverse); after the cold first tick
    the residuals stay tiny."""
    from test_pallas_qp import _make_problems   # the reference test's inputs
    B, n, m, h, t = 4, 16, 8, 2, 0
    jprob = _make_problems(jax.random.PRNGKey(5), B, n, m, h, t)
    probs = {k: torch.tensor(np.asarray(getattr(jprob, k))) for k in "PqAlu"}
    cfg = level_qp.config_from_opts(_opts(h, t), n_eq_head=h, n_eq_tail=t,
                                    iters=12)
    st = tuple(torch.tensor(v) for v in _zero_states(B, n, m).values())
    prims = []
    for _ in range(5):
        x, z, y, K, r, prim, _, _ = level_qp.solve_level(
            cfg, *(probs[k] for k in "PqAlu"), *st)
        st = (x, z, y, K, r)
        prims.append(prim)
    prims = torch.stack(prims)
    assert torch.isfinite(prims).all()
    assert float(prims[-1].max()) < 1e-3


def test_linalg_matches_reference():
    rng = np.random.default_rng(2)
    B, n, m = 4, 12, 5
    T = rng.normal(size=(B, n + 3, n))
    K = (np.einsum("bki,bkj->bij", T, T) + 0.1 * np.eye(n)).astype(np.float32)
    A = rng.normal(size=(B, m, n)).astype(np.float32)
    rx = rng.normal(size=(B, n)).astype(np.float32)
    ry = rng.normal(size=(B, m)).astype(np.float32)
    delta = np.float32(1e-3)
    ref_inv, (ref_x, ref_y) = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda k, a, x, y: (jlinalg.spd_inverse_ns(k),
                            jlinalg.kkt_solve_schur(k, a, x, y, delta))))(
            *map(jnp.asarray, (K, A, rx, ry))))
    inv = linalg.spd_inverse_ns(torch.tensor(K)).numpy()
    x, y = linalg.kkt_solve_schur(*map(torch.tensor, (K, A, rx, ry)),
                                  float(delta))
    # relative to each result's scale: NS inverses of a cond ~1e3 matrix in
    # float32 carry ~1e-4 relative roundoff on both sides
    for ours, theirs in ((inv, ref_inv), (x.numpy(), ref_x), (y.numpy(), ref_y)):
        np.testing.assert_allclose(ours, theirs, rtol=1e-3,
                                   atol=1e-3 * np.max(np.abs(theirs)))
    np.testing.assert_allclose(
        linalg.spd_inverse_chol(torch.tensor(K, dtype=torch.float64)).numpy(),
        np.linalg.inv(K.astype(np.float64)), rtol=1e-8, atol=1e-10)
