"""Parity of the port's Newton-Schulz inverses with qppvm_tpu.

- ``opt/ns_inverse.py::ns_inverse`` (on CPU tensors: its plain version,
  the function of ``csrc/ns_inverse.cu``) against the TPU kernel
  ``pallas_linalg.ns_inverse_pallas`` run in Pallas interpret mode, at the
  shapes, tiles and bars of tests/test_pallas_linalg.py: atol 2e-4 + rtol
  2e-3 against the kernel (float32 products summed in another order over
  24-26 quadratically converging iterations) and max |K X - I| < 5e-3;
- ``linalg.ns_warm_inverse`` against the reference under ``jax.vmap`` (as
  the MPC rollout runs it), per item of a mixed batch: a warm guess that
  passes the contraction guard, one that fails it, one that is not finite,
  and an item whose matrix is not finite, which must not touch the others.

Inputs are made with numpy from a seed (SPD matrices with log-spaced
eigenvalues, condition 300, as tests/test_pallas_linalg.py makes them) and
fed to both sides in float32.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu.opt import linalg as jlinalg
from qppvm_tpu.opt.pallas_linalg import ns_inverse_pallas
from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.opt import linalg, ns_inverse

torch.set_num_threads(1)


def _spd_batch(seed, B, n, cond=300.0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        out.append((Q * np.logspace(0, np.log10(cond), n)) @ Q.T)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("B,n,iters,tile", [(6, 32, 26, 2), (5, 16, 24, 4)])
def test_ns_inverse_matches_pallas_kernel(B, n, iters, tile):
    """(5, 16) with tile 4: B is not a multiple of the TPU kernel's tile,
    whose padding the port does not need."""
    K = _spd_batch(seed=n, B=B, n=n)
    X_ref = np.asarray(ns_inverse_pallas(jnp.asarray(K), iters=iters,
                                         tile=tile, interpret=True))
    before = telemetry.counts()["ns_inverse.launch"]
    X = ns_inverse.ns_inverse(torch.tensor(K), iters=iters)
    # the CPU runs the plain version
    assert telemetry.counts()["ns_inverse.launch"] == before
    assert X.shape == (B, n, n) and X.dtype == torch.float32
    np.testing.assert_allclose(X.numpy(), X_ref, atol=2e-4, rtol=2e-3)
    res = np.abs(K.astype(np.float64) @ X.numpy() - np.eye(n)).max()
    assert res < 5e-3


def test_ns_inverse_is_spd_inverse_ns_without_refinement():
    K = torch.tensor(_spd_batch(seed=3, B=3, n=12))
    np.testing.assert_array_equal(
        ns_inverse.ns_inverse(K, iters=20).numpy(),
        linalg.spd_inverse_ns(K, iters=20, refine=0).numpy())


def test_ns_inverse_raises_off_cpu_and_cuda():
    with pytest.raises(ValueError, match="device"):
        ns_inverse.ns_inverse(torch.empty(2, 4, 4, device="meta"))


def test_ns_warm_inverse_matches_reference_per_item():
    n = 12
    K = _spd_batch(seed=5, B=4, n=n)
    rng = np.random.default_rng(6)
    inv = np.linalg.inv(K.astype(np.float64))
    guess = np.stack([
        np.linalg.inv(K[0] + 0.05 * np.eye(n)),           # passes the guard
        rng.normal(size=(n, n)),                          # fails it
        np.full((n, n), np.inf),                          # not finite
        inv[3],
    ]).astype(np.float32)
    K[3, 0, 1] = np.nan                                   # no inverse exists
    ref = np.asarray(jax.vmap(partial(jlinalg.ns_warm_inverse, iters=4))(
        jnp.asarray(K), jnp.asarray(guess)))
    X = linalg.ns_warm_inverse(torch.tensor(K), torch.tensor(guess),
                               iters=4).numpy()
    assert np.isfinite(X[:3]).all() and not np.isfinite(X[3]).all()
    np.testing.assert_allclose(X, ref, atol=2e-5, rtol=1e-3)
    # the warm item converged from its guess; the two cold items ran the
    # same 4-iteration budget from the Jacobi-prescaled start
    err = lambda i: np.abs(K[i] @ X[i] - np.eye(n)).max()  # noqa: E731
    assert err(0) < 1e-3 < min(err(1), err(2))
