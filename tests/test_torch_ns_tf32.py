"""The arithmetic of the NS-inverse kernel (csrc/ns_inverse.cu), modelled in
plain PyTorch on the CPU: every product error-compensated 3xTF32, as the
kernel runs it on the tensor cores.

- ``tf32``: round to nearest, ties away from zero, to TF32's 10 mantissa
  bits on the int32 view (add 0x1000, mask 0xFFFFE000), as the kernel's
  ``cvt.rna.tf32.f32``; x = hi + lo with hi = tf32(x), lo = tf32(x - hi);
- ``mm3``: A B ~ (A_lo B_hi + A_hi B_lo) + A_hi B_hi, each TF32 product
  exact in float32 and the sums float32, the small terms first;
- the Newton-Schulz inverse with those products, held to the kernel's
  bars (atol 2e-4 + rtol 2e-3, max |K X - I| < 5e-3) against its plain
  version ``ns_inverse_reference`` and against the JAX package's
  ``linalg.spd_inverse_ns(K, iters, refine=0)``, on SPD batches of
  condition 300 (as tests/test_pallas_linalg.py makes them) and on the
  humanoid's regularized mass matrix (n 38, 24 iterations, the plant's);
- a planted fault: the same inverse with plain TF32 products, which the
  bars must catch.

The products' sums run in another order than the tensor cores', so this
holds the precision of the split, not the kernel's bits; the kernel itself
is held to its plain version on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qppvm_tpu.opt import linalg as jlinalg
from qppvm_tpu_torch.model import dynamics, zoo
from qppvm_tpu_torch.mpc.rollout import standing_state
from qppvm_tpu_torch.opt import ns_inverse

torch.set_num_threads(1)
CONTACTS = ("l_sole", "r_sole")


def tf32(x):
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(A, B):
    (ah, al), (bh, bl) = split(A), split(B)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(A, B):
    """The planted fault: one plain TF32 product."""
    return tf32(A) @ tf32(B)


def ns_model(K, iters, mm):
    """``ns_inverse_reference`` with every product taken by ``mm``."""
    I = torch.eye(K.shape[-1])
    d = torch.rsqrt(torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1),
                                min=1e-30))
    Ks = d[..., :, None] * K * d[..., None, :]
    norm1 = torch.amax(torch.sum(torch.abs(Ks), dim=-2), dim=-1)
    X = I * (1.0 / torch.clamp(norm1, min=1e-30))[..., None, None]
    for _ in range(iters):
        X = mm(X, 2.0 * I - mm(Ks, X))
    return d[..., :, None] * X * d[..., None, :]


def _spd_batch(seed, B, n, cond=300.0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        out.append((Q * np.logspace(0, np.log10(cond), n)) @ Q.T)
    return torch.tensor(np.stack(out).astype(np.float32))


def _humanoid_breg():
    """The plant's regularized mass matrix at two perturbed standing
    states."""
    model = zoo.humanoid(device="cpu")
    st = standing_state(model, CONTACTS, batch=2)
    q = torch.tensor(np.random.default_rng(4).normal(size=st.q.shape),
                     dtype=torch.float32)
    st = type(st)(q=st.q + 0.05 * q, **{f: getattr(st, f) for f in
                                        ("qd", "base_rot", "base_pos",
                                         "base_vel")})
    Bm = dynamics.mass_matrix(model, st)
    return Bm + 1e-9 * torch.eye(model.nv)


def _meets_bars(K, X, ref):
    close = bool(torch.all((X - ref).abs() <= 2e-4 + 2e-3 * ref.abs()))
    n = K.shape[-1]
    resid = np.abs(K.double().numpy() @ X.double().numpy()
                   - np.eye(n)).max()
    return close and resid < 5e-3


@pytest.mark.parametrize("scale", [1e-30, 1.0, 1e30])
def test_tf32_split_keeps_10_bits_and_hi_plus_lo_is_x(scale):
    x = torch.tensor(np.random.default_rng(0).normal(size=4096) * scale,
                     dtype=torch.float32)
    x[:3] = torch.tensor([0.0, -0.0, scale], dtype=torch.float32)
    hi, lo = split(x)
    for part in (hi, lo):
        assert bool(torch.all((part.view(torch.int32) & 0x1FFF) == 0))
    xd = x.double()
    assert bool(torch.all((hi.double() - xd).abs() <= 2.0 ** -11 * xd.abs()))
    assert bool(torch.all((hi.double() + lo.double() - xd).abs()
                          <= 2.0 ** -21 * xd.abs()))


def test_tf32_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0, -1.0], dtype=torch.float32)
    ulp = 2.0 ** -10
    tie = one * (1.0 + ulp / 2)       # halfway: away from zero
    below = one * (1.0 + ulp / 2 - 2.0 ** -23)
    assert tf32(tie).tolist() == [1.0 + ulp, -1.0 - ulp]
    assert tf32(below).tolist() == [1.0, -1.0]


@pytest.mark.parametrize("n,iters", [(16, 24), (44, 24), (64, 26)])
def test_3xtf32_ns_meets_the_kernels_bars(n, iters):
    K = _spd_batch(seed=n, B=3, n=n)
    X = ns_model(K, iters, mm3)
    ref = ns_inverse.ns_inverse_reference(K, iters)
    jref = torch.tensor(np.asarray(jlinalg.spd_inverse_ns(
        jnp.asarray(K.numpy()), iters=iters, refine=0)))
    assert _meets_bars(K, X, ref) and _meets_bars(K, X, jref)


def test_3xtf32_ns_meets_the_kernels_bars_on_the_plant_mass_matrix():
    K = _humanoid_breg()
    assert K.shape[-1] == 38
    X = ns_model(K, 24, mm3)
    ref = ns_inverse.ns_inverse_reference(K, 24)
    jref = torch.tensor(np.asarray(jlinalg.spd_inverse_ns(
        jnp.asarray(K.numpy()), iters=24, refine=0)))
    assert _meets_bars(K, X, ref) and _meets_bars(K, X, jref)


def test_plain_tf32_products_fail_the_bars():
    K = _spd_batch(seed=64, B=3, n=64)
    ref = ns_inverse.ns_inverse_reference(K, 26)
    assert _meets_bars(K, ns_model(K, 26, mm3), ref)
    assert not _meets_bars(K, ns_model(K, 26, mm_tf32), ref)
