"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no CUDA device is present. This file
imports no JAX, so it also runs where only PyTorch and the CUDA toolkit are
installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Level kernel: WBC-shaped random problems at the two level shapes of the
humanoid tick (n 44; m 12 with 6 head equalities; m 18 with 6 head and 6
tail) and without equalities, in the RT tick's profile and in the MPC
rollout's (no z clip, no cold NS budget, 8 warm NS iterations, rho carried
across solves); the bars are those of tests/test_pallas_qp.py:72-88
(kernel vs reference solver), except for rho_scale
(``level_qp_parity.check_rho_scale`` says why and how).

NS-inverse kernel: SPD batches K = M M^T + 0.5 I at n 16 / 44 / 64, B = 1
included, to the bars of tests/test_pallas_linalg.py: atol 2e-4 + rtol
2e-3 against the plain version, max |K X - I| < 5e-3.
"""
import pytest
import torch

from qppvm_tpu_torch.opt import level_qp, ns_inverse
from qppvm_tpu_torch.opt import level_qp_parity as parity

pytestmark = pytest.mark.cuda
SHAPES = [(44, 12, 6, 0), (44, 18, 6, 6), (44, 12, 0, 0)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,m,h,t", SHAPES)
def test_kernel_matches_plain_version_cold_then_warm(device, n, m, h, t):
    B = 256
    cfg = level_qp.LevelQPConfig(n_eq_head=h, n_eq_tail=t, cold_ns_iters=10)
    prob = parity.random_problems(B, n, m, h, t, device, seed=0)
    state = parity.zero_state(B, n, m, device)
    for _ in range(2):   # cold from zero, then warm from the kernel's state
        before = level_qp.launches
        out = level_qp.solve_level(cfg, *prob, *state)
        torch.cuda.synchronize()
        assert level_qp.launches == before + 1
        parity.check_level_outputs(cfg, prob, state, out)
        state = out[:5]


@pytest.mark.parametrize("n,m,h,t", SHAPES[:2])
def test_kernel_matches_plain_version_at_the_rollout_profile(device, n, m, h,
                                                             t):
    """Cold, then two warm solves that carry rho_scale at rho_adapt_tol
    1e-3, as the MPC rollout's horizon does."""
    B = 256
    cfg = level_qp.LevelQPConfig(n_eq_head=h, n_eq_tail=t, warm_kinv_iters=8,
                                 cold_ns_iters=None, z_clip=False,
                                 scale_iters=2, pinv_ns_iters=5)
    prob = parity.random_problems(B, n, m, h, t, device, seed=1)
    state = parity.zero_state(B, n, m, device)
    for _ in range(3):
        out = level_qp.solve_level(cfg, *prob, *state)
        torch.cuda.synchronize()
        parity.check_level_outputs(cfg, prob, state, out)
        state = out[:5]


@pytest.mark.parametrize("n,iters", [(16, 24), (44, 24), (64, 26)])
@pytest.mark.parametrize("B", [1, 37])
def test_ns_inverse_matches_plain_version(device, n, iters, B):
    g = torch.Generator(device=device).manual_seed(n + B)
    M = torch.randn(B, n, n, generator=g, device=device)
    K = M @ M.transpose(1, 2) + 0.5 * torch.eye(n, device=device)
    before = ns_inverse.launches
    X = ns_inverse.ns_inverse(K, iters)
    torch.cuda.synchronize()
    assert ns_inverse.launches == before + 1
    ref = ns_inverse.ns_inverse_reference(K, iters)
    assert bool(torch.all((X - ref).abs() <= 2e-4 + 2e-3 * ref.abs()))
    eye = torch.eye(n, device=device)
    assert float((K @ X - eye).abs().max()) < 5e-3


def test_ns_inverse_rejects_bad_inputs(device):
    K = torch.eye(8, device=device).expand(3, 8, 8).contiguous()
    with pytest.raises(ValueError, match="float32"):
        ns_inverse.ns_inverse(K.double())
    with pytest.raises(ValueError, match="contiguous"):
        ns_inverse.ns_inverse(torch.eye(8, device=device).expand(3, 8, 8))
    with pytest.raises(ValueError, match="shape"):
        ns_inverse.ns_inverse(K[:, :, :4].contiguous())
    with pytest.raises(ValueError, match="shared memory"):
        ns_inverse.ns_inverse(torch.eye(160, device=device)[None].contiguous())


def test_kernel_rejects_bad_inputs(device):
    cfg = level_qp.LevelQPConfig()
    B, n, m = 4, 8, 5
    prob = parity.random_problems(B, n, m, 0, 0, device, seed=0)
    state = parity.zero_state(B, n, m, device)
    P_strided = prob[0].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        level_qp.solve_level(cfg, P_strided, *prob[1:], *state)
    with pytest.raises(ValueError, match="float32"):
        level_qp.solve_level(cfg, prob[0].double(), *prob[1:], *state)
    big = level_qp.LevelQPConfig()
    n_big = 200
    P = torch.eye(n_big, device=device).expand(1, n_big, n_big).contiguous()
    args = (P, torch.zeros(1, n_big, device=device),
            torch.zeros(1, 1, n_big, device=device),
            -torch.ones(1, 1, device=device), torch.ones(1, 1, device=device),
            *parity.zero_state(1, n_big, 1, device))
    with pytest.raises(ValueError, match="shared memory"):
        level_qp.solve_level(big, *args)
