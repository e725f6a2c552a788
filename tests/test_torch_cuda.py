"""The CUDA level-QP kernel against its plain PyTorch version, on the card.

Marked ``cuda``: each test skips when no CUDA device is present. This file
imports no JAX, so it also runs where only PyTorch and the CUDA toolkit are
installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Inputs are WBC-shaped random problems at the two level shapes of the
humanoid tick (n 44; m 12 with 6 head equalities; m 18 with 6 head and 6
tail) and without equalities; the bars are those of
tests/test_pallas_qp.py:72-88 (kernel vs reference solver), except for
rho_scale (``level_qp_parity.check_rho_scale`` says why and how).
"""
import pytest
import torch

from qppvm_tpu_torch.opt import level_qp
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
