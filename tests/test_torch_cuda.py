"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no CUDA device is present. This file
imports no JAX, so it also runs where only PyTorch and the CUDA toolkit are
installed:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Level kernel: WBC-shaped random problems at the two level shapes of the
humanoid tick (n 44; m 12 with 6 head equalities; m 18 with 6 head and 6
tail) and without equalities, in the RT tick's profile and in the MPC
rollout's (no z clip, no cold NS budget, 8 warm NS iterations, rho carried
across solves); then the kernel's edges in the RT profile: n off the
16-wide tile (37) and on 4 x 4 tiles (61), B = 1 and 37, tail equalities
only, ne 12 and 13 (the one-warp and the block-wide Gram NS), more
inequality rows than variables and than one product tile covers (48 at
n 44), one inequality row, one launch where half
the items take the warm branch and half the cold one, a non-finite warm
Kinv, and an item whose cold NS diverges and takes the diagonal fallback.
The bars are those of tests/test_pallas_qp.py:72-88 (kernel vs reference
solver), except for rho_scale (``level_qp_parity.check_rho_scale`` says
why and how).

Level kernel at the ForceAccExample robots' shapes: the quadruped's
reference stack (n 34), the centaur's with friction cones (n 49, the
R = 4 instantiation) and an n 49 level with more inequality rows than one
R = 4 product covers, at B 1 and 37; the capture step's stack (the
humanoid with 6D wrenches in friction cones, n 50) at B 1 and 37.

Level kernel at the QPPVM stack's shapes (the dual arm's n 15 and the
arm's n 7: the torque box alone, and with the EE rows locked as tail
equalities) in QPPVMPlugin's profile with rho_updates 0, at B 1 and 37
(items that float32 does not determine, ``float32_undetermined``, held to
the plain version's own float32 error), and one dual-arm QPPVM tick
through both kernels against the plain tick.

NS-inverse kernel (3xTF32 on the tensor cores): SPD batches K = M M^T +
0.5 I at n 1 to 139 (inside one 16 x 8 mma tile, on and off the tile
edges, the QPPVM arms' 7 and 15 at 20 iterations, the quadruped's 22,
the centaur's 37, the humanoid's 38, the 64 of bench_pallas.py, the
unpadded layout above 128) and B 1 / 37, to the bars of
tests/test_pallas_linalg.py: atol
2e-4 + rtol 2e-3 against the plain version, max |K X - I| < 5e-3; a batch
with non-finite items, which stay non-finite where the plain version is
without touching the others.

The plant's mass-matrix inverse routing (float32 to the NS kernel, float64
to the plain NS, counted), one batched tick of the centaur with friction
cones, and one rollout of the quadruped with switchable cones, a swing
decision per sample and a gate_seq (K 37, H 2), level kernel against plain
level solver.

The deployment runtime on the card: the leg-odometry estimator against
the same updates on the CPU, one AsyncPlanner plan on its side stream
against a synchronous plan from the same seed, and ``run.main`` on
config 1.

The centroidal DDP planner: the NS kernel at its shapes (the SRBD
inertia, n 3 at 16 iterations; Q_uu at 22: the LQR problem's n 2, the
humanoid's n 6, the quadruped's n 12), the iLQR's Q_uu routing (float32
to the kernel, float64 to the plain NS, counted) on tests/test_ilqr.py's
LQR problem, and one plan of each robot on the card against the same plan
on the CPU.

The tick as one CUDA graph (runtime/tick_graph.py): 20 chained ticks of
the humanoid at B 1, of the centaur with friction cones at B 64 and of the
QPPVM dual arm at B 1, captured and replayed, equal the same chain run
eagerly, bitwise, with every tick's outputs kept to the end; a replay
counts the launches the eager tick counts; a new refs layout captures once
more; a setting changed between ticks (new gains, a gain changed in
place on the card or on the host, a task's weight, a cone's bound) reaches
the replayed chain as it reaches the eager one.
"""
import pytest
import torch

from qppvm_tpu_torch import telemetry
from qppvm_tpu_torch.model import model_sweep
from qppvm_tpu_torch.opt import level_qp, ns_inverse
from qppvm_tpu_torch.opt import level_qp_parity as parity

pytestmark = pytest.mark.cuda
SHAPES = [(44, 12, 6, 0), (44, 18, 6, 6), (44, 12, 0, 0)]
# (n, m, h, t, B, warm start): the humanoid's shapes, then the kernel's
# edges; "own" warm-starts from the kernel's cold output
LEVEL_CASES = [(*s, 256, "own") for s in SHAPES] + [
    (37, 12, 6, 0, 37, "own"),     # n not a multiple of the 16-wide tile
    (61, 14, 4, 3, 37, "own"),     # 4 x 4 register tiles
    (44, 12, 6, 0, 1, "own"),      # the real-time loop's B = 1
    (44, 18, 6, 6, 1, "own"),
    (44, 18, 0, 6, 37, "own"),     # tail equalities only
    (44, 30, 12, 0, 37, "own"),    # ne 12: the largest one-warp Gram NS
    (44, 30, 7, 6, 37, "own"),     # ne 13: the block-wide Gram NS
    (20, 25, 0, 0, 37, "own"),     # more inequality rows than variables
    (44, 60, 0, 0, 37, "own"),     # more inequality rows than one product
    (44, 66, 6, 6, 37, "own"),     # tile covers (48 at n 44)
    (44, 7, 6, 0, 37, "own"),      # one inequality row
    (44, 12, 6, 0, 37, "half"),    # warm Kinv good on even items only
    (44, 18, 6, 6, 37, "nonfinite"),   # NaN / inf in the warm Kinv
    (44, 12, 6, 0, 37, "indefinite"),  # item 0's NS ends non-finite
] + [(*s, Bs, "own") for s in [
    (34, 18, 6, 0), (34, 24, 6, 6),    # the quadruped's reference stack
    (49, 26, 6, 0), (49, 32, 6, 6),    # the centaur's with friction cones
    (49, 80, 6, 6),                    # more rows than one R 4 product (64)
    (50, 22, 6, 0), (50, 28, 6, 6),    # the capture step's 6D cone stack
] for Bs in (1, 37)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _warm_state(out, warm):
    """The second solve's warm state from the first solve's outputs."""
    x, z, y, K, r = out[:5]
    K = K.clone()
    if warm == "half":    # odd items: a Kinv the contraction guard rejects
        g = torch.Generator(device=K.device).manual_seed(5)
        K[1::2] = 3.0 * torch.randn(K[1::2].shape, generator=g,
                                    device=K.device)
    elif warm == "nonfinite":   # the guard's error is not finite: cold start
        K[0, 0, 0] = float("nan")
        K[-1, 2, 3] = float("inf")
    return x, z, y, K, r


@pytest.mark.parametrize("n,m,h,t,B,warm", LEVEL_CASES)
def test_kernel_matches_plain_version_cold_then_warm(device, n, m, h, t, B,
                                                    warm):
    cfg = level_qp.LevelQPConfig(
        n_eq_head=h, n_eq_tail=t,
        cold_ns_iters=40 if warm == "indefinite" else 10)
    prob = parity.random_problems(B, n, m, h, t, device, seed=0)
    if warm == "indefinite":
        # P - 3 I is indefinite: the cold NS of item 0 diverges, and the
        # solve must fall back to the diagonal cold start, as qp.py does
        P = prob[0].clone()
        P[0] -= 3.0 * torch.eye(n, device=device)
        prob = (P, *prob[1:])
    state = parity.zero_state(B, n, m, device)
    for k in range(2):   # cold from zero, then warm
        before = telemetry.counts()["level_qp.launch"]
        out = level_qp.solve_level(cfg, *prob, *state)
        torch.cuda.synchronize()
        assert telemetry.counts()["level_qp.launch"] == before + 1
        parity.check_level_outputs(cfg, prob, state, out)
        if warm == "indefinite":
            K0 = out[3][0]
            assert torch.equal(K0, torch.diag_embed(torch.diagonal(K0)))
        state = _warm_state(out, warm)


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


# the QPPVM stack's levels on the dual arm (n 15) and the arm (n 7): the
# torque box alone, then the box with 6 locked EE rows as tail equalities,
# in QPPVMPlugin's profile with rho_updates 0
QPPVM_SHAPES = [(15, 15, 0, 0), (15, 21, 0, 6), (7, 7, 0, 0), (7, 13, 0, 6)]
QPPVM_LEVEL = dict(iters=60, warm_kinv_iters=12, scale_iters=5,
                   pinv_ns_iters=7)


@pytest.mark.parametrize("n,m,h,t", QPPVM_SHAPES)
@pytest.mark.parametrize("B", [1, 37])
def test_kernel_matches_plain_version_at_the_qppvm_shapes(device, n, m, h, t,
                                                          B):
    cfg = level_qp.LevelQPConfig(n_eq_head=h, n_eq_tail=t, **QPPVM_LEVEL)
    prob = parity.random_problems(B, n, m, h, t, device, seed=2, locks=True)
    state = parity.zero_state(B, n, m, device)
    for _ in range(2):   # cold from zero, then warm
        out = level_qp.solve_level(cfg, *prob, *state)
        torch.cuda.synchronize()
        parity.check_level_outputs(cfg, prob, state, out, True)
        state = out[:5]


def test_qppvm_tick_kernel_matches_plain(device):
    """One dual-arm QPPVM tick in the level kernel's profile (rho_updates
    0): 2 level launches, no fallback, 1 NS launch (the mass matrix's
    inverse), tau within chip_smoke.py's chain bars of the same tick
    through the plain level solver and the plain NS inverse."""
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.plugins.qppvm import QPPVMPlugin

    model = zoo.dual_arm(device=device)
    plugin = QPPVMPlugin(model, iters=60, solver_opts=dict(rho_updates=0))
    st = model.home_state()
    refs, warm, start = plugin.on_start(st)
    refs = dict(refs, LEFT_ARM=plugin.make_refs(start, 0.5))
    telemetry.reset("level_qp.launch", "ns_inverse.launch", "cascade.fallback")
    tau, _, aux = plugin.control_loop(st, refs, warm)
    torch.cuda.synchronize()
    counted = telemetry.counts()
    assert (counted["level_qp.launch"], counted["cascade.fallback"]) == (2, 0)
    assert telemetry.counts()["ns_inverse.launch"] == 1
    with pytest.MonkeyPatch.context() as mp:   # both kernels' plain versions
        _plain_levels(mp)
        mp.setattr(ns_inverse, "spd_inverse",
                   lambda K, iters=24: ns_inverse.ns_inverse_reference(
                       K, iters))
        tau_ref, _, aux_ref = plugin.control_loop(st, refs, warm)
    assert not aux.solver_failed.any() and not aux_ref.solver_failed.any()
    assert bool(((tau - tau_ref).abs() <= 5e-3 + 1e-3 * tau_ref.abs()).all())
    assert float((tau - aux.h).abs().max()) > 1e-2   # the task acts


def _plain_levels(mp):
    """Every level the kernel takes runs its plain version instead."""
    mp.setattr(level_qp, "_launch", level_qp.solve_level_reference)


@pytest.mark.parametrize("case", ["float64", "too_large"])
def test_level_outside_the_kernel_runs_qp_solve_counted(device, case):
    """A level in the kernel's profile that the kernel cannot hold on the
    card (float64; a working set beyond a block's shared memory) runs
    qp.solve and counts one ``cascade.fallback``, no launch."""
    from qppvm_tpu_torch.opt import qp

    n, m, dtype = (44, 12, torch.float64) if case == "float64" else (
        120, 4, torch.float32)
    opts = dict(iters=12, rho_updates=0, polish_rounds=0,
                assume_warm_kinv=True, warm_kinv_iters=4, scale_iters=2,
                pinv_ns_iters=5)
    assert level_qp.config_from_opts(opts, n_eq_head=0, n_eq_tail=0,
                                     iters=12) is not None
    prob = qp.QPProblem(*(a.to(dtype) for a in parity.random_problems(
        3, n, m, 0, 0, device, seed=1)))
    st = qp.QPState(*(a.to(dtype) for a in parity.zero_state(3, n, m,
                                                             device)))
    telemetry.reset("level_qp.launch", "cascade.fallback")
    x, _, info = level_qp.solve(prob, st, **opts)
    torch.cuda.synchronize()
    counted = telemetry.counts()
    assert (counted["level_qp.launch"], counted["cascade.fallback"]) == (0, 1)
    assert x.dtype == dtype
    assert torch.equal(x, qp.solve(prob, st, **opts)[0])


def _ns_batch(device, B, n, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    M = torch.randn(B, n, n, generator=g, device=device)
    return M @ M.transpose(1, 2) + 0.5 * torch.eye(n, device=device)


def _ns_passes(K, X, ref):
    """Per item: within the kernel's bars of the plain version."""
    n = K.shape[-1]
    close = ((X - ref).abs() <= 2e-4 + 2e-3 * ref.abs()).flatten(1).all(1)
    resid = (K @ X - torch.eye(n, device=K.device)).abs().flatten(1)
    return close & (resid.amax(1) < 5e-3)


@pytest.mark.parametrize("n,iters", [(1, 26), (2, 22), (3, 16), (6, 22),
                                     (7, 20), (7, 26), (8, 26), (12, 22),
                                     (15, 20), (15, 24), (16, 24),
                                     (22, 24), (37, 24),
                                     (38, 24), (40, 26), (44, 24), (63, 26),
                                     (64, 26), (65, 26), (100, 26),
                                     (139, 26)])
@pytest.mark.parametrize("B", [1, 37])
def test_ns_inverse_matches_plain_version(device, n, iters, B):
    K = _ns_batch(device, B, n, seed=n + B)
    before = telemetry.counts()["ns_inverse.launch"]
    X = ns_inverse.ns_inverse(K, iters)
    torch.cuda.synchronize()
    assert telemetry.counts()["ns_inverse.launch"] == before + 1
    ref = ns_inverse.ns_inverse_reference(K, iters)
    assert bool(_ns_passes(K, X, ref).all())


@pytest.mark.parametrize("n", [38, 64])
def test_ns_inverse_keeps_non_finite_items_apart(device, n):
    """Item 0 has a NaN off the diagonal, item 2 an inf on it: each is
    non-finite wherever the plain version is, and the others pass."""
    K = _ns_batch(device, 5, n, seed=3)
    K[0, 0, 1] = float("nan")
    K[2, 1, 1] = float("inf")
    X = ns_inverse.ns_inverse(K, 26)
    torch.cuda.synchronize()
    ref = ns_inverse.ns_inverse_reference(K, 26)
    for i in (0, 2):
        bad = ~torch.isfinite(ref[i])
        assert bool(bad.any()) and bool((~torch.isfinite(X[i]))[bad].all())
    assert _ns_passes(K, X, ref)[[1, 3, 4]].all()


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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plant_mass_matrix_inverse_routing(device, dtype):
    """One SimRobot step of the quadruped: float32 mass matrices go to the
    NS kernel (one launch a substep), float64 ones to the plain NS, counted
    in ``model.plain_inverse`` (``telemetry``); both match the plain plant
    step."""
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.runtime import robot_interface as ri

    feet = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")
    model = zoo.quadruped(dtype=dtype, device=device)
    robots = [ri.SimRobot(model, state=ri.standing_state(model, feet),
                          substeps=4, contact_links=feet, dtype=dtype)
              for _ in range(2)]
    telemetry.reset("ns_inverse.launch")
    telemetry.reset("model.plain_inverse")
    robots[0].move()
    torch.cuda.synchronize()
    kernel = dtype == torch.float32
    assert telemetry.counts()["ns_inverse.launch"] == (4 if kernel else 0)
    assert telemetry.counts()["model.plain_inverse"] == (0 if kernel else 4)
    with pytest.MonkeyPatch.context() as mp:   # the plain plant
        mp.setattr(ns_inverse, "spd_inverse",
                   lambda K, iters=24: ns_inverse.ns_inverse_reference(K, 24))
        robots[1].move()
    for a, r in zip((robots[0].state.q, robots[0].state.base_pos),
                    (robots[1].state.q, robots[1].state.base_pos)):
        torch.testing.assert_close(a, r, atol=1e-5, rtol=1e-5)


def test_centaur_tick_kernel_matches_plain(device):
    """One batched tick (B 37) of the centaur with friction cones through
    the level kernel against the same tick through the plain level solver:
    the same tau (the bars of chip_smoke.py's chained ticks), wrenches in
    their cones, 2 launches and no fallback."""
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.mpc.rollout import standing_state
    from qppvm_tpu_torch.opt import qp
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin

    Bt = 37
    profile = dict(rho_updates=0, warm_kinv_iters=4, cold_ns_iters=10,
                   scale_iters=2, pinv_ns_iters=5)
    model = zoo.centaur(device=device)
    plugin = ForceAccPlugin(model, iters=12, use_friction_cones=True,
                            solver_opts=profile)
    st = standing_state(model, plugin.contact_links)
    refs, warm, _ = plugin.on_start(st)
    ex = lambda a: a.expand(Bt, *a.shape[1:]).contiguous()  # noqa: E731
    refs = {k: {kk: ex(v) for kk, v in r.items()} for k, r in refs.items()}
    warm = tuple(qp.QPState(**{f: ex(getattr(w, f)) for f in
                               ("x", "z", "y", "Kinv", "rho_scale")})
                 for w in warm)
    g = torch.Generator(device=device).manual_seed(0)
    states = type(st)(q=ex(st.q) + 0.01 * torch.randn(
        Bt, model.nj, generator=g, device=device),
        **{f: ex(getattr(st, f))
           for f in ("qd", "base_rot", "base_pos", "base_vel")})
    telemetry.reset("level_qp.launch")
    telemetry.reset("cascade.fallback")
    tau, _, aux = plugin._step_impl(states, refs, warm)
    torch.cuda.synchronize()
    counted = telemetry.counts()
    assert (counted["level_qp.launch"], counted["cascade.fallback"]) == (2, 0)
    with pytest.MonkeyPatch.context() as mp:
        _plain_levels(mp)
        tau_ref, _, aux_ref = plugin._step_impl(states, refs, warm)
    assert not aux.solver_failed.any() and not aux_ref.solver_failed.any()
    assert bool(((tau - tau_ref).abs() <= 5e-3 + 1e-3 * tau_ref.abs()).all())
    f = aux.wrenches
    assert bool((f[..., :2].abs() <= 0.7 / 2 ** 0.5 * f[..., 2:]
                 + 1e-3).all())
    assert bool((f[..., 2] >= 10.0 - 1e-3).all())


def test_swing_gate_rollout_kernel_matches_plain(device):
    """One rollout of the quadruped with switchable friction cones (K 37,
    H 2): a swing decision per sample, foot_fl gated off over the horizon
    in every other sample, through the level kernel against the same
    rollout through the plain level solver: each sample's cost within
    chip_smoke.py's MPC bars (1e-3 + 1e-3 relative), the same failure
    flags, 2 launches a step and no fallback."""
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.mpc import rollout
    from qppvm_tpu_torch.mpc.sampling import expand_batch
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin

    K, H = 37, 2
    feet = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")
    model = zoo.quadruped(device=device)
    plugin = ForceAccPlugin(model, contact_links=feet, iters=40,
                            switchable_contacts=True,
                            use_friction_cones=True, mu=0.5,
                            foot_tasks_6d=False)
    st = rollout.standing_state(model, feet)
    refs, warm, _ = plugin.on_start(st)
    g = torch.Generator(device=device).manual_seed(0)
    theta = {"swing": 3.0 * torch.randn(K, 4, generator=g, device=device),
             "t0": torch.randn(K, generator=g, device=device) - 2.0,
             "dxy": 0.1 * torch.randn(K, 2, generator=g, device=device)}
    gate_seq = torch.ones(K, H, 4, device=device)
    gate_seq[::2, :, 0] = torch.tensor([0.5, 0.0], device=device)
    scen = {"push": 20.0 * torch.randn(K, H, 3, generator=g, device=device),
            "gate_seq": gate_seq}
    U = 0.2 * torch.randn(K, H, 3, generator=g, device=device)
    out = []
    cfg = rollout.RolloutConfig(horizon=H, qp_iters=20, dt=0.04,
                                sim_substeps=2, mu=1.3)
    swing, _ = rollout.make_swing_primitive(plugin, span_s=H * cfg.dt)
    roll = rollout.make_rollout_fn(plugin, cfg, rollout.default_cost,
                                   swing=swing)
    for route in ("kernel", "plain"):
        telemetry.reset("level_qp.launch")
        telemetry.reset("cascade.fallback")
        with pytest.MonkeyPatch.context() as mp:
            if route == "plain":
                _plain_levels(mp)
            out.append(roll(*expand_batch(st, refs, warm, K), U, scen,
                            theta))
        torch.cuda.synchronize()
        counted = telemetry.counts()
        assert (counted["level_qp.launch"], counted["cascade.fallback"]) == (
            2 * H if route == "kernel" else 0, 0)
    (cost, health), (cost_ref, health_ref) = out
    assert bool(torch.isfinite(cost).all())
    assert torch.equal(health["solver_failed"], health_ref["solver_failed"])
    assert bool(((cost - cost_ref).abs()
                 <= 1e-3 + 1e-3 * cost_ref.abs()).all())


def test_estimator_update_on_card_matches_cpu(device):
    """The leg-odometry estimator's init and updates (a break, a make, no
    active contact) on the card against the same on the CPU: base
    position, anchors and base twist within 1e-5 + 1e-5 relative."""
    import dataclasses

    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.runtime.estimator import FloatingBaseEstimator
    from qppvm_tpu_torch.runtime.robot_interface import standing_state

    feet = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")
    gates = [[1, 1, 1, 1], [0, 1, 1, 1], [1, 1, 1, 1], [0, 0, 0, 0],
             [1, 0, 1, 1]]
    g = torch.Generator().manual_seed(3)
    runs = {}
    for dev in ("cpu", device):
        model = zoo.quadruped(device=dev)
        est = FloatingBaseEstimator(model, feet)
        st = standing_state(model, feet)
        es = est.init(st)
        g.manual_seed(3)
        outs = []
        for gate in gates:
            s = dataclasses.replace(
                st, q=st.q + 0.05 * torch.randn(st.q.shape, generator=g).to(dev),
                qd=torch.randn(st.qd.shape, generator=g).to(dev))
            out, es = est.update(es, s.q, s.qd, s.base_rot,
                                 torch.randn(1, 3, generator=g).to(dev),
                                 torch.tensor([gate], dtype=torch.float32))
            outs.append((out.base_pos, out.base_vel, es.anchors))
        runs[str(dev)] = outs
    for got, ref in zip(runs[str(device)], runs["cpu"]):
        for a, r in zip(got, ref):
            assert torch.allclose(a.cpu(), r, rtol=1e-5, atol=1e-5)


def test_async_plan_on_side_stream_matches_sync_plan(device):
    """One AsyncPlanner plan, launched on the worker's stream and flushed,
    against a synchronous plan from the same seed and inputs: the same
    plan U (float32 sums in the same order: within 1e-6 + 1e-5 rel)."""
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.mpc.rollout import RolloutConfig, standing_state
    from qppvm_tpu_torch.mpc.sampling import MPPIConfig, SamplingMPC
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
    from qppvm_tpu_torch.runtime.async_mpc import AsyncPlanner

    soles = ("l_sole", "r_sole")
    model = zoo.humanoid(device=device)
    plugin = ForceAccPlugin(model, contact_links=soles, iters=40)
    st = standing_state(model, soles)
    refs, warm, _ = plugin.on_start(st)
    mpc = SamplingMPC(plugin, MPPIConfig(n_samples=64, horizon=4,
                                         noise_std=0.2, push_std=20.0),
                      RolloutConfig(horizon=4, qp_iters=15, dt=0.02))
    planner = AsyncPlanner(mpc, replan_ticks=20, ticks_per_step=20,
                           generator=torch.Generator(
                               device=device).manual_seed(7))
    u, age = planner.tick(0, st, refs, warm)
    assert age == -1 and planner.n_launch == 1
    planner.close()
    U_async, info = planner._committed[0], planner.infos[0]
    U_sync, _ = mpc.plan(torch.Generator(device=device).manual_seed(7), st,
                         refs, warm, mpc.init_plan())
    assert float(info["solver_fail_frac"]) == 0.0
    assert torch.allclose(U_async, U_sync, rtol=1e-5, atol=1e-6)


def test_run_config1_on_card(device):
    """run.main on config 1 for 5 ticks on the card: the reference's keys
    with the card's name, finite numbers."""
    import math
    from pathlib import Path

    from qppvm_tpu_torch import run

    path = Path(__file__).resolve().parents[1] / "configs" / "config1_arm7.yaml"
    out = run.main(["--config", str(path), "--seconds", "0.005"])
    assert set(out) == {"scenario", "seconds", "p50_ms", "p99_ms",
                        "deadline_misses", "final_q_norm", "device"}
    assert out["device"] == torch.cuda.get_device_name(device)
    assert all(math.isfinite(v) for k, v in out.items()
               if k not in ("scenario", "device"))


def _lqr(device, dtype):
    """tests/test_ilqr.py's LQR problem and the iLQR's solve on it."""
    import numpy as np

    from qppvm_tpu_torch.mpc import ilqr

    rng = np.random.default_rng(0)
    A = np.eye(4) + 0.05 * rng.standard_normal((4, 4))
    B = 0.1 * rng.standard_normal((4, 2))
    x0 = rng.standard_normal(4)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    A, B, Q, R, x0 = t(A), t(B), t(np.eye(4)), t(0.1 * np.eye(2)), t(x0)
    solve = ilqr.make_solver(lambda x, u: A @ x + B @ u,
                             lambda x, u: 0.5 * (x @ Q @ x + u @ R @ u),
                             lambda x: 0.5 * x @ Q @ x,
                             ilqr.ILQRConfig(iterations=3))
    return solve(x0, torch.zeros((30, 2), dtype=dtype, device=device))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ilqr_quu_routing(device, dtype):
    """The backward pass inverts Q_uu once a step: float32 through the NS
    kernel (30 steps x 4 passes = 120 launches), float64 through the plain
    NS, counted; both solve the LQR problem as the CPU does in float64."""
    telemetry.reset("ns_inverse.launch")
    telemetry.reset("model.plain_inverse")
    res = _lqr(device, dtype)
    torch.cuda.synchronize()
    kernel = dtype == torch.float32
    assert telemetry.counts()["ns_inverse.launch"] == (120 if kernel else 0)
    assert telemetry.counts()["model.plain_inverse"] == (0 if kernel else 120)
    ref = _lqr("cpu", torch.float64)
    tol = 1e-4 if kernel else 1e-10
    for f in ("U", "X", "K"):
        got, want = getattr(res, f).cpu().double(), getattr(ref, f)
        assert float((got - want).abs().max()) <= tol * (
            1 + float(want.abs().max())), f


@pytest.mark.parametrize("robot,feet", [
    ("quadruped", ("foot_fl", "foot_fr", "foot_hr", "foot_hl")),
    ("humanoid", ("l_sole", "r_sole"))])
def test_ddp_plan_card_matches_cpu(device, robot, feet):
    """One plan at tests/test_ddp_mpc.py's config (horizon 15, 4
    iterations) in float32: 76 NS launches and no plain inverse on the
    card; the plan held to the CPU's (plain inverses) at chip_smoke.py's
    phase 15 bars."""
    from qppvm_tpu_torch.model import kinematics, zoo
    from qppvm_tpu_torch.mpc.ddp_mpc import CentroidalMPC, CentroidalMPCConfig
    from qppvm_tpu_torch.runtime.robot_interface import standing_state

    plans = {}
    for d in (device, torch.device("cpu")):
        model = getattr(zoo, robot)(device=d)
        st = standing_state(model, feet)
        com0 = kinematics.com(model, kinematics.fk(model, st))[1][0]
        mpc = CentroidalMPC(model, feet, CentroidalMPCConfig(
            horizon=15, dt=0.02, iterations=4))
        telemetry.reset("ns_inverse.launch")
        telemetry.reset("model.plain_inverse")
        plans[d.type] = mpc.plan(st, com0 - torch.tensor(
            [0.0, 0.0, 0.04], device=d), mpc.init_plan(st))[0]
        if d.type == "cuda":
            torch.cuda.synchronize()
            counted = telemetry.counts()
            assert (counted["ns_inverse.launch"],
                    counted["model.plain_inverse"]) == (76, 0)
    got, want = plans["cuda"], plans["cpu"]
    for f, rel in (("U", 1e-3), ("X", 1e-3), ("K", 1e-2), ("cost", 1e-5),
                   ("reg", 1e-6)):
        a, b = getattr(got, f).cpu(), getattr(want, f)
        assert float((a - b).abs().max()) <= rel * (
            1 + float(b.abs().max())), f
    assert float((got.k.cpu() - want.k).abs().max()) <= 1e-3 * (
        1 + float(want.U.abs().max()))


def test_sharded_plan_on_two_ranks_matches_one_process(device, tmp_path):
    """The dryrun's planner (qppvm_tpu_torch/dryrun.py) with 16 samples on
    2 gloo ranks of the card, each rolling its 8 out through the level
    kernel (16 level launches, 1 NS launch, 0 fallbacks and 8 model-sweep
    launches, one a horizon step, a plan): U_new the
    same on both ranks and within tests/test_mpc_parallel.py's bars of
    the same plan in one process."""
    import numpy as np

    import torch_parallel_ranks as ranks
    from qppvm_tpu_torch import dryrun
    from qppvm_tpu_torch.parallel import mesh as meshlib

    level_qp.library()
    ns_inverse.library()
    model_sweep.library()
    got = meshlib.run_ranks(ranks.card_plan, 2, timeout_s=300.0,
                            group_timeout_s=120.0,
                            init_file=str(tmp_path / "rendezvous"))
    U1, info1, counts1, _ = dryrun.plan_step(16, device)
    assert counts1 == (16, 1, 0, 8)
    for U, cost, counts in got:
        assert counts == (16, 1, 0, 8)
        np.testing.assert_array_equal(U, got[0][0])
        np.testing.assert_allclose(U, U1.cpu().numpy(), atol=1e-4)
        np.testing.assert_allclose(cost, float(info1["cost_mean"]),
                                   rtol=1e-3)


def test_flop_count_is_the_same_through_kernel_and_plain(device):
    """bench_util.matmul_flops of the humanoid's RT tick at B 37 through
    the level kernel and through the plain level solver."""
    from qppvm_tpu_torch import bench_util
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.mpc.rollout import standing_state
    from qppvm_tpu_torch.mpc.sampling import expand_batch
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin

    model = zoo.humanoid(device=device)
    contacts = ("l_sole", "r_sole")
    st = standing_state(model, contacts)
    rt = dict(rho_updates=0, warm_kinv_iters=4, cold_ns_iters=10,
              scale_iters=2, pinv_ns_iters=5)
    counts = {}
    plugin = ForceAccPlugin(model, contact_links=contacts,
                            waist_link="pelvis", iters=12, solver_opts=rt)
    refs, warm, _ = plugin.on_start(st)
    st_b, refs_b, warm_b = expand_batch(st, refs, warm, 37)
    for route in ("kernel", "plain"):
        telemetry.reset("level_qp.launch")
        with pytest.MonkeyPatch.context() as mp:
            if route == "plain":
                _plain_levels(mp)
            counts[route] = bench_util.matmul_flops(plugin._step_impl, st_b,
                                                    refs_b, warm_b)
        torch.cuda.synchronize()
        assert telemetry.counts()["level_qp.launch"] == (
            2 if route == "kernel" else 0)
    assert counts["kernel"] == counts["plain"] > 0


# --- the tick as one CUDA graph (runtime/tick_graph.py) --------------------

GRAPH_TICKS = 20
GRAPH_COUNTS = ("level_qp.launch", "model_sweep.launch", "ns_inverse.launch",
                "cascade.level", "cascade.fallback", "model.plain_sweep",
                "model.plain_inverse")


def _graph_case(device, case):
    """(plugin, the chain's inputs: [(state, refs)] of GRAPH_TICKS ticks,
    the warm state): the humanoid's RT tick at B 1, the centaur's with
    friction cones at B 64, the QPPVM dual arm's at B 1 on its sinusoid."""
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.mpc.rollout import standing_state
    from qppvm_tpu_torch.mpc.sampling import expand_batch
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
    from qppvm_tpu_torch.plugins.qppvm import QPPVMPlugin
    from qppvm_tpu_torch.runtime.rt_loop import RT_PROFILE

    g = torch.Generator(device=device).manual_seed(3)
    if case == "qppvm_b1":
        model = zoo.dual_arm(device=device)
        plugin = QPPVMPlugin(model, iters=60,
                             solver_opts=dict(rho_updates=0))
        st = model.home_state()
        refs, warm, start = plugin.on_start(st)
        ticks = [(type(st)(q=st.q + 0.01 * torch.randn(
            st.q.shape, generator=g, device=device), qd=st.qd,
            base_rot=st.base_rot, base_pos=st.base_pos,
            base_vel=st.base_vel),
            dict(refs, LEFT_ARM=plugin.make_refs(start, 1e-3 * k)))
            for k in range(GRAPH_TICKS)]
        return plugin, ticks, warm
    if case == "humanoid_b1":
        model, B, contacts = zoo.humanoid(device=device), 1, ("l_sole",
                                                               "r_sole")
        plugin = ForceAccPlugin(model, contact_links=contacts,
                                waist_link="pelvis", iters=12,
                                solver_opts=dict(RT_PROFILE))
    else:
        model, B = zoo.centaur(device=device), 64
        plugin = ForceAccPlugin(model, iters=12, use_friction_cones=True,
                                solver_opts=dict(RT_PROFILE))
        contacts = plugin.contact_links
    st = standing_state(model, contacts)
    refs, warm, _ = plugin.on_start(st)
    st, refs, warm = expand_batch(st, refs, warm, B)
    ticks = [(type(st)(q=st.q + 0.01 * torch.randn(
        st.q.shape, generator=g, device=device), qd=st.qd,
        base_rot=st.base_rot, base_pos=st.base_pos, base_vel=st.base_vel),
        refs) for _ in range(GRAPH_TICKS)]
    return plugin, ticks, warm


def _tensors(tree):
    from qppvm_tpu_torch.runtime import tick_graph
    out = []
    tick_graph._flatten(tree, out)
    return out


GRAPH_CASES = ["humanoid_b1", "centaur_cones_b64", "qppvm_b1"]


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_graph_chain_equals_eager_chain(device, case):
    """GRAPH_TICKS chained ticks through ``_step_impl`` (the first eager,
    the second captured, the rest replayed) equal the same chain through
    ``_tick_body`` run eagerly, bitwise: tau, the warm carry and aux. Each
    tick's outputs are kept to the end, so none was overwritten by a
    later replay."""
    plugin, ticks, warm0 = _graph_case(device, case)
    eager, warm = [], warm0
    for st, refs in ticks:
        out = plugin._tick_body(st, refs, warm)
        eager.append(out)
        warm = out[1]
    telemetry.reset("tick_graph.capture", "tick_graph.replay")
    graphed, warm = [], warm0
    for st, refs in ticks:
        out = plugin._step_impl(st, refs, warm)
        graphed.append(out)
        warm = out[1]
    torch.cuda.synchronize()
    counted = telemetry.counts()
    assert counted["tick_graph.capture"] == 1
    assert counted["tick_graph.replay"] == GRAPH_TICKS - 1
    for k, (a, r) in enumerate(zip(graphed, eager)):
        ta, tr = _tensors(a), _tensors(r)
        assert len(ta) == len(tr)
        for i, (x, y) in enumerate(zip(ta, tr)):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y), (case, k, i, float(
                (x.double() - y.double()).abs().max()))


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_graph_replay_counts_what_the_eager_tick_counts(device, case):
    """A replay adds the level, sweep and NS launches (and the levels and
    plain routes) that the eager tick counts, once each."""
    plugin, ticks, warm = _graph_case(device, case)
    (st, refs) = ticks[0]
    for _ in range(2):                  # eager, then captured and replayed
        plugin._step_impl(st, refs, warm)
    telemetry.reset(*GRAPH_COUNTS)
    plugin._tick_body(st, refs, warm)
    eager = {n: telemetry.counts()[n] for n in GRAPH_COUNTS}
    telemetry.reset(*GRAPH_COUNTS, "tick_graph.replay", "tick_graph.capture")
    plugin._step_impl(st, refs, warm)
    torch.cuda.synchronize()
    replayed = {n: telemetry.counts()[n] for n in GRAPH_COUNTS}
    assert replayed == eager and eager["level_qp.launch"] == 2
    assert eager["model_sweep.launch"] == 1
    assert telemetry.counts()["tick_graph.replay"] == 1
    assert telemetry.counts()["tick_graph.capture"] == 0


def test_graph_outputs_survive_the_next_replay(device):
    """Tick k's outputs hold their values after tick k + 1 replays."""
    plugin, ticks, warm = _graph_case(device, "humanoid_b1")
    outs = []
    for st, refs in ticks[:4]:
        out = plugin._step_impl(st, refs, warm)
        outs.append((out, [t.clone() for t in _tensors(out)]))
        warm = out[1]
    torch.cuda.synchronize()
    for out, copies in outs:
        for t, c in zip(_tensors(out), copies):
            assert torch.equal(t, c)


def test_graph_new_refs_layout_captures_once_more(device):
    """A refs layout the graph has not seen ticks eagerly once, then
    captures one more graph; the old layout still replays its own."""
    plugin, ticks, warm = _graph_case(device, "humanoid_b1")
    st, refs = ticks[0]
    wider = dict(refs, extra={"v": torch.zeros(1, 3, device=device)})
    for _ in range(2):
        plugin._step_impl(st, refs, warm)
    telemetry.reset("tick_graph.capture", "tick_graph.replay")
    for _ in range(3):
        plugin._step_impl(st, wider, warm)
    plugin._step_impl(st, refs, warm)
    counted = telemetry.counts()
    assert counted["tick_graph.capture"] == 1
    assert counted["tick_graph.replay"] == 3


def _setting_change(plugin, change, device, first_out):
    """(set_a, set_b) of a setting of ``plugin``: the chain starts under
    set_a and changes to set_b halfway."""
    from qppvm_tpu_torch.tasks.generic import FrictionCone

    if change.startswith("qppvm"):
        tasks = (plugin.ee_left, plugin.ee_right)
        Kc, Dc = plugin.ee_left.Kc.clone(), plugin.ee_left.Dc.clone()
        if change == "qppvm_new_gains":
            return (lambda: [t.set_stiffness_damping(Kc, Dc) for t in tasks],
                    lambda: [t.set_stiffness_damping(2.0 * Kc, 3.0 * Dc)
                             for t in tasks])
        if change == "qppvm_gain_in_place":       # read where it lies
            live = plugin.ee_left.Kc
            return lambda: live.copy_(Kc), lambda: live.mul_(2.0)
        host = Kc.to("cpu", torch.float64)        # converted once, watched
        for t in tasks:
            t.set_stiffness_damping(host, Dc)
        return lambda: host.copy_(Kc), lambda: host.mul_(2.0)
    if change == "humanoid_task_weight":
        return (lambda: setattr(plugin.postural, "weight", 1.0),
                lambda: setattr(plugin.postural, "weight", 4.0))
    cones = [c for c in plugin.stack.constraints
             if isinstance(c, FrictionCone)]
    # below the feet that carry more than their share, above the sum
    f_max = 1.05 * float(first_out[2].wrenches[..., 2].mean())
    return (lambda: [setattr(c, "f_max", 1e4) for c in cones],
            lambda: [setattr(c, "f_max", f_max) for c in cones])


# change -> (its case, captures and replays of the graphed chain)
SETTING_CHANGES = {
    "qppvm_new_gains": ("qppvm_b1", 2, GRAPH_TICKS - 2),
    "qppvm_gain_in_place": ("qppvm_b1", 1, GRAPH_TICKS - 1),
    "qppvm_host_gain_in_place": ("qppvm_b1", 2, GRAPH_TICKS - 2),
    "humanoid_task_weight": ("humanoid_b1", 2, GRAPH_TICKS - 2),
    "centaur_cone_f_max": ("centaur_cones_b64", 2, GRAPH_TICKS - 2),
}


@pytest.mark.parametrize("change", list(SETTING_CHANGES))
def test_graph_follows_a_changed_setting(device, change):
    """GRAPH_TICKS chained ticks whose setting changes after half of them:
    through ``_step_impl`` they equal the eager chain through
    ``_tick_body`` bitwise, and differ from the chain with the setting
    unchanged. An assigned setting, or a host gain changed in place, drops
    the graph (one eager tick, one more capture); a gain on the card
    changed in place reaches the replay where it lies."""
    case, captures, replays = SETTING_CHANGES[change]
    plugin, ticks, warm0 = _graph_case(device, case)
    set_a, set_b = _setting_change(
        plugin, change, device, plugin._tick_body(*ticks[0], warm0))
    half = GRAPH_TICKS // 2

    def chain(step, switch):
        set_a()
        outs, warm = [], warm0
        for k, (st, refs) in enumerate(ticks):
            if switch and k == half:
                set_b()
            out = step(st, refs, warm)
            outs.append(out)
            warm = out[1]
        return outs

    unchanged = chain(plugin._tick_body, False)
    eager = chain(plugin._tick_body, True)
    telemetry.reset("tick_graph.capture", "tick_graph.replay")
    graphed = chain(plugin._step_impl, True)
    torch.cuda.synchronize()
    counted = telemetry.counts()
    assert (counted["tick_graph.capture"], counted["tick_graph.replay"]) \
        == (captures, replays)
    assert not torch.equal(eager[-1][0], unchanged[-1][0])
    for k, (a, r) in enumerate(zip(graphed, eager)):
        for i, (x, y) in enumerate(zip(_tensors(a), _tensors(r))):
            assert torch.equal(x, y), (change, k, i, float(
                (x.double() - y.double()).abs().max()))
