"""Smoke test of the PyTorch + CUDA port (qppvm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. build the level-QP kernel from csrc/level_qp.cu and print the card;
2. hold the kernel against its plain PyTorch version on WBC-shaped random
   problems at the humanoid tick's level shapes, B = 1024, cold then warm,
   to the tolerances of tests/test_pallas_qp.py (rho_scale as
   qppvm_tpu_torch/opt/level_qp_parity.py says), and time both;
3. drive the main path: ForceAccPlugin on the humanoid with bench.py's RT
   profile, on_start, then 5 chained batched ticks at B = 1024 (q perturbed
   by 0.01 N(0, 1)); gate on zero solver failures and finite torques,
   require 2 kernel launches and 0 fallbacks per tick, compare tau with the
   same chain run through the plain level solver (backend "torch"), and
   time the tick with either.

Prints a JSON line describing the kernel, then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero without that line when there
is no CUDA device or any phase fails.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B = 1024
TICKS = 5
REPS = 12
CONTACTS = ("l_sole", "r_sole")
RT_PROFILE = dict(rho_updates=0, warm_kinv_iters=4, cold_ns_iters=10,
                  scale_iters=2, pinv_ns_iters=5)
# humanoid level shapes (n, m, head eqs, tail eqs), and one without equalities
MAIN_SHAPES = [(44, 12, 6, 0), (44, 18, 6, 6)]
LEVEL_SHAPES = MAIN_SHAPES + [(44, 12, 0, 0)]
BACKENDS = ("kernel", "torch")   # level solver: CUDA kernel, plain qp.solve
# tau of the kernel chain vs the plain chain: float32 sums in another order
# through 5 chained 12-iteration solves; a wrong row moves tau by O(1) Nm
TAU_ATOL, TAU_RTOL = 5e-3, 1e-3


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(torch, fn, reps=20):
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def tick_times_ms(torch, plugin, states, refs, warm, reps=REPS):
    """Host-clock times of ``reps`` synchronized batched ticks."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plugin._step_impl(states, refs, warm)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def import_port():
    """The checkout's own qppvm_tpu_torch; exits when that is not what
    imports."""
    sys.path.insert(0, str(ROOT))
    import qppvm_tpu_torch
    if Path(qppvm_tpu_torch.__file__).resolve().parent.parent != ROOT:
        sys.exit("chip_smoke: qppvm_tpu_torch is not the checkout's own")
    return qppvm_tpu_torch


def main_path_inputs(torch, dev):
    """The main path's set-up on ``dev``: a ForceAccPlugin per level-solver
    backend on the humanoid with the RT profile, and the batched tick's
    inputs (states with q perturbed by 0.01 N(0, 1), references and warm
    state from the kernel plugin's on_start, expanded to B)."""
    import_port()
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.mpc.rollout import standing_state
    from qppvm_tpu_torch.opt import qp
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin

    model = zoo.humanoid(device=dev)
    plugins = {b: ForceAccPlugin(model, contact_links=CONTACTS,
                                 waist_link="pelvis", iters=12,
                                 solver_opts=dict(RT_PROFILE, backend=b))
               for b in BACKENDS}
    st = standing_state(model, CONTACTS)
    refs, warm, _ = plugins["kernel"].on_start(st)
    expand = lambda a: a.expand(B, *a.shape[1:]).contiguous()  # noqa: E731
    refs_b = {k: {kk: expand(v) for kk, v in r.items()}
              for k, r in refs.items()}
    warm_b = tuple(qp.QPState(**{f: expand(getattr(s, f)) for f in
                                 ("x", "z", "y", "Kinv", "rho_scale")})
                   for s in warm)
    g = torch.Generator(device=dev).manual_seed(0)
    states = type(st)(
        q=expand(st.q) + 0.01 * torch.randn(B, model.nj, generator=g,
                                             device=dev),
        **{f: expand(getattr(st, f))
           for f in ("qd", "base_rot", "base_pos", "base_vel")})
    return plugins, states, refs_b, warm_b


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; nothing run")
    import_port()
    from qppvm_tpu_torch import build
    from qppvm_tpu_torch.opt import hierarchy, level_qp
    from qppvm_tpu_torch.opt import level_qp_parity as parity

    dev = torch.device("cuda", 0)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])
    card = card_line()

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    level_qp.library()
    print(f"build: level_qp.cu built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    log = build.library_path("level_qp").with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())
    print(card)

    # ---- 2. kernel vs plain version ----------------------------------------
    max_err, level_ms = 0.0, []
    for i, (n, m, h, t) in enumerate(LEVEL_SHAPES):
        cfg = level_qp.LevelQPConfig(n_eq_head=h, n_eq_tail=t,
                                     cold_ns_iters=10)
        prob = parity.random_problems(B, n, m, h, t, dev, seed=i)
        state = parity.zero_state(B, n, m, dev)
        for phase in ("cold", "warm"):
            out = level_qp.solve_level(cfg, *prob, *state)
            torch.cuda.synchronize()
            try:
                errs = parity.check_level_outputs(cfg, prob, state, out)
            except AssertionError as e:
                fail(f"n={n} m={m} h={h} t={t} {phase}: {e}")
            print(f"kernel vs plain n={n} m={m} h={h} t={t} {phase}: max abs "
                  + " ".join(f"{k}={v:.3g}" for k, v in errs.items()))
            if (n, m, h, t) in MAIN_SHAPES:
                max_err = max(max_err, max(errs.values()))
            state = out[:5]   # warm: the kernel's own state, rho_scale too
        if (n, m, h, t) in MAIN_SHAPES:
            run_k = lambda: level_qp.solve_level(cfg, *prob, *state)  # noqa
            run_p = lambda: level_qp.solve_level_reference(cfg, *prob, *state)  # noqa
            p1, k1, k2, p2 = (cuda_time_ms(torch, f)
                              for f in (run_p, run_k, run_k, run_p))
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            level_ms.append((k_ms, p_ms))
            print(f"[{card}] level n={n} m={m} h={h} t={t} B={B}: "
                  f"kernel {k_ms:.4f} ms, plain PyTorch {p_ms:.4f} ms")

    # ---- 3. main path -------------------------------------------------------
    plugins, states, refs_b, warm_b = main_path_inputs(torch, dev)

    def chain(backend):
        w, taus, prim_max = warm_b, [], 0.0
        for k in range(TICKS):
            tau, w, aux = plugins[backend]._step_impl(states, refs_b, w)
            fail_frac = float(aux.solver_failed.float().mean())
            if fail_frac != 0.0 or not bool(torch.isfinite(tau).all()):
                fail(f"{backend} tick {k}: solver_fail_frac={fail_frac}, "
                     f"finite tau={bool(torch.isfinite(tau).all())}")
            if tuple(tau.shape) != (B, plugins[backend].model.nj):
                fail(f"tau shape {tuple(tau.shape)}")
            prim_max = max(prim_max, float(aux.prim_res.max()))
            taus.append(tau)
        return taus, prim_max

    level_qp.launches = 0
    hierarchy.fallbacks = 0
    taus, prim_max = chain("kernel")
    torch.cuda.synchronize()
    launches, fallbacks = level_qp.launches, hierarchy.fallbacks
    print(f"main path: {TICKS} ticks at B={B}: kernel launches {launches}, "
          f"fallbacks {fallbacks}, solver_fail_frac 0.0, prim_res_max "
          f"{prim_max:.3g}")
    if launches != 2 * TICKS or fallbacks != 0:
        fail(f"expected {2 * TICKS} launches and 0 fallbacks")
    taus_ref, _ = chain("torch")
    tau_err = 0.0
    for k, (a, r) in enumerate(zip(taus, taus_ref)):
        err = float((a - r).abs().max())
        tau_err = max(tau_err, err)
        if not torch.all((a - r).abs() <= TAU_ATOL + TAU_RTOL * r.abs()):
            fail(f"tick {k}: tau differs from the plain chain by {err:.3g} Nm")
    print(f"tau vs plain-solver chain: max abs diff {tau_err:.3g} Nm "
          f"(|tau| up to {float(taus_ref[-1].abs().max()):.3g} Nm; "
          f"atol {TAU_ATOL}, rtol {TAU_RTOL})")

    for backend in BACKENDS:
        times = tick_times_ms(torch, plugins[backend], states, refs_b, warm_b)
        print(f"[{card}] batched tick B={B} ({backend} level solver): median "
              f"{statistics.median(times):.3f} ms over {REPS} reps "
              f"(min {min(times):.3f}, max {max(times):.3f})")

    print(json.dumps({"kernels": [{
        "name": "level_qp", "route": "cuda",
        "source": "qppvm_tpu_torch/csrc/level_qp.cu",
        "replaces": "qppvm_tpu/opt/pallas_qp.py:257",
        "launches": launches, "max_abs_err": max_err,
        "ms": sum(k for k, _ in level_ms),
        "plain_ms": sum(p for _, p in level_ms)}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
