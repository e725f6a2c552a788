"""Where the time of one level-kernel solve goes, phase by phase, on one GPU.

    python3 tools/profile_level_qp.py

Builds csrc/level_qp.cu with LEVEL_QP_PHASES, which makes thread 0 of
block 0 read clock64() at the end of each phase of the solve, and runs it
on chip_smoke.py's random problems at the humanoid's two level shapes: the
RT profile at B = 1 (one block alone on its SM) and B = 1024 (block 0
sharing its SM), and the rollout profile at B = 512. Prints, for a warm
solve (from the kernel's own cold output), the cycles of each phase and
its share, the median over REPS launches; also the kernel's time at each
size from CUDA events. The uninstrumented kernel is what chip_smoke.py
times; the clock reads add a few cycles per phase.
"""
import ctypes
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

REPS = 9
PHASES = ("load + Ruiz", "equality rows", "Gram NS inverse",
          "pseudo-inverse", "Pn, x_p, q_eff", "rho + KKT matrix",
          "NS guard", "NS iterations", "Kinv out, Pn Kinv, A Pn Kinv",
          "ADMM iterations", "residuals, unscale, outputs")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_level_qp: no CUDA device")
    from qppvm_tpu_torch import build
    from qppvm_tpu_torch.opt import level_qp
    from qppvm_tpu_torch.opt import level_qp_parity as parity

    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    # the instrumented build, bound as level_qp binds its own; it takes the
    # plain library's place in level_qp for the clocked solves
    plain = level_qp.library()
    lib = build.load("level_qp", ("LEVEL_QP_PHASES",))
    for fn in ("level_qp_launch", "level_qp_smem_floats"):
        getattr(lib, fn).argtypes = getattr(plain, fn).argtypes
        getattr(lib, fn).restype = getattr(plain, fn).restype
    lib.level_qp_phase_clocks.argtypes = [ctypes.c_void_p]
    lib.level_qp_phase_clocks.restype = ctypes.c_int
    clocks = (ctypes.c_longlong * 16)()

    def read_clocks():
        rc = lib.level_qp_phase_clocks(ctypes.addressof(clocks))
        if rc != 0:
            raise RuntimeError(f"reading the phase clocks: CUDA error {rc}")
        return list(clocks)

    for (n, m, h, t) in chip_smoke.MAIN_SHAPES:
        for B, prof in ((1, "RT"), (chip_smoke.B, "RT"), (512, "rollout")):
            kw = (dict(cold_ns_iters=10) if prof == "RT"
                  else chip_smoke.ROLLOUT_LEVEL)
            cfg = level_qp.LevelQPConfig(n_eq_head=h, n_eq_tail=t, **kw)
            prob = parity.random_problems(B, n, m, h, t, dev, seed=0)
            state = level_qp.solve_level(
                cfg, *prob, *parity.zero_state(B, n, m, dev))[:5]
            runs = []
            level_qp._lib = lib
            for _ in range(REPS):
                read_clocks()
                level_qp.solve_level(cfg, *prob, *state)
                torch.cuda.synchronize()
                c, last, phase = read_clocks(), None, []
                for k in range(12):   # a phase not run leaves its clock 0
                    phase.append(c[k] - last if c[k] and last else 0)
                    last = c[k] or last
                runs.append(phase[1:])
            level_qp._lib = plain
            cyc = [statistics.median(r[k] for r in runs) for k in range(11)]
            total = sum(cyc)
            ms = chip_smoke.cuda_time_ms(
                torch, lambda: level_qp.solve_level(cfg, *prob, *state),
                lead=True)
            print(f"[{card}] level n={n} m={m} h={h} t={t} {prof} B={B}: "
                  f"kernel {ms:.4f} ms; block 0: {total:.0f} cycles")
            for name, c in zip(PHASES, cyc):
                if c:
                    print(f"  {name:30s} {c:9.0f} cycles {c / total:6.1%}")


if __name__ == "__main__":
    main()
