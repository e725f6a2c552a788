"""Smoke test of the PyTorch + CUDA port (qppvm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
1. build the three kernels (csrc/level_qp.cu, csrc/ns_inverse.cu,
   csrc/model_sweep.cu; one nvcc each, started together) and print the
   card;
2. hold the level-QP kernel against its plain PyTorch version on WBC-shaped
   random problems at the humanoid tick's level shapes and two others (no
   equalities; more inequality rows than one product tile covers), B = 1024,
   cold then warm, to the tolerances of tests/test_pallas_qp.py (rho_scale as
   qppvm_tpu_torch/opt/level_qp_parity.py says), and time both at the
   humanoid's shapes; the same
   at B = 1, the real-time loop's size; then the same at the MPC rollout's
   profile (no z clip, no cold budget, 8 warm NS iterations, rho carried)
   at B = 512, cold then two warm solves, timed warm. Kernel times are
   device times (the host queues every timed launch ahead, LEAD_CYCLES);
   at B = 1 the time of a call with the wrapper's host work is printed too.
   Then the ForceAccExample robots' level shapes (ROBOT_SHAPES: the
   quadruped's n 34, the centaur's n 49 with friction cones, an n 49 level
   with 74 inequality rows, and phase 9's capture stack at n 50) and the
   QPPVM stacks' (phase 11: the dual arm's n 15 and the arm's n 7, the
   torque box alone and with 6 locked rows, in QPPVMPlugin's profile with
   rho_updates 0) at B = 1024 and B = 1, cold then warm, each timed
   beside its bound. The kernels line's max_abs_err
   is the largest gap over ERR_OUTPUTS; each phase's line prints them all;
3. drive the main path: ForceAccPlugin on the humanoid with bench.py's RT
   profile, on_start, then 5 chained batched ticks at B = 1024 (q perturbed
   by 0.01 N(0, 1)); gate on zero solver failures and finite torques,
   require 2 kernel launches and 0 fallbacks per tick and 1 model-sweep
   launch a tick with no plain sweep, compare tau with the
   same chain run through the plain level solver (level_qp's launch
   patched by its plain version: ``plain_levels``), and
   time the tick with either;
4. drive the NS-inverse path (ns_inverse, bench_pallas.py's B 1024, n 64,
   26 iterations on K = M M^T + 0.5 I) and the simulator's shape (the
   humanoid's regularized mass matrix, 24 iterations, B 1 and 1024; the
   quadruped's, n 22, B 1) and the QPPVM loops' (the dual arm's mass
   matrix, n 15, B 1, 20 iterations for the tick's Binv and 24 for the
   plant; the arm's, n 7, 20 iterations); hold
   the kernel to its plain version (atol 2e-4, rtol 2e-3) and to
   max |K X - I| < 5e-3; time the kernel (on the device, and a call with
   the wrapper's host time), the plain version and torch.linalg.inv, and
   print both bounds (float32 on the CUDA cores, 3xTF32 on the tensor
   cores), the kernel's share of the lesser and its ratio to
   torch.linalg.inv at each shape; also every shape phase 15 hands the
   kernel, recorded as it runs: the first Q_uu of a quadruped plan (n 12,
   22 iterations), of a humanoid plan (n 6, 22) and of the LQR problem
   (n 2, 22), and the quadruped's SRBD inertia (n 3, 16); then phase 19
   (``--phase sweep`` alone): the model-sweep kernel (csrc/model_sweep.cu:
   fk, the nonlinear term and the bias accelerations in one launch) held
   to its plain version (model_sweep.sweep_reference; R, p, S_ang, h,
   bias_all within SWEEP_BAR, tests/test_torch_model_sweep.py's bar) at
   the benchmark cells' shapes (the humanoid at B 1, the centaur at B
   1024) and the MPPI rollout's (the humanoid at B 4096), from states far
   from home; the kernel timed on the device and a call with the wrapper,
   the plain version, the bound; one ForceAcc step_core of the humanoid
   counts 1 model_sweep.launch and 0 model.plain_sweep. Every phase that
   counts level or NS launches on a path (3, 5 to 18) also counts that
   path's model-sweep launches (one a model update: a tick, a rollout
   step, a DDP plan's and the QPPVM on_start's) and its CUDA model updates
   outside the kernel (model.plain_sweep: one a ForceAcc on_start in the
   window, none else) and fails on any other count; the kernels line's
   model_sweep row gives them by path;
5. the closed loop (runtime/rt_loop.py): 500 ticks of the humanoid's RT
   tick against the contact plant, gated on zero solver failures and a
   stand within 0.08 m; ms per tick, sim-only ms per tick and their
   difference; then 100 ticks through the level kernel at B = 1, its first
   5 torques held to the plain loop's, 2 level launches and 2 NS launches
   (the plant's mass-matrix inverse, one per substep) per tick; one plant
   step's udot through the NS kernel held to the same step with the plain
   inverse;
6. one sampling-MPC plan step (mpc/humanoid_plan.py: 512 samples, horizon
   8, rollouts through the level kernel): one untimed plan, 3 timed ones;
   2 x horizon level launches and 1 NS launch (the start inverse) per
   plan, 0 fallbacks, solver_fail_frac 0, finite cost; then 3 more draws,
   each rolled out through the kernel and through the plain level solver
   on the same samples, must agree sample by sample
   (each rollout's cost, the failure flags) and in the MPPI plan U_new.
   Prints QP solves/s;
7. the centaur's batched tick: ForceAccPlugin on zoo.centaur() with feet
   foot_fl/fr/hr/hl and friction cones (mu 0.7), the RT profile, on_start,
   then 5 chained ticks at B = 1024 (q perturbed by 0.01 N(0, 1)); gated
   as phase 3, plus every wrench inside its cone and fz >= 10 within
   1e-3 N; tau held to the plain chain's; both timed;
8. the reference's ForceAccExample in closed loop: the quadruped with the
   default stack (3-force wrench box), the RT profile, SimRobot at dt 1 ms
   in 4 substeps (runtime/rt_loop.py's ClosedLoop pieces), 400 ticks
   through the level kernel at B = 1 with the squat reference (0.05 m)
   from tick 200; gated as tests/test_force_acc_e2e.py: no solver
   failure, final base z in (z0 - 0.12, z0 - 0.01), mean sum fz over ticks
   50 to 199 within 25% of the weight, the last tick's fz >= 10 - 1e-3;
   2 level and 4 NS launches a tick; the first 5 torques held to the same
   loop through the plain level solver; ms per tick and sim-only ms per
   tick;
9. the capture step on the humanoid, as tests/test_capture_step.py runs
   it: 6D wrenches in friction cones (mu 0.6), switchable contacts, iters
   40; SimRobot at dt 1 ms in 2 substeps with the foot patches;
   LegLiftScript into single support (t_hold0 + 100 ticks at B 1, its
   on_start seeded in float64, seeded_on_start says why); the shoved state
   (base_vel[4] += 1.2) and the 4-candidate library (null, cross_near,
   cross_far, replant_down) rolled out as one batch, 100 steps of 0.01 s
   in 8 substeps at the plant's stiction with the capture terminal cost,
   once through the level kernel (2 launches a step at n 50, 1 NS launch,
   0 fallbacks) and once through the plain level solver: finite costs,
   cross_near the argmin of both, below null and replant_down, each cost
   within CAPTURE_COST_RTOL of the other solver's, printed beside the JAX
   package's CPU ranking; then, from the snapshot, lean-only until it
   falls and the chosen step for fall tick + 200 ticks, gated as the
   test (lean falls; the swing foot moves > 5 cm; up > 0.9 at lean's fall
   tick; RT failures < 5%), 2 NS launches a tick; the candidate batch, the
   loop and the plant alone timed;
10. MPPI's step-recovery channel on the quadruped (switchable cones at mu
   0.5, iters 40; horizon 12, qp_iters 40, dt 0.04, 4 substeps, mu 1.3,
   theta noise 1.5, dxy noise 0.1) at 512 samples: one untimed plan_step
   and 3 timed, each 2 x 12 level launches, 1 NS launch, 0 fallbacks,
   solver_fail_frac 0 and finite costs; 3 draws through the kernel and the
   plain level solver on the same samples, held as phase 6 (and theta_new
   within MPC_U_ATOL of 1 + |theta|); one rollout at K 512 with a gate_seq
   ramping foot_fl off mid-horizon, healthy and finite;
11. the reference's QPPVMPlugin experiment through
   runtime/plugin.py::ControlLoop, as tests/test_qppvm_e2e.py runs it:
   config 2, the dual arm (iters 60) on the moving sinusoid of its left
   EE, SimRobot at dt 1 ms in 2 substeps, 1,500 ticks with a TraceBuffer:
   at most 15 failed ticks, the left EE's error after tick 500 of mean
   < 0.05 m and max < 0.12 m, tau_desired within +/-(tau_max + 1e-4) on
   every solved tick, the trace flushed with 1,500 rows; 3 NS launches a
   tick (the tick's Binv and one a plant substep, + on_start's), 0 plain
   inverses, 0 level launches; LoopStats p50 / p99 / mean ms and deadline
   misses against 1 ms, the plant alone and the control share. The same
   1,500 ticks in the benchmark's configuration
   (benchmark/configs/dual_arm_qppvm.yaml: the level kernel's profile,
   rho_updates 0, iters 60) under the same gates, with 2 level launches a
   tick, 0 fallbacks in the ticks (on_start's 2 polished levels run the
   plain solver) and 3 NS launches a tick; its p50 / p99 / mean ms. The
   first 5 torques held to the same ticks with the plain NS inverse; 5
   ticks in the level kernel's profile (rho_updates 0) chained
   from one on_start: 2 level launches and 0 fallbacks a tick, tau held to
   the plain level solver's chain at phase 3's bars. Config 1, the arm
   (iters 40) holding home for 500 ticks: no failure, |q - q_home| < 0.05,
   |qd| < 0.5, |tau| <= tau_max + 1e-4; ms a tick;
12. the quadruped's first walk stride, as tests/test_gait_walk.py sets it
   up (friction cones at mu 0.5, switchable contacts, iters 60; SimRobot at
   dt 1 ms in 2 substeps; the walk's LegLiftPhases, shift_mode "edge",
   touch_depth 0.012), n_strides 1: 1,750 ticks and the 300-tick tail,
   the controller reading only runtime/estimator.py's FloatingBaseEstimator
   (its gates the previous tick's references), in the level kernel's
   profile (rho_updates 0); 2 level launches, 0 fallbacks and 2 NS launches
   a tick; gated on 0 solver failures, foot_hl advanced >= 75% of 6 cm,
   the stance feet within 2 cm, up > 0.98, base z within 0.08 m, every
   foot's fz >= 10 N (within 1e-3) on the last tick, the estimate within
   2 cm of the plant's base on every tick; the first 5 torques held to the
   same loop through the plain level solver; the tick's stages (estimator,
   refs_at, control, plant) timed;
13. the async plan/act pipeline (runtime/async_mpc.py) on the humanoid, as
   tests/test_async_mpc.py runs it (400 ticks, the shove at tick 150,
   replan_ticks 20) with phase 6's planner (512 samples x 8 steps through
   the level kernel) on a worker thread and a CUDA stream of its own;
   gated on >= 3 launches and commits, every age after the first commit
   > 0, max age >= 20, every committed plan's solver_fail_frac 0, no
   failed tick, upright; 16 level launches and 1 NS launch a plan, 2 NS
   launches a tick, 2 fallbacks a tick (the tick's default profile runs
   qp.solve); the tick's p50 / p99 with a plan in flight and
   without, the commit latencies;
14. the entry points: run.main on configs 1 to 4 for 20 ticks and on
   config 5 with one 512 x 8 plan (16 level launches, 1 NS launch, 4
   fallbacks: on_start's), each JSON line's keys, finite numbers,
   the card's name and (floating bases) the final base z within 0.05 m of
   the standing height; then runtime/native.py's NativeExecutor driving
   the quadruped's tick for 100 ticks at a 100 ms period, its torques
   traced through the native ring; the executor's deadline stats;
15. the centroidal DDP planner (mpc/ddp_mpc.py): the iLQR on
   tests/test_ilqr.py's LQR problem in float32 (120 NS launches, cost and
   gains held to the Riccati solution); one quadruped plan and one
   humanoid plan (l_sole, r_sole) at tests/test_ddp_mpc.py's config
   (horizon 15, 4 iterations) each held to the same plan on the CPU (76
   NS launches, 0 plain inverses); the default
   config (horizon 40, 8 iterations, 361 NS launches a plan) timed on the
   quadruped and the humanoid; then tests/test_ddp_mpc.py's squat, 600
   ticks at B 1 with a plan every 20 in the level kernel's profile (2
   level and 4 NS launches a tick, 76 a plan), gated as the test (no
   failure, the plan's end within 5 mm of the target, the CoM down more
   than 8 mm), and tests/test_force_plan_tracking.py's loop with the
   plan's forces in ForceReg (normal-force tracking error < 0.25); each
   loop's first 5 torques held to the plain level solver's; ms a tick, the
   plant alone, ms a plan;
16. the URDF loader and ModelInterface: the 7-DoF arm of
   tests/test_mujoco_crosscheck.py (links named arm1_1 ... arm1_7) and
   tests/test_urdf.py's two-link arm on a floating base, every query on
   the card against the CPU; run.main on config 1 with the arm's URDF in
   place of zoo: arm7, 20 ticks.
17. the multi-rank dryrun (qppvm_tpu_torch/dryrun.py, the counterpart of
   __graft_entry__.py::dryrun_multichip): 4 gloo ranks of one process
   group, all on the card, plan the humanoid's MPPI step with 64 samples
   a rank at horizon 8 (pushes, mass and friction randomized), each rank
   rolling its share out through the level kernel, on a 1-D mesh and on a
   (2, 2) mesh, two plans each: solver_fail_frac 0, a finite cost, 16
   level launches, 1 NS launch and 0 fallbacks a plan on every rank,
   U_new bitwise the same on every rank and within 1e-4 (U) and 1e-3
   relative (cost_mean) of the same plan in one process; each mesh's plan
   ms;
18. (a) ring_rollout (parallel/ring_horizon.py) on 4 ranks over the
   quadruped's real rollout step through the level kernel, as
   tests/test_ring_real_rollout.py: at sweeps = S the outputs and final
   state match the sequential rollout (rtol 1e-5, atol 1e-6), the defect
   is below 1e-5 and does not grow from 1 sweep to S, no QP step fails,
   2 level launches a step on every rank; its ms at 1 and S sweeps;
   (b) runtime/logger.py::scan_with_stream over the quadruped's closed
   loop (tests/test_trace_stream.py's set-up, 64 ticks in chunks of 16):
   every channel bitwise the per-tick dispatch's, one host copy a chunk,
   one NS launch a tick (the plant); (c) bench_util's matrix-product FLOP
   count of the humanoid's tick at B 1024 and of the 512 x 8 plan, equal
   through the level kernel and the plain level solver, with its MFU.

Phases 2 to 4 run alone, so their device times are the kernels' own. Then
phases 9, 11 and 15, the longest host-bound loops, and phases 17 and
18 (a), whose ranks are processes of their own, run in processes of their
own (``python3 chip_smoke.py --phase capture`` / ``--phase qppvm`` /
``--phase ddp`` / ``--phase parallel``, which run that phase alone) beside
phases 5 to 14, 16 and 18 (b, c) in this one; each phase
sets and reads the launch counts of its own process, and its output and
model-sweep launches by path are printed and gathered when it ends.

Prints the card's name and power limit, a JSON line describing the kernels,
then, as the last line, {"ok": true, "device": {...}}. Exits non-zero
without that line when there is no CUDA device or any phase fails.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
B = 1024
TICKS = 5
REPS = 12
CONTACTS = ("l_sole", "r_sole")
RT_PROFILE = dict(rho_updates=0, warm_kinv_iters=4, cold_ns_iters=10,
                  scale_iters=2, pinv_ns_iters=5)
# humanoid level shapes (n, m, head eqs, tail eqs), one without equalities,
# and one with 54 inequality rows, more than the 48 of one product tile
MAIN_SHAPES = [(44, 12, 6, 0), (44, 18, 6, 6)]
LEVEL_SHAPES = MAIN_SHAPES + [(44, 12, 0, 0), (44, 66, 6, 6)]
# the level kernel's error in the kernels line: the solution, the
# multipliers, the KKT inverse and the rho_scale the next solve reads; the
# raw rho_scale's gap is float32 noise the bars excuse
# (opt/level_qp_parity.py), printed on each phase's line and not counted
ERR_OUTPUTS = ("x", "z", "y", "Kinv", "carried_rho_scale")
# the ForceAccExample robots' level shapes, each at B 1024 and B 1 and
# timed: the quadruped's reference stack (n 34, kernel tile R 3), the
# centaur's with friction cones (n 49, R 4), and an n 49 level with more
# inequality rows than one R 4 product covers (74 > 64)
ROBOT_SHAPES = {(34, 18, 6, 0): "quadruped", (34, 24, 6, 6): "quadruped",
                (49, 26, 6, 0): "centaur", (49, 32, 6, 6): "centaur",
                (49, 80, 6, 6): "n 49, 74 inequality rows",
                (50, 22, 6, 0): "capture", (50, 28, 6, 6): "capture",
                (15, 15, 0, 0): "dual_arm", (15, 21, 0, 6): "dual_arm",
                (7, 7, 0, 0): "arm7", (7, 13, 0, 6): "arm7"}
ROBOTS = ("quadruped", "centaur", "capture", "dual_arm", "arm7")
# the QPPVM stack's levels (phase 11): level 0 the torque box alone (n
# rows), level 1 the box and level 0's 3 + 3 EE rows locked as tail
# equalities; solved in QPPVMPlugin's profile with rho_updates 0, the
# level kernel's (iters 60, 12 warm NS iterations, 5 Ruiz passes, 7
# pseudo-inverse steps), on problems whose tail rows are feasible locks
# (level_qp_parity.random_problems(locks=True))
QPPVM_ROBOTS = ("dual_arm", "arm7")
QPPVM_LEVEL = dict(iters=60, warm_kinv_iters=12, scale_iters=5,
                   pinv_ns_iters=7)
FEET = ("foot_fl", "foot_fr", "foot_hr", "foot_hl")
# level solver: the CUDA kernel, or its plain version (``plain_levels``)
BACKENDS = ("kernel", "torch")
# tau of the kernel chain vs the plain chain: float32 sums in another order
# through 5 chained 12-iteration solves; a wrong row moves tau by O(1) Nm
TAU_ATOL, TAU_RTOL = 5e-3, 1e-3
# the MPC rollout's level profile (mpc/rollout.py with bench_mpc.py's
# qp_iters 12 and 8 warm NS iterations): no z clip, no cold NS budget
ROLLOUT_LEVEL = dict(warm_kinv_iters=8, cold_ns_iters=None, z_clip=False,
                     scale_iters=2, pinv_ns_iters=5)
# each rollout's cost and the MPPI plan U_new, level kernel vs plain level
# solver on the same samples, over MPC_DRAWS draws: float32 sums in another
# order through 8 chained steps (the gaps this phase prints on an H100 are
# in PERF.md); a wrong level solve moves a cost by whole units
MPC_COST_ATOL, MPC_COST_RTOL, MPC_U_ATOL = 1e-3, 1e-3, 1e-5
# NS inverse: bench_pallas.py's shape and tests/test_pallas_linalg.py's bars
NS_B, NS_N, NS_ITERS = 1024, 64, 26
NS_ATOL, NS_RTOL, NS_RESID = 2e-4, 2e-3, 5e-3
LOOP_TICKS, KERNEL_LOOP_TICKS, LOOP_COMPARE = 500, 100, 5
MPC_REPS = 3
# phase 7: the centaur's friction cones (the bar of the reference's
# tests/test_force_acc_e2e.py on wrenches: in the cone and fz >= fz_min
# within 1e-3 N)
CENTAUR_MU, FZ_MIN, CONE_TOL = 0.7, 10.0, 1e-3
# phase 8: the quadruped's stand and squat, as tests/test_force_acc_e2e.py
# drives it (dt 1 ms, 4 substeps, squat 0.05 m), at 400 ticks with the
# squat from tick 200; the normal forces averaged over ticks 50 to 199;
# the plant alone timed over 100 ticks
QUAD_TICKS, QUAD_SUBSTEPS, QUAD_SIM_TICKS = 400, 4, 100
SQUAT_FROM, SQUAT_DEPTH, FZ_WINDOW = 200, 0.05, (50, 200)
# device sleep ahead of timed kernel launches: about 10 ms at 2 GHz, ample
# for the host to queue 20 launches of a wrapper
LEAD_CYCLES = 20_000_000
MPC_DRAWS = 3
# one H100 SXM (NVIDIA's data sheet): float32 outside the tensor cores,
# dense TF32 on them, HBM3
# bars on the NS kernel's time (ms) at each phase 4 shape, printed and not
# gated: a slow kernel that is right stays
NS_BARS_MS = (1.0, 0.107, 0.60) + (None,) * 8
# phase 9: tests/test_capture_step.py on the humanoid. The plugin (6D
# wrenches in friction cones at mu 0.6, switchable contacts, iters 40; its
# level shapes, n 50, are the "capture" ROBOT_SHAPES), the single-support
# set-up (LegLiftScript on l_sole, held 100 ticks past its lift), the shove
# (base_vel[4] += 1.2 m/s), the plant-fidelity planning horizon (100 steps
# of 0.01 s in 8 substeps at the plant's stiction) and the candidate library
CAPTURE_PLUGIN = dict(contact_links=CONTACTS, waist_link="pelvis", iters=40,
                      switchable_contacts=True, use_friction_cones=True,
                      mu=0.6, wrench_dim=6, foot_tasks_6d=False)
CAPTURE_PHASES = dict(settle=150, shift=450, dwell=150, unload=180,
                      lift=250, hold=600, lower=250, reload=200)
CAPTURE_SCRIPT = dict(lift_height=0.04, swing_kp=100.0, swing_w=3.0)
CAPTURE_HOLD_EXTRA, PUSH_VY = 100, 1.2
CAPTURE_ROLLOUT = dict(horizon=100, qp_iters=30, dt=0.01, sim_substeps=8,
                       contact_kp=2e4, contact_kd=300.0, contact_kt=2e4,
                       contact_kd_t=1500.0, stop_kp=2e3, stop_kd=20.0,
                       fail_tol=0.2)
CAPTURE_CANDIDATES = {
    "null": None,   # the primitive's init_theta: keep holding
    "cross_near": {"swing": [-8.0, 3.0], "t0": -3.0, "dxy": [0.05, 0.05]},
    "cross_far": {"swing": [-8.0, 3.0], "t0": -3.0, "dxy": [0.05, 0.15]},
    "replant_down": {"swing": [3.0, -8.0], "t0": -3.0, "dxy": [0.05, 0.10]}}
# the JAX package's ranking on a CPU, recorded in tests/test_capture_step.py
CAPTURE_JAX_RANKING = ("cross_near 3482 < cross_far 5029 < replant_down "
                       "5173 < null 6438")
# each candidate's cost, level kernel vs plain level solver: float32 sums
# in another order through 100 chained steps of 8 substeps (largest gap
# 1.51e-3 on an H100, the others in PERF.md); a wrong level solve or warm
# start moves a cost by tens of percents and reorders the library
CAPTURE_COST_RTOL = 1e-2
# the closed loop: lean-only runs until it falls (up < 0.7), the chosen
# step fall tick + CAPTURE_STEP_EXTRA ticks, the waist reference pulled
# halfway to the feet's mean every CAPTURE_WAIST_EVERY ticks; the plant
# alone timed over CAPTURE_SIM_TICKS ticks
CAPTURE_MAX_TICKS, CAPTURE_STEP_EXTRA, CAPTURE_WAIST_EVERY = 1300, 200, 40
FALL_UP, UPRIGHT_UP, STEP_MIN_M, RT_FAIL_SHARE = 0.7, 0.9, 0.05, 0.05
CAPTURE_SIM_TICKS = 100
# phase 10: tests/test_mpc_scenarios.py's quadruped (switchable contacts,
# friction cones at mu 0.5, iters 40) with
# test_step_recovery_decision_channel's MPPI and rollout settings at
# bench_mpc.py's 512 samples; theta of the plain plan against the
# kernel's within MPC_U_ATOL of each entry's scale (1 + |theta|)
QUAD_MPC_PLUGIN = dict(contact_links=FEET, waist_link="pelvis", iters=40,
                       switchable_contacts=True, use_friction_cones=True,
                       mu=0.5, foot_tasks_6d=False)
STEP_MPPI = dict(n_samples=512, horizon=12, noise_std=0.2,
                 step_recovery=True, theta_noise_std=1.5, dxy_noise_std=0.1)
STEP_ROLLOUT = dict(horizon=12, qp_iters=40, dt=0.04, sim_substeps=4, mu=1.3)
# test_gate_sequence_inside_horizon's rollout, foot_fl ramped off over the
# first 3 of 8 steps
GATE_ROLLOUT = dict(horizon=8, qp_iters=20, dt=0.02, sim_substeps=2)
# one plant step's udot, NS kernel vs plain inverse: float32 rounding through
# a mass matrix of condition ~1e4 after two refinement steps (the bar of
# tests/test_torch_sim.py for accelerations); a wrong inverse moves udot by
# O(1) of its scale
UDOT_REL = 1e-3
# phase 11: tests/test_qppvm_e2e.py's QPPVM runs through
# runtime/plugin.py::ControlLoop. Config 2: the dual arm on the
# reference's moving sinusoid, 1,500 ticks of dt 1 ms in 2 substeps;
# gated after tick 500 on the left EE's error, with at most 15 failed
# ticks; tau_desired inside +/-(tau_max + 1e-4) on every tick that did
# not fail. Config 1: the arm holding home for 500 ticks. The plant alone
# timed over QPPVM_SIM_TICKS ticks; the kernel-against-plain checks run
# QPPVM_COMPARE ticks.
QPPVM_TICKS, QPPVM_SETTLE, QPPVM_MAX_FAILS = 1500, 500, 15
QPPVM_ERR_MEAN, QPPVM_ERR_MAX, TAU_LIMIT_TOL = 0.05, 0.12, 1e-4
ARM7_TICKS, ARM7_Q_TOL, ARM7_QD_TOL = 500, 0.05, 0.5
QPPVM_SIM_TICKS, QPPVM_COMPARE = 200, 5
# the benchmark's QPPVM configuration (cell dual_arm-qppvm-b1): the same
# sinusoid in the level kernel's profile, read as a scenario file
QPPVM_BENCH_CONFIG = ROOT / "benchmark" / "configs" / "dual_arm_qppvm.yaml"
# phases run in processes of their own, beside phases 5 to 14 in this one,
# once phases 2 to 4 (the kernels' device times) are done: the two longest
# host-bound loops; each ends by printing RESULT_TAG and its result
SIDE_PHASES = ("capture", "qppvm", "ddp", "parallel")
RESULT_TAG = "chip_smoke phase result: "
# phase 17: qppvm_tpu_torch/dryrun.py on 4 gloo ranks of the card, two
# plans a mesh (the first gated on its launches, the last timed), held to
# the same plan in one process at tests/test_mpc_parallel.py:114-117's
# bars; phase 18 (a): tests/test_ring_real_rollout.py's quadruped and
# rollout (the level kernel at B 1) under ring_rollout on 4 ranks, held to
# the sequential rollout at that test's bars
PARALLEL_RANKS, DRYRUN_REPS = 4, 2
DRYRUN_U_ATOL, DRYRUN_COST_RTOL = 1e-4, 1e-3
RING_PLUGIN = dict(contact_links=("foot_fl", "foot_fr", "foot_hr", "foot_hl"),
                   waist_link="pelvis", iters=20, use_friction_cones=True,
                   mu=0.5, foot_tasks_6d=False)
RING_ROLLOUT = dict(horizon=8, dt=0.01, qp_iters=12)
RING_RTOL, RING_ATOL, RING_DEFECT = 1e-5, 1e-6, 1e-5
# phase 18 (b): tests/test_trace_stream.py's loop, its T and CHUNK
STREAM_TICKS, STREAM_CHUNK = 64, 16
# phase 12: tests/test_gait_walk.py's quadruped (friction cones at mu 0.5,
# switchable contacts, position-only feet tasks, iters 60) in the level
# kernel's profile (rho_updates 0: the JAX package's first stride is as
# healthy there as in the default profile, on a CPU), SimRobot at dt 1 ms
# in 2 substeps, closed on FloatingBaseEstimator; the walk's first stride
# (n_strides 1: WALK_PHASES, 1,750 ticks) and the settled tail. Gates: the
# swing foot advanced >= 75% of the 6 cm stride, each stance foot within
# 2 cm of where it stood, upright, base z within 0.08 m, every foot's fz
# >= 10 N within 1e-3 on the last tick, the estimate within 2 cm of the
# plant's base position on every tick
WALK_PLUGIN = dict(contact_links=FEET, waist_link="pelvis", iters=60,
                   switchable_contacts=True, use_friction_cones=True, mu=0.5,
                   foot_tasks_6d=False)
WALK_PROFILE = dict(rho_updates=0)
WALK_PHASES = dict(settle=100, shift=600, dwell=100, unload=150, lift=250,
                   hold=0, lower=300, reload=250)
WALK_GAIT = dict(order=("foot_hl", "foot_fl", "foot_hr", "foot_fr"),
                 stride=(0.06, 0.0), n_strides=1, shift_mode="edge",
                 touch_depth=0.012)
WALK_TAIL, WALK_SUBSTEPS = 300, 2
WALK_SWING, WALK_SWING_SHARE, WALK_STANCE_MAX = "foot_hl", 0.75, 0.02
WALK_UP, WALK_DZ, WALK_EST_ERR = 0.98, 0.08, 0.02
# the JAX package's first stride, run on a CPU (recorded in CHANGES.md)
WALK_JAX = ("foot_hl +0.05899 m, stance feet moved <= 0.0089 m, up 0.99937, "
            "dz -0.00266 m, last fz [97.4, 176.0, 126.1, 51.7] N, 0 failures")
# phase 13: tests/test_async_mpc.py's pipeline on the humanoid (iters 40,
# SimRobot at dt 1 ms in 2 substeps, the shove base_vel[4] += 0.2 at tick
# 150, a re-plan every 20 ticks) with phase 6's planner
# (mpc/humanoid_plan.py: 512 samples x horizon 8, 30 N pushes, rollout
# steps of 10 ms at qp_iters 12 with 8 warm NS iterations, its levels
# through the level kernel), consumed 10 ticks a step
ASYNC_PLUGIN = dict(contact_links=CONTACTS, waist_link="pelvis", iters=40)
ASYNC_MPPI = dict(n_samples=512, horizon=8, push_std=30.0)
ASYNC_ROLLOUT = dict(horizon=8, qp_iters=12, qp_warm_kinv_iters=8)
ASYNC_TICKS, ASYNC_SHOVE, ASYNC_REPLAN, ASYNC_TICKS_PER_STEP = 400, 150, 20, 10
# phase 14: run.main on the shipped configurations, and the native paced
# executor driving the quadruped's tick (tests/test_native_runtime.py's
# loop: the default stack, iters 40, 2 substeps) with its trace through the
# native ring
RUN_CONFIGS = ("config1_arm7", "config2_dual_arm", "config3_biped",
               "config4_humanoid")
RUN_SECONDS, RUN_Z_TOL = "0.02", 0.05
RUN_MPC = ("config5_mpc", ["--samples", "512", "--horizon", "8",
                           "--mpc-steps", "1"])
# phase 15: the centroidal DDP planner (mpc/ddp_mpc.py) on the quadruped.
# tests/test_ddp_mpc.py's planner (horizon 15 of 0.02 s, 4 iterations) and
# its squat: the CoM target 4 cm below the standing CoM, a plan every 20
# ticks, the planned CoM 5 steps ahead as the waist reference, 600 ticks of
# the plugin at iters 40 in the level kernel's profile (the JAX package's
# loop passes the test's gates in that profile on a CPU: 0 failures, dz
# -0.0124 m, the plan's end 1.8 mm off the target) on SimRobot at dt 1 ms
# in 4 substeps; then the same with the plan's forces in ForceReg
# (tests/test_force_plan_tracking.py, weight 5). The planner's default
# config (horizon 40, 8 iterations) timed on the quadruped and the
# humanoid; tests/test_ilqr.py's LQR problem on the card
DDP_TEST = dict(horizon=15, dt=0.02, iterations=4)
DDP_PROFILE = dict(rho_updates=0)
DDP_TICKS, DDP_PLAN_EVERY, DDP_DEPTH, DDP_WAIST_K = 600, 20, 0.04, 5
DDP_FORCE_W, DDP_PLAN_REPS, DDP_SIM_TICKS = 5.0, 3, 100
# the tests' gates: the plan's end within 5 mm of the target, the CoM
# down > 8 mm, the commanded normal forces within 25% of the plan's
DDP_END_TOL, DDP_DZ_MAX, DDP_TRACK_MAX = 0.005, -0.008, 0.25
# a plan on the card against the same plan on the CPU (float32, plain
# inverses): each field's gap over (1 + its largest entry); k, the
# converged feed-forward, is float32 noise (1e-4 of the forces), held on
# the forces' scale. A wrong inverse or a flipped line-search decision
# moves U by whole newtons and reg by a factor 10 or more
DDP_PLAN_BARS = (("U", 1e-3), ("X", 1e-3), ("K", 1e-2), ("cost", 1e-5),
                 ("reg", 1e-6))
# tests/test_ilqr.py's LQR problem: the cost within 1e-3 of the Riccati
# policy's, the final gains within 1e-3 of their scale of the Riccati gains
# (the final LM regularization moves them by up to 2e-3 of it in float64)
LQR_COST_RTOL, LQR_GAIN_REL = 1e-3, 1e-3
# phase 16: the URDF loader and ModelInterface on the card.
# tests/test_mujoco_crosscheck.py's 7-DoF arm with its links named as
# zoo.arm7's (config 1's stack: end effector arm1_7, elbow arm1_4), and
# tests/test_urdf.py's two-link arm loaded with a floating base; every query
# on the card against the same on the CPU, float32, each output within
# LOADER_REL of (1 + its largest entry)
LOADER_REL = 1e-5
URDF_ARM1 = """<robot name="xarm">
  <link name="base"/>
  <link name="arm1_1"><inertial><origin xyz="0.02 -0.01 0.11"/>
    <mass value="3.1"/><inertia ixx="0.031" iyy="0.027" izz="0.012"
    ixy="0.002" ixz="-0.001" iyz="0.003"/></inertial></link>
  <link name="arm1_2"><inertial><origin xyz="-0.01 0.03 0.14"/>
    <mass value="2.4"/><inertia ixx="0.022" iyy="0.019" izz="0.008"
    ixy="-0.001" ixz="0.002" iyz="0.001"/></inertial></link>
  <link name="arm1_3"><inertial><origin xyz="0.015 0.0 0.12"/>
    <mass value="1.9"/><inertia ixx="0.015" iyy="0.014" izz="0.005"
    ixy="0.001" ixz="0" iyz="-0.002"/></inertial></link>
  <link name="arm1_4"><inertial><origin xyz="0 0.02 0.1"/>
    <mass value="1.4"/><inertia ixx="0.009" iyy="0.008" izz="0.003"
    ixy="0" ixz="0.001" iyz="0"/></inertial></link>
  <link name="arm1_5"><inertial><origin xyz="0.01 0 0.08"/>
    <mass value="0.9"/><inertia ixx="0.004" iyy="0.004" izz="0.002"
    ixy="0" ixz="0" iyz="0.001"/></inertial></link>
  <link name="arm1_6"><inertial><origin xyz="0 -0.01 0.06"/>
    <mass value="0.6"/><inertia ixx="0.002" iyy="0.002" izz="0.001"
    ixy="0" ixz="0" iyz="0"/></inertial></link>
  <link name="arm1_7"><inertial><origin xyz="0 0 0.04"/>
    <mass value="0.3"/><inertia ixx="0.001" iyy="0.001" izz="0.0005"
    ixy="0" ixz="0" iyz="0"/></inertial></link>
  <joint name="q1" type="revolute"><parent link="base"/><child link="arm1_1"/>
    <origin xyz="0 0 0.15"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3" effort="150" velocity="4"/></joint>
  <joint name="q2" type="revolute"><parent link="arm1_1"/>
    <child link="arm1_2"/>
    <origin xyz="0.05 0 0.22" rpy="0.3 0 0"/><axis xyz="0 1 0"/>
    <limit lower="-2.2" upper="2.2" effort="150" velocity="4"/></joint>
  <joint name="q3" type="revolute"><parent link="arm1_2"/>
    <child link="arm1_3"/>
    <origin xyz="0 0.04 0.28" rpy="0 -0.2 0.1"/><axis xyz="1 0 0"/>
    <limit lower="-2.8" upper="2.8" effort="100" velocity="5"/></joint>
  <joint name="q4" type="revolute"><parent link="arm1_3"/>
    <child link="arm1_4"/>
    <origin xyz="0.03 0 0.24"/><axis xyz="0 1 0"/>
    <limit lower="-2.5" upper="2.5" effort="80" velocity="5"/></joint>
  <joint name="q5" type="revolute"><parent link="arm1_4"/>
    <child link="arm1_5"/>
    <origin xyz="0 0 0.2" rpy="0.1 0.1 0"/><axis xyz="0 0 1"/>
    <limit lower="-3" upper="3" effort="40" velocity="6"/></joint>
  <joint name="q6" type="revolute"><parent link="arm1_5"/>
    <child link="arm1_6"/>
    <origin xyz="0 0.02 0.16"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2" effort="25" velocity="6"/></joint>
  <joint name="q7" type="revolute"><parent link="arm1_6"/>
    <child link="arm1_7"/>
    <origin xyz="0 0 0.12"/><axis xyz="1 0 0"/>
    <limit lower="-2.8" upper="2.8" effort="12" velocity="8"/></joint>
</robot>
"""
URDF_2LINK = """<robot name="twolink">
  <link name="base"/>
  <link name="l1"><inertial><origin xyz="0 0 0.25"/><mass value="2.0"/>
    <inertia ixx="0.05" iyy="0.05" izz="0.001" ixy="0" ixz="0" iyz="0"/>
  </inertial></link>
  <link name="l2"><inertial><origin xyz="0 0 0.2"/><mass value="1.0"/>
    <inertia ixx="0.02" iyy="0.02" izz="0.001" ixy="0" ixz="0" iyz="0"/>
  </inertial></link>
  <link name="tool"><inertial><origin xyz="0 0 0.05"/><mass value="0.3"/>
    <inertia ixx="0.001" iyy="0.001" izz="0.001" ixy="0" ixz="0" iyz="0"/>
  </inertial></link>
  <joint name="j1" type="revolute"><parent link="base"/><child link="l1"/>
    <origin xyz="0 0 0.1"/><axis xyz="0 1 0"/>
    <limit lower="-2" upper="2" effort="100" velocity="5"/></joint>
  <joint name="j2" type="revolute"><parent link="l1"/><child link="l2"/>
    <origin xyz="0 0 0.5"/><axis xyz="0 1 0"/>
    <limit lower="-2.5" upper="2.5" effort="60" velocity="5"/></joint>
  <joint name="jt" type="fixed"><parent link="l2"/><child link="tool"/>
    <origin xyz="0 0 0.4" rpy="0 0 1.0"/></joint>
</robot>
"""
# (label, text, load_urdf options, links queried)
LOADER_ROBOTS = (("xarm", URDF_ARM1, {}, ("arm1_7", "arm1_4")),
                 ("two_link_floating", URDF_2LINK, {"floating": True},
                  ("tool", "l1")))
EXEC_TICKS, EXEC_PERIOD_S, EXEC_Z_TOL = 100, 0.1, 0.05


# the program's counters (qppvm_tpu_torch/telemetry.py) the phases reset
# and read: level and NS kernel launches, levels outside the level kernel's
# profile, plain mass-matrix inverses of CUDA tensors, streamed host copies,
# model-sweep launches and CUDA model updates outside the kernel
LEVEL, NS, FALLBACK = "level_qp.launch", "ns_inverse.launch", \
    "cascade.fallback"
PLAIN, COPY = "model.plain_inverse", "logger.host_copy"
SWEEP, PLAIN_SWEEP = "model_sweep.launch", "model.plain_sweep"
# ticks replayed through the tick's CUDA graph, and its captures
REPLAY, CAPTURE = "tick_graph.replay", "tick_graph.capture"
# phase 19: (robot, B) of the benchmark's cells and of the MPPI rollout;
# the bar of tests/test_torch_model_sweep.py, max |a - r| / max(max |r|, 1)
# an item
SWEEP_SHAPES = (("humanoid", 1), ("centaur", 1024), ("humanoid", 4096))
SWEEP_BAR = 5e-5
# each path's model-sweep launches, for the kernels line (``gate_sweeps``)
SWEEPS = {}


def zero(*names):
    """Set the named counters back to 0."""
    from qppvm_tpu_torch import telemetry
    telemetry.reset(*names)


def counted(name) -> int:
    """The count of ``name`` since it was last set back to 0."""
    from qppvm_tpu_torch import telemetry
    return telemetry.counts()[name]


def gate_sweeps(path, expected, plain=0) -> int:
    """The model-sweep launches since ``zero(SWEEP, PLAIN_SWEEP)``, kept
    in SWEEPS under ``path``; fails unless they are ``expected`` and the
    CUDA model updates outside the kernel are ``plain`` (the ForceAcc
    on_starts in the window)."""
    got = (counted(SWEEP), counted(PLAIN_SWEEP))
    if got != (expected, plain):
        fail(f"{path}: {got[0]} model-sweep launches and {got[1]} plain "
             f"sweeps, expected {expected} and {plain}")
    SWEEPS[path] = got[0]
    return got[0]


def gate_graph(path, ticks, captures=0) -> None:
    """The tick's CUDA graph since ``zero(REPLAY, CAPTURE)`` over a window
    of ``ticks`` plugin ticks: fails unless it made ``captures`` captures
    (one where the window starts a layout: its first tick runs eagerly,
    its second captures) and replayed every other tick."""
    got = (counted(REPLAY), counted(CAPTURE))
    if got != (ticks - captures, captures):
        fail(f"{path}: {got[0]} tick-graph replays and {got[1]} captures "
             f"over {ticks} ticks, expected {ticks - captures} and "
             f"{captures}")
    print(f"tick graph, {path}: {got[0]} replays of {ticks} ticks, "
          f"{got[1]} captures")


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_time_ms(torch, fn, reps=20, lead=False):
    """Mean ms of ``fn`` over ``reps`` runs between CUDA events. With
    ``lead`` the stream first sleeps for LEAD_CYCLES, so the host has queued
    every run before the start event and the events time the device alone
    (at B = 1 a wrapper's host time exceeds its kernel's)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    if lead:
        torch.cuda._sleep(LEAD_CYCLES)
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


def plain_levels():
    """A patch under which every level the level kernel takes runs its
    plain version (``level_qp.solve_level_reference``) in place of the
    launch: the plain side of each kernel-against-plain comparison."""
    from qppvm_tpu_torch.opt import level_qp
    return mock.patch.object(level_qp, "_launch",
                             level_qp.solve_level_reference)


def routed(b, fn):
    """``fn`` with its levels through level solver ``b`` of BACKENDS: the
    kernel as built, or under ``plain_levels``."""
    if b == "kernel":
        return fn

    def call(*args, **kwargs):
        with plain_levels():
            return fn(*args, **kwargs)
    return call


def on_route(b, obj, method="_step_impl"):
    """``obj`` with ``method`` through level solver ``b`` (``routed``)."""
    setattr(obj, method, routed(b, getattr(obj, method)))
    return obj


def main_path_inputs(torch, dev, model, contacts, **options):
    """A batched tick's set-up on ``dev``: a ForceAccPlugin per level
    solver on ``model`` with ``options`` and the RT profile, and the tick's
    inputs (states with q perturbed by 0.01 N(0, 1), references and warm
    state from the kernel plugin's on_start, expanded to B)."""
    from qppvm_tpu_torch.mpc.rollout import standing_state
    from qppvm_tpu_torch.opt import qp
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin

    plugins = {b: on_route(b, ForceAccPlugin(
        model, contact_links=contacts, waist_link="pelvis", iters=12,
        solver_opts=RT_PROFILE, **options)) for b in BACKENDS}
    st = standing_state(model, contacts)
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


def chain(torch, plugin, states, refs, warm, label, check=None):
    """TICKS chained batched ticks, each gated on zero solver failures,
    finite torques of the right shape and ``check(aux)``. Returns the
    torques and the largest relative primal residual."""
    taus, prim_max = [], 0.0
    for k in range(TICKS):
        tau, warm, aux = plugin._step_impl(states, refs, warm)
        fail_frac = float(aux.solver_failed.float().mean())
        if fail_frac != 0.0 or not bool(torch.isfinite(tau).all()):
            fail(f"{label} tick {k}: solver_fail_frac={fail_frac}, "
                 f"finite tau={bool(torch.isfinite(tau).all())}")
        if tuple(tau.shape) != (B, plugin.model.nj):
            fail(f"{label} tau shape {tuple(tau.shape)}")
        if check is not None:
            check(k, aux)
        prim_max = max(prim_max, float(aux.prim_res.max()))
        taus.append(tau)
    return taus, prim_max


def compare_taus(torch, taus, taus_ref, label):
    """Each tick's torques within TAU_ATOL + TAU_RTOL |tau| of the plain
    chain's; returns the largest gap."""
    tau_err = 0.0
    for k, (a, r) in enumerate(zip(taus, taus_ref)):
        err = float((a - r).abs().max())
        tau_err = max(tau_err, err)
        if not torch.all((a - r).abs() <= TAU_ATOL + TAU_RTOL * r.abs()):
            fail(f"{label} tick {k}: tau differs from the plain chain by "
                 f"{err:.3g} Nm")
    return tau_err


def check_level_phase(torch, parity, level_qp, cfg, prob, state, label,
                      phases=("cold", "warm"), excuse=False):
    """Kernel vs plain version from ``state``, each phase warm-started from
    the kernel's own output state. Returns (max abs error over
    ERR_OUTPUTS, last state); every gap, the raw rho_scale's too, is
    printed. ``excuse``: the float32-undetermined items of the QPPVM
    shapes are held to the plain version's own float32 error
    (``level_qp_parity.check_level_outputs``)."""
    max_err = 0.0
    for phase in phases:
        out = level_qp.solve_level(cfg, *prob, *state)
        torch.cuda.synchronize()
        try:
            errs = parity.check_level_outputs(cfg, prob, state, out, excuse)
        except AssertionError as e:
            fail(f"{label} {phase}: {e}")
        print(f"kernel vs plain {label} {phase}: max abs "
              + " ".join(f"{k}={v:.3g}" for k, v in errs.items()))
        max_err = max(max_err, max(errs[k] for k in ERR_OUTPUTS))
        state = out[:5]   # warm: the kernel's own state, rho_scale too
    return max_err, state


def time_level(torch, level_qp, cfg, prob, state):
    """(kernel ms, plain ms) of one level solve from ``state``, timed in
    turns plain, kernel, kernel, plain; the kernel on the device alone."""
    run_k = lambda: level_qp.solve_level(cfg, *prob, *state)  # noqa: E731
    run_p = lambda: level_qp.solve_level_reference(cfg, *prob, *state)  # noqa
    p1 = cuda_time_ms(torch, run_p)
    k1, k2 = (cuda_time_ms(torch, run_k, lead=True) for _ in range(2))
    p2 = cuda_time_ms(torch, run_p)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_robot_levels(torch, dev, card, parity, level_qp):
    """Phase 2, continued: the level kernel against its plain version at
    ROBOT_SHAPES, B 1024 and B 1, cold then warm, in the RT profile (the
    QPPVM shapes in QPPVM_LEVEL's), timed with their bounds. Returns (max abs error, {(shape, B): (kernel ms,
    plain ms, bound ms, bound_by)})."""
    from qppvm_tpu_torch.bench_util import bound_ms, level_qp_cost

    max_err, times = 0.0, {}
    for i, ((n, m, h, t), robot) in enumerate(ROBOT_SHAPES.items()):
        profile = (QPPVM_LEVEL if robot in QPPVM_ROBOTS
                   else dict(cold_ns_iters=10))
        cfg = level_qp.LevelQPConfig(n_eq_head=h, n_eq_tail=t, **profile)
        qppvm = robot in QPPVM_ROBOTS
        for Bl in (B, 1):
            prob = parity.random_problems(Bl, n, m, h, t, dev, seed=30 + i,
                                          locks=qppvm)
            label = f"n={n} m={m} h={h} t={t} B={Bl}"
            err, state = check_level_phase(
                torch, parity, level_qp, cfg, prob,
                parity.zero_state(Bl, n, m, dev), label, excuse=qppvm)
            max_err = max(max_err, err)
            k_ms, p_ms = time_level(torch, level_qp, cfg, prob, state)
            b_ms, b_by = bound_ms(*level_qp_cost(cfg, Bl, n, m))
            times[(n, m, h, t), Bl] = (k_ms, p_ms, b_ms, b_by)
            print(f"[{card}] level {label} ({robot}): kernel "
                  f"{k_ms:.4f} ms on the device, plain PyTorch {p_ms:.4f} ms, "
                  f"bound {b_ms:.4g} ms ({b_by}), kernel at "
                  f"{100 * b_ms / k_ms:.3g}% of it")
    return max_err, times


def phase_ns_inverse(torch, dev, card):
    """Phase 4: the NS-inverse path and the kernel against its plain
    version at the bench shape, the simulators' shapes and the QPPVM
    loops' (phase 11)."""
    from qppvm_tpu_torch.bench_util import (PEAK_TF32_FLOPS, bound_ms,
                                            ns_inverse_cost)
    from qppvm_tpu_torch.model import dynamics, zoo
    from qppvm_tpu_torch.mpc.rollout import standing_state
    from qppvm_tpu_torch.opt import ns_inverse as nsi

    M = torch.tensor(np.random.default_rng(0).standard_normal(
        (NS_B, NS_N, NS_N), dtype=np.float32), device=dev)
    K = M @ M.transpose(1, 2) + 0.5 * torch.eye(NS_N, device=dev)
    zero(NS)
    X = nsi.ns_inverse(K, NS_ITERS)      # the path, as a caller drives it
    torch.cuda.synchronize()
    launches = counted(NS)
    if launches != 1:
        fail(f"ns_inverse path: {launches} kernel launches, expected 1")

    model = zoo.humanoid(device=dev)
    st = standing_state(model, CONTACTS, batch=NS_B)
    g = torch.Generator(device=dev).manual_seed(1)
    st = type(st)(q=st.q + 0.01 * torch.randn(st.q.shape, generator=g,
                                               device=dev),
                  **{f: getattr(st, f)
                     for f in ("qd", "base_rot", "base_pos", "base_vel")})
    Bm = dynamics.mass_matrix(model, st)
    Breg = Bm + 1e-9 * torch.eye(model.nv, device=dev)
    quad = zoo.quadruped(device=dev)
    st_q = standing_state(quad, FEET)
    Bq = dynamics.mass_matrix(quad, st_q) + 1e-9 * torch.eye(quad.nv,
                                                             device=dev)
    # the QPPVM tick's Binv (18 + 2 iterations) and the fixed-base plant's
    # inverse (24), at the dual arm's and the arm's home
    arms = {name: getattr(zoo, name)(device=dev) for name in QPPVM_ROBOTS}
    Ba = {name: dynamics.mass_matrix(m, m.home_state())
          for name, m in arms.items()}
    n2, n1 = arms["dual_arm"].nv, arms["arm7"].nv
    ddp_K = ddp_inverse_inputs(torch, dev)
    cases = {f"bench B={NS_B} n={NS_N} iters={NS_ITERS}": (K, NS_ITERS, X),
             f"sim B=1 n={model.nv} iters=24": (Breg[:1].contiguous(), 24,
                                                None),
             f"sim B={NS_B} n={model.nv} iters=24": (Breg, 24, None),
             # the quadruped's plant in phase 8
             f"sim B=1 n={quad.nv} iters=24": (Bq.contiguous(), 24, None),
             # phase 11's QPPVM loops
             f"qppvm Binv B=1 n={n2} iters=20": (Ba["dual_arm"], 20, None),
             f"qppvm sim B=1 n={n2} iters=24": (
                 Ba["dual_arm"] + 1e-9 * torch.eye(n2, device=dev), 24, None),
             f"qppvm Binv B=1 n={n1} iters=20": (Ba["arm7"], 20, None),
             # phase 15's planner: Q_uu and the SRBD inertia
             "ddp Quu B=1 n=12 iters=22": (ddp_K["quadruped"], 22, None),
             "ddp Quu B=1 n=6 iters=22": (ddp_K["humanoid"], 22, None),
             "ddp LQR Quu B=1 n=2 iters=22": (ddp_K["lqr"], 22, None),
             "ddp inertia B=1 n=3 iters=16": (ddp_K["inertia"], 16, None)}
    if len(NS_BARS_MS) != len(cases):
        fail(f"phase 4: {len(NS_BARS_MS)} bars for {len(cases)} shapes")
    max_err, times, bounds = 0.0, {}, {}
    for (label, (Kc, iters, Xc)), bar in zip(cases.items(), NS_BARS_MS):
        Xc = nsi.ns_inverse(Kc, iters) if Xc is None else Xc
        torch.cuda.synchronize()
        ref = nsi.ns_inverse_reference(Kc, iters)
        err = float((Xc - ref).abs().max())
        n = Kc.shape[-1]
        resid = float((Kc @ Xc - torch.eye(n, device=dev)).abs().max())
        print(f"ns_inverse kernel vs plain {label}: max abs {err:.3g}, "
              f"max |K X - I| {resid:.3g}")
        if not bool(torch.all((Xc - ref).abs()
                              <= NS_ATOL + NS_RTOL * ref.abs())):
            fail(f"ns_inverse {label}: kernel differs from the plain "
                 f"version by {err:.3g}")
        if not resid < NS_RESID:
            fail(f"ns_inverse {label}: max |K X - I| = {resid:.3g}")
        max_err = max(max_err, err) if label.startswith("bench") else max_err
        run_k = lambda: nsi.ns_inverse(Kc, iters)  # noqa: E731
        run_p = lambda: nsi.ns_inverse_reference(Kc, iters)  # noqa: E731
        p1 = cuda_time_ms(torch, run_p)
        k1, k2 = (cuda_time_ms(torch, run_k, lead=True) for _ in range(2))
        p2 = cuda_time_ms(torch, run_p)
        lib = cuda_time_ms(torch, lambda: torch.linalg.inv(Kc))
        k_ms = (k1 + k2) / 2
        # a call with the wrapper's host time: at B 1 it may exceed the
        # kernel's; the bar holds the slower of the two
        call_ms = cuda_time_ms(torch, run_k)
        times[label] = (k_ms, (p1 + p2) / 2, lib)
        # float32 products on the CUDA cores, or three TF32 products each
        # on the tensor cores; the share is of the lesser
        flops, nbytes = ns_inverse_cost(len(Kc), n, iters)
        f32 = bound_ms(flops, nbytes)
        tc = bound_ms(3 * flops, nbytes, PEAK_TF32_FLOPS)
        bounds[label] = min(f32, tc)
        print(f"[{card}] ns_inverse {label}: kernel {k_ms:.4f} ms on the "
              f"device ({call_ms:.4f} ms a call with the wrapper's host "
              f"time), plain PyTorch {times[label][1]:.4f} ms, "
              f"torch.linalg.inv {lib:.4f} ms (kernel / inv "
              f"{k_ms / lib:.3f}); bound "
              f"float32 {f32[0]:.4g} ms, 3xTF32 {tc[0]:.4g} ms "
              f"({bounds[label][1]}), kernel at "
              f"{100 * bounds[label][0] / k_ms:.3g}% of the lesser; "
              + ("no bar" if bar is None else f"bar {bar} ms " + (
                  "held" if max(k_ms, call_ms) <= bar else "MISSED")))
    bench = f"bench B={NS_B} n={NS_N} iters={NS_ITERS}"
    k_ms, p_ms, lib_ms = times[bench]
    b_ms, b_by = bounds[bench]
    return {"name": "ns_inverse", "route": "cuda",
            "source": "qppvm_tpu_torch/csrc/ns_inverse.cu",
            "replaces": "qppvm_tpu/opt/pallas_linalg.py:32",
            "launches": launches, "max_abs_err": max_err, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms,
            "ms_sim_b1": times[f"sim B=1 n={model.nv} iters=24"][0],
            "ms_sim_b1024": times[f"sim B={NS_B} n={model.nv} iters=24"][0],
            "ms_quadruped_sim_b1": times[f"sim B=1 n={quad.nv} iters=24"][0],
            **{f"{field}_{key}": v for label, key in (
                (f"qppvm Binv B=1 n={n2} iters=20", "dual_arm_binv_b1"),
                (f"qppvm sim B=1 n={n2} iters=24", "dual_arm_sim_b1"),
                (f"qppvm Binv B=1 n={n1} iters=20", "arm7_binv_b1"),
                ("ddp Quu B=1 n=12 iters=22", "ddp_quu_b1"),
                ("ddp Quu B=1 n=6 iters=22", "ddp_quu_humanoid_b1"),
                ("ddp LQR Quu B=1 n=2 iters=22", "ddp_lqr_quu_b1"),
                ("ddp inertia B=1 n=3 iters=16", "ddp_inertia_b1"))
               for field, v in zip(("ms", "plain_ms", "library_ms",
                                    "bound_ms"),
                                   times[label] + (bounds[label][0],))}}


def ddp_inverse_inputs(torch, dev):
    """Every shape phase 15 hands to ns_inverse, recorded as it runs: the
    first Q_uu of a quadruped plan (n 12) and of a humanoid plan (n 6) at
    DDP_TEST, the quadruped's SRBD inertia (n 3) and the first Q_uu of the
    LQR problem (n 2)."""
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.opt import ns_inverse as nsi

    seen, real = {}, nsi.ns_inverse

    def record(K, iters=26):
        seen.setdefault(K.shape[-1], K.clone())
        return real(K, iters)

    nsi.ns_inverse = record
    try:
        for model, contacts in ((zoo.quadruped(device=dev), FEET),
                                (zoo.humanoid(device=dev), CONTACTS)):
            mpc, st, p_ref = ddp_planner(torch, model, contacts, DDP_TEST)
            mpc.plan(st, p_ref, mpc.init_plan(st))
        solve, x0, U0 = lqr_problem(torch, dev)[:3]
        solve(x0, U0)
    finally:
        nsi.ns_inverse = real
    return {"quadruped": seen[12], "humanoid": seen[6], "inertia": seen[3],
            "lqr": seen[2]}


def check_plant_step(torch, nsi, loop, res):
    """One plant step's udot at the loop's last state and torque, its mass
    matrix inverted by the NS kernel (one launch), held to the same step
    with the plain version's inverse passed in as ``binv``."""
    from qppvm_tpu_torch.model import dynamics, kinematics
    from qppvm_tpu_torch.runtime import robot_interface as ri

    robot, model, st = loop.robot, loop.plugin.model, res.state
    kin = kinematics.fk(model, st)
    ext, _ = ri.ground_forces(
        model, robot._contact_idx, robot._contact_offsets, robot.ground_z,
        robot.contact_kp, robot.contact_kd, robot.mu, robot.contact_kt, kin,
        kinematics.all_link_jacobians(model, kin), st.u, res.anchors,
        st.q.dtype)
    Bm = dynamics.mass_matrix(model, st, kin=kin)
    Breg = Bm + 1e-9 * torch.eye(model.nv, device=Bm.device)
    step = lambda **kw: dynamics.forward_dynamics(  # noqa: E731
        model, st, res.taus[-1], ext_wrenches=ext, kin=kin, B=Bm, **kw)
    zero(NS)
    udot = step()
    torch.cuda.synchronize()
    if counted(NS) != 1:
        fail(f"plant step: {counted(NS)} NS launches, expected 1")
    ref = step(binv=nsi.ns_inverse_reference(Breg, 24))
    err = float((udot - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= UDOT_REL * (scale + 1.0):
        fail(f"plant step: udot through the NS kernel differs from the "
             f"plain inverse's by {err:.3g} (|udot| up to {scale:.3g})")
    print(f"plant step udot, NS kernel vs plain inverse: max abs diff "
          f"{err:.3g} (|udot| up to {scale:.3g}; bar {UDOT_REL} x "
          f"(max |udot| + 1))")


def phase_closed_loop(torch, dev, card, hierarchy, level_qp, nsi):
    """Phase 5: the closed loop with the plain level solver, gated and
    timed, then through the level kernel at B = 1; the plant's NS inverse
    runs through the NS kernel in both."""
    from qppvm_tpu_torch.runtime import rt_loop

    loop = rt_loop.humanoid_loop(device=dev)
    on_route("torch", loop.plugin)
    loop.run(3)                             # warm-up, untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = loop.run(LOOP_TICKS, record=LOOP_COMPARE)
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / LOOP_TICKS * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run_sim(LOOP_TICKS)
    torch.cuda.synchronize()
    sim_ms = (time.perf_counter() - t0) / LOOP_TICKS * 1e3
    try:
        health = loop.check_health(res)
    except RuntimeError as e:
        fail(f"closed loop: {e}")
    print(f"closed loop: {LOOP_TICKS} ticks, {health}")
    print(f"[{card}] closed loop B=1 (plain level solver): {tick_ms:.3f} ms "
          f"per tick, sim only {sim_ms:.3f} ms per tick, control "
          f"{tick_ms - sim_ms:.3f} ms per tick")

    loop_k = rt_loop.humanoid_loop(device=dev)
    loop_k.run(2)          # warm-up, untimed: eager, then the graph captured
    torch.cuda.synchronize()
    zero(LEVEL)
    zero(FALLBACK)
    zero(NS)
    zero(SWEEP, PLAIN_SWEEP)
    zero(REPLAY, CAPTURE)
    t0 = time.perf_counter()
    res_k = loop_k.run(KERNEL_LOOP_TICKS, record=LOOP_COMPARE)
    torch.cuda.synchronize()
    tick_k_ms = (time.perf_counter() - t0) / KERNEL_LOOP_TICKS * 1e3
    launches, fallbacks = counted(LEVEL), counted(FALLBACK)
    ns_launches = counted(NS)
    if launches != 2 * KERNEL_LOOP_TICKS or fallbacks != 0:
        fail(f"kernel loop: {launches} launches and {fallbacks} fallbacks, "
             f"expected {2 * KERNEL_LOOP_TICKS} and 0")
    gate_sweeps("closed_loop_b1", KERNEL_LOOP_TICKS)
    gate_graph("closed_loop_b1", KERNEL_LOOP_TICKS, 0)
    substeps = loop_k.robot.substeps
    if ns_launches != substeps * KERNEL_LOOP_TICKS:
        fail(f"kernel loop: {ns_launches} NS launches, expected "
             f"{substeps} per tick ({substeps * KERNEL_LOOP_TICKS})")
    try:
        health_k = loop_k.check_health(res_k)
    except RuntimeError as e:
        fail(f"kernel loop: {e}")
    tau_err = 0.0
    for k, (a, r) in enumerate(zip(res_k.taus, res.taus)):
        tau_err = max(tau_err, float((a - r).abs().max()))
        if not torch.all((a - r).abs() <= TAU_ATOL + TAU_RTOL * r.abs()):
            fail(f"kernel loop tick {k}: tau differs from the plain loop by "
                 f"{float((a - r).abs().max()):.3g} Nm")
    print(f"closed loop through the level kernel: {KERNEL_LOOP_TICKS} ticks, "
          f"{launches} level launches, {ns_launches} NS launches, "
          f"{health_k}; first {LOOP_COMPARE} taus within {tau_err:.3g} Nm "
          f"of the plain loop")
    print(f"[{card}] closed loop B=1 (level kernel): {tick_k_ms:.3f} ms per "
          f"tick")
    check_plant_step(torch, nsi, loop_k, res_k)
    return launches, ns_launches


def phase_mpc(torch, dev, card, hierarchy, level_qp, nsi):
    """Phase 6: the sampling-MPC plan step through the level kernel, its
    start inverse through the NS kernel."""
    from qppvm_tpu_torch.mpc.humanoid_plan import (HORIZON, N_SAMPLES,
                                                   humanoid_plan)

    hp = humanoid_plan(device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    zero(LEVEL)
    zero(FALLBACK)
    zero(NS)
    zero(SWEEP, PLAIN_SWEEP)
    U, info0 = hp.plan(g, hp.mpc.init_plan())      # untimed
    torch.cuda.synchronize()
    if counted(LEVEL) != 2 * HORIZON or counted(FALLBACK) != 0:
        fail(f"MPC plan: {counted(LEVEL)} launches, "
             f"{counted(FALLBACK)} fallbacks, expected {2 * HORIZON}, 0")
    if counted(NS) != 1:
        fail(f"MPC plan: {counted(NS)} NS launches, expected 1")
    gate_sweeps("mpc_plans", HORIZON)
    zero(LEVEL)
    zero(NS)
    zero(SWEEP, PLAIN_SWEEP)
    t0 = time.perf_counter()
    for _ in range(MPC_REPS):
        U, info = hp.plan(g, U)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) / MPC_REPS * 1e3
    launches, fallbacks = counted(LEVEL), counted(FALLBACK)
    ns_launches = counted(NS)
    if launches != 2 * HORIZON * MPC_REPS or fallbacks != 0:
        fail(f"MPC plans: {launches} launches and {fallbacks} fallbacks, "
             f"expected {2 * HORIZON * MPC_REPS} and 0")
    if ns_launches != MPC_REPS:
        fail(f"MPC plans: {ns_launches} NS launches, expected {MPC_REPS}")
    sweep_launches = gate_sweeps("mpc_plans", HORIZON * MPC_REPS)
    for tag, inf in (("untimed", info0), ("timed", info)):
        ff, cm = float(inf["solver_fail_frac"]), float(inf["cost_mean"])
        if ff != 0.0 or not np.isfinite(cm):
            fail(f"MPC {tag} plan: solver_fail_frac {ff}, cost_mean {cm}")
    print(f"MPC plan: {N_SAMPLES} samples x {HORIZON} steps, {launches} "
          f"level launches, {ns_launches} NS launches and {sweep_launches} "
          f"model-sweep launches over {MPC_REPS} plans, 0 fallbacks, "
          f"solver_fail_frac "
          f"0.0, cost_mean {float(info['cost_mean']):.6g}, prim_res_max "
          f"{float(info['prim_res_max']):.3g}, ess {float(info['ess']):.1f}")
    print(f"[{card}] MPC plan step: {plan_ms:.3f} ms, "
          f"{N_SAMPLES * HORIZON / plan_ms * 1e3:.1f} QP solves/s")

    hp_t = on_route("torch", humanoid_plan(device=dev), "update")
    for d in range(MPC_DRAWS):
        U_s, scen = hp.mpc.sample(g, U)
        U, inf_k = hp.update(U_s, scen)
        U_t, inf_t = hp_t.update(U_s, scen)
        if not torch.equal(inf_k["solver_failed"], inf_t["solver_failed"]):
            fail(f"MPC draw {d}: solver_failed flags differ between the "
                 f"level kernel and the plain level solver")
        ck, ct = inf_k["costs"], inf_t["costs"]
        gap = (ck - ct).abs()
        bar = MPC_COST_ATOL + MPC_COST_RTOL * ct.abs()
        worst = int(torch.argmax(gap / bar))
        u_err = float((U - U_t).abs().max())
        print(f"MPC draw {d} on the same samples, level kernel vs plain "
              f"level solver: cost max abs diff {float(gap.max()):.3g}, max "
              f"rel diff {float((gap / ct.abs()).max()):.3g} (costs "
              f"{float(ct.min()):.4g} to {float(ct.max()):.4g}; atol "
              f"{MPC_COST_ATOL}, rtol {MPC_COST_RTOL}), U_new max abs diff "
              f"{u_err:.3g} (atol {MPC_U_ATOL}), solver_failed flags equal")
        if not torch.all(gap <= bar):
            fail(f"MPC draw {d}: sample {worst} costs {float(ck[worst])} "
                 f"(kernel) vs {float(ct[worst])} (plain)")
        if not u_err <= MPC_U_ATOL:
            fail(f"MPC draw {d}: U_new differs from the plain plan's by "
                 f"{u_err:.3g}")
    return launches, ns_launches


def phase_centaur_tick(torch, dev, card, hierarchy, level_qp, nsi, zoo):
    """Phase 7: the centaur's batched tick with friction cones (n 49)
    through the level kernel, against the plain chain. Returns the level
    and NS launches of the kernel chain."""
    plugins, states, refs_b, warm_b = main_path_inputs(
        torch, dev, zoo.centaur(device=dev), FEET, use_friction_cones=True,
        mu=CENTAUR_MU)
    cone = CENTAUR_MU / 2 ** 0.5

    def inside_cones(k, aux):
        f = aux.wrenches
        slip = float((f[..., :2].abs() - cone * f[..., 2:]).max())
        fz = float(f[..., 2].min())
        if not (slip <= CONE_TOL and fz >= FZ_MIN - CONE_TOL):
            fail(f"centaur tick {k}: a wrench leaves its cone (|f_t| - "
                 f"mu/sqrt(2) fz up to {slip:.3g} N, min fz {fz:.6g} N)")

    zero(LEVEL)
    zero(FALLBACK)
    zero(NS)
    zero(SWEEP, PLAIN_SWEEP)
    zero(REPLAY, CAPTURE)
    taus, prim_max = chain(torch, plugins["kernel"], states, refs_b, warm_b,
                           "centaur kernel", inside_cones)
    torch.cuda.synchronize()
    launches, fallbacks, ns_launches = (counted(LEVEL),
                                        counted(FALLBACK), counted(NS))
    if launches != 2 * TICKS or fallbacks != 0:
        fail(f"centaur tick: {launches} launches and {fallbacks} fallbacks, "
             f"expected {2 * TICKS} and 0")
    gate_sweeps("centaur_tick_b1024", TICKS)
    gate_graph("centaur_tick_b1024", TICKS, 1)
    taus_ref, _ = chain(torch, plugins["torch"], states, refs_b, warm_b,
                        "centaur torch", inside_cones)
    tau_err = compare_taus(torch, taus, taus_ref, "centaur")
    print(f"centaur tick (friction cones, n 49): {TICKS} ticks at B={B}: "
          f"kernel launches {launches}, fallbacks 0, model-sweep launches "
          f"{TICKS}, solver_fail_frac 0.0, "
          f"prim_res_max {prim_max:.3g}, every wrench in its cone (mu "
          f"{CENTAUR_MU}, fz >= {FZ_MIN} within {CONE_TOL} N); tau vs plain "
          f"chain max abs diff {tau_err:.3g} Nm (|tau| up to "
          f"{float(taus_ref[-1].abs().max()):.3g} Nm)")
    for b in BACKENDS:
        times = tick_times_ms(torch, plugins[b], states, refs_b, warm_b)
        print(f"[{card}] centaur batched tick B={B} ({b} level solver): "
              f"median {statistics.median(times):.3f} ms over {REPS} reps "
              f"(min {min(times):.3f}, max {max(times):.3f})")
    return launches, ns_launches


def quadruped_loop(torch, dev, b, zoo):
    """The reference's ForceAccExample in closed loop: the quadruped with
    the default ForceAcc stack (3-force wrench box) under the RT profile,
    on SimRobot at dt 1 ms in QUAD_SUBSTEPS substeps, warm state from
    on_start; returns the loop and the initial waist position."""
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
    from qppvm_tpu_torch.runtime import robot_interface as ri
    from qppvm_tpu_torch.runtime import rt_loop

    model = zoo.quadruped(device=dev)
    plugin = on_route(b, ForceAccPlugin(model, iters=12,
                                        solver_opts=RT_PROFILE))
    robot = ri.SimRobot(model, state=ri.standing_state(model, FEET),
                        dt=1e-3, substeps=QUAD_SUBSTEPS, contact_links=FEET)
    refs, warm, waist = plugin.on_start(robot.state)
    return rt_loop.ClosedLoop(plugin, robot, refs, warm), waist


def drive_quadruped(torch, loop, waist, ticks, record=0):
    """``ticks`` ticks of ``loop`` from its robot's state, the squat
    reference (waist lowered by SQUAT_DEPTH) from tick SQUAT_FROM on. Keeps
    every quantity on the device; returns the final state, the solver
    failures, the summed normal force of each tick in FZ_WINDOW, the
    normal forces of the last tick and the first ``record`` torques."""
    plugin, robot = loop.plugin, loop.robot
    squat = plugin.squat_refs(loop.refs, waist, depth=SQUAT_DEPTH)
    st, anchors, w = robot.state, robot._anchors, loop.warm
    n_fail = torch.zeros((), dtype=torch.int64, device=st.q.device)
    fz_sums, taus, aux = [], [], None
    for k in range(ticks):
        refs = squat if k >= SQUAT_FROM else loop.refs
        tau, w, aux = plugin._step_impl(st, refs, w)
        for _ in range(robot.substeps):
            st, anchors = robot.step(st, anchors, tau, st.q, loop.zero_kd,
                                     loop.zero_kd)
        n_fail = n_fail + aux.solver_failed.sum()
        if FZ_WINDOW[0] <= k < FZ_WINDOW[1]:
            fz_sums.append(aux.wrenches[0, :, 2].sum())
        if k < record:
            taus.append(tau)
    return st, n_fail, fz_sums, aux.wrenches[0, :, 2], taus


def phase_quadruped_loop(torch, dev, card, hierarchy, level_qp, nsi, zoo):
    """Phase 8: the quadruped stands and squats for QUAD_TICKS ticks through
    the level kernel at B 1, its plant's mass-matrix inverse through the NS
    kernel; gated as tests/test_force_acc_e2e.py's stand and squat."""
    from qppvm_tpu_torch.model import dynamics

    loop, waist = quadruped_loop(torch, dev, "kernel", zoo)
    z0 = float(loop.robot.state.base_pos[0, 2])
    weight = float(dynamics.compute_model_data(
        loop.plugin.model, loop.robot.state).total_mass[0]) * 9.81
    zero(LEVEL)
    zero(FALLBACK)
    zero(NS)
    zero(SWEEP, PLAIN_SWEEP)
    zero(REPLAY, CAPTURE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, n_fail, fz_sums, fz_last, taus = drive_quadruped(
        torch, loop, waist, QUAD_TICKS, record=LOOP_COMPARE)
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / QUAD_TICKS * 1e3
    launches, fallbacks, ns_launches = (counted(LEVEL),
                                        counted(FALLBACK), counted(NS))
    if launches != 2 * QUAD_TICKS or fallbacks != 0:
        fail(f"quadruped loop: {launches} level launches and {fallbacks} "
             f"fallbacks, expected {2 * QUAD_TICKS} and 0")
    if ns_launches != QUAD_SUBSTEPS * QUAD_TICKS:
        fail(f"quadruped loop: {ns_launches} NS launches, expected "
             f"{QUAD_SUBSTEPS} per tick ({QUAD_SUBSTEPS * QUAD_TICKS})")
    gate_sweeps("quadruped_loop_b1", QUAD_TICKS)
    gate_graph("quadruped_loop_b1", QUAD_TICKS, 1)
    z1 = float(st.base_pos[0, 2])
    fz_mean = float(torch.stack(fz_sums).mean())
    fz_min = float(fz_last.min())
    print(f"quadruped loop (ForceAccExample, 3-force box, n 34): "
          f"{QUAD_TICKS} ticks through the level kernel at B=1, squat "
          f"{SQUAT_DEPTH} m from tick {SQUAT_FROM}: {int(n_fail)} solver "
          f"failures, {launches} level launches, {ns_launches} NS launches, "
          f"base z {z0:.4f} -> {z1:.4f} m, mean sum fz over ticks "
          f"{FZ_WINDOW[0]}-{FZ_WINDOW[1]} {fz_mean:.1f} N (weight "
          f"{weight:.1f} N), last tick's min fz {fz_min:.3f} N")
    if int(n_fail) != 0:
        fail(f"quadruped loop: {int(n_fail)} solver failures")
    if not (z0 - 0.12 < z1 < z0 - 0.01):
        fail(f"quadruped loop: base z {z0:.4f} -> {z1:.4f} m, outside "
             f"(z0 - 0.12, z0 - 0.01)")
    if not abs(fz_mean - weight) < 0.25 * weight:
        fail(f"quadruped loop: mean sum fz {fz_mean:.1f} N against a weight "
             f"of {weight:.1f} N")
    if not fz_min >= FZ_MIN - 1e-3:
        fail(f"quadruped loop: min fz {fz_min:.6g} N below {FZ_MIN}")

    plain, _ = quadruped_loop(torch, dev, "torch", zoo)
    *_, taus_ref = drive_quadruped(torch, plain, waist, LOOP_COMPARE,
                                   record=LOOP_COMPARE)
    tau_err = compare_taus(torch, taus, taus_ref, "quadruped loop")
    sim_ms = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run_sim(QUAD_SIM_TICKS)
    torch.cuda.synchronize()
    sim_ms = (time.perf_counter() - t0) / QUAD_SIM_TICKS * 1e3
    print(f"quadruped loop: first {LOOP_COMPARE} taus within {tau_err:.3g} "
          f"Nm of the plain loop's")
    print(f"[{card}] quadruped closed loop B=1 (level kernel): {tick_ms:.3f} "
          f"ms per tick, sim only {sim_ms:.3f} ms per tick "
          f"({QUAD_SUBSTEPS} substeps)")
    return launches, ns_launches


def stack_level_shapes(plugin, state, refs):
    """(n, m, head equalities, tail equalities) of each level of the
    plugin's assembled stack at ``state``."""
    from qppvm_tpu_torch.model import dynamics

    return level_shapes(plugin.stack.build(
        plugin.model, dynamics.compute_model_data(plugin.model, state), state,
        refs, nx=plugin.opt.size))


def level_shapes(sd):
    """(n, m, head equalities, tail equalities) of each level of an
    assembled stack ``sd``."""
    n = sd.lb.shape[1]
    m = sd.C.shape[1] + (n if sd.has_box else 0)
    shapes, tail = [], 0
    for lv in sd.levels:
        shapes.append((n, m + tail, sd.n_eq, tail))
        tail += lv.A.shape[1]
    return shapes


def seeded_on_start(torch, dev, plugin, state):
    """The capture plugin's on_start in float64, its references and warm
    state cast to float32, beside the float32 on_start's level-0 normal
    forces. In float32 the polish acceptance of on_start's level 0 is
    decided by roundoff (ROADMAP section 3): 1e-6 rad moves of q flip it
    between two solutions in both packages, whose level-0 wrenches differ
    by about 78 N. Level 0's proximal term carries that null-space part
    through the whole set-up into the planner's warm start, and from the
    other solution the null candidate's rollout falls over and diverges.
    In float64 the decision is no longer roundoff's."""
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin

    f64 = torch.float64
    plugin64 = ForceAccPlugin(zoo.humanoid(dtype=f64, device=dev),
                              **CAPTURE_PLUGIN, dtype=f64)
    st64 = dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(f64)
        for f in dataclasses.fields(state)})
    refs, warm, waist = plugin64.on_start(st64)
    cast = lambda t: ({k: cast(v) for k, v in t.items()}  # noqa: E731
                      if isinstance(t, dict) else t.float())
    refs, waist = cast(refs), waist.float()
    warm = tuple(dataclasses.replace(w, **{
        f.name: getattr(w, f.name).float() for f in dataclasses.fields(w)})
        for w in warm)
    _, warm32, _ = plugin.on_start(state)
    nc = len(CONTACTS)
    fz = lambda w: [round(float(w[0].x[0, -6 * (nc - i) + 2]), 3)  # noqa
                    for i in range(nc)]
    print(f"capture on_start, level-0 normal force of each sole: float64 "
          f"seed {fz(warm)} N, float32 {fz(warm32)} N")
    return refs, warm, waist


def capture_setup(torch, dev):
    """tests/test_capture_step.py's single support on the card: the
    humanoid on SimRobot (dt 1 ms, 2 substeps, the 4-point foot patches),
    LegLiftScript lifting l_sole, driven t_hold0 + CAPTURE_HOLD_EXTRA
    ticks at B 1 through the plugin's own profile from a float64 on_start
    (seeded_on_start), every tick gated on the RT solver gate. Returns
    (plugin, robot, base_refs, warm, offsets, script) with the waist
    reference held at the script's shifted target."""
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
    from qppvm_tpu_torch.runtime import robot_interface as ri
    from qppvm_tpu_torch.runtime.contact_switch import (LegLiftPhases,
                                                        LegLiftScript)
    from qppvm_tpu_torch.runtime.rt_loop import FOOT_PATCH

    model = zoo.humanoid(device=dev)
    plugin = ForceAccPlugin(model, **CAPTURE_PLUGIN)
    offsets = {c: FOOT_PATCH for c in CONTACTS}
    robot = ri.SimRobot(model, state=ri.standing_state(model, CONTACTS),
                        dt=1e-3, substeps=2, contact_links=CONTACTS,
                        contact_offsets=offsets)
    refs, warm, waist = seeded_on_start(torch, dev, plugin, robot.state)
    script = LegLiftScript(model, plugin, refs, waist, "l_sole",
                           state=robot.state,
                           phases=LegLiftPhases(**CAPTURE_PHASES),
                           **CAPTURE_SCRIPT)
    fails = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(script.t_hold0 + CAPTURE_HOLD_EXTRA):
        st = robot.state
        tau, warm, aux = plugin.control_loop(st, script.refs_at(i), warm)
        fails = fails + aux.solver_failed.sum()
        robot.set_reference(tau_ref=tau, q_ref=st.q)
        robot.move()
    if int(fails) != 0:
        fail(f"capture set-up: {int(fails)} ticks failed the RT gate on the "
             f"way into single support")
    base_refs = dict(refs, waist_task=dict(refs["waist_task"], p=script.w1))
    return plugin, robot, base_refs, warm, offsets, script


def capture_candidates(torch, dev, init_theta):
    """The candidate library as one batch of thetas (K 4), and its names."""
    names = list(CAPTURE_CANDIDATES)
    cands = [init_theta() if CAPTURE_CANDIDATES[n] is None else
             {k: torch.tensor(v, dtype=torch.float32, device=dev)
              for k, v in CAPTURE_CANDIDATES[n].items()} for n in names]
    return names, {k: torch.stack([c[k] for c in cands]) for k in cands[0]}


def shoved(state):
    """``state`` shoved sideways: base_vel[4] += PUSH_VY."""
    bv = state.base_vel.clone()
    bv[:, 4] += PUSH_VY
    return dataclasses.replace(state, base_vel=bv)


def capture_run(torch, plugin, robot, base_refs, warm, theta, swing, ticks):
    """Execute ``theta`` (or hold, if None) from the robot's shoved state,
    the waist reference pulled halfway to the feet's mean every
    CAPTURE_WAIST_EVERY ticks, as tests/test_capture_step.py's _run.
    Returns (fall tick or None, up per tick, swing-foot xy at the first
    and last tick, RT failures, ticks run)."""
    from qppvm_tpu_torch.model import kinematics

    model = plugin.model
    span_ticks = int(CAPTURE_ROLLOUT["horizon"] * CAPTURE_ROLLOUT["dt"] * 1e3)
    feet = [model.link_index(c) for c in CONTACTS]
    li = model.link_index("r_sole")
    waist_p = base_refs["waist_task"]["p"]
    ups, foot_xy, fall_tick = [], [], None
    rt_fails = torch.zeros((), dtype=torch.int64, device=waist_p.device)
    for i in range(ticks):
        state = robot.state
        if i % CAPTURE_WAIST_EVERY == 0:
            fm = kinematics.fk(model, state).p[:, feet, :2].mean(dim=1)
            waist_p = torch.cat([waist_p[:, :2] + 0.5 * (fm - waist_p[:, :2]),
                                 waist_p[:, 2:]], dim=-1)
        refs_t = dict(base_refs,
                      waist_task=dict(base_refs["waist_task"], p=waist_p))
        if theta is not None and i < span_ticks:
            refs_t = swing(refs_t, theta, i / span_ticks)
        tau, warm, aux = plugin.control_loop(state, refs_t, warm)
        rt_fails = rt_fails + aux.solver_failed.sum()
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        if i == 0:
            foot_xy.append(kinematics.fk(model, robot.state).p[0, li, :2])
        ups.append(float(robot.state.base_rot[0, 2, 2]))
        if ups[-1] < FALL_UP:
            fall_tick = i
            break
    foot_xy.append(kinematics.fk(model, robot.state).p[0, li, :2])
    return fall_tick, ups, foot_xy, int(rt_fails), len(ups)


def phase_capture(torch, dev, card, hierarchy, level_qp, nsi):
    """Phase 9: the capture step on the humanoid, as
    tests/test_capture_step.py runs it: the candidate library rolled out
    as one batch through the level kernel and through the plain level
    solver, then lean-only and the chosen step executed on the plant.
    Returns ({path: level launches}, {path: NS launches})."""
    from qppvm_tpu_torch.mpc import rollout as ro
    from qppvm_tpu_torch.mpc.sampling import expand_batch

    t0 = time.perf_counter()
    plugin, robot, base_refs, warm, offsets, script = capture_setup(torch,
                                                                    dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    shapes = stack_level_shapes(plugin, robot.state, base_refs)
    if any(ROBOT_SHAPES.get(s) != "capture" for s in shapes):
        fail(f"capture stack level shapes {shapes} are not phase 2's "
             f"'capture' shapes")
    snap = (robot.state, robot._anchors)
    swing, init_theta = ro.make_swing_primitive(
        plugin, span_s=CAPTURE_ROLLOUT["horizon"] * CAPTURE_ROLLOUT["dt"])
    term = ro.make_capture_terminal_cost(plugin)
    names, thetas = capture_candidates(torch, dev, init_theta)
    K, H = len(names), CAPTURE_ROLLOUT["horizon"]
    st_k, refs_k, warm_k = expand_batch(shoved(snap[0]), base_refs, warm, K)
    U0 = torch.zeros((K, H, 3), device=dev)
    scen = {"push": torch.zeros((K, H, 3), device=dev)}
    costs, times = {}, {}
    roll = ro.make_rollout_fn(
        plugin, ro.RolloutConfig(**CAPTURE_ROLLOUT), ro.default_cost,
        swing=swing, terminal_cost=term, contact_offsets=offsets)
    for b in BACKENDS:
        zero(LEVEL)
        zero(FALLBACK)
        zero(NS)
        zero(SWEEP, PLAIN_SWEEP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, health = routed(b, roll)(st_k, refs_k, warm_k, U0, scen, thetas)
        torch.cuda.synchronize()
        times[b] = (time.perf_counter() - t0) * 1e3
        costs[b] = c
        if b == "kernel":
            plan_launches = (counted(LEVEL), counted(NS))
            if (counted(LEVEL) != len(shapes) * H
                    or counted(FALLBACK) != 0 or counted(NS) != 1):
                fail(f"capture plan: {counted(LEVEL)} level launches, "
                     f"{counted(FALLBACK)} fallbacks, {counted(NS)} NS "
                     f"launches; expected {len(shapes) * H}, 0, 1")
            gate_sweeps("capture_plan_b4", H)
        if not bool(torch.isfinite(c).all()):
            fail(f"capture plan ({b}): costs {c.tolist()}")
        print(f"capture plan ({b} level solver): "
              + ", ".join(f"{n} {float(v):.6g}" for n, v in zip(names, c))
              + f"; prim_res_max {health['prim_res_max'].tolist()}, "
              f"solver_failed {health['solver_failed'].tolist()}")
    ck, ct = costs["kernel"], costs["torch"]
    gap = float(((ck - ct).abs() / ct.abs()).max())
    best = {b: names[int(torch.argmin(costs[b]))] for b in BACKENDS}
    rank = {b: " < ".join(f"{names[i]} {float(costs[b][i]):.0f}"
                          for i in torch.argsort(costs[b]).tolist())
            for b in BACKENDS}
    print(f"capture plan ranking: kernel {rank['kernel']}; plain "
          f"{rank['torch']}; the JAX package on a CPU "
          f"{CAPTURE_JAX_RANKING}; kernel vs plain largest relative cost gap "
          f"{gap:.3g} (bar {CAPTURE_COST_RTOL})")
    i_best = names.index("cross_near")
    for b in BACKENDS:
        c = costs[b]
        if best[b] != "cross_near" or not (
                c[names.index("null")] > c[i_best]
                and c[names.index("replant_down")] > c[i_best]):
            fail(f"capture plan ({b}): argmin {best[b]}, ranking {rank[b]}; "
                 f"expected cross_near below null and replant_down")
    if not gap <= CAPTURE_COST_RTOL:
        fail(f"capture plan: kernel and plain costs {gap:.3g} apart "
             f"(relative), bar {CAPTURE_COST_RTOL}")
    print(f"[{card}] capture plan, K={K} x {H} steps x "
          f"{CAPTURE_ROLLOUT['sim_substeps']} substeps: level kernel "
          f"{times['kernel']:.1f} ms, plain level solver {times['torch']:.1f} "
          f"ms (set-up into single support {setup_s:.1f} s, "
          f"{script.t_hold0 + CAPTURE_HOLD_EXTRA} ticks)")

    # ---- execution: lean-only, then the chosen step, from the snapshot
    robot.state = shoved(snap[0])
    fall_lean, ups_lean, _, _, _ = capture_run(
        torch, plugin, robot, base_refs, warm, None, swing,
        CAPTURE_MAX_TICKS)
    if fall_lean is None:
        fail(f"capture: lean-only did not fall in {CAPTURE_MAX_TICKS} ticks "
             f"(up {ups_lean[-1]:.3f})")
    robot.state, robot._anchors = shoved(snap[0]), snap[1]
    theta_c = {k: v[i_best:i_best + 1] for k, v in thetas.items()}
    ticks = fall_lean + CAPTURE_STEP_EXTRA
    zero(LEVEL)
    zero(FALLBACK)
    zero(NS)
    zero(SWEEP, PLAIN_SWEEP)
    zero(REPLAY, CAPTURE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fall_step, ups_step, foot_xy, rt_fails, ran = capture_run(
        torch, plugin, robot, base_refs, warm, theta_c, swing, ticks)
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / ran * 1e3
    loop_launches = (counted(LEVEL), counted(NS))
    gate_sweeps("capture_loop_b1", ran)
    gate_graph("capture_loop_b1", ran, 0)
    step_len = float(torch.linalg.norm(foot_xy[-1] - foot_xy[0]))
    up_at = ups_step[fall_lean] if fall_lean < len(ups_step) else None
    print(f"capture loop: lean-only fell at tick {fall_lean}; the chosen "
          f"step (cross_near) ran {ran} ticks, fall "
          f"{fall_step}, up at lean's fall tick {up_at}, swing foot moved "
          f"{step_len:.4f} m, {rt_fails} RT failures, "
          f"{loop_launches[0]} level launches (the plugin's profile runs "
          f"the plain level solver), {loop_launches[1]} NS launches")
    if counted(NS) != robot.substeps * ran:
        fail(f"capture loop: {counted(NS)} NS launches, expected "
             f"{robot.substeps} per tick ({robot.substeps * ran})")
    if not step_len > STEP_MIN_M:
        fail(f"capture loop: the swing foot moved {step_len:.4f} m")
    if not (fall_step is None or fall_step > fall_lean + 150):
        fail(f"capture loop: the step fell at tick {fall_step}, lean-only "
             f"at {fall_lean}")
    if up_at is None or not up_at > UPRIGHT_UP:
        fail(f"capture loop: up {up_at} at lean-only's fall tick")
    if not rt_fails < RT_FAIL_SHARE * ticks:
        fail(f"capture loop: {rt_fails} RT failures in {ticks} ticks")
    robot.state, robot._anchors = snap
    robot.set_reference(tau_ref=torch.zeros_like(robot.state.q))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CAPTURE_SIM_TICKS):
        robot.move()
    torch.cuda.synchronize()
    sim_ms = (time.perf_counter() - t0) / CAPTURE_SIM_TICKS * 1e3
    print(f"[{card}] capture closed loop B=1: {tick_ms:.3f} ms per tick, "
          f"plant alone {sim_ms:.3f} ms per tick ({robot.substeps} "
          f"substeps)")
    return ({"capture_plan_b4": plan_launches[0],
             "capture_loop_b1": loop_launches[0]},
            {"capture_plan_b4": plan_launches[1],
             "capture_loop_b1": loop_launches[1]})


def phase_step_recovery(torch, dev, card, hierarchy, level_qp, nsi, zoo):
    """Phase 10: MPPI with the step-recovery channel on the quadruped at
    512 samples, through the level kernel; the same samples through the
    plain level solver; one gate_seq rollout at K 512. Returns the level
    and NS launches of the timed plans."""
    from qppvm_tpu_torch.mpc import rollout as ro
    from qppvm_tpu_torch.mpc.sampling import (MPPIConfig, SamplingMPC,
                                              expand_batch)
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin

    model = zoo.quadruped(device=dev)
    plugin = ForceAccPlugin(model, **QUAD_MPC_PLUGIN)
    st = ro.standing_state(model, FEET)
    refs, warm, _ = plugin.on_start(st)
    mpc = {b: on_route(b, SamplingMPC(plugin, MPPIConfig(**STEP_MPPI),
                                      ro.RolloutConfig(**STEP_ROLLOUT)),
                       "update") for b in BACKENDS}
    H, N = STEP_MPPI["horizon"], STEP_MPPI["n_samples"]
    g = torch.Generator(device=dev).manual_seed(0)
    U, theta = mpc["kernel"].init_plan(), mpc["kernel"].init_theta()

    def plans(reps, U, theta):
        zero(LEVEL)
        zero(FALLBACK)
        zero(NS)
        zero(SWEEP, PLAIN_SWEEP)
        for _ in range(reps):
            (U, theta), info = mpc["kernel"].plan_step(g, st, refs, warm, U,
                                                       theta)
            ff = float(info["solver_fail_frac"])
            if ff != 0.0 or not bool(torch.isfinite(info["costs"]).all()):
                fail(f"step-recovery plan: solver_fail_frac {ff}, costs "
                     f"finite {bool(torch.isfinite(info['costs']).all())}")
        torch.cuda.synchronize()
        counts = (counted(LEVEL), counted(FALLBACK), counted(NS))
        if counts != (2 * H * reps, 0, reps):
            fail(f"step-recovery plans: (level launches, fallbacks, NS "
                 f"launches) {counts}, expected {(2 * H * reps, 0, reps)}")
        gate_sweeps("mppi_step_recovery_b512", H * reps)
        return U, theta, info, counts

    U, theta, _, _ = plans(1, U, theta)            # untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U, theta, info, counts = plans(MPC_REPS, U, theta)
    plan_ms = (time.perf_counter() - t0) / MPC_REPS * 1e3
    print(f"step-recovery MPPI: {N} samples x {H} steps, {counts[0]} level "
          f"and {counts[2]} NS launches over {MPC_REPS} plans, 0 fallbacks, "
          f"solver_fail_frac 0.0, cost_min {float(info['cost_min']):.6g}, "
          f"ess {float(info['ess']):.1f}, theta "
          + ", ".join(f"{k} {v.tolist()}" for k, v in theta.items()))
    print(f"[{card}] step-recovery MPPI plan step: {plan_ms:.3f} ms, "
          f"{N * H / plan_ms * 1e3:.1f} QP solves/s")

    for d in range(MPC_DRAWS):
        U_s, scen, th = mpc["kernel"].sample(g, U, theta)
        (U, theta), inf_k = mpc["kernel"].update(st, refs, warm, U_s, scen,
                                                 th)
        (U_t, theta_t), inf_t = mpc["torch"].update(st, refs, warm, U_s,
                                                    scen, th)
        if not torch.equal(inf_k["solver_failed"], inf_t["solver_failed"]):
            fail(f"step-recovery draw {d}: solver_failed flags differ")
        ck, ct = inf_k["costs"], inf_t["costs"]
        gap = (ck - ct).abs()
        bar = MPC_COST_ATOL + MPC_COST_RTOL * ct.abs()
        worst = int(torch.argmax(gap / bar))
        u_err = float((U - U_t).abs().max())
        th_err = max(float(((theta[k] - theta_t[k]).abs()
                            / (1.0 + theta_t[k].abs())).max())
                     for k in theta)
        print(f"step-recovery draw {d} on the same samples, level kernel vs "
              f"plain level solver: cost max abs diff {float(gap.max()):.3g}, "
              f"max rel diff {float((gap / ct.abs()).max()):.3g}, U_new max "
              f"abs diff {u_err:.3g}, theta_new max diff over (1 + |theta|) "
              f"{th_err:.3g} (atol {MPC_U_ATOL}), solver_failed flags equal")
        if not torch.all(gap <= bar):
            fail(f"step-recovery draw {d}: sample {worst} costs "
                 f"{float(ck[worst])} (kernel) vs {float(ct[worst])} (plain)")
        if not (u_err <= MPC_U_ATOL and th_err <= MPC_U_ATOL):
            fail(f"step-recovery draw {d}: U_new / theta_new differ from the "
                 f"plain plan's by {u_err:.3g} / {th_err:.3g}")

    roll = ro.make_rollout_fn(plugin, ro.RolloutConfig(**GATE_ROLLOUT),
                              ro.default_cost)
    Hg = GATE_ROLLOUT["horizon"]
    gate_seq = torch.ones((N, Hg, len(FEET)), device=dev)
    gate_seq[:, :, 0] = torch.clamp(
        1.0 - torch.arange(Hg, device=dev) / 3.0, 0.0, 1.0)
    st_n, refs_n, warm_n = expand_batch(st, refs, warm, N)
    zero(LEVEL)
    zero(FALLBACK)
    zero(SWEEP, PLAIN_SWEEP)
    cost, health = roll(st_n, refs_n, warm_n, torch.zeros((N, Hg, 3),
                                                          device=dev),
                        {"push": torch.zeros((N, Hg, 3), device=dev),
                         "gate_seq": gate_seq})
    torch.cuda.synchronize()
    n_failed = int(health["solver_failed"].sum())
    print(f"gate_seq rollout, foot_fl ramped off mid-horizon, K={N} x {Hg} "
          f"steps: {counted(LEVEL)} level launches, "
          f"{counted(FALLBACK)} fallbacks, {n_failed} failed samples, "
          f"cost {float(cost.min()):.6g} to {float(cost.max()):.6g}")
    if (n_failed or not bool(torch.isfinite(cost).all())
            or counted(LEVEL) != 2 * Hg or counted(FALLBACK)):
        fail("gate_seq rollout: unhealthy, non-finite or off the kernel")
    gate_sweeps("gate_seq_rollout_b512", Hg)
    return counts[0], counts[2]


def qppvm_loop(torch, plugin, robot, ticks, trace_path, ref_gen=None):
    """``ticks`` ticks of ``plugin`` against ``robot`` through
    runtime/plugin.py::ControlLoop, with a TraceBuffer at ``trace_path``
    (flushed when the loop closes). Returns (LoopStats, the flushed
    trace's arrays)."""
    from qppvm_tpu_torch.runtime.logger import TraceBuffer
    from qppvm_tpu_torch.runtime.plugin import ControlLoop

    trace = TraceBuffer(trace_path, capacity=ticks)
    stats = ControlLoop(plugin, robot, period=1e-3, trace=trace,
                        ref_generator=ref_gen).run(ticks * 1e-3)
    torch.cuda.synchronize()
    with np.load(trace_path + ".npz") as data:
        return stats, {k: data[k] for k in data.files}


def qppvm_sine_gates(torch, model, st, stats, tr, robot, label):
    """The sinusoid's gates on a dual-arm QPPVM loop of QPPVM_TICKS ticks
    from ``st`` (its trace ``tr``, ``robot`` after the loop): at most
    QPPVM_MAX_FAILS failed ticks, the left EE's error after tick
    QPPVM_SETTLE (mean, max) under QPPVM_ERR_MEAN and QPPVM_ERR_MAX, and
    tau_desired within +/-(tau_max + TAU_LIMIT_TOL) on every solved tick.
    Returns (EE error mean, max, |tau_desired| - tau_max at most)."""
    from qppvm_tpu_torch.model import kinematics
    from qppvm_tpu_torch.runtime.trajectory import qppvm_sinusoid

    dev = st.q.device
    if tr["tau_desired"].shape[0] != QPPVM_TICKS:
        fail(f"{label} trace: {tr['tau_desired'].shape[0]} rows")
    # the left EE after each tick's move against that tick's reference
    q_after = torch.cat([torch.tensor(tr["q"][1:, 0], dtype=torch.float32,
                                      device=dev), robot.state.q])
    p_ee = kinematics.link_pose(model, kinematics.fk(
        model, type(st).init(model, q=q_after, batch=QPPVM_TICKS)),
        "arm1_7")[1]
    p_start = kinematics.link_pose(model, kinematics.fk(model, st),
                                   "arm1_7")[1]
    t_ticks = torch.arange(QPPVM_TICKS, device=dev, dtype=torch.float32)
    p_ref = qppvm_sinusoid(p_start, 1e-3 * t_ticks)   # (T, 3)
    errs = torch.linalg.norm(p_ee - p_ref, dim=-1)[QPPVM_SETTLE + 1:]
    err_mean, err_max = float(errs.mean()), float(errs.max())
    failed = tr["solver_failed"] != 0.0
    tau_max = model.tau_max.cpu().numpy()
    over = float((np.abs(tr["tau_desired"][~failed, 0]) - tau_max).max())
    print(f"{label}: {QPPVM_TICKS} ticks through ControlLoop, "
          f"{stats.solver_failures} failed, left EE error after tick "
          f"{QPPVM_SETTLE}: mean {err_mean:.5f} m, max {err_max:.5f} m; "
          f"|tau_desired| - tau_max up to {over:.3g} Nm on the solved "
          f"ticks; trace {tr['tau_desired'].shape[0]} rows")
    if stats.solver_failures > QPPVM_MAX_FAILS:
        fail(f"{label}: {stats.solver_failures} failed ticks")
    if not (err_mean < QPPVM_ERR_MEAN and err_max < QPPVM_ERR_MAX):
        fail(f"{label}: EE error mean {err_mean:.4f} max {err_max:.4f}")
    if not over <= TAU_LIMIT_TOL:
        fail(f"{label}: tau_desired outside the torque limits by "
             f"{over:.3g} Nm")
    return err_mean, err_max, over


def phase_qppvm(torch, dev, card, hierarchy, level_qp, nsi, zoo):
    """Phase 11: the reference's QPPVMPlugin through ControlLoop: config 2
    (the dual arm on the moving sinusoid) and config 1 (the arm holding
    home), gated as tests/test_qppvm_e2e.py; the NS kernel against the
    plain NS on the loop's first ticks; the level kernel's profile chained
    against the plain level solver. Returns ({path: level launches},
    {path: NS launches})."""
    import tempfile

    from qppvm_tpu_torch import config as cfglib
    from qppvm_tpu_torch.model import dynamics
    from qppvm_tpu_torch.opt import linalg
    from qppvm_tpu_torch.plugins.qppvm import QPPVMPlugin
    from qppvm_tpu_torch.runtime.robot_interface import SimRobot

    model = zoo.dual_arm(device=dev)
    plugin = QPPVMPlugin(model, iters=60)
    st = model.home_state()
    data = dynamics.compute_model_data(model, st, need_binv=True)
    shapes = level_shapes(plugin.stack.build(
        model, data, st, plugin.stack.ref_init(model, data, st), nx=model.nj))
    if any(ROBOT_SHAPES.get(sh) != "dual_arm" for sh in shapes):
        fail(f"dual-arm QPPVM level shapes {shapes} are not phase 2's")

    def sinusoid(t, ctx):
        return dict(ctx["refs"], LEFT_ARM=plugin.make_refs(ctx["start"], t))

    tmp = tempfile.TemporaryDirectory()
    robot = SimRobot(model, dt=1e-3, substeps=2)
    zero(NS)
    zero(PLAIN)
    zero(LEVEL)
    zero(SWEEP, PLAIN_SWEEP)
    zero(REPLAY, CAPTURE)
    t0 = time.perf_counter()
    stats, tr = qppvm_loop(torch, plugin, robot, QPPVM_TICKS,
                           tmp.name + "/dual_arm", sinusoid)
    run_s = time.perf_counter() - t0
    ns_launches, plain, levels = (counted(NS), counted(PLAIN),
                                  counted(LEVEL))
    # 1 NS launch a tick for Binv and 1 a plant substep, + on_start's Binv
    ns_expected = (1 + robot.substeps) * QPPVM_TICKS + 1
    if (ns_launches, plain, levels) != (ns_expected, 0, 0):
        fail(f"QPPVM loop: {ns_launches} NS launches, {plain} plain "
             f"inverses, {levels} level launches; expected {ns_expected}, "
             f"0, 0")
    # one model update a tick and on_start's
    gate_sweeps("qppvm_dual_arm_loop_b1", QPPVM_TICKS + 1)
    gate_graph("qppvm_dual_arm_loop_b1", QPPVM_TICKS, 1)
    print(f"QPPVM dual arm, default profile: {ns_launches} NS launches, 0 "
          f"plain inverses, 0 level launches")
    qppvm_sine_gates(torch, model, st, stats, tr, robot,
                     "QPPVM dual arm, default profile")

    # the benchmark's configuration: the same sinusoid in the level
    # kernel's profile, 2 launches a tick
    cfg = cfglib.load_scenario(str(QPPVM_BENCH_CONFIG))
    kmodel = cfglib.build_model(cfg, dev)
    kplugin = cfglib.build_plugin(cfg, kmodel)
    krobot = cfglib.build_sim(cfg, kmodel)
    zero(NS)
    zero(LEVEL)
    zero(FALLBACK)
    zero(SWEEP, PLAIN_SWEEP)
    zero(REPLAY, CAPTURE)
    t0 = time.perf_counter()
    kstats, ktr = qppvm_loop(torch, kplugin, krobot, QPPVM_TICKS,
                             tmp.name + "/dual_arm_kernel", sinusoid)
    krun_s = time.perf_counter() - t0
    klevels, kns = counted(LEVEL), counted(NS)
    # on_start's two cold, polished levels run the plain solver
    if (klevels, counted(FALLBACK), kns) != (
            2 * QPPVM_TICKS, 2, (1 + krobot.substeps) * QPPVM_TICKS + 1):
        fail(f"QPPVM kernel-profile loop: {klevels} level launches, "
             f"{counted(FALLBACK)} fallbacks, {kns} NS launches; expected "
             f"{2 * QPPVM_TICKS}, 2 (on_start's) and "
             f"{(1 + krobot.substeps) * QPPVM_TICKS + 1}")
    gate_sweeps("qppvm_kernel_profile_loop_b1", QPPVM_TICKS + 1)
    gate_graph("qppvm_kernel_profile_loop_b1", QPPVM_TICKS, 1)
    print(f"QPPVM dual arm, {QPPVM_BENCH_CONFIG.name}: {klevels} level "
          f"launches (2 a tick), 0 fallbacks in the ticks, {kns} NS "
          f"launches")
    qppvm_sine_gates(torch, kmodel, krobot.model.home_state(), kstats, ktr,
                     krobot, f"QPPVM dual arm, {QPPVM_BENCH_CONFIG.name}")
    print(f"[{card}] QPPVM dual arm loop B=1, {QPPVM_BENCH_CONFIG.name} "
          f"(ControlLoop, {QPPVM_TICKS} ticks in {krun_s:.1f} s): tick p50 "
          f"{kstats.p50_ms:.3f} ms, p99 {kstats.p99_ms:.3f} ms, mean "
          f"{kstats.mean_ms:.3f} ms")

    # the plant alone at zero torque
    robot.set_reference(tau_ref=torch.zeros_like(robot.state.q))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(QPPVM_SIM_TICKS):
        robot.move()
    torch.cuda.synchronize()
    sim_ms = (time.perf_counter() - t0) / QPPVM_SIM_TICKS * 1e3
    print(f"[{card}] QPPVM dual arm loop B=1 (ControlLoop, {QPPVM_TICKS} "
          f"ticks in {run_s:.1f} s): tick p50 {stats.p50_ms:.3f} ms, p99 "
          f"{stats.p99_ms:.3f} ms, mean {stats.mean_ms:.3f} ms, deadline "
          f"misses {stats.deadline_misses()} of {QPPVM_TICKS} against 1 ms; "
          f"plant alone {sim_ms:.3f} ms per tick ({robot.substeps} "
          f"substeps); control share "
          f"{stats.mean_ms / (stats.mean_ms + sim_ms):.3f}")

    # the NS kernel against the plain NS on the loop's first ticks
    def plain_inverse(K, iters=24):
        return linalg.spd_inverse_ns(K, iters=iters - 2, refine=2)

    # a plugin of its own: ``plugin``'s tick graph replays the NS kernel
    # it captured, which the patch does not reach
    with mock.patch.object(nsi, "spd_inverse", plain_inverse):
        zero(NS)
        _, tr_p = qppvm_loop(torch, QPPVMPlugin(model, iters=60),
                             SimRobot(model, dt=1e-3, substeps=2),
                             QPPVM_COMPARE, tmp.name + "/plain", sinusoid)
    if counted(NS) != 0:
        fail(f"plain-NS QPPVM ticks made {counted(NS)} NS launches")
    taus = torch.tensor(tr["tau_desired"][:QPPVM_COMPARE], device=dev)
    taus_p = torch.tensor(tr_p["tau_desired"], device=dev)
    ns_err = compare_taus(torch, list(taus), list(taus_p),
                          "QPPVM NS kernel vs plain NS")
    print(f"QPPVM first {QPPVM_COMPARE} taus, NS kernel vs plain NS: max "
          f"abs diff {ns_err:.3g} Nm (atol {TAU_ATOL}, rtol {TAU_RTOL})")

    # the level kernel's profile, chained from the same on_start
    chain_p = {b: on_route(b, QPPVMPlugin(model, iters=60, solver_opts=dict(
        rho_updates=0))) for b in BACKENDS}
    refs, warm0, start = chain_p["kernel"].on_start(st)
    states = [type(st)(q=torch.tensor(tr["q"][k], dtype=torch.float32,
                                      device=dev),
                       qd=torch.tensor(tr["qd"][k], dtype=torch.float32,
                                       device=dev),
                       base_rot=st.base_rot, base_pos=st.base_pos,
                       base_vel=st.base_vel) for k in range(QPPVM_COMPARE)]
    chain_taus = {}
    for b, pl in chain_p.items():
        warm, chain_taus[b] = warm0, []
        zero(LEVEL)
        zero(FALLBACK)
        zero(SWEEP, PLAIN_SWEEP)
        zero(REPLAY, CAPTURE)
        for k, s_k in enumerate(states):
            r = dict(refs, LEFT_ARM=pl.make_refs(start, k * 1e-3))
            tau, warm, aux = pl.control_loop(s_k, r, warm)
            if bool(aux.solver_failed.any()):
                fail(f"QPPVM {b} chain tick {k}: the solve failed")
            chain_taus[b].append(tau)
        torch.cuda.synchronize()
        if b == "kernel":
            chain_launches = counted(LEVEL)
            if (counted(LEVEL), counted(FALLBACK)) != (
                    2 * QPPVM_COMPARE, 0):
                fail(f"QPPVM kernel chain: {counted(LEVEL)} launches, "
                     f"{counted(FALLBACK)} fallbacks; expected "
                     f"{2 * QPPVM_COMPARE} and 0")
            gate_sweeps("qppvm_kernel_profile_chain_b1", QPPVM_COMPARE)
            gate_graph("qppvm_kernel_profile_chain_b1", QPPVM_COMPARE, 1)
    chain_err = compare_taus(torch, chain_taus["kernel"], chain_taus["torch"],
                             "QPPVM level-kernel chain")
    print(f"QPPVM rho_updates 0, {QPPVM_COMPARE} chained ticks: level "
          f"kernel {chain_launches} launches, 0 fallbacks; tau within "
          f"{chain_err:.3g} Nm of the plain level solver's")

    # config 1: the arm holding home
    arm = zoo.arm7(device=dev)
    arm_plugin = QPPVMPlugin(arm, left_ee="arm1_7", right_ee="arm1_7",
                             iters=40)
    arm_robot = SimRobot(arm, dt=1e-3, substeps=2)
    zero(NS)
    zero(SWEEP, PLAIN_SWEEP)
    zero(REPLAY, CAPTURE)
    arm_stats, arm_tr = qppvm_loop(torch, arm_plugin, arm_robot, ARM7_TICKS,
                                   tmp.name + "/arm7")
    arm_ns = counted(NS)
    q_err = float((arm_robot.state.q - arm.q_home).abs().max())
    qd_max = float(arm_robot.state.qd.abs().max())
    tau_over = float((np.abs(arm_tr["tau_desired"][:, 0])
                      - arm.tau_max.cpu().numpy()).max())
    print(f"QPPVM arm7 hold: {ARM7_TICKS} ticks, {arm_stats.solver_failures} "
          f"failed, max |q - q_home| {q_err:.4g}, max |qd| {qd_max:.4g}, "
          f"|tau| - tau_max up to {tau_over:.3g} Nm, {arm_ns} NS launches")
    print(f"[{card}] QPPVM arm7 loop B=1: tick p50 {arm_stats.p50_ms:.3f} "
          f"ms, p99 {arm_stats.p99_ms:.3f} ms, mean {arm_stats.mean_ms:.3f} "
          f"ms")
    if arm_stats.solver_failures or not (
            q_err < ARM7_Q_TOL and qd_max < ARM7_QD_TOL
            and tau_over <= TAU_LIMIT_TOL):
        fail("QPPVM arm7 hold outside tests/test_qppvm_e2e.py's gates")
    if arm_ns != (1 + arm_robot.substeps) * ARM7_TICKS + 1:
        fail(f"QPPVM arm7 loop: {arm_ns} NS launches")
    gate_sweeps("qppvm_arm7_loop_b1", ARM7_TICKS + 1)
    gate_graph("qppvm_arm7_loop_b1", ARM7_TICKS, 1)
    tmp.cleanup()
    return ({"qppvm_dual_arm_loop_b1": levels,
             "qppvm_kernel_profile_chain_b1": chain_launches,
             "qppvm_kernel_profile_loop_b1": klevels},
            {"qppvm_dual_arm_loop_b1": ns_launches,
             "qppvm_kernel_profile_loop_b1": kns,
             "qppvm_arm7_loop_b1": arm_ns})


def walk_setup(torch, dev, zoo, b, start=None):
    """The walk's quadruped, plant, estimator and one-stride gait; the
    plugin's level solver ``b`` of BACKENDS; references and warm state from
    ``start`` or the plugin's on_start."""
    from types import SimpleNamespace

    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
    from qppvm_tpu_torch.runtime import robot_interface as ri
    from qppvm_tpu_torch.runtime.contact_switch import LegLiftPhases
    from qppvm_tpu_torch.runtime.estimator import FloatingBaseEstimator
    from qppvm_tpu_torch.runtime.gait import GaitScript

    model = zoo.quadruped(device=dev)
    plugin = on_route(b, ForceAccPlugin(model, **WALK_PLUGIN,
                                        solver_opts=WALK_PROFILE))
    robot = ri.SimRobot(model, state=ri.standing_state(model, FEET),
                        dt=1e-3, substeps=WALK_SUBSTEPS, contact_links=FEET,
                        ground_z=0.0)
    start = start or plugin.on_start(robot.state)
    refs, warm, waist = start
    est = FloatingBaseEstimator(model, FEET)
    gait = GaitScript(model, plugin, refs, waist, tail=WALK_TAIL,
                      phases=LegLiftPhases(**WALK_PHASES), **WALK_GAIT)
    return SimpleNamespace(plugin=plugin, robot=robot, est=est, gait=gait,
                           es=est.init(robot.state), warm=warm, start=start)


def drive_walk(torch, w, ticks, record=0, stages=None):
    """``ticks`` ticks of the walk closed on the estimator: estimator (the
    gates of the previous tick's references) -> refs_at -> tick -> plant.
    With ``stages`` (a dict of lists) each stage is timed to a synchronize.
    Returns the last aux, the failures, the largest estimate error and the
    first ``record`` torques, keeping the gates' quantities on the
    device."""
    robot, est, gait, plugin = w.robot, w.est, w.gait, w.plugin
    dev = robot.state.q.device
    gates = torch.ones((1, len(FEET)), device=dev)
    n_fail = torch.zeros((), dtype=torch.int64, device=dev)
    err_max = torch.zeros((), device=dev)
    es, warm, taus, aux = w.es, w.warm, [], None

    def mark(name, t):
        if stages is not None:
            torch.cuda.synchronize()
            now = time.perf_counter()
            stages[name].append((now - t[0]) * 1e3)
            t[0] = now

    for i in range(ticks):
        t = [time.perf_counter()]
        truth = robot.state
        imu = robot.get_imu()
        state, es = est.update(es, robot.get_motor_position(),
                               robot.get_motor_velocity(), imu.orientation,
                               imu.angular_velocity, active=gates)
        mark("estimator", t)
        refs = gait.refs_at(i, state)
        gates = refs["contacts"]["active"]
        mark("refs_at", t)
        tau, warm, aux = plugin.control_loop(state, refs, warm)
        mark("control", t)
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        mark("plant", t)
        n_fail = n_fail + aux.solver_failed.sum()
        err_max = torch.maximum(err_max, torch.linalg.norm(
            state.base_pos - truth.base_pos))
        if i < record:
            taus.append(tau)
    return aux, int(n_fail), float(err_max), taus


def phase_walk(torch, dev, card, hierarchy, level_qp, nsi, zoo):
    """Phase 12: the quadruped's first walk stride closed on the leg-odometry
    estimator, through the level kernel (2 launches a tick) and the NS
    kernel (one launch a plant substep); the first LOOP_COMPARE torques
    held to the same loop through the plain level solver; the tick's
    stages timed."""
    from qppvm_tpu_torch.model import kinematics

    w = walk_setup(torch, dev, zoo, "kernel")
    model, robot = w.plugin.model, w.robot
    ticks = w.gait.total
    p0 = kinematics.fk(model, robot.state).p[0]
    z0 = float(robot.state.base_pos[0, 2])
    stages = {k: [] for k in ("estimator", "refs_at", "control", "plant")}
    zero(LEVEL)
    zero(FALLBACK)
    zero(NS)
    zero(SWEEP, PLAIN_SWEEP)
    zero(REPLAY, CAPTURE)
    t0 = time.perf_counter()
    aux, n_fail, err_max, taus = drive_walk(torch, w, ticks,
                                            record=LOOP_COMPARE,
                                            stages=stages)
    run_s = time.perf_counter() - t0
    launches, fallbacks, ns_launches = (counted(LEVEL),
                                        counted(FALLBACK), counted(NS))
    p1 = kinematics.fk(model, robot.state).p[0]
    moved = {c: (p1[model.link_index(c)] - p0[model.link_index(c)])
             for c in FEET}
    swing_dx = float(moved[WALK_SWING][0])
    stance = max(float(torch.linalg.norm(d)) for c, d in moved.items()
                 if c != WALK_SWING)
    up = float(robot.state.base_rot[0, 2, 2])
    dz = float(robot.state.base_pos[0, 2]) - z0
    fz = aux.wrenches[0, :, 2].tolist()
    print(f"walk stride (quadruped, cones mu 0.5, switchable contacts, "
          f"closed on the estimator): {ticks} ticks in {run_s:.1f} s, "
          f"{n_fail} solver failures, {launches} level launches, "
          f"{fallbacks} fallbacks, {ns_launches} NS launches; {WALK_SWING} "
          f"{swing_dx:+.5f} m, stance feet moved <= {stance:.4f} m, up "
          f"{up:.5f}, dz {dz:+.5f} m, last fz {[round(f, 1) for f in fz]} "
          f"N, estimate error <= {err_max:.5f} m")
    print(f"walk stride, the JAX package's first stride on a CPU: "
          f"{WALK_JAX}")
    if (launches, fallbacks) != (2 * ticks, 0):
        fail(f"walk stride: {launches} level launches, {fallbacks} "
             f"fallbacks; expected {2 * ticks} and 0")
    if ns_launches != WALK_SUBSTEPS * ticks:
        fail(f"walk stride: {ns_launches} NS launches, expected "
             f"{WALK_SUBSTEPS * ticks}")
    gate_sweeps("walk_stride_b1", ticks)
    gate_graph("walk_stride_b1", ticks, 1)
    if n_fail:
        fail(f"walk stride: {n_fail} solver failures")
    if not swing_dx >= WALK_SWING_SHARE * WALK_GAIT["stride"][0]:
        fail(f"walk stride: {WALK_SWING} advanced {swing_dx:.4f} m")
    if not stance < WALK_STANCE_MAX:
        fail(f"walk stride: a stance foot moved {stance:.4f} m")
    if not (up > WALK_UP and abs(dz) < WALK_DZ):
        fail(f"walk stride: up {up:.4f}, dz {dz:.4f} m")
    if not min(fz) >= FZ_MIN - 1e-3:
        fail(f"walk stride: last tick's fz {fz}")
    if not err_max < WALK_EST_ERR:
        fail(f"walk stride: estimate error {err_max:.4f} m")

    plain = walk_setup(torch, dev, zoo, "torch", start=w.start)
    *_, taus_ref = drive_walk(torch, plain, LOOP_COMPARE,
                              record=LOOP_COMPARE)
    tau_err = compare_taus(torch, taus, taus_ref, "walk stride")
    print(f"walk stride: first {LOOP_COMPARE} taus within {tau_err:.3g} Nm "
          f"of the plain level solver's loop")
    parts = "; ".join(f"{k} {statistics.median(v):.3f} / "
                      f"{statistics.fmean(v):.3f}"
                      for k, v in stages.items())
    total = [sum(v) for v in zip(*stages.values())]
    print(f"[{card}] walk stride B=1 (level kernel, rho_updates 0): tick "
          f"median {statistics.median(total):.3f} ms, mean "
          f"{statistics.fmean(total):.3f} ms, p99 "
          f"{float(np.percentile(total, 99)):.3f} ms; stages median / mean "
          f"ms: {parts}")
    return launches, ns_launches


def phase_async(torch, dev, card, hierarchy, level_qp, nsi, zoo):
    """Phase 13: the async plan/act pipeline on the humanoid: the planner
    on a worker thread and a CUDA stream of its own, the tick acting on
    the committed plan, time-shifted; gated as tests/test_async_mpc.py.
    The tick's host times with a plan in flight and without one."""
    from qppvm_tpu_torch.mpc.rollout import RolloutConfig, standing_state
    from qppvm_tpu_torch.mpc.sampling import MPPIConfig, SamplingMPC
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
    from qppvm_tpu_torch.runtime.async_mpc import AsyncPlanner
    from qppvm_tpu_torch.runtime.robot_interface import SimRobot

    model = zoo.humanoid(device=dev)
    plugin = ForceAccPlugin(model, **ASYNC_PLUGIN)
    st0 = standing_state(model, CONTACTS)
    robot = SimRobot(model, state=st0, dt=1e-3, substeps=2,
                     contact_links=CONTACTS)
    refs, warm, waist_p = plugin.on_start(robot.state)
    mpc = SamplingMPC(plugin, MPPIConfig(**ASYNC_MPPI),
                      RolloutConfig(**ASYNC_ROLLOUT))
    planner = AsyncPlanner(mpc, replan_ticks=ASYNC_REPLAN,
                           ticks_per_step=ASYNC_TICKS_PER_STEP)
    stream = torch.cuda.current_stream()
    zero(LEVEL)
    zero(FALLBACK)
    zero(NS)
    zero(SWEEP, PLAIN_SWEEP)
    zero(REPLAY, CAPTURE)
    ages, tick_ms, in_flight, rt_fails = [], [], [], 0
    t0 = time.perf_counter()
    for i in range(ASYNC_TICKS):
        t = time.perf_counter()
        state = robot.state
        u, age = planner.tick(i, state, refs, warm)
        ages.append(age)
        waist_p = waist_p + u * 1e-3
        refs_t = dict(refs, waist_task=dict(refs["waist_task"], p=waist_p))
        tau, warm, aux = plugin.control_loop(state, refs_t, warm)
        rt_fails += bool(aux.solver_failed.any())   # waits on this stream
        tick_ms.append((time.perf_counter() - t) * 1e3)
        in_flight.append(planner._pending is not None)
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        if i == ASYNC_SHOVE:
            bv = robot.state.base_vel.clone()
            bv[:, 4] += 0.2
            robot.state = dataclasses.replace(robot.state, base_vel=bv)
    stream.synchronize()
    run_s = time.perf_counter() - t0
    planner.close()
    torch.cuda.synchronize()
    launches, fallbacks, ns_launches = (counted(LEVEL),
                                        counted(FALLBACK), counted(NS))
    fails = [float(info["solver_fail_frac"]) for info in planner.infos]
    up = float(robot.state.base_rot[0, 2, 2])
    z, z0 = float(robot.state.base_pos[0, 2]), float(st0.base_pos[0, 2])
    first = next((k for k, a in enumerate(ages) if a >= 0), None)
    busy = [m for m, f in zip(tick_ms, in_flight) if f]
    idle = [m for m, f in zip(tick_ms, in_flight) if not f]
    pct = lambda v, q: float(np.percentile(v, q)) if v else float("nan")  # noqa
    print(f"async pipeline (humanoid, {ASYNC_TICKS} ticks in {run_s:.1f} "
          f"s, planner {ASYNC_MPPI['n_samples']} x {ASYNC_MPPI['horizon']} "
          f"on its own stream): {planner.n_launch} launches, "
          f"{planner.n_commit} commits, commit latencies "
          f"{planner.commit_latency_ticks} ticks, max age {max(ages)}, "
          f"{rt_fails} failed ticks, plans' solver_fail_frac {fails}; "
          f"{launches} level launches ({launches / planner.n_launch:.1f} a "
          f"plan), {fallbacks} fallbacks, {ns_launches} NS launches; up "
          f"{up:.4f}, base z {z0:.4f} -> {z:.4f} m")
    print(f"[{card}] async pipeline tick B=1 (planner.tick + control, to a "
          f"synchronize of the tick's stream): with a plan in flight "
          f"{len(busy)} ticks, p50 {pct(busy, 50):.3f} ms, p99 "
          f"{pct(busy, 99):.3f} ms; without {len(idle)} ticks, p50 "
          f"{pct(idle, 50):.3f} ms, p99 {pct(idle, 99):.3f} ms")
    if planner.n_launch < 3 or planner.n_commit < 3 or first is None:
        fail(f"async pipeline: {planner.n_launch} launches, "
             f"{planner.n_commit} commits")
    if not all(a > 0 for a in ages[first + 1:]):
        fail("async pipeline: a plan was consumed at age 0 after the first "
             "commit")
    if max(ages) < ASYNC_REPLAN:
        fail(f"async pipeline: max age {max(ages)} < {ASYNC_REPLAN}")
    if any(f != 0.0 for f in fails) or rt_fails:
        fail(f"async pipeline: plans' fail fractions {fails}, {rt_fails} "
             f"failed ticks")
    if not (up > 0.95 and z > z0 - 0.08):
        fail(f"async pipeline: up {up:.4f}, base z {z:.4f} m")
    # the ticks' default profile (rho_updates 1) runs qp.solve, counted
    if (launches, fallbacks) != (
            2 * ASYNC_MPPI["horizon"] * planner.n_launch, 2 * ASYNC_TICKS):
        fail(f"async pipeline: {launches} level launches, {fallbacks} "
             f"fallbacks for {planner.n_launch} plans")
    if ns_launches != 2 * ASYNC_TICKS + planner.n_launch:
        fail(f"async pipeline: {ns_launches} NS launches, expected "
             f"{2 * ASYNC_TICKS + planner.n_launch}")
    # one model update a tick and one a step of each plan's rollout
    gate_sweeps("async_loop_b1_and_plans",
                ASYNC_TICKS + ASYNC_MPPI["horizon"] * planner.n_launch)
    gate_graph("async_loop_b1", ASYNC_TICKS, 1)
    return launches, ns_launches


def phase_entry(torch, dev, card, hierarchy, level_qp, nsi, zoo):
    """Phase 14: run.main on configs 1 to 4 for RUN_SECONDS and on config 5
    (one plan at 512 x 8), each JSON line checked; then the native paced
    executor driving the quadruped's tick, traced through the native
    ring."""
    import math

    from qppvm_tpu_torch import config, run
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
    from qppvm_tpu_torch.runtime import native
    from qppvm_tpu_torch.runtime import robot_interface as ri

    name = torch.cuda.get_device_name(dev)
    loop_keys = {"scenario", "seconds", "p50_ms", "p99_ms", "deadline_misses",
                 "final_q_norm", "device"}
    ns_by, level_by = {}, {}
    for cname, args in [(c, ["--seconds", RUN_SECONDS]) for c in RUN_CONFIGS] \
            + [RUN_MPC]:
        path = str(ROOT / "configs" / f"{cname}.yaml")
        cfg = config.load_scenario(path)
        zero(NS)
        zero(LEVEL)
        zero(FALLBACK)
        zero(SWEEP, PLAIN_SWEEP)
        zero(REPLAY, CAPTURE)
        t0 = time.perf_counter()
        out = run.main(["--config", path, *args])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        ns_by[cname], level_by[cname] = counted(NS), counted(LEVEL)
        keys = ({"scenario", "mpc_steps", "n_samples", "horizon", "devices",
                 "plan_norm", "device"} if cfg.mpc.enabled else
                loop_keys | ({"final_base_z"} if cfg.plugin.contact_links
                             else set()))
        nums = [v for k, v in out.items() if k not in ("scenario", "device")]
        if set(out) != keys or out["device"] != name or not all(
                math.isfinite(v) for v in nums):
            fail(f"run {cname}: {out}")
        if "final_base_z" in out:
            model = config.build_model(cfg, dev)
            z_stand = float(config.build_sim(cfg, model).state.base_pos[0, 2])
            if not abs(out["final_base_z"] - z_stand) < RUN_Z_TOL:
                fail(f"run {cname}: final base z {out['final_base_z']} "
                     f"against the standing {z_stand:.4f} m")
        if cfg.mpc.enabled:
            horizon = int(args[args.index("--horizon") + 1])
            # on_start's two cold, polished solves of the humanoid's 2
            # levels run qp.solve, counted
            if (counted(LEVEL), counted(FALLBACK), out["devices"]) != (
                    2 * horizon, 2 * 2, 1) or counted(NS) != 1:
                fail(f"run {cname}: {counted(LEVEL)} level launches, "
                     f"{counted(FALLBACK)} fallbacks, {counted(NS)} NS")
        elif counted(NS) < int(round(float(RUN_SECONDS) * 1e3)):
            fail(f"run {cname}: {counted(NS)} NS launches")
        # one model update a tick or a rollout step; a ForceAcc on_start
        # runs the plain sweeps, a QPPVM one the kernel
        steps = (horizon if cfg.mpc.enabled
                 else int(round(float(RUN_SECONDS) / cfg.sim.dt)))
        on_start = (0, 1) if cfg.plugin.type == "force_acc" else (1, 0)
        gate_sweeps(f"run_{cname}", steps + on_start[0], plain=on_start[1])
        # a plan's run makes no tick
        gate_graph(f"run_{cname}", 0 if cfg.mpc.enabled else steps,
                   int(not cfg.mpc.enabled))
        print(f"[{card}] run {cname} {' '.join(args)}: {json.dumps(out)} "
              f"({run_s:.1f} s with set-up; {ns_by[cname]} NS launches, "
              f"{level_by[cname]} level launches)")

    model = zoo.quadruped(device=dev)
    plugin = ForceAccPlugin(model, iters=40)
    robot = ri.SimRobot(model, state=ri.standing_state(model, FEET),
                        dt=1e-3, substeps=2, contact_links=FEET)
    z0 = float(robot.state.base_pos[0, 2])
    refs, warm0, _ = plugin.on_start(robot.state)
    for _ in range(2):          # eager, then the tick's graph captured
        plugin.control_loop(robot.state, refs, warm0)
    torch.cuda.synchronize()
    ring = native.NativeTraceRing()
    box = {"warm": warm0, "fails": 0, "ticks": 0}

    def tick(i, t_s):
        tau, box["warm"], aux = plugin.control_loop(robot.state, refs,
                                                    box["warm"])
        box["fails"] += bool(aux.solver_failed.any())
        robot.set_reference(tau_ref=tau, q_ref=robot.state.q)
        robot.move()
        ring.push(0, tau)
        box["ticks"] += 1
        return True

    zero(NS)
    zero(SWEEP, PLAIN_SWEEP)
    zero(REPLAY, CAPTURE)
    ex = native.NativeExecutor(period_s=EXEC_PERIOD_S)
    done = ex.run(tick, EXEC_TICKS)
    stats = ex.stats()
    exec_ns = counted(NS)
    gate_sweeps("native_executor_b1", EXEC_TICKS)
    gate_graph("native_executor_b1", EXEC_TICKS, 0)
    n_pop = 0
    while ring.pop() is not None:
        n_pop += 1
    dz = float(robot.state.base_pos[0, 2]) - z0
    print(f"[{card}] native executor, quadruped tick (iters 40) at a "
          f"{EXEC_PERIOD_S * 1e3:.0f} ms period: {done} ticks, "
          f"{box['fails']} failed, p50 {stats['p50_s'] * 1e3:.3f} ms, p99 "
          f"{stats['p99_s'] * 1e3:.3f} ms, mean {stats['mean_s'] * 1e3:.3f} "
          f"ms, deadline misses {stats['deadline_misses']}; {n_pop} trace "
          f"records popped, {ring.dropped} dropped; {exec_ns} NS launches; "
          f"dz {dz:+.5f} m")
    if (done, box["ticks"], box["fails"], n_pop) != (EXEC_TICKS, EXEC_TICKS,
                                                     0, EXEC_TICKS):
        fail(f"native executor: {done} ticks, {box['fails']} failed, "
             f"{n_pop} records")
    if exec_ns != 2 * EXEC_TICKS or not abs(dz) < EXEC_Z_TOL:
        fail(f"native executor: {exec_ns} NS launches, dz {dz:.4f} m")
    return ({"run_config5_plan_b512": level_by[RUN_MPC[0]]},
            {**{f"run_{c}": ns_by[c] for c in ns_by},
             "native_executor_b1": exec_ns})


def ddp_planner(torch, model, contacts, cfg):
    """A CentroidalMPC at ``cfg`` on ``model`` standing on ``contacts``, the
    standing state and the target DDP_DEPTH below its CoM."""
    from qppvm_tpu_torch.model import kinematics
    from qppvm_tpu_torch.mpc.ddp_mpc import CentroidalMPC, CentroidalMPCConfig
    from qppvm_tpu_torch.runtime.robot_interface import standing_state

    st = standing_state(model, contacts)
    com0 = kinematics.com(model, kinematics.fk(model, st))[1][0]
    p_ref = com0 - torch.tensor([0.0, 0.0, DDP_DEPTH], device=com0.device)
    return (CentroidalMPC(model, contacts, CentroidalMPCConfig(**cfg)), st,
            p_ref)


def lqr_problem(torch, dev):
    """tests/test_ilqr.py's LQR problem in float32 on ``dev``: (solve, x0,
    U0, (A, B, Q, R) as numpy); 3 iterations over a horizon of 30."""
    from qppvm_tpu_torch.mpc import ilqr

    rng = np.random.default_rng(0)
    A = np.eye(4) + 0.05 * rng.standard_normal((4, 4))
    Bm = 0.1 * rng.standard_normal((4, 2))
    Q, R, x0 = np.eye(4), 0.1 * np.eye(2), rng.standard_normal(4)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa
    At, Bt, Qt, Rt = t(A), t(Bm), t(Q), t(R)
    solve = ilqr.make_solver(lambda x, u: At @ x + Bt @ u,
                             lambda x, u: 0.5 * (x @ Qt @ x + u @ Rt @ u),
                             lambda x: 0.5 * x @ Qt @ x,
                             ilqr.ILQRConfig(iterations=3))
    return solve, t(x0), torch.zeros((30, 2), device=dev), (A, Bm, Q, R, x0)


def plan_launches(cfg):
    """NS launches of one plan: Q_uu at every step of every backward pass,
    and the SRBD inertia once."""
    from qppvm_tpu_torch.mpc.ddp_mpc import CentroidalMPCConfig

    c = CentroidalMPCConfig(**cfg)
    return c.horizon * (c.iterations + 1) + 1


def ddp_loop(torch, dev, zoo, b, ticks, force=False, record=0):
    """tests/test_ddp_mpc.py's squat on the quadruped for ``ticks`` ticks,
    its levels through level solver ``b``; with ``force`` the plan's step-0
    forces in ForceReg as tests/test_force_plan_tracking.py wires them. Keeps
    every quantity on the device; sets the launch counts to 0 after the
    set-up (on_start's polished solves are outside the kernel's profile);
    returns the run's numbers."""
    from qppvm_tpu_torch.model import dynamics, kinematics
    from qppvm_tpu_torch.mpc.ddp_mpc import CentroidalMPC
    from qppvm_tpu_torch.opt import hierarchy, level_qp
    from qppvm_tpu_torch.opt import ns_inverse as nsi
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
    from qppvm_tpu_torch.runtime import robot_interface as ri

    model = zoo.quadruped(device=dev)
    plugin = on_route(b, ForceAccPlugin(model, contact_links=FEET,
                                        waist_link="pelvis", iters=40,
                                        solver_opts=DDP_PROFILE))
    mpc, st, p_ref = ddp_planner(torch, model, FEET, DDP_TEST)
    robot = ri.SimRobot(model, state=st, dt=1e-3, substeps=4,
                        contact_links=FEET)
    refs, warm, waist = plugin.on_start(robot.state)
    com0 = p_ref + torch.tensor([0.0, 0.0, DDP_DEPTH], device=dev)
    weight = float(dynamics.compute_model_data(model, st).total_mass[0]) * 9.81
    U = mpc.init_plan(st)
    w_force = torch.full((1,), DDP_FORCE_W, device=dev)
    n_fail = torch.zeros((), dtype=torch.int64, device=dev)
    taus, track, plan_s = [], [], 0.0
    zero(LEVEL, FALLBACK, NS)
    zero(PLAIN)
    zero(SWEEP, PLAIN_SWEEP)
    zero(REPLAY, CAPTURE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ticks):
        state = robot.state
        if i % DDP_PLAN_EVERY == 0:
            torch.cuda.synchronize()
            tp = time.perf_counter()
            res, params = mpc.plan(state, p_ref, U)
            torch.cuda.synchronize()
            plan_s += time.perf_counter() - tp
            U = res.U
            if force:
                f_off = CentroidalMPC.force_ref_offset(res, params, weight)
        refs_t = dict(refs)
        refs_t["waist_task"] = dict(refs["waist_task"], p=waist + (
            CentroidalMPC.waist_ref_from_plan(res, DDP_WAIST_K) - com0))
        if force:
            refs_t["FORCE_REG"] = dict(refs["FORCE_REG"], f=f_off[None],
                                       w=w_force)
        tau, warm, aux = plugin.control_loop(state, refs_t, warm)
        n_fail = n_fail + aux.solver_failed.sum()
        robot.set_reference(tau_ref=tau, q_ref=state.q)
        robot.move()
        if i < record:
            taus.append(tau)
        if force and i % DDP_PLAN_EVERY == DDP_PLAN_EVERY - 1:
            fz_plan = res.U[0].reshape(len(FEET), 3)[:, 2]
            track.append(torch.linalg.norm(aux.wrenches[0, :, 2] - fz_plan)
                         / torch.clamp(torch.linalg.norm(fz_plan), min=1e-6))
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    com1 = kinematics.com(model, kinematics.fk(model, robot.state))[1][0]
    return dict(robot=robot, n_fail=int(n_fail), taus=taus,
                finite=bool(torch.isfinite(robot.state.q).all()),
                end_gap=float(res.X[-1, 2] - p_ref[2]),
                dz=float(com1[2] - com0[2]),
                track=[float(t) for t in track], plan_s=plan_s,
                plans=-(-ticks // DDP_PLAN_EVERY), loop_s=loop_s)


def phase_ddp(torch, dev, card, hierarchy, level_qp, nsi, zoo):
    """Phase 15: the centroidal DDP planner on the card. The iLQR on
    tests/test_ilqr.py's LQR problem against the Riccati gains; one plan at
    the test's config against the CPU's; the default config timed on the
    quadruped and the humanoid; tests/test_ddp_mpc.py's squat in closed
    loop and tests/test_force_plan_tracking.py's force-plan loop, each
    600 ticks through both kernels, gated as the tests."""
    from qppvm_tpu_torch.model import dynamics

    # (a) the LQR problem, float32 on the card
    solve, x0_t, U0, (A, Bm, Q, R, x0) = lqr_problem(torch, dev)
    H = U0.shape[0]
    zero(NS)
    zero(PLAIN)
    res = solve(x0_t, U0)
    torch.cuda.synchronize()
    lqr_ns = counted(NS)
    if (lqr_ns, counted(PLAIN)) != (H * 4, 0):
        fail(f"ddp LQR: {lqr_ns} NS launches, {counted(PLAIN)} "
             f"plain inverses, expected {H * 4} and 0")
    P, Ks = Q.copy(), []
    for _ in range(H):
        Ks.append(np.linalg.solve(R + Bm.T @ P @ Bm, Bm.T @ P @ A))
        P = Q + A.T @ P @ (A - Bm @ Ks[-1])
    Ks = np.stack(Ks[::-1])
    x, c_opt = x0.copy(), 0.0
    for k in range(H):
        u = -Ks[k] @ x
        c_opt += 0.5 * (x @ Q @ x + u @ R @ u)
        x = A @ x + Bm @ u
    c_opt += 0.5 * x @ Q @ x
    cost_gap = abs(float(res.cost) - c_opt) / c_opt
    gain_gap = float(np.abs(res.K.cpu().numpy() + Ks).max())
    print(f"ddp LQR (H {H}, 3 iterations, float32 on the card): cost "
          f"{float(res.cost):.6f} against the Riccati policy's {c_opt:.6f} "
          f"(rel {cost_gap:.3g}, bar {LQR_COST_RTOL}); gains within "
          f"{gain_gap:.3g} of the Riccati gains (bar {LQR_GAIN_REL} x "
          f"(1 + {np.abs(Ks).max():.3g})); {lqr_ns} NS launches")
    if not (cost_gap <= LQR_COST_RTOL
            and gain_gap <= LQR_GAIN_REL * (1 + np.abs(Ks).max())):
        fail("ddp LQR: the plan misses the Riccati solution")

    # one plan at the test's config on each robot, card against CPU
    ns_by = {"ddp_lqr": lqr_ns}
    for robot, contacts in (("quadruped", FEET), ("humanoid", CONTACTS)):
        mpc, st, p_ref = ddp_planner(
            torch, getattr(zoo, robot)(device=dev), contacts, DDP_TEST)
        cpu_mpc, cpu_st, cpu_ref = ddp_planner(
            torch, getattr(zoo, robot)(device="cpu"), contacts, DDP_TEST)
        zero(NS)
        zero(PLAIN)
        zero(SWEEP, PLAIN_SWEEP)
        res, _ = mpc.plan(st, p_ref, mpc.init_plan(st))
        torch.cuda.synchronize()
        plan_ns = counted(NS)
        if (plan_ns, counted(PLAIN)) != (plan_launches(DDP_TEST),
                                                  0):
            fail(f"ddp plan ({robot}): {plan_ns} NS launches, "
                 f"{counted(PLAIN)} plain inverses, expected "
                 f"{plan_launches(DDP_TEST)} and 0")
        # one model update in init_plan, one in the plan
        gate_sweeps(f"ddp_plan_test_config_{robot}", 2)
        ref, _ = cpu_mpc.plan(cpu_st, cpu_ref, cpu_mpc.init_plan(cpu_st))
        gaps = []
        for f, rel in DDP_PLAN_BARS:
            a, b = getattr(res, f).cpu(), getattr(ref, f)
            gap, scale = float((a - b).abs().max()), 1 + float(b.abs().max())
            gaps.append(f"{f} {gap:.3g} (bar {rel * scale:.3g})")
            if not gap <= rel * scale:
                fail(f"ddp plan ({robot}), card against CPU: {f} {gap:.3g} "
                     f"apart")
        k_gap = float((res.k.cpu() - ref.k).abs().max())
        k_bar = 1e-3 * (1 + float(ref.U.abs().max()))
        if not k_gap <= k_bar:
            fail(f"ddp plan ({robot}), card against CPU: k {k_gap:.3g} apart")
        print(f"ddp plan ({robot}, horizon {DDP_TEST['horizon']}, "
              f"{DDP_TEST['iterations']} iterations), card against CPU: "
              f"{', '.join(gaps)}, k {k_gap:.3g} (bar {k_bar:.3g}); "
              f"{plan_ns} NS launches, 0 plain inverses; plan end z "
              f"{float(res.X[-1, 2]):.4f} m, target {float(p_ref[2]):.4f}")
        ns_by[f"ddp_plan_test_config_{robot}"] = plan_ns

    # the planner's default config, timed
    plan_ms = {}
    for robot, contacts in (("quadruped", FEET), ("humanoid", CONTACTS)):
        mpc, st, p_ref = ddp_planner(
            torch, getattr(zoo, robot)(device=dev), contacts, {})
        res, _ = mpc.plan(st, p_ref, mpc.init_plan(st))
        zero(NS)
        zero(PLAIN)
        zero(SWEEP, PLAIN_SWEEP)
        times = []
        for _ in range(DDP_PLAN_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, _ = mpc.plan(st, p_ref, res.U)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        per_plan = counted(NS) / DDP_PLAN_REPS
        if per_plan != plan_launches({}) or counted(PLAIN) != 0:
            fail(f"ddp default plan ({robot}): {per_plan} NS launches a "
                 f"plan, {counted(PLAIN)} plain inverses")
        if not (torch.isfinite(res.U).all() and torch.isfinite(res.cost)):
            fail(f"ddp default plan ({robot}): not finite")
        ns_by[f"ddp_plans_default_{robot}"] = counted(NS)
        gate_sweeps(f"ddp_plans_default_{robot}", DDP_PLAN_REPS)
        plan_ms[robot] = statistics.mean(times)
        print(f"[{card}] ddp plan, default config (horizon "
              f"{mpc.cfg.horizon}, {mpc.cfg.iterations} iterations, nu "
              f"{3 * len(contacts)}), {robot}: mean {plan_ms[robot]:.1f} ms "
              f"over {DDP_PLAN_REPS} plans (min {min(times):.1f}, max "
              f"{max(times):.1f}); {per_plan:.0f} NS launches a plan, 0 plain "
              f"inverses; cost {float(res.cost):.4f}, plan end z "
              f"{float(res.X[-1, 2]):.4f} m, target {float(p_ref[2]):.4f}")

    # (b) the closed-loop squat and (c) the force-plan loop
    levels_by = {}
    for label, force in (("ddp_squat_b1", False),
                         ("ddp_force_plan_b1", True)):
        loop = ddp_loop(torch, dev, zoo, "kernel", DDP_TICKS, force=force,
                        record=LOOP_COMPARE)
        launches, fallbacks = counted(LEVEL), counted(FALLBACK)
        ns = counted(NS)
        want_ns = 4 * DDP_TICKS + loop["plans"] * plan_launches(DDP_TEST)
        track = loop["track"][2:]
        print(f"{label}: {DDP_TICKS} ticks at B=1, {loop['plans']} plans: "
              f"{loop['n_fail']} solver failures, finite {loop['finite']}, "
              f"the last plan's end {loop['end_gap'] * 1e3:+.2f} mm off the "
              f"target, CoM dz {loop['dz']:+.5f} m"
              + (f", normal-force tracking error mean {np.mean(track):.4f} "
                 f"(max {max(track):.4f})" if force else "")
              + f"; {launches} level launches, {fallbacks} fallbacks, {ns} "
              f"NS launches, {counted(PLAIN)} plain inverses")
        if loop["n_fail"] or not loop["finite"]:
            fail(f"{label}: {loop['n_fail']} solver failures")
        if not loop["dz"] < DDP_DZ_MAX:
            fail(f"{label}: the CoM moved {loop['dz']:+.5f} m")
        if not force and not abs(loop["end_gap"]) < DDP_END_TOL:
            fail(f"{label}: the plan ends {loop['end_gap']:+.4f} m off")
        if force and not np.mean(track) < DDP_TRACK_MAX:
            fail(f"{label}: normal-force tracking error {np.mean(track):.4f}")
        if (launches, fallbacks, ns, counted(PLAIN)) != (
                2 * DDP_TICKS, 0, want_ns, 0):
            fail(f"{label}: expected {2 * DDP_TICKS} level launches, 0 "
                 f"fallbacks, {want_ns} NS launches, 0 plain inverses")
        # one model update a tick and one a plan
        gate_sweeps(label, DDP_TICKS + loop["plans"])
        gate_graph(label, DDP_TICKS, 1)
        levels_by[label], ns_by[label] = launches, ns
        plain = ddp_loop(torch, dev, zoo, "torch", LOOP_COMPARE, force=force,
                         record=LOOP_COMPARE)
        tau_err = compare_taus(torch, loop["taus"], plain["taus"], label)
        robot = loop["robot"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DDP_SIM_TICKS):
            robot.move()
        torch.cuda.synchronize()
        sim_ms = (time.perf_counter() - t0) / DDP_SIM_TICKS * 1e3
        tick_ms = (loop["loop_s"] - loop["plan_s"]) / DDP_TICKS * 1e3
        print(f"{label}: first {LOOP_COMPARE} taus within {tau_err:.3g} Nm "
              f"of the plain level solver's")
        print(f"[{card}] {label}: {tick_ms:.3f} ms a tick without the plans "
              f"(plant alone {sim_ms:.3f} ms, 4 substeps), "
              f"{loop['plan_s'] / loop['plans'] * 1e3:.1f} ms a plan, "
              f"{loop['loop_s']:.1f} s in all")
    return levels_by, ns_by


def phase_loaders(torch, dev, card, hierarchy, level_qp, nsi, zoo):
    """Phase 16: ModelInterface on two URDF robots, every query on the card
    against the CPU; then run.main on config 1 with the arm's URDF in place
    of zoo: arm7."""
    import math
    import tempfile

    from qppvm_tpu_torch import config, run
    from qppvm_tpu_torch.model import dynamics, spatial
    from qppvm_tpu_torch.model.interface import ModelInterface

    with tempfile.TemporaryDirectory() as tmp:
        for label, text, kw, links in LOADER_ROBOTS:
            path = Path(tmp) / f"{label}.urdf"
            path.write_text(text)
            out = []     # the card's queries, then the CPU's
            for d in (dev, torch.device("cpu")):
                mi = ModelInterface.get_model(str(path), device=d, **kw)
                rng = np.random.default_rng(0)
                mi.set_joint_position(rng.uniform(-1, 1, mi.model.nj))
                mi.set_joint_velocity(rng.uniform(-1, 1, mi.model.nj))
                if mi.model.floating:
                    mi.set_floating_base_state(
                        spatial.so3_exp(torch.full((3,), 0.2)),
                        [0.1, -0.2, 0.8], rng.uniform(-1, 1, 6))
                mi.update()
                q = {}
                for link in links:
                    q[f"pose {link} R"], q[f"pose {link} p"] = mi.get_pose(
                        link)
                    q[f"point {link}"] = mi.get_point_position(
                        link, [0.01, -0.02, 0.03])
                    q[f"J {link}"] = mi.get_jacobian(link)
                q.update(com=mi.get_com(), B=mi.get_inertia_matrix(),
                         h=mi.compute_nonlinear_term(),
                         id=mi.compute_inverse_dynamics(
                             rng.uniform(-1, 1, mi.model.nv)),
                         g=mi.compute_gravity_compensation(),
                         ke=dynamics.kinetic_energy(mi.model, mi.state)[0])
                if any(v.device != d for v in q.values()):
                    fail(f"loaders {label}: a query left {d}")
                out.append({k: v.cpu() for k, v in q.items()})
            gaps = {k: float((out[0][k] - v).abs().max())
                    / (1 + float(v.abs().max()))
                    for k, v in out[1].items()}
            worst = max(gaps, key=gaps.get)
            print(f"loaders {label} (nj {mi.model.nj}, floating "
                  f"{mi.model.floating}): {len(gaps)} ModelInterface queries "
                  f"on the card against the CPU, largest gap {gaps[worst]:.3g}"
                  f" of scale ({worst}; bar {LOADER_REL})")
            if not gaps[worst] <= LOADER_REL:
                fail(f"loaders {label}: {worst} {gaps[worst]:.3g} apart")

        urdf = Path(tmp) / "xarm.urdf"
        cfg_path = Path(tmp) / "config1_urdf.yaml"
        cfg_path.write_text((ROOT / "configs" / "config1_arm7.yaml")
                            .read_text().replace("zoo: arm7",
                                                 f"urdf: {urdf}"))
        model = config.build_model(config.load_scenario(str(cfg_path)), dev)
        if model.device.type != dev.type or model.link_names[-1] != "arm1_7":
            fail(f"loaders: config 1 on the URDF built {model.link_names} on "
                 f"{model.device}")
        zero(NS)
        zero(LEVEL)
        zero(SWEEP, PLAIN_SWEEP)
        zero(REPLAY, CAPTURE)
        t0 = time.perf_counter()
        out = run.main(["--config", str(cfg_path), "--seconds", RUN_SECONDS])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    ticks = int(round(float(RUN_SECONDS) * 1e3))
    keys = {"scenario", "seconds", "p50_ms", "p99_ms", "deadline_misses",
            "final_q_norm", "device"}
    nums = [v for k, v in out.items() if k not in ("scenario", "device")]
    if (set(out) != keys or out["device"] != torch.cuda.get_device_name(dev)
            or not all(math.isfinite(v) for v in nums)):
        fail(f"loaders run config 1 on the URDF: {out}")
    if counted(NS) < ticks:
        fail(f"loaders run: {counted(NS)} NS launches over {ticks} ticks")
    # one model update a tick and the QPPVM on_start's
    gate_sweeps("run_config1_urdf", ticks + 1)
    gate_graph("run_config1_urdf", ticks, 1)
    print(f"[{card}] run config1_arm7 on the URDF arm --seconds "
          f"{RUN_SECONDS}: {json.dumps(out)} ({run_s:.1f} s with set-up; "
          f"{counted(NS)} NS launches, {counted(NS) / ticks:.2f} a tick, "
          f"{counted(LEVEL)} level launches)")
    return {"run_config1_urdf": counted(NS)}


def _ring_rank(rank, n_ranks, device_type):
    """One rank of phase 18 (a): the ring over the real rollout step at
    sweeps None (= S), 1 and S, each timed, against the sequential rollout
    run on this rank. Returns host values."""
    import torch

    from qppvm_tpu_torch.dryrun import rank_device
    from qppvm_tpu_torch.model import zoo
    from qppvm_tpu_torch.mpc.rollout import (RolloutConfig, default_cost,
                                             make_rollout_fn, standing_state)
    from qppvm_tpu_torch.opt import hierarchy, level_qp
    from qppvm_tpu_torch.parallel import mesh as meshlib
    from qppvm_tpu_torch.parallel.ring_horizon import ring_rollout
    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin

    dev = rank_device(rank, device_type)
    sync = torch.cuda.synchronize if dev.type == "cuda" else lambda: None
    # tests/test_ring_real_rollout.py's set-up: the start carry, mild
    # waist commands and pushes, the horizon fractions
    plugin = ForceAccPlugin(zoo.quadruped(device=dev), **RING_PLUGIN)
    st = standing_state(plugin.model, FEET)
    refs, warm, _ = plugin.on_start(st)
    rollout = make_rollout_fn(plugin, RolloutConfig(**RING_ROLLOUT),
                              default_cost)
    carry0 = rollout.init_carry(st, refs, warm)
    H = RING_ROLLOUT["horizon"]
    ones = torch.ones((H, 1, 3), device=dev)
    U = (0.05 * ones, 5.0 * ones, None,
         (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H)
    c, seq = carry0, []
    sync()
    t0 = time.perf_counter()
    for t in range(H):
        c, o = rollout.one_step(c, (U[0][t], U[1][t], None, U[3][t]))
        seq.append(o)
    sync()
    seq_ms = (time.perf_counter() - t0) * 1e3
    L = H // n_ranks
    seg = seq[rank * L:(rank + 1) * L]
    mesh = meshlib.make_mesh(n_ranks, axis="seg")
    out = {}
    for sweeps in (None, 1, n_ranks):
        zero(LEVEL, FALLBACK, SWEEP, PLAIN_SWEEP)
        sync()
        t0 = time.perf_counter()
        final, outs, info = ring_rollout(rollout.one_step, carry0, U, mesh,
                                         sweeps=sweeps)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        out[sweeps] = {
            "ms": ms, "defect": float(info.defect),
            "launches": (counted(LEVEL), counted(FALLBACK)),
            "model_sweeps": (counted(SWEEP), counted(PLAIN_SWEEP)),
            # cost and prim_res of each step against the sequential ones
            "outs_err": max(float((a - torch.stack(b)).abs().max())
                            for a, b in zip(outs[:2], list(zip(*seg))[:2])),
            "outs_scale": max(float(torch.stack(b).abs().max())
                              for b in list(zip(*seg))[:2]),
            "q_err": float((final[0].q - c[0].q).abs().max()),
            "fails": bool(outs[2].any()) or bool(
                torch.stack([o[2] for o in seq]).any())}
    return {"sweeps": out, "seq_ms": seq_ms}


def phase_parallel(torch, dev, card, hierarchy, level_qp, nsi):
    """Phase 17: the multi-rank dryrun (qppvm_tpu_torch/dryrun.py) on 4
    gloo ranks on the card, 1-D and (2, 2) meshes, held to the same plan in
    one process; phase 18 (a): the ring over the real rollout step on 4
    ranks."""
    from qppvm_tpu_torch import dryrun
    from qppvm_tpu_torch.parallel import mesh as meshlib

    n = PARALLEL_RANKS
    H = dryrun.HORIZON
    t0 = time.perf_counter()
    results = dryrun.dryrun_multichip(n, dev, reps=DRYRUN_REPS)
    print(f"phase 17: {n} ranks spawned and planned in "
          f"{time.perf_counter() - t0:.1f} s")
    U1, info1, counts1, ms1 = dryrun.plan_step(dryrun.SAMPLES_PER_RANK * n,
                                               dev)
    U1 = U1.cpu().numpy()
    _, _, _, ms1b = dryrun.plan_step(dryrun.SAMPLES_PER_RANK * n, dev)
    # a plan: 2 levels a rollout step, the start inverse, one model update
    # a rollout step
    want = (2 * H, 1, 0, H)
    if counts1 != want:
        fail(f"dryrun single-process plan: (level, NS, fallbacks, model "
             f"sweeps) launches {counts1}, expected {want}")
    SWEEPS["dryrun_one_process_plan"] = counts1[3]
    launches = {}
    for tag, per_rank in results.items():
        for r, res in enumerate(per_rank):
            if tuple(res["counts"]) != want:
                fail(f"dryrun [{tag}] rank {r}: (level, NS, fallbacks, "
                     f"model sweeps) launches {res['counts']} a plan, "
                     f"expected {want}")
        res = per_rank[0]
        u_err = float(np.abs(res["U_new"] - U1).max())
        c_rel = abs(res["cost_mean"] - float(info1["cost_mean"])) / abs(
            float(info1["cost_mean"]))
        print(f"dryrun [{tag}]: U_new bitwise equal on {n} ranks; against "
              f"the same plan in one process: U max abs diff {u_err:.3g} "
              f"(atol {DRYRUN_U_ATOL}), cost_mean rel diff {c_rel:.3g} "
              f"(rtol {DRYRUN_COST_RTOL}); (level, NS, fallbacks) launches "
              f"a plan on each rank {res['counts']}")
        if not (u_err <= DRYRUN_U_ATOL and c_rel <= DRYRUN_COST_RTOL):
            fail(f"dryrun [{tag}]: the sharded plan is not the one-process "
                 "plan")
        plan_ms = ", ".join(f"{r['ms'][-1]:.3f}" for r in per_rank)
        first_ms = ", ".join(f"{r['ms'][0]:.3f}" for r in per_rank)
        print(f"[{card}] dryrun [{tag}]: {dryrun.SAMPLES_PER_RANK * n} "
              f"samples x {H} steps on {n} gloo ranks of one card: plan "
              f"{max(r['ms'][-1] for r in per_rank):.3f} ms (slowest rank; "
              f"ranks {plan_ms}; first plans {first_ms})")
        launches[f"dryrun_{tag.split()[0]}_plan_per_rank"] = \
            res["counts"][0]
        SWEEPS[f"dryrun_{tag.split()[0]}_plan_per_rank"] = res["counts"][3]
    print(f"[{card}] dryrun: the same plan in one process: "
          f"{ms1b:.3f} ms (first {ms1:.3f})")
    ns = {f"dryrun_{t.split()[0]}_plan_per_rank": per_rank[0]["counts"][1]
          for t, per_rank in results.items()}

    # ---- 18 (a). the ring over the real rollout step ----------------------
    ranks = meshlib.run_ranks(_ring_rank, n, (n, dev.type), timeout_s=600.0,
                              group_timeout_s=120.0)
    S, H_ring = n, RING_ROLLOUT["horizon"]
    sw = [r["sweeps"] for r in ranks]
    for r, res in enumerate(sw):
        for sweeps, v in res.items():
            # a scan of H / S steps a sweep, 2 level launches a step
            want = 2 * (S if sweeps is None else sweeps) * H_ring // S
            if tuple(v["launches"]) != (want, 0):
                fail(f"ring rank {r} sweeps {sweeps}: (level, fallbacks) "
                     f"{v['launches']}, expected ({want}, 0)")
            if tuple(v["model_sweeps"]) != (want // 2, 0):
                fail(f"ring rank {r} sweeps {sweeps}: (model-sweep "
                     f"launches, plain sweeps) {v['model_sweeps']}, "
                     f"expected ({want // 2}, 0)")
            if v["fails"]:
                fail(f"ring rank {r} sweeps {sweeps}: a failed QP step")
        exact = res[None]
        if not (exact["outs_err"] <= RING_ATOL + RING_RTOL
                * exact["outs_scale"] and exact["defect"] < RING_DEFECT
                and exact["q_err"] <= RING_ATOL + RING_RTOL):
            fail(f"ring rank {r}: sweeps=S is not the sequential rollout "
                 f"(outputs {exact['outs_err']:.3g}, defect "
                 f"{exact['defect']:.3g}, final q {exact['q_err']:.3g})")
        if not res[S]["defect"] < RING_DEFECT or \
                res[1]["defect"] < res[S]["defect"]:
            fail(f"ring rank {r}: defects {res[1]['defect']:.3g} (1 sweep) "
                 f"and {res[S]['defect']:.3g} ({S})")
    print(f"ring over the real rollout step (quadruped, cones, horizon "
          f"{H_ring}, {S} segments of {H_ring // S}, level kernel at B 1): "
          f"sweeps=S outputs max abs diff "
          f"{max(r[None]['outs_err'] for r in sw):.3g} from the sequential "
          f"rollout, final q {max(r[None]['q_err'] for r in sw):.3g}, "
          f"defect {sw[0][None]['defect']:.3g}; defect 1 sweep "
          f"{sw[0][1]['defect']:.3g}, {S} sweeps {sw[0][S]['defect']:.3g}; "
          f"{2 * H_ring} level launches a rank at sweeps=S, 0 fallbacks")
    slowest = {k: max(r[k]["ms"] for r in sw) for k in (1, S)}
    print(f"[{card}] ring: 1 sweep {slowest[1]:.3f} ms, {S} sweeps "
          f"{slowest[S]:.3f} ms (slowest rank), {slowest[S] / S:.3f} ms a "
          f"sweep; the {H_ring}-step rollout in one rank "
          f"{max(r['seq_ms'] for r in ranks):.3f} ms")
    launches["ring_real_rollout_per_rank_sweeps_s"] = 2 * H_ring
    SWEEPS["ring_real_rollout_per_rank_sweeps_s"] = H_ring
    return {"levels": launches, "ns": ns}


def phase_stream(torch, dev, card, hierarchy, level_qp, nsi, zoo):
    """Phase 18 (b): scan_with_stream over the quadruped's closed-loop
    tick (tests/test_trace_stream.py's set-up) against the same ticks
    dispatched one by one with host-side adds."""
    import tempfile

    from qppvm_tpu_torch.plugins.force_acc import ForceAccPlugin
    from qppvm_tpu_torch.runtime import logger
    from qppvm_tpu_torch.runtime import robot_interface as ri

    model = zoo.quadruped(device=dev)
    plugin = ForceAccPlugin(model, contact_links=FEET, waist_link="pelvis",
                            iters=15, use_friction_cones=True, mu=0.5,
                            foot_tasks_6d=False)
    robot = ri.SimRobot(model, state=ri.standing_state(model, FEET),
                        dt=1e-3, substeps=1, contact_links=FEET)
    refs, warm, _ = plugin.on_start(robot.state)
    zk = torch.zeros(model.nj, device=dev)

    def tick(carry, _):
        st, anchors, w = carry
        tau, w, aux = plugin._step_impl(st, refs, w)
        st, anchors = robot.step(st, anchors, tau, st.q, zk, zk)
        return (st, anchors, w), {
            "tau_qp": tau[0], "prim_res": aux.prim_res[0],
            "fz": aux.wrenches[0, :, 2], "base_z": st.base_pos[0, 2]}

    carry0 = (robot.state, robot._anchors, warm)
    with tempfile.TemporaryDirectory() as tmp:
        streamed = logger.TraceBuffer(f"{tmp}/dev", capacity=STREAM_TICKS)
        zero(COPY)
        zero(NS)
        zero(SWEEP, PLAIN_SWEEP)
        zero(REPLAY, CAPTURE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry_s = logger.scan_with_stream(tick, carry0, STREAM_TICKS,
                                          streamed, chunk=STREAM_CHUNK)
        torch.cuda.synchronize()
        ms_s = (time.perf_counter() - t0) / STREAM_TICKS * 1e3
        copies, ns_launches = counted(COPY), counted(NS)
        gate_sweeps("stream_loop_b1", STREAM_TICKS)
        gate_graph("stream_loop_b1", STREAM_TICKS, 1)
        host = logger.TraceBuffer(f"{tmp}/host", capacity=STREAM_TICKS)
        c = carry0
        t0 = time.perf_counter()
        for _ in range(STREAM_TICKS):
            c, ch = tick(c, None)
            for k, v in ch.items():
                host.add(k, v)
        ms_h = (time.perf_counter() - t0) / STREAM_TICKS * 1e3
        got, want = streamed.data(), host.data()
    if copies != STREAM_TICKS // STREAM_CHUNK:
        fail(f"stream: {copies} host copies, expected "
             f"{STREAM_TICKS // STREAM_CHUNK}")
    if ns_launches != STREAM_TICKS:
        fail(f"stream: {ns_launches} NS launches, expected {STREAM_TICKS}")
    if sorted(got) != sorted(want) or not all(
            np.array_equal(got[k], want[k]) for k in want):
        fail("stream: the streamed channels differ from the per-tick ones")
    if not torch.equal(carry_s[0].q, c[0].q):
        fail("stream: the streamed loop's state differs")
    if not float(np.max(got["prim_res"])) < plugin.RT_FAIL_TOL:
        fail(f"stream: prim_res up to {float(np.max(got['prim_res']))}")
    print(f"stream: {STREAM_TICKS} ticks of the quadruped's closed loop "
          f"in {copies} host copies of {STREAM_CHUNK} ticks, every channel "
          f"bitwise the per-tick dispatch's; {ns_launches} NS launches")
    print(f"[{card}] stream: {ms_s:.3f} ms a tick streamed, {ms_h:.3f} ms "
          "a tick with a host add a channel")
    return {"levels": 0, "ns": ns_launches}


def phase_flops(torch, dev, card, hierarchy, level_qp, nsi, zoo):
    """Phase 18 (c): bench_util's FLOP count and MFU of the humanoid tick
    at B 1024 and of the 512 x 8 plan, the count the same through the
    level kernel and the plain level solver."""
    from qppvm_tpu_torch import bench_util
    from qppvm_tpu_torch.mpc.humanoid_plan import (HORIZON, N_SAMPLES,
                                                   humanoid_plan)

    name = torch.cuda.get_device_name(dev)
    plugins, states, refs_b, warm_b = main_path_inputs(
        torch, dev, zoo.humanoid(device=dev), CONTACTS)
    counts = {b: bench_util.matmul_flops(plugins[b]._step_impl, states,
                                         refs_b, warm_b) for b in BACKENDS}
    if counts["kernel"] != counts["torch"]:
        fail(f"FLOP count of the tick: {counts}")
    tick_ms = statistics.median(tick_times_ms(
        torch, plugins["kernel"], states, refs_b, warm_b))
    plans = {b: on_route(b, humanoid_plan(device=dev), "plan")
             for b in BACKENDS}
    g = torch.Generator(device=dev).manual_seed(0)
    U0 = plans["kernel"].mpc.init_plan()
    pcounts = {b: bench_util.matmul_flops(p.plan, g, U0)
               for b, p in plans.items()}
    if pcounts["kernel"] != pcounts["torch"]:
        fail(f"FLOP count of the plan: {pcounts}")
    plans["kernel"].plan(g, U0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MPC_REPS):
        plans["kernel"].plan(g, U0)
    torch.cuda.synchronize()
    plan_ms = (time.perf_counter() - t0) / MPC_REPS * 1e3
    for label, flops, ms in (
            (f"humanoid tick B={B}", counts["kernel"], tick_ms),
            (f"MPC plan {N_SAMPLES} x {HORIZON}", pcounts["kernel"],
             plan_ms)):
        print(f"[{card}] FLOPs ({label}): {flops:.6g} matrix-product FLOPs "
              f"(equal through the level kernel and the plain level "
              f"solver), {ms:.3f} ms, {flops / ms / 1e9:.4g} TFLOP/s, MFU "
              f"{bench_util.mfu(flops, ms / 1e3, name):.4g} of "
              f"{bench_util.peak_flops(name):.3g} FLOP/s float32")
    return {"tick_flops": counts["kernel"], "plan_flops": pcounts["kernel"]}


def start_side_phase(name):
    """Start phase ``name`` in a process of its own (``--phase name``),
    its output to a temporary file; returns (process, file)."""
    import subprocess
    import tempfile

    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                             "--phase", name], stdout=out,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def collect_side_phase(name, proc, out):
    """Wait for a side phase, print its output and return its result;
    fails when the process failed."""
    rc = proc.wait()
    out.seek(0)
    lines = out.read().splitlines()
    out.close()
    results = [ln[len(RESULT_TAG):] for ln in lines
               if ln.startswith(RESULT_TAG)]
    print("\n".join(ln for ln in lines if not ln.startswith(RESULT_TAG)))
    if rc != 0 or len(results) != 1:
        fail(f"phase {name}: its process exited {rc}")
    out = json.loads(results[0])
    SWEEPS.update(out["sweeps"])
    return out["result"]


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; nothing run")
    import_port()
    from qppvm_tpu_torch import build
    from qppvm_tpu_torch.opt import hierarchy, level_qp, ns_inverse
    from qppvm_tpu_torch.model import model_sweep, zoo
    from qppvm_tpu_torch.opt import level_qp_parity as parity

    dev = torch.device("cuda", 0)
    card = card_line()
    args = (torch, dev, card, hierarchy, level_qp, ns_inverse)
    # phases 5 to 18, each with its result's name
    phases = {
        "loop": lambda: phase_closed_loop(*args),
        "mpc": lambda: phase_mpc(*args),
        "centaur": lambda: phase_centaur_tick(*args, zoo),
        "quad": lambda: phase_quadruped_loop(*args, zoo),
        "capture": lambda: phase_capture(*args),
        "step": lambda: phase_step_recovery(*args, zoo),
        "qppvm": lambda: phase_qppvm(*args, zoo),
        "walk": lambda: phase_walk(*args, zoo),
        "async": lambda: phase_async(*args, zoo),
        "entry": lambda: phase_entry(*args, zoo),
        "ddp": lambda: phase_ddp(*args, zoo),
        "loaders": lambda: phase_loaders(*args, zoo),
        "parallel": lambda: phase_parallel(*args),
        "stream": lambda: phase_stream(*args, zoo),
        "flops": lambda: phase_flops(*args, zoo)}
    if sys.argv[1:2] == ["--phase"]:    # one phase in a process of its own
        for m in (level_qp, ns_inverse, model_sweep):   # built before timing
            m.library()
        alone = dict(phases, sweep=lambda: phase_model_sweep(
            torch, dev, card, zoo))
        result = alone[sys.argv[2]]()
        print(RESULT_TAG + json.dumps({"result": result, "sweeps": SWEEPS}))
        return
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    kernels = (level_qp, ns_inverse, model_sweep)
    with ThreadPoolExecutor(3) as pool:   # one nvcc per source, together
        for f in [pool.submit(m.library) for m in kernels]:
            f.result()
    print(f"build: level_qp.cu, ns_inverse.cu and model_sweep.cu built and "
          f"loaded in {time.perf_counter() - t0:.1f} s")
    for name in ("level_qp", "ns_inverse", "model_sweep"):
        log = build.library_path(name).with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())
    print(card)

    t0 = time.perf_counter()
    run = phase_levels(torch, dev, card, parity, level_qp)
    run.update(phase_main_path(torch, dev, card, hierarchy, level_qp, zoo))
    run["ns_row"] = phase_ns_inverse(torch, dev, card)
    run["sweep_row"] = phase_model_sweep(torch, dev, card, zoo)
    print(f"phases 2 to 4 took {time.perf_counter() - t0:.1f} s")
    # the kernels' timing phases ran alone; the closed loops and plans,
    # host-bound, now share the card: the longest run in processes of
    # their own beside this one's
    side = {name: start_side_phase(name) for name in SIDE_PHASES}
    try:
        for name, phase in phases.items():
            if name not in side:
                t0 = time.perf_counter()
                run[name] = phase()
                print(f"phase {name} took {time.perf_counter() - t0:.1f} s")
        for name in list(side):
            run[name] = collect_side_phase(name, *side.pop(name))
    finally:
        for proc, out in side.values():
            proc.kill()
            proc.wait()
            out.close()
    print(card)
    print_kernels_line(torch, run)


def phase_levels(torch, dev, card, parity, level_qp):
    """Phase 2: the level kernel against its plain version, timed."""
    from qppvm_tpu_torch.bench_util import bound_ms, level_qp_cost
    from qppvm_tpu_torch.mpc.humanoid_plan import N_SAMPLES

    # ---- 2. level kernel vs plain version ----------------------------------
    max_err, level_ms, level_bound = 0.0, [], []
    level_ms_b1, level_ms_rollout = [], []
    for i, (n, m, h, t) in enumerate(LEVEL_SHAPES):
        cfg = level_qp.LevelQPConfig(n_eq_head=h, n_eq_tail=t,
                                     cold_ns_iters=10)
        prob = parity.random_problems(B, n, m, h, t, dev, seed=i)
        err, state = check_level_phase(
            torch, parity, level_qp, cfg, prob,
            parity.zero_state(B, n, m, dev), f"n={n} m={m} h={h} t={t}")
        if (n, m, h, t) in MAIN_SHAPES:
            max_err = max(max_err, err)
            k_ms, p_ms = time_level(torch, level_qp, cfg, prob, state)
            level_ms.append((k_ms, p_ms))
            level_bound.append(level_qp_cost(cfg, B, n, m))
            b_ms, b_by = bound_ms(*level_bound[-1])
            print(f"[{card}] level n={n} m={m} h={h} t={t} B={B}: "
                  f"kernel {k_ms:.4f} ms, plain PyTorch {p_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})")
            # the real-time tick's size: one problem, one block
            prob1 = parity.random_problems(1, n, m, h, t, dev, seed=20 + i)
            err, state1 = check_level_phase(
                torch, parity, level_qp, cfg, prob1,
                parity.zero_state(1, n, m, dev),
                f"B=1 n={n} m={m} h={h} t={t}")
            max_err = max(max_err, err)
            k_ms, p_ms = time_level(torch, level_qp, cfg, prob1, state1)
            call_ms = cuda_time_ms(torch, lambda: level_qp.solve_level(
                cfg, *prob1, *state1))
            level_ms_b1.append(k_ms)
            print(f"[{card}] level n={n} m={m} h={h} t={t} B=1: kernel "
                  f"{k_ms:.4f} ms on the device ({call_ms:.4f} ms a call with "
                  f"the wrapper's host time), plain PyTorch {p_ms:.4f} ms")
    for i, (n, m, h, t) in enumerate(MAIN_SHAPES):
        cfg = level_qp.LevelQPConfig(n_eq_head=h, n_eq_tail=t,
                                     **ROLLOUT_LEVEL)
        prob = parity.random_problems(N_SAMPLES, n, m, h, t, dev, seed=10 + i)
        label = f"rollout profile B={N_SAMPLES} n={n} m={m} h={h} t={t}"
        err, state = check_level_phase(
            torch, parity, level_qp, cfg, prob,
            parity.zero_state(N_SAMPLES, n, m, dev), label,
            phases=("cold", "warm", "warm 2"))
        max_err = max(max_err, err)
        k_ms, p_ms = time_level(torch, level_qp, cfg, prob, state)
        level_ms_rollout.append(k_ms)
        print(f"[{card}] level {label}: kernel {k_ms:.4f} ms, plain PyTorch "
              f"{p_ms:.4f} ms")

    err, robot_level_ms = phase_robot_levels(torch, dev, card, parity,
                                             level_qp)
    return {"max_err": max(max_err, err), "level_ms": level_ms,
            "level_bound": level_bound, "level_ms_b1": level_ms_b1,
            "level_ms_rollout": level_ms_rollout,
            "robot_level_ms": robot_level_ms}


def phase_main_path(torch, dev, card, hierarchy, level_qp, zoo):
    """Phase 3: the humanoid's batched tick through the level kernel."""
    # ---- 3. main path -------------------------------------------------------
    plugins, states, refs_b, warm_b = main_path_inputs(
        torch, dev, zoo.humanoid(device=dev), CONTACTS)
    zero(LEVEL)
    zero(FALLBACK)
    zero(SWEEP, PLAIN_SWEEP)
    zero(REPLAY, CAPTURE)
    taus, prim_max = chain(torch, plugins["kernel"], states, refs_b, warm_b,
                           "kernel")
    torch.cuda.synchronize()
    launches, fallbacks = counted(LEVEL), counted(FALLBACK)
    print(f"main path: {TICKS} ticks at B={B}: kernel launches {launches}, "
          f"fallbacks {fallbacks}, model-sweep launches {counted(SWEEP)}, "
          f"plain sweeps {counted(PLAIN_SWEEP)}, solver_fail_frac 0.0, "
          f"prim_res_max {prim_max:.3g}")
    if launches != 2 * TICKS or fallbacks != 0:
        fail(f"expected {2 * TICKS} launches and 0 fallbacks")
    gate_sweeps("batched_tick", TICKS)
    gate_graph("batched_tick", TICKS, 1)
    taus_ref, _ = chain(torch, plugins["torch"], states, refs_b, warm_b,
                        "torch")
    tau_err = compare_taus(torch, taus, taus_ref, "main path")
    print(f"tau vs plain-solver chain: max abs diff {tau_err:.3g} Nm "
          f"(|tau| up to {float(taus_ref[-1].abs().max()):.3g} Nm; "
          f"atol {TAU_ATOL}, rtol {TAU_RTOL})")

    for b in BACKENDS:
        times = tick_times_ms(torch, plugins[b], states, refs_b, warm_b)
        print(f"[{card}] batched tick B={B} ({b} level solver): median "
              f"{statistics.median(times):.3f} ms over {REPS} reps "
              f"(min {min(times):.3f}, max {max(times):.3f})")
    return {"launches": launches}


def sweep_cost(model, B):
    """(FLOPs, bytes) of one model sweep of B items, counted from
    csrc/model_sweep.cu: about 687 FLOPs a revolute link (joint transform
    127, fk 78, three motion transforms 126, the velocity products 51, the
    link's force 180, the bias 72, the backward step 53) and 200 for the
    base; the state read and the outputs written once an item, the model
    and the topology read once."""
    nj, nv = model.nj, model.nv
    flops = B * (687 * nj + 200)
    nbytes = 4 * (B * (2 * nj + 18 + 21 * nj + nv) + 51 * nj + 39
                  + 5 * nj + 2)
    return flops, nbytes


def far_state(torch, model, B, seed):
    """A state far from home: q std 0.5 about home, qd and base_vel std 1,
    a random base rotation and position (tests/test_torch_model_sweep.py's)."""
    from qppvm_tpu_torch.model import spatial
    g = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                  device=model.device)
    return type(model.home_state())(
        q=t(model.q_home.cpu().numpy() + 0.5 * g.standard_normal(
            (B, model.nj))),
        qd=t(g.standard_normal((B, model.nj))),
        base_rot=spatial.so3_exp(t(g.standard_normal((B, 3)))),
        base_pos=t(g.standard_normal((B, 3))),
        base_vel=t(g.standard_normal((B, 6))))


def phase_model_sweep(torch, dev, card, zoo):
    """Phase 19: the model-sweep kernel against its plain version at the
    cells' and the rollout's shapes, timed, and its launches in a tick."""
    from qppvm_tpu_torch.bench_util import bound_ms
    from qppvm_tpu_torch.model import model_sweep

    max_gap, rows = 0.0, {}
    for i, (name, Bs) in enumerate(SWEEP_SHAPES):
        model = zoo.by_name(name, device=dev)
        state = far_state(torch, model, Bs, seed=i)
        (kin, h, bias) = model_sweep.sweep(model, state)
        kr, hr, br = model_sweep.sweep_reference(model, state)
        torch.cuda.synchronize()
        gaps = {}
        for out, a, r in (("R", kin.R, kr.R), ("p", kin.p, kr.p),
                          ("S_ang", kin.S_ang, kr.S_ang), ("h", h, hr),
                          ("bias_all", bias, br)):
            a, r = a.reshape(Bs, -1), r.reshape(Bs, -1)
            gaps[out] = float(((a - r).abs().amax(1) / torch.clamp(
                r.abs().amax(1), min=1.0)).max())
        label = f"{name} B={Bs}"
        print(f"model_sweep kernel vs plain {label}: " + ", ".join(
            f"{k} {v:.3g}" for k, v in gaps.items()))
        if not max(gaps.values()) < SWEEP_BAR:
            fail(f"model_sweep {label}: kernel differs from the plain "
                 f"version by {max(gaps.values()):.3g} (bar {SWEEP_BAR})")
        max_gap = max(max_gap, *gaps.values())
        run_k = lambda: model_sweep.sweep(model, state)  # noqa: E731
        run_p = lambda: model_sweep.sweep_reference(model, state)  # noqa: E731
        p1 = cuda_time_ms(torch, run_p)
        k1, k2 = (cuda_time_ms(torch, run_k, lead=True) for _ in range(2))
        p2 = cuda_time_ms(torch, run_p)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        call_ms = cuda_time_ms(torch, run_k)
        b_ms, b_by = bound_ms(*sweep_cost(model, Bs))
        rows[label] = (k_ms, p_ms, b_ms, b_by)
        print(f"[{card}] model_sweep {label}: kernel {k_ms:.4f} ms on the "
              f"device ({call_ms:.4f} ms a call with the wrapper's host "
              f"time), plain PyTorch {p_ms:.4f} ms; bound {b_ms:.4g} ms "
              f"({b_by}), kernel at {100 * b_ms / k_ms:.3g}%")

    plugins, states, refs_b, warm_b = main_path_inputs(
        torch, dev, zoo.humanoid(device=dev), CONTACTS)
    zero(SWEEP, PLAIN_SWEEP)
    plugins["kernel"].step_core(states, refs_b, warm_b)
    torch.cuda.synchronize()
    print(f"model_sweep: one step_core of the humanoid at B={B}: "
          f"{counted(SWEEP)} kernel launch(es), {counted(PLAIN_SWEEP)} plain "
          f"sweep(s)")
    gate_sweeps("step_core_b1024", 1)
    k_ms, p_ms, b_ms, b_by = rows["centaur B=1024"]
    return {"name": "model_sweep", "route": "cuda",
            "source": "qppvm_tpu_torch/csrc/model_sweep.cu",
            "replaces": None, "max_abs_err": max_gap,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "ms_humanoid_b1": rows["humanoid B=1"][0],
            "plain_ms_humanoid_b1": rows["humanoid B=1"][1],
            "ms_humanoid_b4096": rows["humanoid B=4096"][0],
            "plain_ms_humanoid_b4096": rows["humanoid B=4096"][1]}


def print_kernels_line(torch, run):
    """The kernels JSON line from every phase's results, then the last
    line."""
    from qppvm_tpu_torch.bench_util import bound_ms

    max_err, level_ms = run["max_err"], run["level_ms"]
    level_bound, level_ms_b1 = run["level_bound"], run["level_ms_b1"]
    level_ms_rollout = run["level_ms_rollout"]
    robot_level_ms, launches = run["robot_level_ms"], run["launches"]
    (loop_launches, loop_ns), (mpc_launches, mpc_ns) = run["loop"], run["mpc"]
    centaur_launches, centaur_ns = run["centaur"]
    quad_launches, quad_ns = run["quad"]
    capture_levels, capture_ns = run["capture"]
    step_launches, step_ns = run["step"]
    qppvm_levels, qppvm_ns = run["qppvm"]
    walk_levels, walk_ns = run["walk"]
    async_levels, async_ns = run["async"]
    entry_levels, entry_ns = run["entry"]
    ddp_levels, ddp_ns = run["ddp"]
    ns_row = run["ns_row"]
    ns_row["launches_by_path"] = {"ns_path": ns_row["launches"],
                                  "closed_loop_b1": loop_ns,
                                  "mpc_plans": mpc_ns,
                                  "centaur_tick_b1024": centaur_ns,
                                  "quadruped_loop_b1": quad_ns,
                                  **capture_ns,
                                  "mppi_step_recovery_b512": step_ns,
                                  **qppvm_ns,
                                  "walk_stride_b1": walk_ns,
                                  "async_loop_b1_and_plans": async_ns,
                                  **entry_ns, **ddp_ns, **run["loaders"],
                                  **run["parallel"]["ns"],
                                  "stream_loop_b1": run["stream"]["ns"]}

    sweep_row = dict(run["sweep_row"], launches=SWEEPS["batched_tick"],
                     launches_by_path=dict(SWEEPS))

    b_ms, b_by = bound_ms(sum(f for f, _ in level_bound),
                          sum(b for _, b in level_bound))
    print(json.dumps({"kernels": [{
        "name": "level_qp", "route": "cuda",
        "source": "qppvm_tpu_torch/csrc/level_qp.cu",
        "replaces": "qppvm_tpu/opt/pallas_qp.py:257",
        "launches": launches, "max_abs_err": max_err,
        "ms": sum(k for k, _ in level_ms),
        "plain_ms": sum(p for _, p in level_ms),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "ms_b1": sum(level_ms_b1), "ms_rollout_b512": sum(level_ms_rollout),
        **{f"ms_{robot}_b{Bl}": sum(
            robot_level_ms[shape, Bl][0]
            for shape, r in ROBOT_SHAPES.items() if r == robot)
           for robot in ROBOTS for Bl in (B, 1)},
        "launches_by_path": {"batched_tick": launches,
                             "closed_loop_b1": loop_launches,
                             "mpc_plans": mpc_launches,
                             "centaur_tick_b1024": centaur_launches,
                             "quadruped_loop_b1": quad_launches,
                             **capture_levels,
                             "mppi_step_recovery_b512": step_launches,
                             **qppvm_levels,
                             "walk_stride_b1": walk_levels,
                             "async_plans_b512": async_levels,
                             **entry_levels, **ddp_levels,
                             **run["parallel"]["levels"]}},
        ns_row, sweep_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
