"""Smoke test of the PyTorch/CUDA port (`spheremanopt_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only uvwx     # phases A, B and the ones named
    python3 chip_smoke.py --only 89       # profiling, the doctor, sharding
    python3 chip_smoke.py --only 0        # the example studies

Drives the port's main paths through the same entry points as the
command line (`spheremanopt_torch.run.make_problem` and `run.optimise`),
after building the CUDA kernels from `spheremanopt_torch/csrc` and
holding each against its plain PyTorch version on the card:

  * SH23: 256 Fourier modes on a 512-point grid, 1000 SBDF1 steps,
    strong-Wolfe + hybrid CG, alpha0 = pi (shared-matrix kernels);
  * SHB23: 512 Chebyshev roots points, 2000 SBDF1 steps, alpha0 = 1,
    max_iters = 50, err_tol = 1e-5 (two-matrix kernels);
  * the fused diagnostics of both (the series variants of the forward
    kernels);
  * KDyn: the kinematic dynamo on two spheres, 24^3 modes on the 36^3
    dealiased grid, Rm = 1, 2000 CNAB1 steps at dt = 5e-4, cost "Final",
    alpha0 = 100, max_iters = 10 (the three kdyn_step kernels);
  * the operator cotangents of `FusedObjectiveShared` / `FusedObjective`
    at the SH23 and SHB23 widths (the lambda-history variants of both
    reverse kernels and the op_grads product kernel);
  * SH23 with L-BFGS (`--direction lbfgs`) and the continuous adjoint;
  * the device-resident loop (`--device-loop`: the line search and the
    SD/CG/L-BFGS loop on the device, each step a CUDA graph, one flag
    read per step) on the SH23, SHB23 and KDyn kernel workloads and on
    the f64 plain paths, and trust-region Newton (`--direction rtr`) on
    the host and on the device;
  * optimal mixing (no kernel of its own): 2D Boussinesq, 256 Fourier x
    128 Chebyshev modes, 1000 SBDF1 steps at dt = 5e-3, s = 1 (mix-norm),
    E0 = 0.02, the reference workload (Wolfe + hybrid CG, alpha0 = 100,
    max_iters = 200) on the host and device loops.

Inputs come from `baselines/sh23_port_ref.npz`,
`baselines/sh23_ext_port_ref.npz`, `baselines/sh23_rtr_port_ref.npz`,
`baselines/shb23_port_ref.npz`,
`baselines/kdyn_port_ref.npz`, `baselines/kdyn24_truth.npz`,
`baselines/mixing_port_ref.npz` and `baselines/mixing256_truth.npz` (the JAX
package's seed-42 initial conditions, trajectories and f64 values; this
script imports no JAX).

Phases, one line each; any failure exits non-zero without a result line:
  A  card, power limit, torch/CUDA versions, TF32 flags (off)
  B  kernel build (nvcc, sm_90a, one process per source), timed, on a
     thread beside E, F and J, which launch no kernel
  C  SH23 kernels vs plain f32 vs plain f64 on the card, full width (mg =
     512: the grid-wide forward and the 16-CTA cluster reverse sweep);
     the grid forward's u_T, J, trajectory and series, and the cluster
     reverse's lambda_0 and history, bitwise the one-block kernels'
  D  SH23 CUDA-event timings: each sweep and the fwd+grad unit
  E  Taylor test of the SH23 f64 plain path (gamma2 within 0.05 of 2)
  F  SH23 f64 workload (method=matmul) vs the pinned JAX f64 trajectory
  G  SH23 f32 workload through the kernels (method=cuda): a main path,
     then a torch.profiler trace of a second run
  H  SHB23 kernels vs plain f32 vs plain f64, full width (mg = 512: the
     grid-wide forward, bitwise the one-block forward kernel called
     directly, and the 16-CTA cluster reverse); the series variants of
     both forwards bitwise the plain ones (J, u_T, lambda); above the
     reverse cluster's width at mg = 1024, N = 200 the grid-wide forward
     and reverse: a main path of their own through the fused objectives,
     differentiated in u0 (and in u0 and the operators: the reverse's
     history variant), against plain f32, bitwise across the series and
     history variants and bitwise the one-block kernels called directly,
     timed beside them; the grid-wide forward and reverse that read the B
     rows and columns that do not fit from L2 (mg > 1792) at mg = 2048,
     N = 200, the same way; the same for SH23's grid-wide forward and
     reverse (mg > 896) at mg = 1024, N = 200
  I  CUDA-event timings: the SHB23 sweeps (grid forward, cluster reverse), both series
     forwards (grids) and the SHB23 fwd+grad unit, kernel vs plain
  J  Taylor test of the SHB23 f64 plain path
  K  SHB23 f64 workload (method=matmul) vs the pinned JAX f64 trajectory
  L  SHB23 f32 workload through the kernels (method=cuda): a main path,
     then a torch.profiler trace of a second run
  M  fused diagnostics on method=cuda, both problems: a main path of the
     series kernels; J and the gradient bitwise the plain objective's
  N  KDyn kernels vs plain f32 on the card, full width: cost Final at the
     full 2000 steps, Integrated at 200; then J and both gradients of
     method=cuda, plain f32 and plain f64 against the pinned f64 values
  O  CUDA-event timings: the three KDyn sweeps (each in two grid-wide
     stages a step) and the fwd+grad unit (unprojected gradients, as the
     JAX bench's), kernel vs plain (the plain forward with the trajectory,
     the plain reverse and the plain f32 unit are phase N's calls on the
     same inputs, timed there)
  P  Taylor test of the KDyn f64 plain path at 200 steps
  Q  KDyn f64 workload (method=plain) at 200 steps vs the pinned JAX f64
     trajectory
  R  KDyn f32 workload through the kernels (method=cuda) at full size: a
     main path, then a torch.profiler trace of a second run
  S  operator cotangents at full width (SH23: B, N = 1000; SHB23: A and
     B, N = 2000): autograd of the fused objectives in u0 and the
     operators, op_grads at its default (a main path of the history
     sweeps and the product kernel); dB, dA against the plain f32 and
     f64 versions; lambda_0 bitwise the sweep's without the history;
     CUDA-event timings of the sweeps with and without the history and
     of the whole gradient beside the u0-only one; the product kernels
     beside torch.matmul, each in a CUDA graph (no host time per call);
     the product's bound is 3xTF32 at the tensor cores' TF32 peak; a
     torch.profiler trace of one gradient of each
  T  SH23 L-BFGS: the f32 kernel workload (method=cuda, a main path) and
     the f64 workload (method=matmul) vs the pinned JAX f64 trajectory;
     the f64 continuous-adjoint gradient vs JAX's pinned one
  U  SH23 f32 kernels through `--device-loop` (Wolfe + hybrid CG): a main
     path (warm-up, capture, replays); a call of replays only, whose
     counted launches must equal the replayed graphs' launches; the same
     steps run eagerly (graphs=False), bitwise; the first value against
     JAX's f32 one; launches per iteration beside phase G's host loop; a
     torch.profiler trace of a third call
  V  the same for SHB23 (L) and KDyn (R) at full size, and KDyn's armijo
     mode (its J-only backtracking trials: the kdyn_fwd kernel)
  W  the f64 plain device loop vs the pinned JAX f64 trajectories: SH23
     (Wolfe + CG), SH23 L-BFGS, KDyn at 200 steps
  X  trust-region Newton, SH23 f64: the host loop (its first 3
     iterations) and the device loop (to convergence) vs the pinned JAX
     f64 trajectories and counts; `spheremanopt_torch.run sh23
     --direction rtr` (its `main`) at the CUDA default prints the
     substitution notice and runs
  Y  mixing's fwd+grad unit at full width and depth from
     mixing256_truth's x0: f64 J and gradient against the pinned f64
     truth, f32 against the same truth; the fused diagnostics' J bitwise
     `objective`, the wall residuals at roundoff; CUDA-event times of the
     f64 and f32 units beside the operator-stream bound, and a
     torch.profiler trace of an f32 unit at N = 50
  Z  mixing workloads: the f64 host loop at N = 100 vs the pinned JAX f64
     trajectory; the f32 reference workload through `--device-loop` to
     its end (the operator stacks as the loop's aux operand), its first
     value against JAX's f64 one; the same workload's first 3 iterations
     through the host loop (a launch-bound eager unit takes seconds); the
     loop's graphs bitwise its eager steps at N = 100, and a trace of one
     Wolfe-trial graph replay of that loop; one RTR iteration through
     `spheremanopt_torch.run mixing` (its `main`) at N = 100
  1  KDyn's continuous adjoint: f64 at N = 200, both costs, the gradient
     and the invariant series (max|div G|, max|div nu|, |<G>|) against
     JAX's pinned ones (`baselines/kdyn_ext_port_ref.npz`); the card's
     default route (method=cuda f32: J from the kdyn_fwd kernel, a main
     path, and the f32 continuous sweep) at the full 2000 steps against
     the port's f64 run; the wall time of one continuous gradient in f32
     and f64 and its launches a step (traced at N = 20); the continuous
     gradient against the discrete truth (reported)
  2  KDyn's remat modes (step, nested, offload, store-all) on the plain
     f32 path, cost Final at 500 steps and Integrated at 1000: J and
     both gradients against step remat, and each mode's peak device
     memory above the resident
  3  df64 (the f32 config's solves in float64): KDyn at full depth and
     mixing at full depth against the truths (J via objective_f64, the
     gradients), KDyn with --df-adjoint at N = 200 against the pinned
     values there; each gradient equal to the f64 config's cast to f32;
     two iterations of each on the device loop (the aux form; KDyn at
     N = 50, mixing at N = 100) against the host loop's
  4  KDyn's Rm route: f64 at N = 50, Wolfe + CG, alpha0 = 100, 4
     iterations at Rm = 1 and 4 through one device-loop object (one
     capture), each against a loop (eager steps) on a problem built at
     that Rm;
     `spheremanopt_torch.run kdyn` (its `main`) for one iteration with
     `--adjoint continuous` and with `--remat nested` at N = 50 (the
     phase cut from N = 200, then 100, for the 1200 s limit)
  5  sweeps over rows (`DeviceOptimiser.sweep`) at full width: the four
     row kernels (a sweep's rows in one launch, the vmapped Pallas
     kernels) called directly at R = 8, every row's u_T, J, trajectory
     and lambda_0 bitwise the one-row kernels', against the plain rows,
     timed at R = 8 and 1 beside 8 one-row calls; SH23 f32 kernels on
     native rows, B = 8, E0 = linspace(0.02, 0.10): 5 Wolfe + CG
     iterations, every row bitwise its unbatched run, a main path of a
     warm sweep (the row kernels, no one-row kernel); the same sweep one
     row at a time (rows=None), bitwise, a main path of the one-row
     kernels; then 30 iterations, bitwise, with the batched and
     sequential wall times and a trace (idle share, launches a replay);
     SHB23 f32 kernels on native rows, B = 4, 5 iterations, bitwise and a
     main path the same way; KDyn's three row kernels (24^3 on 36^3, 2000
     steps) called directly at R = 8, both costs, every row's b_T, J,
     trajectory, b0_bar and u_bar bitwise the one-row kernels', against
     the plain rows at R = 2 (Final; each plain row version timed once),
     timed at R = 8 and 1 beside 8 one-row calls; KDyn f32 kernel sweeps
     on native rows, B = 4, each row on its own radii: Wolfe + CG (5
     iterations) and Armijo (2), every row bitwise its unbatched run, a
     main path of each warm sweep (the row kernels, no one-row kernel);
     a trial of the native f32
     matmul rows at N = 200 (cut), and
     that optimiser's sweep of one row against its unbatched call (walls,
     launches of a trial replay); SH23 f64 matmul (native rows), B = 3, N = 200
     and 5 iterations (cut), within rtol 1e-10; mixing 256x128 at N = 50
     (cut) with one shared stack operand, B = 4, 3 iterations, f64 within
     1e-10, f32 reported; the device RTR on SH23 f64 at N = 100 (cut),
     B = 3, per-row iterations,
     trials, HVPs and `converged` equal to the unbatched runs
  6  the server (`spheremanopt_torch.serve`) in a thread on a socket in a
     temporary directory: status; optimise sh23 f32 `cuda` at full width,
     5 Wolfe iterations, cold then warm; a sweep of 8 seeds with e0 on
     native rows (row 0 bitwise the optimise reply); a sweep on mixing
     (N = 100); save; an
     error reply; status answered while a sweep is busy; shutdown
  7  I/O and --resume through `spheremanopt_torch.run.main` in-process:
     SH23 f32 `cuda` at full width, 5 iterations from the pinned x0,
     plain, with `--archive-full` (FusedArchiver), with `--archive-every
     1` (LightArchiver; `--h5` where h5py is installed) and plain again,
     each a main path: the archived run launches the series forward as
     often as the plain run the plain forward, the plain forward never,
     the reverse as often, J histories bitwise, no recompute, the last
     archive's u_initial bitwise the checkpoint's x_opt_0; the
     optimisation walls and the archiving overhead; SHB23 likewise (3
     iterations); `--resume` of the SH23 checkpoint for 2 iterations (x0
     bitwise); KDyn f32 `cuda` 2 iterations and a resume for 1 (both
     spheres bitwise); `--regrid` from 512 to 1024 points (on the
     sphere); `--solve-steps` a + a bitwise one run of 2a (SH23 and SHB23
     at a = 500, KDyn 100, mixing 50); the native SMO1 writer's round
     trip with CRCs on this host
  8  profiling and the doctor: `spheremanopt_torch.run doctor` in a child
     process, run after the last timed work of phases 8 and 9 so that it
     shares the card with no timing (exit 0, gpu_ok true, the device name
     nvidia-smi gives, the kernels' library current); SH23 f32 `cuda` at full width, 2
     iterations through `run.main` with `--profile-dir` (a main path;
     the trace names both kernels); `profiling.time_solve` of the
     fwd+grad unit beside phase D's time, and its `roofline`
     (`sh23_cost_model`)
  9  sharding at one rank, an in-process one-rank NCCL group: KDyn
     transform="distributed" f64 at N = 100 from kdyn24_truth's x0 (24^3
     modes on 36^3), slab and the (1, 1) pencil, J and both gradients
     against the matmul transform (rtol 1e-12 / 1e-9), the two units'
     times; 2 iterations of the device loop on CUDA graphs with the
     distributed problem at N = 20 (full width; CHIP_SMOKE_DIST_LOOP_N=200
     runs it at the pins' depth) against the unsharded matmul loop (rtol
     1e-9);
     SHB23 f32 plain and mixing f64 at N = 100 with the state a one-rank
     DTensor (`on_mesh`), J and g bitwise the unsharded calls
  0  the example studies (`examples/torch_*.py`) through their `main` on
     the card, run last, at full width and a cut depth (EXAMPLES): the
     critical seed energy (SH23 256 modes, 1000 steps, f32 kernels, 1
     bisection of 6-iteration probes: one capture, the ends straddling
     the threshold, E_c inside the final bracket); the critical Rm (KDyn
     24^3, the plain Rm route at 10 of the 2000 steps, 2 iterations a
     probe, 1 bisection: one capture, rm_c inside the bracket); L-BFGS
     against CG on SH23 (f32 kernels, 1000 steps, 6 iterations) and KDyn
     (f32 kernels, 2000 steps, 2 iterations); RTR against CG (SH23 plain
     f32, 100 steps, 2 iterations); the regrid warm start (128 -> 256
     modes, f32 kernels, 50 steps, 20 iterations); the two mixing studies
     at their --small widths (df64 solves, 100 steps, 2 + 1 and 2
     iterations: mix-norm non-increasing). Every x_opt on its sphere,
     every value finite, each JSON line the example's result. The two
     sharded examples run as one-rank torchrun children side by side
     (NCCL, f64, KDyn 16^3 and mixing 32x16 at 20 steps, mixing with the
     KE objective, 3 iterations each) against the unsharded loops
     (TOL_DIST_LOOP). The bisections, L-BFGS against CG and the warm start
     are main paths of their kernels (not recorded on the kernels line)

The phases run in ORDER: A, B, E, F, J (beside the build), then T, X
and Z while K, Q and W, the other pinned f64 loops, run in a second
process on the card (`chip_smoke.py --beside kqw`, its lines printed
after Z), then the rest from C on; no phase that times a kernel runs
beside another process.

Each main path (G, H, L, M, R, S, T, U, V, 1, 5, 7, 8, 0) runs with the launch counters set to 0
just before it and read just after; a kernel of that path that was not
launched fails it. The kernels line lists the kernels of those paths;
the one-block kernels, which no path reaches on an H100, are timed in
phase H's lines only. The last lines are the card, the kernels' JSON line
and `{"ok": true, ...}`. Without CUDA it exits non-zero: there is no
CPU path.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from spheremanopt_torch import run as cli
from spheremanopt_torch.convert import (
    operators_to_torch,
    sh23_operators,
    shb23_operators,
)
from spheremanopt_torch.grad.testgrad import adjoint_gradient_test
from spheremanopt_torch.ops.cuda import build as kbuild
from spheremanopt_torch.ops.cuda import fused_two_matrix as fk
from spheremanopt_torch.ops.cuda import kdyn_step as kd
from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo
# the H100 SXM data-sheet peaks and the bound of a piece of work: the
# larger of its bytes over the HBM rate and its flop over a peak
from spheremanopt_torch.utils.profiling import (
    HBM_RATE,
    TF32_PEAK,
    bound_ms,
    card_name,
    gpu_ms,
)

HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(HERE, "baselines", "sh23_port_ref.npz")
REF_X = os.path.join(HERE, "baselines", "sh23_ext_port_ref.npz")
REF_B = os.path.join(HERE, "baselines", "shb23_port_ref.npz")
REF_K = os.path.join(HERE, "baselines", "kdyn_port_ref.npz")
TRUTH_K = os.path.join(HERE, "baselines", "kdyn24_truth.npz")
REF_R = os.path.join(HERE, "baselines", "sh23_rtr_port_ref.npz")
REF_M = os.path.join(HERE, "baselines", "mixing_port_ref.npz")
REF_KX = os.path.join(HERE, "baselines", "kdyn_ext_port_ref.npz")
TRUTH_M = os.path.join(HERE, "baselines", "mixing256_truth.npz")
OUT = os.path.join(HERE, "build", "chip_smoke")   # run logs (git-ignored)
C2, C3 = 1.8, -1.0     # SH23:  g(u) = 1.8 u^2 - u^3
C2B, C3B = 2.0, -1.0   # SHB23: g(u) = 2 u^2 - u^3
# kernel vs plain f32: both f32, summed in another order over 1000-2000
# nonlinear steps. Kernel vs plain f64: SH23 at the TPU kernel's recorded
# class; SHB23's A_lin has entries ~1/dt = 100, so its gradient gets 1e-4.
TOL_VS_PLAIN, TOL_VS_F64, TOL_G_VS_F64_SHB = 1e-4, 1e-5, 1e-4
GAMMA2_TOL, TRAJ_F64_RTOL, FV0_ATOL, FV0_RTOL, SPHERE_TOL = 0.05, 1e-6, 1e-4, 1e-4, 1e-5
# KDyn. Kernel vs plain f32: both f32, sums in another order, growth over
# 2000 steps whose factors carry 1/dt = 2000. f32 vs the pinned f64 values:
# the class the JAX package recorded for its full-f32 path (1.5e-4), with
# margin. Plain f64 vs the pinned values: J to f64 roundoff; the pinned
# gradients are stored in f32 (~6e-8).
TOL_KDYN_VS_PLAIN, TOL_KDYN_VS_F64, TOL_KDYN_J64, TOL_KDYN_G64 = 1e-3, 1e-3, 1e-10, 1e-6
KDYN_CUT = 200   # steps of the depth-cut f64 phases (a tenth of the horizon)
# steps of phase 1's traced continuous gradients (the profiler's own cost
# grows with their ~170 launches a step: 7.6 and 9.0 s at 50 steps; cut
# from KDYN_CUT for the 1200 s limit)
KDYN_TRACE_CUT = 20
# the continuous adjoint is the same FFT recursion in both packages (f64)
TOL_CONT_F64 = 1e-10
# the JAX package's bench record (iterations, J): another workload, with
# unprojected gradients through its device-resident optimiser loop
KDYN_BENCH_END = (10, 2.518)
# Mixing at 256x128 x 1000 against mixing256_truth.npz: f64 J to roundoff,
# the gradient stored in f32 (~6e-8); f32 J at the class of the JAX
# package's 6-pass f32 solves (1.9e-5); the f32 gradient, from full-f32
# products (no TF32), reads 5.5e-5 of the truth on an H100, and 1e-3
# holds it with a margin of ~18 (the TPU's bf16-pass solves sat at
# several 1e-2, a wrong adjoint gives O(1)); the wall residuals of f64
# solves at roundoff.
TOL_MIX_J64, TOL_MIX_G64, TOL_MIX_J32, TOL_MIX_G32, TOL_MIX_BC = 1e-10, 1e-6, 1e-4, 1e-3, 1e-10
MIX_CUT = 100   # steps of the depth-cut phases (a tenth of the horizon)
# steps of phase Y's traced f32 unit (the profiler's own cost grows with
# its ~85 launches a step: 9.8 s at 100 steps; cut from MIX_CUT for the
# 1200 s limit)
MIX_TRACE_CUT = 50
MIX_HOST_ITERS = 3   # iterations of the f32 workload's host loop
# KDyn's continuous adjoint (1): f64 against JAX's pinned gradient as the
# SH23 one (T); the adjoint invariants at Leray roundoff, as in the JAX
# package's test (below 1e-10 of max|k| max|G|). The f32 route against
# the port's own f64 run at full depth holds KDyn's f32 limit.
TOL_KCONT_INV = 1e-10
# remat modes (2): nested and offload against step remat in f32 (the same
# step arithmetic; the nested sum and recompute order may differ at f32
# roundoff); each mode's own peak device memory below a quarter of step's
TOL_REMAT32, MEM_FRACTION = 1e-6, 0.25
# df64 (3) against the f64 truths: J to f64 roundoff; the truths store
# their gradients in f32 (the port's exact f64 mixing gradient reads
# 5.62e-8), so 1e-7 is the f32 storage floor. The device loop's first
# values against the host loop's, the JAX package's test tolerance.
TOL_DF_J, TOL_DF_G, TOL_DF_LOOP = 1e-10, 1e-7, 2e-6
RM_ITERS, RM_VALUES, TOL_RM = 4, (1.0, 4.0), 1e-12   # Rm route (4)
# phase 4's steps (its checks hold at any depth: loop against loop at each
# Rm, the CLI runs' exit and J); cut from KDYN_CUT, then 100, for the
# 1200 s limit
RM_CUT = 50
# sweeps (5): the row kernels called directly at R = SWEEP_B, full width,
# each row bitwise the one-row kernel; SH23 f32 kernels B = 8 over E0 =
# linspace(0.02, 0.10) and SHB23 f32 kernels B = SHB_SWEEP_B on their
# native rows (the row kernels; u0 = P x and the inner product taken a
# row as the unbatched call takes them), every row bitwise its unbatched
# run at SWEEP_F64_ITERS iterations and SH23's at SWEEP_ITERS; the same
# SH23 sweep one row at a time (rows=None), bitwise; the native f64 rows
# (products of R columns: another summation order) within ROW_RTOL;
# mixing's f32 native rows reported against theirs (f32 roundoff of the
# other order); the depth cuts keep phases 5 and 6 near 150 s
SWEEP_B, SWEEP_ITERS, SWEEP_F64_ITERS, ROW_RTOL = 8, 30, 5, 1e-10
SHB_SWEEP_B = 4
# KDyn's rows (5): the row kernels at R = SWEEP_B, full width and depth,
# both costs, each row bitwise the one-row kernels; against the plain rows
# at R = KDYN_PLAIN_ROWS, cost Final (a plain row takes ~3.4 s forward and
# ~5.3 s reverse), within TOL_KDYN_VS_PLAIN; the f32 `cuda` sweep of
# KDYN_SWEEP_B rows on native rows, Wolfe + CG at KDYN_SWEEP_ITERS
# iterations (cut from SWEEP_F64_ITERS for the 1200 s limit), every row
# bitwise its unbatched run; a warm Armijo sweep (its J-only trials: the
# forward without the trajectory) at KDYN_ARMIJO_ITERS as the main path of
# that row kernel
KDYN_PLAIN_ROWS, KDYN_SWEEP_B, KDYN_SWEEP_ITERS, KDYN_ARMIJO_ITERS = 2, 4, 3, 2
KDYN_ONE_ROW = ("kdyn_fwd", "kdyn_fwd_traj", "kdyn_bwd")
KDYN_ROWS = ("kdyn_fwd_rows", "kdyn_fwd_traj_rows", "kdyn_bwd_rows")
SWEEP_CUT = 200   # steps of the native-row SH23 sweeps (their captures are eager)
MIX_SWEEP_E0, MIX_SWEEP_ITERS = (0.005, 0.01, 0.02, 0.04), 3
MIX_SWEEP_CUT = 50   # the mixing rows' steps (cut from MIX_CUT for the 1200 s limit)
RTR_SWEEP_CUT = 100
# depths: the remat modes' Final units at a quarter of the horizon (cut
# from 2000 for the 1200 s limit: each mode against step remat and each
# mode's peak against step's hold at any depth, ~0.15 of step's for nested
# at 500 steps; an eager unit takes ~5-10 s at 2000), the Integrated ones
# at half, the depth at which phase 2 caught offload's host-copy fault
# (ROADMAP); the df64 device loop's KDyn at N = 50
REMAT_STEPS = {"Final": 500, "Integrated": 1000}
KDYN_LOOP_CUT = 50
# the routes above the reverse clusters' widths (H): SHB23's and SH23's
# grid-wide sweeps at BLOCK_MG, held to the one-block kernels; SHB23's
# grid-wide sweeps with B rows and columns from L2 at WIDE_MG
BLOCK_MG, BLOCK_N, WIDE_MG = 1024, 200, 2048
# phase 9: distributed KDyn against the matmul transform (the tolerances of
# tests/test_parallel.py), the device loop's values against the unsharded
# loop's (tests/test_sharded_optimise.py); 2 iterations of each loop
# (the loops at a cut depth: a distributed f64 unit at N = 200 takes seconds)
TOL_DIST_J, TOL_DIST_G, TOL_DIST_LOOP, DIST_LOOP_ITERS = 1e-12, 1e-9, 1e-9, 2
DIST_LOOP_CUT = int(os.environ.get("CHIP_SMOKE_DIST_LOOP_N", "20"))
DIST_CUT = 100   # the distributed units' steps (cut from KDYN_CUT for the 1200 s limit)
# phase 0: the example studies (examples/torch_*.py) through their `main`,
# at full width and a cut depth: (name, argv, the main path's kernels).
# SH23 at 256 modes on 512 points (the bisection and L-BFGS against CG at
# 1000 steps, RTR's host loops cut to 100; the regrid from 128 to 256
# modes at its own 50 steps), KDyn at 24^3 on 36^3 (the Rm bisection's
# plain loop cut to 10 steps; L-BFGS against CG on the kernels at the
# full 2000), the mixing studies at their --small widths
# (64x32, 128x64; a cold f64 operator assembly at 512x256 takes minutes)
EXAMPLES = (
    ("sh23_critical_seed", ["--max-iters", "6", "--bisections", "1"],
     ("fused_fwd_shared_grid", "fused_bwd_shared")),
    ("kdyn_critical_rm", ["--steps", "10", "--iters", "2", "--bisections", "1"], None),
    ("lbfgs_vs_cg", ["sh23", "--max-iters", "6"],
     ("fused_fwd_shared_grid", "fused_bwd_shared")),
    ("lbfgs_vs_cg", ["kdyn", "--max-iters", "2"], ("kdyn_fwd_traj", "kdyn_bwd")),
    ("rtr_newton_vs_cg", ["--n-iters", "100", "--max-iters", "2"], None),
    ("regrid_warmstart", ["--max-iters", "20"],
     ("fused_fwd_shared_grid", "fused_bwd_shared")),
    ("mixing_regrid_continuation", ["--small", "--coarse-iters", "2", "--fine-iters", "1",
                                    "--out", os.path.join(OUT, "examples", "c.json")], None),
    ("mixing512_df64_study", ["--small", "--n-iters", "100", "--max-iters", "2",
                              "--out", os.path.join(OUT, "examples", "s.npz")], None),
)
# the two sharded examples run as one-rank torchrun children, side by
# side, in f64 at their default widths (KDyn 16^3 at 20 of its 50 steps,
# mixing 32x16; mixing's KE objective, whose Wolfe searches go on past
# the first iteration) against the unsharded loops here (TOL_DIST_LOOP)
SHARDED_ITERS = 3
SHARDED = {
    "kdyn_sharded_optimisation": ["--iters", str(SHARDED_ITERS), "--steps", "20"],
    "mixing_sharded_optimisation": ["--iters", str(SHARDED_ITERS), "--s", "0"],
}
# the order of the phases. NO_KERNELS launch no kernel (the f64 Taylor
# tests and SH23's pinned f64 host loop): they run right after phase B,
# beside the kernels' build. BESIDE, the other pinned f64 loops (host
# loops and device loops, launch-bound, nothing timed), run in a second
# process on the card while this one runs ALONGSIDE, which times no
# kernel either; every timed phase runs after both.
NO_KERNELS, BESIDE, ALONGSIDE = "efj", "kqw", "txz"
ORDER = "ab" + NO_KERNELS + "<" + ALONGSIDE + ">" + "".join(
    c for c in "cdghilmnopqrstuvwxyz1234567890" if c not in NO_KERNELS + BESIDE + ALONGSIDE)
# the run.main flags of phase 7's three SH23 runs
ARCHIVE_FLAGS = {"plain": [], "light": ["--archive-every", "1"], "fused": ["--archive-full"]}
PALLAS = "spheremanopt_tpu/ops/pallas/fused_two_matrix.py"
PALLAS_K = "spheremanopt_tpu/ops/pallas/kdyn_step.py"
LAUNCH_TABLES = (fk, kd)   # modules that count their kernels' launches
# the one-block kernels are the route only on a card where a grid's rows
# or columns do not fit, so no main path on an H100 launches them: phase H
# holds the grids to them bit for bit and prints their times, and they
# stay off the kernels line
REFERENCE_ONLY = ("fused_fwd_shared_block", "fused_fwd_shared_block_ser",
                  "fused_fwd_block", "fused_fwd_block_ser", "fused_bwd_block",
                  "fused_bwd_shared_block")
SOURCES = {k: v for k, v in {**fk.KERNEL_SOURCES, **kd.KERNEL_SOURCES}.items()
           if k not in REFERENCE_ONLY}
REPLACES = {
    "fused_fwd_shared_grid": f"{PALLAS}:150",   # _fwd_kernel_shared
    "fused_fwd_shared_grid_ser": f"{PALLAS}:150",   # same, has_ser=True
    "fused_bwd_shared": f"{PALLAS}:185",        # _bwd_kernel_shared, mg <= 896
    "fused_bwd_shared_grid": f"{PALLAS}:185",   # same, mg > 896
    "fused_fwd_grid": f"{PALLAS}:60",           # _fwd_kernel, mg <= 1792 (H100 SXM)
    "fused_fwd_grid_ser": f"{PALLAS}:60",       # same, has_ser=True
    "fused_fwd_grid_stream": f"{PALLAS}:60",    # same, mg > 1792 (H100 SXM)
    "fused_fwd_grid_stream_ser": f"{PALLAS}:60",    # same, mg > 1792, has_ser=True
    "fused_bwd": f"{PALLAS}:102",               # _bwd_kernel, mg <= 640
    "fused_bwd_grid": f"{PALLAS}:102",          # same, 640 < mg <= 1792 (H100 SXM)
    "fused_bwd_grid_stream": f"{PALLAS}:102",   # same, mg > 1792 (H100 SXM), both variants
    "kdyn_fwd": f"{PALLAS_K}:411",              # _fwd_kernel
    "kdyn_fwd_traj": f"{PALLAS_K}:201",         # _fwd_traj_kernel
    "kdyn_bwd": f"{PALLAS_K}:247",              # _bwd_kernel
    "fused_bwd_shared_ops": f"{PALLAS}:203",    # _bwd_kernel_shared, op_grads
    "fused_bwd_ops": f"{PALLAS}:125",           # _bwd_kernel, op_grads
    "fused_bwd_shared_grid_ops": f"{PALLAS}:203",   # _bwd_kernel_shared, op_grads, mg > 896
    "fused_bwd_grid_ops": f"{PALLAS}:125",      # _bwd_kernel, op_grads, mg > 640
    "op_grads": f"{PALLAS}:125",                # its dA/dB (and :203-206's dB)
    # the same kernels under jax.vmap: pallas_call's batching rule gives
    # each a grid over a sweep's rows, one launch for all of them
    "fused_fwd_shared_rows": f"{PALLAS}:150",   # _fwd_kernel_shared, vmapped
    "fused_bwd_shared_rows": f"{PALLAS}:185",   # _bwd_kernel_shared, vmapped, mg <= 896
    "fused_fwd_rows": f"{PALLAS}:60",           # _fwd_kernel, vmapped
    "fused_bwd_rows": f"{PALLAS}:102",          # _bwd_kernel, vmapped, mg <= 640
    "kdyn_fwd_rows": f"{PALLAS_K}:411",         # _fwd_kernel, vmapped
    "kdyn_fwd_traj_rows": f"{PALLAS_K}:201",    # _fwd_traj_kernel, vmapped
    "kdyn_bwd_rows": f"{PALLAS_K}:247",         # _bwd_kernel, vmapped
}


def two_matrix_objectives(a, b, w, u0, dt, n, operators=False):
    """A main path of the two-matrix sweeps at any width: J of
    `FusedObjective` differentiated in u0, and `FusedObjectiveDiag`'s
    (J, series, u_T), the operators as data (op_grads=False); with
    `operators`, also J's gradient in u0, A and B (the reverse's history
    variant and the product)."""
    def path():
        uu = u0.detach().requires_grad_(True)
        J = fk.FusedObjective.apply(a, b, w, uu, C2B, C3B, dt, n, False)
        (grad,) = torch.autograd.grad(J, uu)
        out = (J.detach(), grad,
               fk.FusedObjectiveDiag.apply(a, b, w, u0, C2B, C3B, dt, n, False))
        if operators:
            aa, bb = (m.detach().requires_grad_(True) for m in (a, b))
            uu = u0.detach().requires_grad_(True)
            J = fk.FusedObjective.apply(aa, bb, w, uu, C2B, C3B, dt, n)
            out += (torch.autograd.grad(J, (uu, aa, bb)),)
        return out
    return path


def reset_launches():
    for mod in LAUNCH_TABLES:
        mod.reset_launches()


def launches():
    return {k: v for mod in LAUNCH_TABLES for k, v in mod.LAUNCHES.items()}


def problem_args(problem, dtype, method, *extra):
    return cli.build_parser().parse_args(
        [problem, "--device", "cuda", "--dtype", dtype, "--method", method,
         "--quiet", "--out-dir", OUT, *extra])


def rel(a, b):
    """max |a - b| / max |b| over tensors (or 0-dim values)."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max())


def crel(a, b):
    """rel() of complex tensors or arrays."""
    a, b = torch.as_tensor(a).to(torch.complex128), torch.as_tensor(b).to(torch.complex128)
    return float((a - b).abs().max() / b.abs().max())


def nrel(a, b):
    """||a - b|| / ||b|| in f64."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double().to(a.device)
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _no_loop(args):
    """A copy of the parsed `args` with --device-loop off."""
    out = type(args)(**vars(args))
    out.device_loop = False
    return out


def max_abs(pairs):
    return max(float((torch.as_tensor(a).double() - torch.as_tensor(b).double())
                     .abs().max()) for a, b in pairs)


def interleaved_ms(plain, kernel, reps_plain, reps_kernel, warm_plain=2,
                   plain_once=False):
    """(plain ms, kernel ms), measured plain, kernel, kernel, plain; with
    `plain_once` (plain versions that take seconds), kernel, plain,
    kernel."""
    if plain_once:
        t = [gpu_ms(kernel, reps_kernel), gpu_ms(plain, reps_plain, warm_plain),
             gpu_ms(kernel, reps_kernel)]
        return t[1], (t[0] + t[2]) / 2
    t = [gpu_ms(plain, reps_plain, warm_plain), gpu_ms(kernel, reps_kernel),
         gpu_ms(kernel, reps_kernel), gpu_ms(plain, reps_plain, warm_plain)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def sweep_work(mg, n_steps, n_mats, fwd, traj=True, ser=False):
    """(flop, bytes) one sweep must do: n_mats (mg, mg) f32 matvecs and
    ~12 flop of elementwise work per grid point per step; each input read
    once (matrices, w, u0 or u_T, the trajectory for a reverse sweep) and
    each output written once (u_T and J, or lambda; the trajectory and
    the series when stored)."""
    flop = n_steps * (2 * n_mats * mg * mg + 12 * mg)
    floats = n_mats * mg * mg + 3 * mg + 1
    floats += n_steps * mg if (traj or not fwd) else 0
    floats += n_steps + 1 if ser else 0
    return flop, 4 * floats


def rows_work(mg, n_steps, n_mats, fwd, n_rows):
    """(flop, bytes) of a row kernel over n_rows sweeps: n_rows times a
    sweep's operations; the matrices read once, each row's vectors (and
    the trajectory: written by a forward, read by a reverse) once."""
    flop, _ = sweep_work(mg, n_steps, n_mats, fwd)
    floats = n_mats * mg * mg + n_rows * (3 * mg + 1 + n_steps * mg)
    return n_rows * flop, 4 * floats


def hist_work(mg, n_steps, n_mats):
    """(flop, bytes) of a reverse sweep that also writes its lambda
    history (n_steps rows of mg floats)."""
    flop, nbytes = sweep_work(mg, n_steps, n_mats, fwd=False)
    return flop, nbytes + 4 * n_steps * mg


def op_grads_work(mg, n_steps, n_out):
    """(flop, bytes, peak) of the operator-cotangent product at f32
    accuracy on the tensor cores: 3xTF32, three TF32 products of 2 mg^2 N
    flop per output (f(u) elementwise aside) at the TF32 peak; the
    history and the trajectory read once, the outputs written once."""
    return (3 * 2 * mg * mg * n_steps * n_out,
            4 * (2 * n_steps * mg + n_out * mg * mg), TF32_PEAK)


def kdyn_work(n, mg, n_steps, fwd, traj):
    """(flop, bytes) one KDyn sweep must do. A transform between the
    (3, n, n, kz) modes and the (3, mg, mg, mg) grid is three per-axis DFT
    stages: complex along x and y (8 flop per complex multiply-add), and
    along z between complex modes and a real grid (4 flop). A forward step
    is a synthesis and an analysis; a reverse step is two transposed
    transforms and the synthesis of the stored state. The pointwise work
    is ~9 flop per grid point for each cross product and ~60 per mode for
    the mode-space tail. Each input is read once (both planes, u, the
    constant pack, the trajectory for a reverse sweep) and each output
    written once (both planes and J, or both plane cotangents and u_bar;
    the trajectory when stored)."""
    kz = n // 2 + 1
    s, grid = 3 * n * n * kz, 3 * mg ** 3
    transform = (8 * mg * n * 3 * n * kz + 8 * mg * n * 3 * mg * kz
                 + 4 * mg * kz * 3 * mg * mg)
    tail = 60 * n * n * kz
    step = (2 * transform + 3 * grid + tail if fwd
            else 3 * transform + 2 * 3 * grid + tail)
    consts = 4 * n * mg + 4 * kz * mg + 9 * n * n * kz
    floats = 2 * s + grid + consts + 1 + (2 * s if fwd else 2 * s + grid)
    floats += 2 * n_steps * s if (traj or not fwd) else 0
    return n_steps * step, 4 * floats


def kdyn_rows_work(n, mg, n_steps, fwd, traj, n_rows):
    """(flop, bytes) of a KDyn row sweep over n_rows rows: n_rows times a
    sweep's operations and bytes, the constant pack read once."""
    flop, nbytes = kdyn_work(n, mg, n_steps, fwd, traj)
    kz = n // 2 + 1
    consts = 4 * (4 * n * mg + 4 * kz * mg + 9 * n * n * kz)
    return n_rows * flop, n_rows * (nbytes - consts) + consts


def _numbers(obj):
    """Every number in a JSON-like object."""
    if isinstance(obj, bool) or obj is None or isinstance(obj, str):
        return []
    if isinstance(obj, (int, float)):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    return [v for o in obj for v in _numbers(o)]


def trace(fn):
    """(wall s, device-busy s, [(kernel, ms, launches)] by time) of one
    call of `fn` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = (getattr(ev, "self_device_time_total", 0)
              or getattr(ev, "self_cuda_time_total", 0))
        rows.append((ev.key, us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows) / 1e3, rows


def timed_once(fn):
    """(fn(), ms) of one call of `fn` by CUDA events (a plain version that
    takes seconds a call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def graph_ms(fn, reps=20, replays=5):
    """Mean ms per call of `fn` on the card: CUDA events around replays of
    one CUDA graph that holds `reps` calls, so the host's per-call time
    (Python wrappers, allocation) is not in it. A call whose host side
    takes longer than its kernels leaves the card idle, and CUDA events
    around plain calls then measure the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()   # warm-up outside the graph
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return gpu_ms(g.replay, replays) / reps


class Smoke:
    def __init__(self):
        self.ref, self.refb, self.refx = np.load(REF), np.load(REF_B), np.load(REF_X)
        self.refk, self.truthk = np.load(REF_K), np.load(TRUTH_K)
        self.refr = np.load(REF_R)
        self.refm, self.truthm = np.load(REF_M), np.load(TRUTH_M)
        self.refkx = np.load(REF_KX)
        self.failures = []
        self.kernels = {name: {} for name in SOURCES}
        self.card = ""
        self.launched, self.host_iters = {}, {}   # main paths' launches, iterations
        # phase B's build, the second process, phase 0's children
        self.build, self.beside, self.children = {}, {}, {}

    def check(self, phase, ok, msg):
        print(f"[{phase}] {'ok' if ok else 'FAIL'}: {msg}", flush=True)
        if not ok:
            self.failures.append(f"{phase}: {msg}")

    def main_path(self, phase, kernels, fn, record=None):
        """Run `fn` with the launch counters set to 0 just before and read
        just after; every kernel in `kernels` must have launched. The
        counts of `record` (default: `kernels`) go to the JSON line."""
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launched = {k: launches()[k] for k in kernels}
        self.launched[phase] = launched
        for k in (kernels if record is None else record):
            self.kernels[k]["launches"] = launched[k]
        self.check(phase, all(v > 0 for v in launched.values()),
                   f"main-path launches {launched}")
        return out

    def print_trace(self, phase, what, fn):
        """Trace one call of `fn` and print its wall and device-busy time,
        idle share and the kernels that took the most device time."""
        wall, busy, rows = trace(fn)
        top = "; ".join(f"{k[:40]} {ms:.3f} ms x{n}" for k, ms, n in rows[:4])
        idle = f"{100 * (1 - busy / wall):.1f} %" if busy > 0 else "not measured"
        print(f"[{phase}] trace of {what}: wall {1e3 * wall:.3f} ms, device busy "
              f"{1e3 * busy:.3f} ms, idle share {idle}; by kernel: {top} "
              f"({len(rows)} kernel names) [{self.card}]", flush=True)
        return wall, busy, rows

    def report_trace(self, phase, problem, x0):
        """Trace a second run of the f32 kernel workload (the optimisation
        only; the problem is built before)."""
        args = problem_args(problem, "float32", "cuda")
        p, x, defaults = cli.make_problem(args, x0=x0)
        self.print_trace(phase, "a second run",
                         lambda: cli.optimise(p, x, defaults, args))

    # -- SH23 ---------------------------------------------------------------

    def phase_a(self):
        self.card = card_name()
        print(self.card, flush=True)
        cli.set_precision()
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        self.check("A", flags == (False, False),
                   f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                   f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
                   f"tf32 matmul/cudnn = {flags}")

    def phase_b(self):
        """Start the kernels' build (each csrc/*.cu in its own nvcc, all at
        once) on a thread: the phases that launch no kernel (NO_KERNELS)
        run meanwhile, and every other phase first waits for it (built)."""
        import threading

        t0 = time.perf_counter()

        def build():
            try:
                kbuild.build()
            except Exception as e:   # reported by built()
                self.build["error"] = e
            self.build["s"] = time.perf_counter() - t0

        self.build = {"thread": threading.Thread(target=build, daemon=True)}
        self.build["thread"].start()

    def built(self):
        """Wait for phase B's build, load the library and report it (once);
        raises if the build failed."""
        if self.build.get("done"):
            if "error" in self.build:
                raise RuntimeError("the kernels did not build (phase B)")
            return
        t0 = time.perf_counter()
        self.build["thread"].join()
        self.build["done"] = True
        if "error" in self.build:
            self.check("B", False, f"build failed: {self.build['error']}")
            raise RuntimeError("the kernels did not build (phase B)")
        kbuild.load()
        ptxas = [ln.strip() for ln in kbuild.build_log.splitlines() if "ptxas info" in ln]
        for ln in ptxas:
            print("  " + ln)
        self.check("B", True, f"built {kbuild.library_path().relative_to(HERE)} "
                   f"in {self.build['s']:.1f} s on a thread (waited "
                   f"{time.perf_counter() - t0:.1f} s for it)")

    def phase_c(self):
        p, x0, _ = cli.make_problem(problem_args("sh23", "float32", "cuda"),
                                    x0=[self.ref["x0_f32"]])
        cfg, dev = p.cfg, x0[0].device
        ops = operators_to_torch(sh23_operators(p), dev)
        b, w = ops["b32"], ops["w32"]
        lin, n = 1.0 / cfg.dt, cfg.n_iters
        u0 = torch.matmul(ops["p32"], x0[0])
        self.sweep_args = (b, w, u0, lin, n)
        fk.reset_launches()
        uT_k, js_k, tr_k, _ = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n)
        uT_p, js_p, tr_p, _ = fk.fused_fwd_shared_plain(b, w, u0, C2, C3, lin, n)
        scale = torch.tensor(-2.0 * cfg.dt, dtype=torch.float32, device=dev)
        lam_k, _ = fk.fused_bwd_shared(b, w, uT_k, tr_k, C2, C3, lin, scale, n)
        lam_p, _ = fk.fused_bwd_shared_plain(b, w, uT_k, tr_k, C2, C3, lin, scale, n)
        torch.cuda.synchronize()
        launched = {k: fk.LAUNCHES[k] for k in ("fused_fwd_shared_grid", "fused_bwd_shared")}
        e_fwd = max(rel(uT_k, uT_p), rel(tr_k, tr_p), rel(js_k, js_p))
        e_bwd = rel(lam_k, lam_p)
        abs_fwd = max_abs([(uT_k, uT_p), (tr_k, tr_p), (js_k, js_p)])
        abs_bwd = max_abs([(lam_k, lam_p)])
        self.kernels["fused_fwd_shared_grid"]["max_abs_err"] = abs_fwd
        self.kernels["fused_bwd_shared"]["max_abs_err"] = abs_bwd
        self.check("C", e_fwd <= TOL_VS_PLAIN and e_bwd <= TOL_VS_PLAIN,
                   f"kernel vs plain f32 (mg={b.shape[0]}, N={n}): fwd rel "
                   f"{e_fwd:.2e} (abs {abs_fwd:.2e}), bwd rel {e_bwd:.2e} "
                   f"(abs {abs_bwd:.2e}), tol {TOL_VS_PLAIN:g}")
        self.check("C", all(v > 0 for v in launched.values()),
                   f"launch counters moved: {launched}")
        # the grid route against the one-block kernel on the same inputs
        ks = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n, store_series=True)
        blk = fk._fwd_shared_block(b, w, u0, C2, C3, lin, n, True, True)
        torch.cuda.synchronize()
        same = ([torch.equal(x, y) for x, y in zip(ks, blk)]
                + [torch.equal(x, y) for x, y in zip((uT_k, js_k, tr_k), ks)])
        route = fk.shared_fwd_route(b.shape[0], fk._card(dev))
        self.check("C", route == "grid" and all(same),
                   f"SH23 forward route {route!r}: u_T, J, trajectory and series "
                   f"bitwise the one-block kernel's, and the series variant's bitwise "
                   f"the plain one's: {same}")
        # the reverse cluster against the one-block kernel on the same inputs
        h_c, h_b = torch.empty_like(tr_k), torch.empty_like(tr_k)
        lam_c = fk.fused_bwd_shared(b, w, uT_k, tr_k, C2, C3, lin, scale, n, lam_hist=h_c)[0]
        lam_b = fk._bwd_shared_block(b, w, uT_k, tr_k, C2, C3, lin, scale, n)
        lam_bh = fk._bwd_shared_block(b, w, uT_k, tr_k, C2, C3, lin, scale, n, h_b)
        torch.cuda.synchronize()
        same_r = [torch.equal(lam_k, x) for x in (lam_b, lam_bh, lam_c)] + [torch.equal(h_c, h_b)]
        route_r = fk.shared_bwd_route(b.shape[0])
        self.check("C", route_r == "cluster" and all(same_r),
                   f"SH23 reverse route {route_r!r}: lambda_0 bitwise the one-block "
                   f"kernel's with and without the history and the history variant's, "
                   f"the history bitwise the one-block kernel's: {same_r}")

        # both f32 paths against plain f64 on the card, at the same x
        p64, x64, _ = cli.make_problem(problem_args("sh23", "float64", "matmul"),
                                       x0=[self.ref["x0_f32"].astype(np.float64)])
        J64, g64 = p64.objective_and_gradient(x64)
        Jk, gk = p.objective_and_gradient(x0)
        pm, xm, _ = cli.make_problem(problem_args("sh23", "float32", "matmul"),
                                     x0=[self.ref["x0_f32"]])
        self.p_cuda, self.p_plain32, self.x32 = p, pm, x0
        Jm, gm = pm.objective_and_gradient(xm)
        relJ = abs(float(Jk) - float(J64)) / abs(float(J64))
        relg = float(torch.linalg.norm(gk[0].double() - g64[0]) / torch.linalg.norm(g64[0]))
        relJm = abs(float(Jm) - float(J64)) / abs(float(J64))
        relgm = float(torch.linalg.norm(gm[0].double() - g64[0]) / torch.linalg.norm(g64[0]))
        self.check("C", relJ <= TOL_VS_F64 and relg <= TOL_VS_F64,
                   f"vs plain f64: kernel rel_J {relJ:.3e} rel_g {relg:.3e} "
                   f"(plain f32: rel_J {relJm:.3e} rel_g {relgm:.3e}), tol {TOL_VS_F64:g}")

    def phase_d(self):
        b, w, u0, lin, n = self.sweep_args
        uT, _, tr, _ = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n)
        scale = torch.tensor(-0.1, dtype=torch.float32, device=u0.device)
        f_pl, f_k = interleaved_ms(
            lambda: fk.fused_fwd_shared_plain(b, w, u0, C2, C3, lin, n),
            lambda: fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n), 3, 20)
        b_pl, b_k = interleaved_ms(
            lambda: fk.fused_bwd_shared_plain(b, w, uT, tr, C2, C3, lin, scale, n),
            lambda: fk.fused_bwd_shared(b, w, uT, tr, C2, C3, lin, scale, n), 3, 20)
        u_pl, u_k = interleaved_ms(
            lambda: self.p_plain32.objective_and_gradient(self.x32),
            lambda: self.p_cuda.objective_and_gradient(self.x32), 3, 20)
        self.unit_ms = u_k   # beside phase 8's time_solve
        mg = b.shape[0]
        self.kernels["fused_fwd_shared_grid"].update(
            ms=f_k, plain_ms=f_pl, work=sweep_work(mg, n, 1, fwd=True))
        self.kernels["fused_bwd_shared"].update(
            ms=b_k, plain_ms=b_pl, work=sweep_work(mg, n, 1, fwd=False))
        self.check("D", True,
                   f"[{self.card}] SH23 fwd sweep (traj) kernel {f_k:.3f} ms vs plain "
                   f"{f_pl:.3f} ms; bwd sweep kernel {b_k:.3f} ms vs plain "
                   f"{b_pl:.3f} ms; fwd+grad unit kernel path {u_k:.3f} ms vs "
                   f"plain f32 path {u_pl:.3f} ms")

    def taylor(self, phase, args, x0):
        p, x0, _ = cli.make_problem(args, x0=x0)
        dx0 = p.generate_ic(seed=43)
        r = adjoint_gradient_test(x0, dx0, p.objective, p.gradient, p.inner_product,
                                  epsilon=1e-4, verbose=False)
        self.check(phase, abs(r.gamma2 - 2.0) <= GAMMA2_TOL,
                   f"Taylor {args.problem} f64 plain path: gamma1 {r.gamma1:.4f}, "
                   f"gamma2 {r.gamma2:.4f} (tol {GAMMA2_TOL})")

    def phase_e(self):
        self.taylor("E", problem_args("sh23", "float64", "matmul"),
                    [self.ref["x0_f64"]])

    def workload(self, problem, dtype, method, x0, *extra):
        args = problem_args(problem, dtype, method, *extra)
        os.makedirs(OUT, exist_ok=True)
        p, x, defaults = cli.make_problem(args, x0=x0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.optimise(p, x, defaults, args)
        torch.cuda.synchronize()
        return p, res, time.perf_counter() - t0

    def pinned_f64(self, phase, problem, ref):
        pin_fv, pin_k = ref["fv_f64_matmul"], int(ref["iters_f64_matmul"])
        _, res, wall = self.workload(problem, "float64", "matmul", [ref["x0_f64"]])
        fv = np.asarray(res.function_values)
        worst = (float(np.max(np.abs(fv - pin_fv) / np.abs(pin_fv)))
                 if len(fv) == len(pin_fv) else float("inf"))
        self.check(phase, res.iterations == pin_k and worst <= TRAJ_F64_RTOL,
                   f"{problem} f64 workload: {res.iterations} iterations (JAX "
                   f"{pin_k}), J_final {float(fv[-1]) if len(fv) else None!r} "
                   f"(JAX {float(pin_fv[-1])!r}), worst rel {worst:.2e} "
                   f"(tol {TRAJ_F64_RTOL:g}), {wall:.2f} s")

    def phase_f(self):
        self.pinned_f64("F", "sh23", self.ref)

    def f32_workload(self, phase, problem, ref, kernels, fv0_ok, iters):
        p, res, wall = self.main_path(
            phase, kernels,
            lambda: self.workload(problem, "float32", "cuda", [ref["x0_f32"]]))
        fv = np.asarray(res.function_values)
        x = res.x_opt[0]
        self.host_iters[phase] = res.iterations
        sphere = abs(float(p.inner_product(x, x)) / p.radii[0] - 1.0)
        fv0_ref = float(ref["fv_f32_matmul"][0])
        ok = (iters[0] <= res.iterations <= iters[1]
              and bool(np.all(np.diff(fv) >= 0)) and fv0_ok(fv[0], fv0_ref)
              and sphere <= SPHERE_TOL)
        self.check(phase, ok,
                   f"{problem} f32 kernel workload: {res.iterations} iterations "
                   f"({iters[0]}-{iters[1]}), values {[float(v) for v in fv]}, "
                   f"first {float(fv[0])!r} vs JAX f32 matmul {fv0_ref!r}, |<x,x>/r-1| "
                   f"{sphere:.1e}, {wall:.2f} s [{self.card}]")
        print(f"[{phase}] end point: {res.iterations} iterations to J {float(fv[-1])!r}; JAX "
              f"f32 matmul {int(ref['iters_f32_matmul'])} to "
              f"{float(ref['fv_f32_matmul'][-1])!r}, JAX f32 pallas "
              f"{int(ref['iters_f32_pallas'])} to {float(ref['fv_f32_pallas'][-1])!r}. "
              "Not gated: from one x0 the f32 runs differ by roundoff after the "
              "first iteration, so the end point may differ.", flush=True)
        self.report_trace(phase, problem, [ref["x0_f32"]])

    def phase_g(self):
        self.f32_workload("G", "sh23", self.ref,
                          ("fused_fwd_shared_grid", "fused_bwd_shared"),
                          lambda a, b: abs(a - b) <= FV0_ATOL, (5, 200))

    # -- SHB23 --------------------------------------------------------------

    def phase_h(self):
        p, x0, _ = cli.make_problem(problem_args("shb23", "float32", "cuda"),
                                    x0=[self.refb["x0_f32"]])
        dev, n = x0[0].device, p.cfg.n_iters
        ops = operators_to_torch(shb23_operators(p), dev)
        a, b, w, u0 = ops["a32"], ops["b32"], ops["w32"], x0[0]
        self.shb_sweep = (a, b, w, u0, n)
        scale = torch.tensor(-2.0 * p.cfg.dt, dtype=torch.float32, device=dev)
        k = fk.fused_fwd(a, b, w, u0, C2B, C3B, n)
        ks = fk.fused_fwd(a, b, w, u0, C2B, C3B, n, store_series=True)
        r = fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, n, store_series=True)
        lk = fk.fused_bwd(a, b, w, k[0], k[2], C2B, C3B, scale, n)[0]
        lks = fk.fused_bwd(a, b, w, ks[0], ks[2], C2B, C3B, scale, n)[0]
        lp = fk.fused_bwd_plain(a, b, w, k[0], k[2], C2B, C3B, scale, n)[0]
        blk = fk._fwd_block(a, b, w, u0, C2B, C3B, n, True, True)
        torch.cuda.synchronize()
        fwd_pairs = list(zip(k[:3], r[:3]))
        ser_pairs = list(zip(ks, r))
        e_fwd = max(rel(x, y) for x, y in fwd_pairs)
        e_ser = max(rel(x, y) for x, y in ser_pairs)
        e_bwd = rel(lk, lp)
        self.kernels["fused_fwd_grid"]["max_abs_err"] = max_abs(fwd_pairs)
        self.kernels["fused_fwd_grid_ser"]["max_abs_err"] = max_abs(ser_pairs)
        self.kernels["fused_bwd"]["max_abs_err"] = max_abs([(lk, lp)])
        self.check("H", max(e_fwd, e_ser, e_bwd) <= TOL_VS_PLAIN,
                   f"SHB23 kernel vs plain f32 (mg={a.shape[0]}, N={n}): fwd "
                   f"(u_T, J, traj) rel {e_fwd:.2e}, with series {e_ser:.2e}, bwd "
                   f"rel {e_bwd:.2e}, tol {TOL_VS_PLAIN:g}")
        same = [torch.equal(x, y) for x, y in zip(k[:3], ks[:3])] + [torch.equal(lk, lks)]
        same_blk = [torch.equal(x, y) for x, y in zip(ks, blk)]
        route = fk.fwd_route(a.shape[0], fk._card(dev))
        self.check("H", route == "grid" and all(same) and all(same_blk),
                   f"two-matrix series variant bitwise the plain one (u_T, J, traj, "
                   f"lambda): {same}; forward route {route!r} bitwise the one-block "
                   f"kernel's (u_T, J, traj, series): {same_blk}")

        # the shared-matrix series variant, SH23 full width
        bs, ws, us, lin, ns = self.sweep_args
        sc = torch.tensor(-0.1, dtype=torch.float32, device=dev)
        sk = fk.fused_fwd_shared(bs, ws, us, C2, C3, lin, ns)
        sks = fk.fused_fwd_shared(bs, ws, us, C2, C3, lin, ns, store_series=True)
        sr = fk.fused_fwd_shared_plain(bs, ws, us, C2, C3, lin, ns, store_series=True)
        sl = fk.fused_bwd_shared(bs, ws, sk[0], sk[2], C2, C3, lin, sc, ns)[0]
        sls = fk.fused_bwd_shared(bs, ws, sks[0], sks[2], C2, C3, lin, sc, ns)[0]
        torch.cuda.synchronize()
        s_pairs = [(sks[0], sr[0]), (sks[1], sr[1]), (sks[2], sr[2]), (sks[3], sr[3])]
        e_s = max(rel(x, y) for x, y in s_pairs)
        self.kernels["fused_fwd_shared_grid_ser"]["max_abs_err"] = max_abs(s_pairs)
        same_s = [torch.equal(x, y) for x, y in zip(sk[:3], sks[:3])] + [torch.equal(sl, sls)]
        self.check("H", e_s <= TOL_VS_PLAIN and all(same_s),
                   f"SH23 series variant vs plain f32 rel {e_s:.2e} (tol "
                   f"{TOL_VS_PLAIN:g}); bitwise the plain kernel (u_T, J, traj, "
                   f"lambda): {same_s}")

        # both f32 paths against plain f64 on the card, at the same x
        p64, x64, _ = cli.make_problem(problem_args("shb23", "float64", "matmul"),
                                       x0=[self.refb["x0_f32"].astype(np.float64)])
        pm, xm, _ = cli.make_problem(problem_args("shb23", "float32", "matmul"),
                                     x0=[self.refb["x0_f32"]])
        self.pb_cuda, self.pb_plain32, self.xb32 = p, pm, x0
        J64, g64 = p64.objective_and_gradient(x64)
        res = []
        for q, x in ((p, x0), (pm, xm)):
            J, g = q.objective_and_gradient(x)
            res.append((abs(float(J) - float(J64)) / abs(float(J64)),
                        float(torch.linalg.norm(g[0].double() - g64[0])
                              / torch.linalg.norm(g64[0]))))
        (relJ, relg), (relJm, relgm) = res
        self.check("H", relJ <= TOL_VS_F64 and relg <= TOL_G_VS_F64_SHB,
                   f"SHB23 vs plain f64: kernel rel_J {relJ:.3e} rel_g {relg:.3e} "
                   f"(plain f32: rel_J {relJm:.3e} rel_g {relgm:.3e}), tol "
                   f"{TOL_VS_F64:g} / {TOL_G_VS_F64_SHB:g}")
        self.block_route(p.cfg.dt)
        self.wide_route(p.cfg.dt)
        self.shared_wide_route()

    @staticmethod
    def reverse_pair(bwd, bwd_block, args, traj):
        """The grid reverse `bwd` against the one-block kernel `bwd_block`
        called directly on the same inputs `args` (trajectory `traj`):
        lambda_0, the lambda history, and whether lambda_0 with the
        history, the one-block kernel's lambda_0 without and with it, and
        the two histories are bitwise lambda_0 and each other."""
        hk, hb = torch.empty_like(traj), torch.empty_like(traj)
        lk = bwd(*args)[0]
        lkh = bwd(*args, lam_hist=hk)[0]
        lb = bwd_block(*args)
        lbh = bwd_block(*args, hb)
        torch.cuda.synchronize()
        return lk, hk, [torch.equal(lk, lkh), torch.equal(lk, lb), torch.equal(lk, lbh),
                        torch.equal(hk, hb)]

    def block_route(self, dt):
        """The two-matrix sweeps at twice the reference's width: SHB23's
        operators at npts = 1024 take the grid-wide forward and reverse.
        Their main path is the fused objectives (J differentiated in u0,
        J with the series, and J differentiated in u0, A and B: the
        reverse's history variant); then the kernels against plain f32 and
        across the series variants and the history, each grid bitwise the
        one-block kernel called directly, and their times beside the
        one-block kernels'. The kernels line keeps the grid forward's
        numbers from phase H's and I's SHB23 width (mg = 512, N = 2000) and
        the grid reverse's from here."""
        q, _, _ = cli.make_problem(problem_args("shb23", "float32", "cuda", "--npts",
                                                str(BLOCK_MG)))
        ops = operators_to_torch(shb23_operators(q), q.device)
        a, b, w = ops["a32"], ops["b32"], ops["w32"]
        u0 = q.generate_ic(seed=42)[0]
        n = BLOCK_N
        J, grad, (Jd, ser, _), g_ops = self.main_path(
            "H", ("fused_fwd_grid", "fused_fwd_grid_ser", "fused_bwd_grid", "fused_bwd_grid_ops"),
            two_matrix_objectives(a, b, w, u0, dt, n, operators=True),
            record=("fused_bwd_grid", "fused_bwd_grid_ops"))
        k = fk.fused_fwd(a, b, w, u0, C2B, C3B, n)
        ks = fk.fused_fwd(a, b, w, u0, C2B, C3B, n, store_series=True)
        blk = fk._fwd_block(a, b, w, u0, C2B, C3B, n)
        blk_s = fk._fwd_block(a, b, w, u0, C2B, C3B, n, True, True)
        r = fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, n, store_series=True)
        scale = torch.tensor(-2.0 * dt, dtype=torch.float32, device=u0.device)
        rargs = (a, b, w, k[0], k[2], C2B, C3B, scale, n)
        lk, hk, same_rev = self.reverse_pair(fk.fused_bwd, fk._bwd_block, rargs, k[2])
        hp = torch.empty_like(k[2])
        lp = fk.fused_bwd_plain(*rargs, lam_hist=hp)[0]
        torch.cuda.synchronize()
        pairs, ser_pairs = list(zip(k[:3], r[:3])), list(zip(ks, r))
        e = max(rel(x, y) for x, y in pairs + ser_pairs + [(J, -dt * r[1])])
        e_b = max(rel(lk, lp), rel(hk, hp))
        same = ([torch.equal(x, y) for x, y in zip(k[:3], ks[:3])]
                + [torch.equal(J, Jd), torch.equal(ser, ks[3]), torch.equal(grad, lk),
                   torch.equal(g_ops[0], lk)])
        same_blk = ([torch.equal(x, y) for x, y in zip(k[:3], blk[:3])]
                    + [torch.equal(x, y) for x, y in zip(ks, blk_s)])
        self.kernels["fused_bwd_grid"]["max_abs_err"] = max_abs([(lk, lp)])
        self.kernels["fused_bwd_grid_ops"]["max_abs_err"] = max_abs([(lk, lp), (hk, hp)])
        f_pl, f_k = interleaved_ms(
            lambda: fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, n),
            lambda: fk.fused_fwd(a, b, w, u0, C2B, C3B, n), 2, 10)
        fs_pl, fs_k = interleaved_ms(
            lambda: fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, n, store_series=True),
            lambda: fk.fused_fwd(a, b, w, u0, C2B, C3B, n, store_series=True), 2, 10)
        fb_k = gpu_ms(lambda: fk._fwd_block(a, b, w, u0, C2B, C3B, n), 10)
        fbs_k = gpu_ms(lambda: fk._fwd_block(a, b, w, u0, C2B, C3B, n, True, True), 10)
        b_pl, b_k = interleaved_ms(lambda: fk.fused_bwd_plain(*rargs),
                                   lambda: fk.fused_bwd(*rargs), 2, 10)
        bh_pl, bh_k = interleaved_ms(lambda: fk.fused_bwd_plain(*rargs, lam_hist=hp),
                                     lambda: fk.fused_bwd(*rargs, lam_hist=hk), 2, 10)
        bb_k = gpu_ms(lambda: fk._bwd_block(*rargs), 10)
        self.kernels["fused_bwd_grid"].update(
            ms=b_k, plain_ms=b_pl, work=sweep_work(BLOCK_MG, n, 2, fwd=False))
        self.kernels["fused_bwd_grid_ops"].update(
            ms=bh_k, plain_ms=bh_pl, work=hist_work(BLOCK_MG, n, 2))
        card = fk._card(u0.device)
        routes = (fk.fwd_route(BLOCK_MG, card), fk.bwd_route(BLOCK_MG, card))
        self.check("H", routes == ("grid", "grid") and max(e, e_b) <= TOL_VS_PLAIN
                   and all(same) and all(same_blk) and all(same_rev),
                   f"[{self.card}] routes {routes} (mg={a.shape[0]}, N={n}): forward "
                   f"vs plain f32 (u_T, J, traj, series, the objective's J) rel "
                   f"{e:.2e} (abs {max_abs(pairs + ser_pairs):.2e}), reverse "
                   f"(lambda_0, history) rel {e_b:.2e} (abs {max_abs([(lk, lp)]):.2e}; tol "
                   f"{TOL_VS_PLAIN:g}); series variant, the objectives and autograd's "
                   f"gradients (in u0; in u0 and the operators) bitwise the wrappers': "
                   f"{same}; grid forward bitwise the "
                   f"one-block kernel's (u_T, J, traj; with the series): {same_blk}; grid "
                   f"reverse's lambda_0 bitwise with the history, the one-block kernel's "
                   f"without and with it, and the histories: {same_rev}; grid forward "
                   f"{f_k:.3f} ms vs plain {f_pl:.3f} ms, with series {fs_k:.3f} vs "
                   f"{fs_pl:.3f} ms; one-block forward kernel {fb_k:.3f} ms, with series "
                   f"{fbs_k:.3f} ms; grid reverse {b_k:.3f} ms vs plain {b_pl:.3f} ms, "
                   f"with the history {bh_k:.3f} vs {bh_pl:.3f} ms; one-block reverse "
                   f"kernel {bb_k:.3f} ms")

    def wide_route(self, dt):
        """The two-matrix sweeps above the width where all of a CTA's B rows
        and columns fit: SHB23's operators at npts = 2048 take the grid-wide
        forward and reverse that read the B rows and columns that do not
        fit from L2. Their main path is the fused objectives; then the
        kernels against plain f32, across the series variants and the
        history and bitwise the one-block kernels called directly, and their
        times (the one-block kernels' in this phase's line only)."""
        q, _, _ = cli.make_problem(problem_args("shb23", "float32", "cuda", "--npts",
                                                str(WIDE_MG)))
        ops = operators_to_torch(shb23_operators(q), q.device)
        a, b, w = ops["a32"], ops["b32"], ops["w32"]
        u0 = q.generate_ic(seed=42)[0]
        n = BLOCK_N
        kernels = ("fused_fwd_grid_stream", "fused_fwd_grid_stream_ser", "fused_bwd_grid_stream")
        J, grad, (Jd, ser, _) = self.main_path(
            "H", kernels, two_matrix_objectives(a, b, w, u0, dt, n))
        k = fk.fused_fwd(a, b, w, u0, C2B, C3B, n)
        ks = fk.fused_fwd(a, b, w, u0, C2B, C3B, n, store_series=True)
        blk = fk._fwd_block(a, b, w, u0, C2B, C3B, n)
        blk_s = fk._fwd_block(a, b, w, u0, C2B, C3B, n, True, True)
        r = fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, n, store_series=True)
        scale = torch.tensor(-2.0 * dt, dtype=torch.float32, device=u0.device)
        rargs = (a, b, w, k[0], k[2], C2B, C3B, scale, n)
        lk, _, same_rev = self.reverse_pair(fk.fused_bwd, fk._bwd_block, rargs, k[2])
        lp = fk.fused_bwd_plain(*rargs)[0]
        torch.cuda.synchronize()
        pairs, ser_pairs = list(zip(k[:3], r[:3])), list(zip(ks, r))
        e = max(rel(x, y) for x, y in pairs + ser_pairs + [(J, -dt * r[1])])
        e_b = rel(lk, lp)
        same = ([torch.equal(x, y) for x, y in zip(k[:3], ks[:3])]
                + [torch.equal(J, Jd), torch.equal(ser, ks[3]), torch.equal(grad, lk)])
        same_blk = ([torch.equal(x, y) for x, y in zip(k[:3], blk[:3])]
                    + [torch.equal(x, y) for x, y in zip(ks, blk_s)])
        self.kernels["fused_fwd_grid_stream"]["max_abs_err"] = max_abs(pairs)
        self.kernels["fused_fwd_grid_stream_ser"]["max_abs_err"] = max_abs(ser_pairs)
        self.kernels["fused_bwd_grid_stream"]["max_abs_err"] = max_abs([(lk, lp)])
        f_pl, f_k = interleaved_ms(
            lambda: fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, n),
            lambda: fk.fused_fwd(a, b, w, u0, C2B, C3B, n), 1, 10, warm_plain=1)
        fs_pl, fs_k = interleaved_ms(
            lambda: fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, n, store_series=True),
            lambda: fk.fused_fwd(a, b, w, u0, C2B, C3B, n, store_series=True), 1, 10,
            warm_plain=1)
        fb_k = gpu_ms(lambda: fk._fwd_block(a, b, w, u0, C2B, C3B, n), 2, warm=1)
        fbs_k = gpu_ms(lambda: fk._fwd_block(a, b, w, u0, C2B, C3B, n, True, True), 2, warm=1)
        b_pl, b_k = interleaved_ms(lambda: fk.fused_bwd_plain(*rargs),
                                   lambda: fk.fused_bwd(*rargs), 1, 10, warm_plain=1)
        bb_k = gpu_ms(lambda: fk._bwd_block(*rargs), 2, warm=1)
        self.kernels["fused_fwd_grid_stream"].update(
            ms=f_k, plain_ms=f_pl, work=sweep_work(WIDE_MG, n, 2, fwd=True))
        self.kernels["fused_fwd_grid_stream_ser"].update(
            ms=fs_k, plain_ms=fs_pl, work=sweep_work(WIDE_MG, n, 2, fwd=True, ser=True))
        self.kernels["fused_bwd_grid_stream"].update(
            ms=b_k, plain_ms=b_pl, work=sweep_work(WIDE_MG, n, 2, fwd=False))
        card = fk._card(u0.device)
        rows, _, rows_b = fk.fwd_grid_partition(WIDE_MG, card)
        cols, _, cols_b = fk.bwd_grid_partition(WIDE_MG, card)
        routes = (fk.fwd_route(WIDE_MG, card), fk.bwd_route(WIDE_MG, card))
        self.check("H", routes == ("grid", "grid") and rows_b < rows and cols_b < cols
                   and max(e, e_b) <= TOL_VS_PLAIN and all(same) and all(same_blk)
                   and all(same_rev),
                   f"[{self.card}] routes {routes} (mg={a.shape[0]}, N={n}; {rows_b} of "
                   f"{rows} B rows and {cols_b} of {cols} B columns a CTA kept, the rest "
                   f"from L2): forward vs plain f32 (u_T, J, traj, series, the objective's "
                   f"J) rel {e:.2e}, reverse (lambda_0) rel {e_b:.2e} (tol "
                   f"{TOL_VS_PLAIN:g}); series variant, the objectives and autograd's "
                   f"gradient bitwise the wrappers': {same}; forward bitwise the one-block "
                   f"kernel's (u_T, J, traj; with the series): {same_blk}; reverse's "
                   f"lambda_0 bitwise with the history, the one-block kernel's without and "
                   f"with it, and the histories: {same_rev}; forward sweep {f_k:.3f} ms vs "
                   f"plain {f_pl:.3f} ms, with series {fs_k:.3f} vs {fs_pl:.3f} ms; one-block "
                   f"forward kernel {fb_k:.3f} ms, with series {fbs_k:.3f} ms; reverse sweep "
                   f"{b_k:.3f} ms vs plain {b_pl:.3f} ms; one-block reverse kernel "
                   f"{bb_k:.3f} ms")

    def shared_wide_route(self):
        """SH23's sweeps at twice the reference's width: SH23's operators
        at npts = 512 (mg = 1024) take the grid-wide forward and reverse.
        Their main path is the fused objectives (J differentiated in u0,
        J with the series, and J differentiated in u0 and B: the reverse's
        history variant); then the kernels against plain f32, across the
        series variants and the history, each grid bitwise the one-block
        kernel called directly (whose times go to this phase's line only),
        the reverse's lambda_0 against autograd's gradients, and their
        times. The kernels line keeps the grid forward's numbers from the
        SH23 width (mg = 512, phases C, D, G) and the grid reverse's from
        here."""
        q, _, _ = cli.make_problem(problem_args("sh23", "float32", "cuda", "--npts",
                                                str(BLOCK_MG // 2)))
        ops = operators_to_torch(sh23_operators(q), q.device)
        b, w = ops["b32"], ops["w32"]
        u0 = torch.matmul(ops["p32"], q.generate_ic(seed=42)[0])
        lin, dt, n = 1.0 / q.cfg.dt, q.cfg.dt, BLOCK_N

        def path():
            uu = u0.detach().requires_grad_(True)
            J = fk.FusedObjectiveShared.apply(b, w, uu, C2, C3, lin, dt, n, False)
            (grad,) = torch.autograd.grad(J, uu)
            out = (J.detach(), grad,
                   fk.FusedObjectiveSharedDiag.apply(b, w, u0, C2, C3, lin, dt, n, False))
            bb, uu = b.detach().requires_grad_(True), u0.detach().requires_grad_(True)
            J = fk.FusedObjectiveShared.apply(bb, w, uu, C2, C3, lin, dt, n)
            return out + (torch.autograd.grad(J, (uu, bb)),)

        J, grad, (Jd, ser, _), g_ops = self.main_path(
            "H", ("fused_fwd_shared_grid", "fused_fwd_shared_grid_ser", "fused_bwd_shared_grid",
                  "fused_bwd_shared_grid_ops"), path,
            record=("fused_bwd_shared_grid", "fused_bwd_shared_grid_ops"))
        k = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n)
        ks = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n, store_series=True)
        blk = fk._fwd_shared_block(b, w, u0, C2, C3, lin, n)
        blk_s = fk._fwd_shared_block(b, w, u0, C2, C3, lin, n, True, True)
        r = fk.fused_fwd_shared_plain(b, w, u0, C2, C3, lin, n, store_series=True)
        scale = torch.tensor(-2.0 * dt, dtype=torch.float32, device=u0.device)
        rargs = (b, w, k[0], k[2], C2, C3, lin, scale, n)
        lk, hk, same_rev = self.reverse_pair(fk.fused_bwd_shared, fk._bwd_shared_block, rargs,
                                             k[2])
        hp = torch.empty_like(k[2])
        lp = fk.fused_bwd_shared_plain(*rargs, lam_hist=hp)[0]
        torch.cuda.synchronize()
        pairs, ser_pairs = list(zip(k[:3], r[:3])), list(zip(ks, r))
        e = max(rel(x, y) for x, y in pairs + ser_pairs + [(J, -dt * r[1])])
        e_b = max(rel(lk, lp), rel(hk, hp))
        same = ([torch.equal(x, y) for x, y in zip(k[:3], ks[:3])]
                + [torch.equal(J, Jd), torch.equal(ser, ks[3]), torch.equal(grad, lk),
                   torch.equal(g_ops[0], lk)])
        self.kernels["fused_bwd_shared_grid"]["max_abs_err"] = max_abs([(lk, lp)])
        self.kernels["fused_bwd_shared_grid_ops"]["max_abs_err"] = max_abs([(lk, lp), (hk, hp)])
        same_blk = ([torch.equal(x, y) for x, y in zip(k[:3], blk[:3])]
                    + [torch.equal(x, y) for x, y in zip(ks, blk_s)])
        f_pl, f_k = interleaved_ms(
            lambda: fk.fused_fwd_shared_plain(b, w, u0, C2, C3, lin, n),
            lambda: fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n), 2, 10)
        fs_pl, fs_k = interleaved_ms(
            lambda: fk.fused_fwd_shared_plain(b, w, u0, C2, C3, lin, n, store_series=True),
            lambda: fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n, store_series=True), 2, 10)
        fb_k = gpu_ms(lambda: fk._fwd_shared_block(b, w, u0, C2, C3, lin, n), 10)
        fbs_k = gpu_ms(lambda: fk._fwd_shared_block(b, w, u0, C2, C3, lin, n, True, True), 10)
        b_pl, b_k = interleaved_ms(lambda: fk.fused_bwd_shared_plain(*rargs),
                                   lambda: fk.fused_bwd_shared(*rargs), 2, 10)
        bh_pl, bh_k = interleaved_ms(lambda: fk.fused_bwd_shared_plain(*rargs, lam_hist=hp),
                                     lambda: fk.fused_bwd_shared(*rargs, lam_hist=hk), 2, 10)
        bb_k = gpu_ms(lambda: fk._bwd_shared_block(*rargs), 10)
        self.kernels["fused_bwd_shared_grid"].update(
            ms=b_k, plain_ms=b_pl, work=sweep_work(BLOCK_MG, n, 1, fwd=False))
        self.kernels["fused_bwd_shared_grid_ops"].update(
            ms=bh_k, plain_ms=bh_pl, work=hist_work(BLOCK_MG, n, 1))
        card = fk._card(u0.device)
        routes = (fk.shared_fwd_route(BLOCK_MG, card), fk.shared_bwd_route(BLOCK_MG, card))
        self.check("H", routes == ("grid", "grid") and max(e, e_b) <= TOL_VS_PLAIN
                   and all(same) and all(same_blk) and all(same_rev),
                   f"[{self.card}] SH23 routes {routes} (mg={b.shape[0]}, N={n}): "
                   f"forward vs plain f32 (u_T, J, traj, series, the objective's J) rel "
                   f"{e:.2e}, reverse (lambda_0, history) rel {e_b:.2e} (abs "
                   f"{max_abs([(lk, lp)]):.2e}; tol {TOL_VS_PLAIN:g}); series variant, the "
                   f"objectives and autograd's gradients (in u0; in u0 and B) bitwise the "
                   f"wrappers': {same}; grid "
                   f"forward bitwise the one-block kernel's (u_T, J, traj; with the series): "
                   f"{same_blk}; grid reverse's lambda_0 bitwise with the history, the "
                   f"one-block kernel's without and with it, and the histories: {same_rev}; "
                   f"forward sweep {f_k:.3f} ms vs plain {f_pl:.3f} ms, with series "
                   f"{fs_k:.3f} vs {fs_pl:.3f} ms; one-block forward kernel {fb_k:.3f} ms, "
                   f"with series {fbs_k:.3f} ms; reverse sweep {b_k:.3f} ms vs plain "
                   f"{b_pl:.3f} ms, with the history {bh_k:.3f} vs {bh_pl:.3f} ms; one-block "
                   f"reverse kernel {bb_k:.3f} ms")

    def phase_i(self):
        a, b, w, u0, n = self.shb_sweep
        uT, _, tr, _ = fk.fused_fwd(a, b, w, u0, C2B, C3B, n)
        scale = torch.tensor(-0.02, dtype=torch.float32, device=u0.device)
        f_pl, f_k = interleaved_ms(
            lambda: fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, n),
            lambda: fk.fused_fwd(a, b, w, u0, C2B, C3B, n), 2, 10)
        fs_pl, fs_k = interleaved_ms(
            lambda: fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, n, store_series=True),
            lambda: fk.fused_fwd(a, b, w, u0, C2B, C3B, n, store_series=True), 2, 10)
        b_pl, b_k = interleaved_ms(
            lambda: fk.fused_bwd_plain(a, b, w, uT, tr, C2B, C3B, scale, n),
            lambda: fk.fused_bwd(a, b, w, uT, tr, C2B, C3B, scale, n), 2, 10)
        bs, ws, us, lin, ns = self.sweep_args
        ss_pl, ss_k = interleaved_ms(
            lambda: fk.fused_fwd_shared_plain(bs, ws, us, C2, C3, lin, ns,
                                              store_series=True),
            lambda: fk.fused_fwd_shared(bs, ws, us, C2, C3, lin, ns,
                                        store_series=True), 3, 20)
        u_pl, u_k = interleaved_ms(
            lambda: self.pb_plain32.objective_and_gradient(self.xb32),
            lambda: self.pb_cuda.objective_and_gradient(self.xb32), 2, 10)
        mg, mgs = a.shape[0], bs.shape[0]
        self.kernels["fused_fwd_grid"].update(
            ms=f_k, plain_ms=f_pl, work=sweep_work(mg, n, 2, fwd=True))
        self.kernels["fused_fwd_grid_ser"].update(
            ms=fs_k, plain_ms=fs_pl, work=sweep_work(mg, n, 2, fwd=True, ser=True))
        self.kernels["fused_bwd"].update(
            ms=b_k, plain_ms=b_pl, work=sweep_work(mg, n, 2, fwd=False))
        self.kernels["fused_fwd_shared_grid_ser"].update(
            ms=ss_k, plain_ms=ss_pl, work=sweep_work(mgs, ns, 1, fwd=True, ser=True))
        self.unit_ms_shb = (u_k, u_pl)
        self.check("I", True,
                   f"[{self.card}] SHB23 fwd sweep (traj) kernel {f_k:.3f} ms vs plain "
                   f"{f_pl:.3f} ms; with series {fs_k:.3f} vs {fs_pl:.3f} ms; bwd "
                   f"sweep kernel {b_k:.3f} ms vs plain {b_pl:.3f} ms; SH23 fwd "
                   f"with series kernel {ss_k:.3f} ms vs plain {ss_pl:.3f} ms; "
                   f"SHB23 fwd+grad unit kernel path {u_k:.3f} ms vs plain f32 "
                   f"path {u_pl:.3f} ms")

    def phase_j(self):
        self.taylor("J", problem_args("shb23", "float64", "matmul"),
                    [self.refb["x0_f64"]])

    def phase_k(self):
        self.pinned_f64("K", "shb23", self.refb)

    def phase_l(self):
        self.f32_workload("L", "shb23", self.refb, ("fused_fwd_grid", "fused_bwd"),
                          lambda a, b: abs(a - b) <= FV0_RTOL * abs(b), (5, 50))

    # -- fused diagnostics -------------------------------------------------

    def phase_m(self):
        pairs = ((self.p_cuda, self.x32), (self.pb_cuda, self.xb32))

        def diagnostics():
            return [(p.objective_gradient_and_diagnostics(x),
                     p.objective_and_diagnostics(x)) for p, x in pairs]

        # only the diagnostics calls run in the counted window; the plain
        # objective they are held to runs after it
        outs = self.main_path("M", ("fused_fwd_shared_grid_ser", "fused_fwd_grid_ser",
                                    "fused_bwd_shared", "fused_bwd"), diagnostics,
                              record=("fused_fwd_shared_grid_ser", "fused_fwd_grid_ser"))
        res = []
        for (p, x), ((Jgd, ggd, dg), (Jd, dd)) in zip(pairs, outs):
            J, g = p.objective_and_gradient(x)
            ke = dd["kinetic_energy"]
            res.append((p.cfg.n_iters,
                        bool(torch.equal(J, Jgd) and torch.equal(g[0], ggd[0])
                             and torch.equal(Jd, p.objective(x))
                             and torch.equal(Jd, J)),
                        tuple(ke.shape), bool(torch.isfinite(ke).all()),
                        bool(torch.equal(ke, dg["kinetic_energy"]))))
        ok = all(same and shape == (n + 1,) and finite and ser_same
                 for n, same, shape, finite, ser_same in res)
        self.check("M", ok, "objective_(gradient_and_)diagnostics on method=cuda "
                   "(SH23, SHB23): J and gradient bitwise the plain objective's, "
                   f"series (n+1,) finite and equal in both calls: {res}")


    # -- KDyn ---------------------------------------------------------------

    def kdyn_x0(self, dtype):
        return [self.refk["b0"].astype(dtype), self.refk["u0"].astype(dtype)]

    def phase_n(self):
        p, x0, _ = cli.make_problem(problem_args("kdyn", "float32", "cuda"),
                                    x0=self.kdyn_x0(np.float32))
        cfg, C = p.cfg, p._consts
        with torch.no_grad():
            b0_c, u = p._prepare(x0)
        br0, bi0, u = b0_c.real.contiguous(), b0_c.imag.contiguous(), u.contiguous()
        self.kdyn_sweep = (br0, bi0, u, C, cfg.n_iters, cfg.dt)
        gbar = torch.tensor(-1.0, dtype=torch.float32, device=u.device)
        pairs = {k: [] for k in KDYN_ONE_ROW}
        reset_launches()
        for integrated, n in ((False, cfg.n_iters), (True, KDYN_CUT)):
            k = kd.run_fwd_traj(br0, bi0, u, C, n, integrated, cfg.dt)
            k0 = kd.run_forward(br0, bi0, u, C, n, integrated, cfg.dt)
            r, r_ms = timed_once(lambda: kd.run_fwd_traj_plain(br0, bi0, u, C, n, integrated,
                                                               cfg.dt))
            bk = kd.run_bwd(u, k[0], k[1], gbar, k[3], k[4], C, n, integrated, cfg.dt)
            bp, bp_ms = timed_once(lambda: kd.run_bwd_plain(
                u, k[0], k[1], gbar, k[3], k[4], C, n, integrated, cfg.dt))
            if not integrated:   # phase O's plain times: the same calls, once each
                self.kdyn_plain_ms = {"kdyn_fwd_traj": r_ms, "kdyn_bwd": bp_ms}
            pairs["kdyn_fwd_traj"] += list(zip(k, r))
            pairs["kdyn_fwd"] += list(zip(k0, r[:3]))
            pairs["kdyn_bwd"] += list(zip(bk, bp))
            same = [torch.equal(a, b) for a, b in zip(k0, k[:3])]
            self.check("N", all(same), f"KDyn forward with and without the trajectory "
                       f"bitwise equal (b_T re, im, J), integrated={integrated}: {same}")
        launched = {k: launches()[k] for k in pairs}
        errs = {k: max(rel(a, b) for a, b in v) for k, v in pairs.items()}
        for k, v in pairs.items():
            self.kernels[k]["max_abs_err"] = max_abs(v)
        self.check("N", max(errs.values()) <= TOL_KDYN_VS_PLAIN,
                   f"KDyn kernel vs plain f32 (n={cfg.npts}, mg={p.mg}; Final N="
                   f"{cfg.n_iters}, Integrated N={KDYN_CUT}): worst rel "
                   + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                   + f", tol {TOL_KDYN_VS_PLAIN:g}")
        self.check("N", all(v == 2 for v in launched.values()),
                   f"launch counters moved: {launched}")

        # J and both unprojected gradients at the pinned x0, full depth,
        # against the pinned f64 values (computed by the JAX package on a CPU)
        def unprojected(args, dtype):
            """(J, gradients, the call's ms, problem, x0): one fwd+grad unit
            with unprojected gradients, timed by CUDA events."""
            q, x, _ = cli.make_problem(args, x0=self.kdyn_x0(dtype))
            q = KinematicDynamo(dataclasses.replace(q.cfg, project_gradients=False),
                                device=q.device)
            (J, g), ms = timed_once(lambda: q.objective_and_gradient(x))
            return float(J), [a.double() for a in g], ms, q, x

        def against(J, g, J64, g64):
            return (abs(J - J64) / abs(J64),
                    *(float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
                      for a, b in zip(g, g64)))

        dev = u.device
        J64 = float(self.truthk["J"])
        g64 = [torch.as_tensor(self.truthk[k], device=dev).double() for k in ("gb", "gu")]
        k32 = unprojected(problem_args("kdyn", "float32", "cuda"), np.float32)
        p32 = unprojected(problem_args("kdyn", "float32", "plain"), np.float32)
        e_k, e_p = against(*k32[:2], J64, g64), against(*p32[:2], J64, g64)
        # phase O's fwd+grad units: these unprojected ones (as the JAX
        # bench's KDyn unit), the plain f32 one timed here, once
        self.kdyn_units = (k32[3], k32[4], p32[2])
        d64 = unprojected(problem_args("kdyn", "float64", "plain"), np.float64)
        self.kdyn_g64 = d64[1]   # phase 3's f64-config gradient
        e_d = against(*d64[:2], J64, g64)
        fmt = "rel_J {:.3e} rel_gB {:.3e} rel_gU {:.3e}".format
        self.check("N", max(e_k) <= TOL_KDYN_VS_F64,
                   f"KDyn full depth vs pinned f64: method=cuda {fmt(*e_k)} (plain "
                   f"f32: {fmt(*e_p)}), tol {TOL_KDYN_VS_F64:g}")
        self.check("N", e_d[0] <= TOL_KDYN_J64 and max(e_d[1:]) <= TOL_KDYN_G64,
                   f"KDyn full depth plain f64 vs pinned f64: {fmt(*e_d)}, tol "
                   f"{TOL_KDYN_J64:g} / {TOL_KDYN_G64:g}")

        # both costs at the cut depth, projected gradients, through the
        # problem: method=cuda f32 and plain f64 against the pinned f64 values
        for cost in ("Final", "Integrated"):
            J64 = float(self.refk[f"J200_{cost}"])
            g64 = [torch.as_tensor(self.refk[f"{k}200_{cost}"], device=dev).double()
                   for k in ("gb", "gu")]
            extra = ("--n-iters", str(KDYN_CUT), "--cost", cost)
            res = []
            for dtype, method, npd in (("float32", "cuda", np.float32),
                                       ("float64", "plain", np.float64)):
                q, x, _ = cli.make_problem(problem_args("kdyn", dtype, method, *extra),
                                           x0=self.kdyn_x0(npd))
                J, g = q.objective_and_gradient(x)
                res.append(against(float(J), [a.double() for a in g], J64, g64))
            self.check("N", max(res[0]) <= TOL_KDYN_VS_F64 and res[1][0] <= TOL_KDYN_J64
                       and max(res[1][1:]) <= TOL_KDYN_G64,
                       f"KDyn cost={cost} N={KDYN_CUT}, projected gradients, vs pinned "
                       f"f64: method=cuda {fmt(*res[0])} (tol {TOL_KDYN_VS_F64:g}); "
                       f"plain f64 {fmt(*res[1])} (tol {TOL_KDYN_J64:g} / "
                       f"{TOL_KDYN_G64:g})")

    def phase_o(self):
        br0, bi0, u, C, n, dt = self.kdyn_sweep
        brT, biT, _, trr, tri = kd.run_fwd_traj(br0, bi0, u, C, n, False, dt)
        gbar = torch.tensor(-1.0, dtype=torch.float32, device=u.device)
        # the plain versions take seconds a sweep: the forward timed once, no
        # warm-up, between two kernel timings; the forward with the
        # trajectory and the reverse are phase N's calls (cost Final, the
        # same inputs), timed there once each
        f_pl, f_k = interleaved_ms(
            lambda: kd.run_forward_plain(br0, bi0, u, C, n, False, dt),
            lambda: kd.run_forward(br0, bi0, u, C, n, False, dt), 1, 5, 0, plain_once=True)
        t_k = gpu_ms(lambda: kd.run_fwd_traj(br0, bi0, u, C, n, False, dt), 10, 1)
        b_k = gpu_ms(lambda: kd.run_bwd(u, brT, biT, gbar, trr, tri, C, n, False, dt), 10, 1)
        t_pl, b_pl = self.kdyn_plain_ms["kdyn_fwd_traj"], self.kdyn_plain_ms["kdyn_bwd"]
        qk, xk, u_pl = self.kdyn_units
        u_k = gpu_ms(lambda: qk.objective_and_gradient(xk), 10, 1)
        npts, mg = br0.shape[1], u.shape[1]
        self.kernels["kdyn_fwd"].update(
            ms=f_k, plain_ms=f_pl, work=kdyn_work(npts, mg, n, fwd=True, traj=False))
        self.kernels["kdyn_fwd_traj"].update(
            ms=t_k, plain_ms=t_pl, work=kdyn_work(npts, mg, n, fwd=True, traj=True))
        self.kernels["kdyn_bwd"].update(
            ms=b_k, plain_ms=b_pl, work=kdyn_work(npts, mg, n, fwd=False, traj=True))
        self.check("O", True,
                   f"[{self.card}] KDyn (n={npts}, mg={mg}, N={n}) fwd sweep kernel "
                   f"{f_k:.3f} ms vs plain {f_pl:.3f} ms; with the trajectory "
                   f"{t_k:.3f} vs {t_pl:.3f} ms; bwd sweep kernel {b_k:.3f} ms vs "
                   f"plain {b_pl:.3f} ms; fwd+grad unit (unprojected gradients) kernel "
                   f"path {u_k:.3f} ms vs plain f32 path {u_pl:.3f} ms")

    def phase_p(self):
        self.taylor("P", problem_args("kdyn", "float64", "plain", "--n-iters",
                                      str(KDYN_CUT)), self.kdyn_x0(np.float64))

    def phase_q(self):
        pin_fv, pin_k = self.refk["fv200_f64"], int(self.refk["iters200_f64"])
        _, res, wall = self.workload("kdyn", "float64", "plain",
                                     self.kdyn_x0(np.float64), "--n-iters",
                                     str(KDYN_CUT))
        fv = np.asarray(res.function_values)
        worst = (float(np.max(np.abs(fv - pin_fv) / np.abs(pin_fv)))
                 if len(fv) == len(pin_fv) else float("inf"))
        self.check("Q", res.iterations == pin_k and worst <= TRAJ_F64_RTOL,
                   f"kdyn f64 workload at N={KDYN_CUT}: {res.iterations} iterations "
                   f"(JAX {pin_k}), J_final {float(fv[-1]) if len(fv) else None!r} "
                   f"(JAX {float(pin_fv[-1])!r}), worst rel {worst:.2e} (tol "
                   f"{TRAJ_F64_RTOL:g}), {wall:.2f} s")

    def phase_r(self):
        x0 = self.kdyn_x0(np.float32)
        p, res, wall = self.main_path(
            "R", KDYN_ONE_ROW,
            lambda: self.workload("kdyn", "float32", "cuda", x0))
        fv = np.asarray(res.function_values)
        self.host_iters["R"] = res.iterations
        spheres = [abs(float(p.inner_product(x, x)) / r - 1.0)
                   for x, r in zip(res.x_opt, p.radii)]
        fv0_ref = float(self.refk["fv0_f32_full"])
        finite = all(bool(torch.isfinite(x).all()) and x.shape == (3, p.mg, p.mg, p.mg)
                     for x in res.x_opt)
        ok = (5 <= res.iterations <= 10 and bool(np.all(np.diff(fv) >= 0))
              and abs(fv[0] - fv0_ref) <= TOL_KDYN_VS_F64 * abs(fv0_ref)
              and max(spheres) <= SPHERE_TOL and finite)
        self.check("R", ok,
                   f"kdyn f32 kernel workload (n={p.cfg.npts}, N={p.cfg.n_iters}): "
                   f"{res.iterations} iterations (5-10), values "
                   f"{[float(v) for v in fv]}, first {float(fv[0])!r} vs JAX f32 "
                   f"{fv0_ref!r} (rel tol {TOL_KDYN_VS_F64:g}), |<x,x>/r-1| "
                   f"{[f'{s:.1e}' for s in spheres]}, {wall:.2f} s [{self.card}]")
        pin = self.refk["fv_f32_full"]
        drift = (f"{float(np.max(np.abs(fv - pin) / np.abs(pin))):.2e}"
                 if len(fv) == len(pin) else "not comparable")
        print(f"[R] end point: {res.iterations} iterations to J {float(fv[-1])!r}; the "
              f"JAX package in f32 on a CPU, from the same x0: "
              f"{int(self.refk['iters_f32_full'])} iterations to {float(pin[-1])!r} "
              f"(worst rel over the trajectory {drift}), and in f64 "
              f"{int(self.refk['iters_f64_full'])} iterations to "
              f"{float(self.refk['fv_f64_full'][-1])!r}. Its bench record of "
              f"{KDYN_BENCH_END[0]} iterations to {KDYN_BENCH_END[1]} is another "
              "workload (unprojected gradients, device-resident loop). Not gated: "
              "f32 runs from one x0 differ by roundoff after the first iteration.",
              flush=True)
        self.report_trace("R", "kdyn", x0)

    # -- operator cotangents ------------------------------------------------

    def op_grads_case(self, tag, bwd, bwd_plain, mats, w, u0, n, dt, c, lin, mode):
        """One problem's operator cotangents from the same kernel
        trajectory: the history sweep, the product kernel and the sweep
        without the history, against the plain f32 sweep (step-by-step
        outer products), the plain product on the kernel's history, and
        the plain f64 sweep on the same inputs. Returns what the checks
        and timings need."""
        dev = u0.device
        fwd = fk.fused_fwd_shared if mode == "shared" else fk.fused_fwd
        fwd_plain = fk.fused_fwd_shared_plain if mode == "shared" else fk.fused_fwd_plain
        lin_arg = (lin,) if mode == "shared" else ()
        sc = torch.tensor(-2.0 * dt, dtype=torch.float32, device=dev)
        uT, _, tr, _ = fwd(*mats, w, u0, *c, *lin_arg, n)
        args = (*mats, w, uT, tr, *c, *lin_arg, sc, n)
        hist, hist_p = torch.empty_like(tr), torch.empty_like(tr)
        lk = bwd(*args, lam_hist=hist)[0]
        ops_k = fk.op_grads_product(hist, tr, mode, *c, lin)
        l0 = bwd(*args)[0]
        lp, *ops_p = bwd_plain(*args, op_grads=True, lam_hist=hist_p)
        ops_q = fk.op_grads_plain(hist, tr, mode, *c, lin)
        m64 = [m.double() for m in mats]
        uT64, _, tr64, _ = fwd_plain(*m64, w.double(), u0.double(), *c, *lin_arg, n)
        l64, *ops_64 = bwd_plain(*m64, w.double(), uT64, tr64, *c, *lin_arg, sc.double(),
                                 n, op_grads=True)
        torch.cuda.synchronize()
        return dict(tag=tag, args=args, hist=hist, tr=tr, lk=lk, l0=l0, lp=lp,
                    hist_p=hist_p, l64=l64, ops_k=ops_k, ops_p=ops_p, ops_q=ops_q,
                    ops_64=ops_64, c=c, lin=lin, mode=mode)

    def phase_s(self):
        b, w, u0, lin, n = self.sweep_args
        a2, b2, w2, u2, n2 = self.shb_sweep
        dt, dt2 = self.p_cuda.cfg.dt, self.pb_cuda.cfg.dt

        def sh23(with_ops=True):
            bb = b.detach().requires_grad_(with_ops)
            uu = u0.detach().requires_grad_(True)
            J = fk.FusedObjectiveShared.apply(bb, w, uu, C2, C3, lin, dt, n)
            return torch.autograd.grad(J, (uu, bb) if with_ops else (uu,))

        def shb23(with_ops=True):
            aa, bb = (m.detach().requires_grad_(with_ops) for m in (a2, b2))
            uu = u2.detach().requires_grad_(True)
            J = fk.FusedObjective.apply(aa, bb, w2, uu, C2B, C3B, dt2, n2)
            return torch.autograd.grad(J, (uu, aa, bb) if with_ops else (uu,))

        # the main path: autograd in u0 and the operators, op_grads left at
        # its default
        g_sh, g_shb = self.main_path(
            "S", ("fused_bwd_shared_ops", "fused_bwd_ops", "op_grads"),
            lambda: (sh23(), shb23()))
        cases = [
            self.op_grads_case("SH23", fk.fused_bwd_shared, fk.fused_bwd_shared_plain,
                               (b,), w, u0, n, dt, (C2, C3), lin, "shared"),
            self.op_grads_case("SHB23", fk.fused_bwd, fk.fused_bwd_plain, (a2, b2), w2,
                               u2, n2, dt2, (C2B, C3B), 0.0, "two")]
        for cs, g, tol64 in zip(cases, (g_sh, g_shb), (TOL_VS_F64, TOL_G_VS_F64_SHB)):
            auto_same = all(torch.equal(x, y) for x, y in zip(g, (cs["lk"], *cs["ops_k"])))
            e_p = max(rel(x, y) for x, y in zip((cs["lk"], cs["hist"], *cs["ops_k"]),
                                                 (cs["lp"], cs["hist_p"], *cs["ops_p"])))
            e_q = max(rel(x, y) for x, y in zip(cs["ops_k"], cs["ops_q"]))
            e_64 = [rel(x, y) for x, y in zip((cs["lk"], *cs["ops_k"]),
                                               (cs["l64"], *cs["ops_64"]))]
            same0 = torch.equal(cs["lk"], cs["l0"])
            self.check("S", auto_same and same0 and max(e_p, e_q) <= TOL_VS_PLAIN
                       and max(e_64) <= tol64,
                       f"{cs['tag']} operator cotangents (mg={cs['tr'].shape[1]}, "
                       f"N={cs['tr'].shape[0]}): kernels vs plain f32 (lambda_0, history, "
                       f"d{'AB' if cs['mode'] == 'two' else 'B'}) rel {e_p:.2e}, product "
                       f"kernel vs its plain version on the same history {e_q:.2e} (tol "
                       f"{TOL_VS_PLAIN:g}); vs plain f64 lambda_0 {e_64[0]:.2e}, operators "
                       f"{max(e_64[1:]):.2e} (tol {tol64:g}); lambda_0 bitwise the sweep "
                       f"without the history: {same0}; autograd's (u0, operators) "
                       f"gradient bitwise the wrappers': {auto_same}")
        sh, shb = cases
        self.kernels["fused_bwd_shared_ops"]["max_abs_err"] = max_abs(
            [(sh["lk"], sh["lp"]), (sh["hist"], sh["hist_p"])])
        self.kernels["fused_bwd_ops"]["max_abs_err"] = max_abs(
            [(shb["lk"], shb["lp"]), (shb["hist"], shb["hist_p"])])
        self.kernels["op_grads"]["max_abs_err"] = max_abs(
            list(zip(shb["ops_k"], shb["ops_q"])))

        # timings: each sweep without / with the history, the product
        # kernel beside its plain version and torch.matmul on the same
        # operands (f(u) formed before), the whole gradient beside the
        # u0-only one
        t = {}
        for cs, bwd, bwd_plain, reps, reps_plain in (
                (sh, fk.fused_bwd_shared, fk.fused_bwd_shared_plain, 20, 3),
                (shb, fk.fused_bwd, fk.fused_bwd_plain, 10, 2)):
            args, hist, tr, tag = cs["args"], cs["hist"], cs["tr"], cs["tag"]
            c, lin_, mode = cs["c"], cs["lin"], cs["mode"]
            t[tag, "sweep"] = interleaved_ms(lambda: bwd(*args),
                                             lambda: bwd(*args, lam_hist=hist), reps, reps)
            t[tag, "hist_plain"] = gpu_ms(lambda: bwd_plain(*args, lam_hist=cs["hist_p"]),
                                          reps_plain, 1)
            fcat = torch.cat(fk.op_factors(tr, mode, *c, lin_), dim=1)
            t[tag, "prod"] = interleaved_ms(
                lambda: fk.op_grads_plain(hist, tr, mode, *c, lin_),
                lambda: fk.op_grads_product(hist, tr, mode, *c, lin_), reps_plain, 50, 1)
            t[tag, "lib"] = gpu_ms(lambda: torch.matmul(hist.T, fcat), 50)
            t[tag, "prod_dev"] = graph_ms(
                lambda: fk.op_grads_product(hist, tr, mode, *c, lin_))
            t[tag, "lib_dev"] = graph_ms(lambda: torch.matmul(hist.T, fcat))
        t["SH23", "unit"] = interleaved_ms(lambda: sh23(False), lambda: sh23(True), 10, 10)
        t["SHB23", "unit"] = interleaved_ms(lambda: shb23(False), lambda: shb23(True), 5, 5)
        mg, mg2 = b.shape[0], b2.shape[0]
        self.kernels["fused_bwd_shared_ops"].update(
            ms=t["SH23", "sweep"][1], plain_ms=t["SH23", "hist_plain"],
            work=hist_work(mg, n, 1))
        self.kernels["fused_bwd_ops"].update(
            ms=t["SHB23", "sweep"][1], plain_ms=t["SHB23", "hist_plain"],
            work=hist_work(mg2, n2, 2))
        self.kernels["op_grads"].update(
            ms=t["SHB23", "prod_dev"], plain_ms=t["SHB23", "prod"][0],
            library_ms=t["SHB23", "lib_dev"], work=op_grads_work(mg2, n2, 2))
        for tag, mg_, n_, n_out in (("SH23", mg, n, 1), ("SHB23", mg2, n2, 2)):
            (s0, s1), (p0, p1), (u0_ms, u1_ms) = (t[tag, "sweep"], t[tag, "prod"],
                                                   t[tag, "unit"])
            pb, _ = bound_ms(*op_grads_work(mg_, n_, n_out))   # 3xTF32
            pd, ld = t[tag, "prod_dev"], t[tag, "lib_dev"]
            self.check("S", True,
                       f"[{self.card}] {tag} reverse sweep without the history "
                       f"{s0:.3f} ms, with it {s1:.3f} ms ({100 * (s1 / s0 - 1):+.2f} %), "
                       f"plain with it {t[tag, 'hist_plain']:.3f} ms; op_grads product "
                       f"kernels in a CUDA graph {1e3 * pd:.1f} us a call (3xTF32 bound "
                       f"{1e3 * pb:.1f} us, {100 * pb / pd:.1f} % of it) vs torch.matmul "
                       f"{1e3 * ld:.1f} us; "
                       f"per call with the host (CUDA events) {1e3 * p1:.1f} vs "
                       f"{1e3 * t[tag, 'lib']:.1f} us; plain loop {p0:.3f} ms; gradient in "
                       f"u0 {u0_ms:.3f} ms, in u0 and the operators {u1_ms:.3f} ms "
                       f"({100 * (u1_ms / u0_ms - 1):+.2f} %)")
        for tag, fn in (("SH23", sh23), ("SHB23", shb23)):
            self.print_trace("S", f"one {tag} gradient in u0 and the operators", fn)

    # -- L-BFGS and the continuous adjoint ------------------------------------

    def phase_t(self):
        ref, ext = self.ref, self.refx
        p, res, wall = self.main_path(
            "T", ("fused_fwd_shared_grid", "fused_bwd_shared"),
            lambda: self.workload("sh23", "float32", "cuda", [ref["x0_f32"]],
                                  "--direction", "lbfgs"), record=())
        fv = np.asarray(res.function_values)
        x = res.x_opt[0]
        sphere = abs(float(p.inner_product(x, x)) / p.radii[0] - 1.0)
        # iteration 0 is the same Armijo steepest-descent step as CG's
        fv0_ref = float(ref["fv_f32_matmul"][0])
        ok = (5 <= res.iterations <= 200 and bool(np.all(np.diff(fv) >= 0))
              and abs(fv[0] - fv0_ref) <= FV0_ATOL and sphere <= SPHERE_TOL)
        pin32 = ext["fv_f32_lbfgs"]
        self.check("T", ok,
                   f"sh23 f32 kernel L-BFGS workload: {res.iterations} iterations "
                   f"(5-200), values {[float(v) for v in fv]}, first {float(fv[0])!r} vs "
                   f"JAX f32 {fv0_ref!r}, |<x,x>/r-1| {sphere:.1e}, {wall:.2f} s "
                   f"[{self.card}]; not gated: the JAX package in f32 on a CPU took "
                   f"{int(ext['iters_f32_lbfgs'])} iterations to {float(pin32[-1])!r}")

        pin_fv, pin_st, pin_k = (ext["fv_f64_lbfgs"], ext["steps_f64_lbfgs"],
                                 int(ext["iters_f64_lbfgs"]))
        _, res, wall = self.workload("sh23", "float64", "matmul", [ref["x0_f64"]],
                                     "--direction", "lbfgs")
        fv, st = np.asarray(res.function_values), np.asarray(res.step_sizes)
        worst = (max(float(np.max(np.abs(fv - pin_fv) / np.abs(pin_fv))),
                     float(np.max(np.abs(st - pin_st) / np.abs(pin_st))))
                 if len(fv) == len(pin_fv) else float("inf"))
        self.check("T", res.iterations == pin_k and worst <= TRAJ_F64_RTOL,
                   f"sh23 f64 L-BFGS workload: {res.iterations} iterations (JAX "
                   f"{pin_k}), J_final {float(fv[-1]) if len(fv) else None!r} (JAX "
                   f"{float(pin_fv[-1])!r}), worst rel over values and steps "
                   f"{worst:.2e} (tol {TRAJ_F64_RTOL:g}), {res.message!r}, {wall:.2f} s")

        p, x0, _ = cli.make_problem(
            problem_args("sh23", "float64", "matmul", "--adjoint", "continuous"),
            x0=[ref["x0_f64"]])
        t0 = time.perf_counter()
        g = p.gradient(x0)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        e = rel(g.cpu(), ext["gc_f64"])
        self.check("T", e <= TOL_CONT_F64 and bool(torch.isfinite(g).all()),
                   f"sh23 f64 continuous-adjoint gradient vs JAX's pinned one: rel "
                   f"{e:.2e} (tol {TOL_CONT_F64:g}), {wall:.2f} s")

    # -- the device-resident loop (U-X) --------------------------------------

    def device_loop_f32(self, phase, problem, x0, kernels, fv0_ok, fv0_ref,
                        iters, host_phase):
        """The f32 kernel workload through `--device-loop`: a main path (the
        first call warms up, captures the loop's CUDA graphs and replays
        them), a second call of replays only, whose launches must be the
        graphs' launches times their replays, the same steps run eagerly
        (`graphs=False`), bitwise, and a trace of a third call."""
        args = problem_args(problem, "float32", "cuda", "--device-loop")
        p, x, defaults = cli.make_problem(args, x0=x0)
        opt = cli.device_optimiser(p, defaults, args)
        t0 = time.perf_counter()
        r = self.main_path(phase, kernels, lambda: opt(x), record=())
        first = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        r2 = opt(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = {k: v for k, v in launches().items() if v}
        loop = opt.last_loop
        held = {}
        for step, n in loop.replays.items():
            for k, d in loop.graph_launches(step).items():
                held[k] = held.get(k, 0) + n * d
        self.check(phase, counted == held and all(held.get(k, 0) > 0 for k in kernels),
                   f"{problem} device loop, a call of graph replays only: launches "
                   f"counted {counted}, held by the replayed graphs {held}; steps "
                   f"replayed {dict(loop.replays)}")
        re = cli.optimise(p, x, defaults, args, graphs=False)
        torch.cuda.synchronize()
        same = [torch.equal(r.function_values, re.function_values),
                torch.equal(r.step_sizes, re.step_sizes),
                all(torch.equal(a, b) for a, b in zip(r.x_opt, re.x_opt)),
                torch.equal(r.function_values, r2.function_values)]
        self.check(phase, all(same),
                   f"{problem} device loop on CUDA graphs against the same steps run "
                   f"eagerly: J history, step sizes and x_opt bitwise, and the "
                   f"replay-only call bitwise the first: {same}")
        k = int(r.iterations)
        fv = r.function_values[:k].cpu().numpy()
        spheres = [abs(float(p.inner_product(xo, xo)) / rad - 1.0)
                   for xo, rad in zip(r.x_opt, p.radii)]
        ok = (iters[0] <= k <= iters[1] and bool(np.all(np.diff(fv) >= 0))
              and fv0_ok(float(fv[0]), fv0_ref) and max(spheres) <= SPHERE_TOL)
        self.check(phase, ok,
                   f"{problem} f32 kernel device loop: {k} iterations ({iters[0]}-"
                   f"{iters[1]}), values {[float(v) for v in fv]}, first "
                   f"{float(fv[0])!r} vs JAX f32 {fv0_ref!r}, |<x,x>/r-1| "
                   f"{[f'{v:.1e}' for v in spheres]}, J_final {float(fv[-1])!r}; "
                   f"wall {first:.3f} s with the warm-up and capture, {wall:.3f} s "
                   f"replaying [{self.card}]")
        trials = sum(n for st, n in loop.replays.items() if "trial" in st)
        hk, hl = self.host_iters.get(host_phase), self.launched.get(host_phase, {})
        host = ({kk: round(v / hk, 2) for kk, v in hl.items()} if hk else "not run")
        print(f"[{phase}] launches per iteration: device loop "
              f"{ {kk: round(v / k, 2) for kk, v in counted.items()} } over {k} "
              f"iterations and {trials} line-search trials; host loop ({host_phase}) "
              f"{host} over {hk} iterations", flush=True)
        wall_t, busy, rows = self.print_trace(phase, "a third call (graph replays)",
                                              lambda: opt(x))
        steps = sum(loop.replays.values())
        n_kernels = sum(n for _, _, n in rows)
        print(f"[{phase}] idle time (wall - device busy) per step replayed: "
              f"{1e6 * (wall_t - busy) / steps:.1f} us over {steps} steps "
              f"({1e6 * (wall_t - busy) / max(trials, 1):.1f} us per trial); "
              f"{n_kernels} kernel launches in the call, {n_kernels / steps:.1f} a step, "
              f"{1e6 * (wall_t - busy) / n_kernels:.2f} us of idle time a launch",
              flush=True)
        return r

    def phase_u(self):
        self.device_loop_f32(
            "U", "sh23", [self.ref["x0_f32"]],
            ("fused_fwd_shared_grid", "fused_bwd_shared"),
            lambda a, b: abs(a - b) <= FV0_ATOL, float(self.ref["fv_f32_matmul"][0]),
            (5, 200), "G")

    def phase_v(self):
        self.device_loop_f32(
            "V", "shb23", [self.refb["x0_f32"]], ("fused_fwd_grid", "fused_bwd"),
            lambda a, b: abs(a - b) <= FV0_RTOL * abs(b),
            float(self.refb["fv_f32_matmul"][0]), (5, 50), "L")
        self.device_loop_f32(
            "V", "kdyn", self.kdyn_x0(np.float32), ("kdyn_fwd_traj", "kdyn_bwd"),
            lambda a, b: abs(a - b) <= TOL_KDYN_VS_F64 * abs(b),
            float(self.refk["fv0_f32_full"]), (5, 10), "R")
        # the J-only forward serves the backtracking trials of armijo mode
        args = problem_args("kdyn", "float32", "cuda", "--device-loop", "--ls",
                            "armijo", "--max-iters", "2")
        p, x, defaults = cli.make_problem(args, x0=self.kdyn_x0(np.float32))
        opt = cli.device_optimiser(p, defaults, args)
        opt(x)
        r = self.main_path("V", ("kdyn_fwd", "kdyn_fwd_traj", "kdyn_bwd"),
                           lambda: opt(x), record=())
        fv = r.function_values[:int(r.iterations)].tolist()
        self.check("V", int(r.iterations) >= 1 and all(np.isfinite(fv)),
                   f"kdyn f32 kernel device loop, armijo mode (2 iterations, graph "
                   f"replays only): values {fv}, steps replayed "
                   f"{dict(opt.last_loop.replays)}")

    def device_loop_f64(self, phase, what, problem, method, x0, pin_fv, pin_k,
                        pin_steps=None, *extra):
        args = problem_args(problem, "float64", method, "--device-loop", *extra)
        p, x, defaults = cli.make_problem(args, x0=x0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = cli.optimise(p, x, defaults, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k = int(r.iterations)
        fv = r.function_values[:k].cpu().numpy()
        worst = float("inf")
        if k == len(pin_fv):
            worst = float(np.max(np.abs(fv - pin_fv) / np.abs(pin_fv)))
            if pin_steps is not None:
                st = r.step_sizes[:k].cpu().numpy()
                worst = max(worst, float(np.max(np.abs(st - pin_steps) / np.abs(pin_steps))))
        self.check(phase, k == pin_k and worst <= TRAJ_F64_RTOL,
                   f"{what} f64 device loop: {k} iterations (JAX host loop {pin_k}), "
                   f"J_final {float(fv[-1]) if k else None!r} (JAX {float(pin_fv[-1])!r}), "
                   f"worst rel {worst:.2e} (tol {TRAJ_F64_RTOL:g}), {wall:.2f} s "
                   "with the warm-up and capture")

    def phase_w(self):
        ref, ext = self.ref, self.refx
        self.device_loop_f64("W", "sh23 (Wolfe + CG)", "sh23", "matmul",
                             [ref["x0_f64"]], ref["fv_f64_matmul"],
                             int(ref["iters_f64_matmul"]))
        self.device_loop_f64("W", "sh23 L-BFGS", "sh23", "matmul", [ref["x0_f64"]],
                             ext["fv_f64_lbfgs"], int(ext["iters_f64_lbfgs"]),
                             ext["steps_f64_lbfgs"], "--direction", "lbfgs")
        self.device_loop_f64("W", f"kdyn at N={KDYN_CUT}", "kdyn", "plain",
                             self.kdyn_x0(np.float64), self.refk["fv200_f64"],
                             int(self.refk["iters200_f64"]), None, "--n-iters",
                             str(KDYN_CUT))

    def phase_x(self):
        if self.only is None or "0" in self.only:
            self.start_children()
        pin = self.refr
        os.makedirs(OUT, exist_ok=True)
        # the host loop's eager forward-over-reverse products cost ~4 s each
        # at full depth, so it runs the first 3 iterations (the full run's
        # first 3: the same decisions); the device loop runs to convergence
        for loop, extra in (("host", ("--max-iters", "3")),
                            ("device", ("--device-loop",))):
            args = problem_args("sh23", "float64", "matmul", "--direction", "rtr", *extra)
            p, x, defaults = cli.make_problem(args, x0=[self.ref["x0_f64"]])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = cli.optimise(p, x, defaults, args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if loop == "host":
                k, fv, st = r.iterations, np.asarray(r.function_values), np.asarray(r.step_sizes)
                counts = dict(hvp=r.hvp_evals)
                want = dict(hvp=int(pin["hvp_f64_rtr3"]))
                pfv, pst, pk = pin["fv_f64_rtr3"], pin["steps_f64_rtr3"], 3
            else:
                k = int(r.iterations)
                fv, st = r.function_values[:k].cpu().numpy(), r.step_sizes[:k].cpu().numpy()
                counts = dict(hvp=int(r.hvp_evals), trials=int(r.trials))
                want = dict(hvp=int(pin["hvp_f64_jrtr"]), trials=int(pin["trials_f64_jrtr"]))
                pfv, pst, pk = pin["fv_f64_jrtr"], pin["steps_f64_jrtr"], int(pin["iters_f64_jrtr"])
            worst = (max(float(np.max(np.abs(fv - pfv) / np.abs(pfv))),
                         float(np.max(np.abs(st - pst) / np.abs(pst))))
                     if k == len(pfv) else float("inf"))
            self.check("X", k == pk and worst <= TRAJ_F64_RTOL and counts == want,
                       f"sh23 f64 RTR, {loop} loop: {k} iterations (JAX {pk}), counts "
                       f"{counts} (JAX {want}), J_final {float(fv[-1]) if k else None!r}, "
                       f"worst rel over values and steps {worst:.2e} (tol "
                       f"{TRAJ_F64_RTOL:g}), {wall:.2f} s")
        # the command line's own entry point, in this process
        out = os.path.join(OUT, "rtr_cli")
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(["sh23", "--direction", "rtr", "--max-iters", "1",
                           "--quiet", "--out-dir", out])
        summary = os.path.join(out, "summary.json")
        s = json.load(open(summary)) if os.path.exists(summary) else {}
        notice = "substituting" in printed.getvalue()
        self.check("X", rc == 0 and notice and s.get("iterations", 0) >= 1,
                   f"`spheremanopt_torch.run sh23 --direction rtr --max-iters 1` at "
                   f"the CUDA default: rc {rc}, notice {notice}, summary "
                   f"{s.get('iterations')} iterations to J {s.get('J_final')!r}, method "
                   f"{s.get('config', {}).get('method')!r}, "
                   f"{time.perf_counter() - t0:.1f} s")

    # -- optimal mixing (Y, Z) -------------------------------------------------

    def mixing(self, dtype, *extra):
        """(problem, x0, defaults, args) of `spheremanopt_torch.run mixing`
        at the reference config, from mixing256_truth's x0."""
        args = cli.build_parser().parse_args(
            ["mixing", "--device", "cuda", "--dtype", dtype, "--quiet",
             "--out-dir", OUT, *extra])
        os.makedirs(OUT, exist_ok=True)
        return cli.make_problem(args, x0=[self.truthm["x0"]]) + (args,)

    def phase_y(self):
        truth = self.truthm
        J_t = truth["J"]   # f64: rel() keeps numpy's dtype, not a Python float's
        t0 = time.perf_counter()
        p64, x64, _, _ = self.mixing("float64")
        p32, x32, _, _ = self.mixing("float32")
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        J, g = p64.objective_and_gradient(x64)
        first = time.perf_counter() - t0
        self.mix_g64 = g   # phase 3's f64-config gradient
        eJ, eg = rel(J.cpu(), J_t), rel(g[0].cpu(), truth["g"])
        ok = (g[0].shape == truth["g"].shape and bool(torch.isfinite(g[0]).all()))
        self.check("Y", ok and eJ <= TOL_MIX_J64 and eg <= TOL_MIX_G64,
                   f"mixing f64 fwd+grad (256x128, N=1000, s=1) at mixing256_truth's "
                   f"x0: J {float(J)!r} vs {float(J_t)!r}, rel {eJ:.2e} (tol "
                   f"{TOL_MIX_J64:g}); gradient rel {eg:.2e} (tol {TOL_MIX_G64:g}); "
                   f"problem set-up (operator assembly, cache) {setup:.1f} s, first "
                   f"unit {first:.1f} s")
        J32, g32 = p32.objective_and_gradient(x32)
        eJ32, eg32 = rel(J32.cpu(), J_t), rel(g32[0].cpu(), truth["g"])
        step = p32._step(p32._ops, p32._initial(x32[0]))
        dtypes = (p32._ops["S"].dtype, p32._ops["MN"].dtype, step.dtype, J32.dtype,
                  g32[0].dtype)
        want = (torch.complex64, torch.complex64, torch.float32, torch.float32,
                torch.float32)
        self.check("Y", eJ32 <= TOL_MIX_J32 and eg32 < TOL_MIX_G32 and dtypes == want,
                   f"mixing f32 fwd+grad vs the f64 truth: J {float(J32)!r}, rel "
                   f"{eJ32:.2e} (tol {TOL_MIX_J32:g}); gradient rel {eg32:.2e} (tol "
                   f"{TOL_MIX_G32:g}); dtypes {dtypes}")
        for tag, p, x in (("f64", p64, x64), ("f32", p32, x32)):
            t0 = time.perf_counter()
            Jd, d = p.objective_and_diagnostics(x)
            t_diag = time.perf_counter() - t0
            bc = float(d["bc_residuals"][1:].max())
            t0 = time.perf_counter()
            same = torch.equal(Jd, p.objective(x))
            t_obj = time.perf_counter() - t0
            ok = same and (bc <= TOL_MIX_BC if tag == "f64" else np.isfinite(bc))
            self.check("Y", ok,
                       f"mixing {tag} fused diagnostics: J bitwise objective {same}; "
                       f"wall residuals after the first solve max {bc:.2e}"
                       + (f" (tol {TOL_MIX_BC:g})" if tag == "f64" else " (f32 roundoff)")
                       + f"; series {tuple(d['kinetic_energy'].shape)}; forward "
                       f"{t_obj:.2f} s, with the diagnostics {t_diag:.2f} s")
        # one unit reads the parity-blocked S three times a step (forward,
        # recompute, transposed); the transforms' flop stay below that
        n = p32.cfg.n_iters
        for tag, p, x in (("f64", p64, x64), ("f32", p32, x32)):
            s_bytes = p._ops["S"].numel() * p._ops["S"].element_size()
            s_ms = 1e3 * 3 * n * s_bytes / HBM_RATE
            ms = gpu_ms(lambda: p.objective_and_gradient(x), reps=2, warm=0)
            print(f"[Y] mixing {tag} fwd+grad unit: {ms:.1f} ms (CUDA events, mean "
                  f"of 2 after an earlier call); operator-stream bound {s_ms:.1f} ms "
                  f"(3 x {n} reads of S, {s_bytes / 1e6:.1f} MB, at "
                  f"{HBM_RATE / 1e12:g} TB/s) [{self.card}]", flush=True)
        # the profiler's own cost grows with the ~85 host-side ops a step:
        # trace a unit at MIX_TRACE_CUT steps
        pc, xc, _, _ = self.mixing("float32", "--n-iters", str(MIX_TRACE_CUT))
        pc.objective_and_gradient(xc)
        wall, busy, rows = self.print_trace("Y", f"an f32 fwd+grad unit at N={MIX_TRACE_CUT}",
                                            lambda: pc.objective_and_gradient(xc))
        n_k = sum(c for _, _, c in rows)
        print(f"[Y] f32 unit at N={MIX_TRACE_CUT}: {n_k} kernel launches, "
              f"{n_k / MIX_TRACE_CUT:.1f} a step, {1e6 * (wall - busy) / max(n_k, 1):.2f} us "
              "of idle time a launch", flush=True)

    def phase_z(self):
        ref = self.refm
        # f64 host loop at a tenth of the horizon vs the pinned JAX trajectory
        p, x, d, args = self.mixing("float64", "--n-iters", str(MIX_CUT),
                                    "--max-iters", "3")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.optimise(p, x, d, args)
        wall = time.perf_counter() - t0
        pin_fv, pin_st = ref["fv_full100"], ref["steps_full100"]
        pin_k = int(ref["iters_full100"])
        fv, st = np.asarray(res.function_values), np.asarray(res.step_sizes)
        worst = (max(float(np.max(np.abs(fv - pin_fv) / np.abs(pin_fv))),
                     float(np.max(np.abs(st - pin_st) / np.abs(pin_st))))
                 if len(fv) == len(pin_fv) else float("inf"))
        self.check("Z", res.iterations == pin_k and worst <= TRAJ_F64_RTOL,
                   f"mixing f64 host loop at N={MIX_CUT}: {res.iterations} iterations "
                   f"(JAX {pin_k}), values {fv.tolist()}, worst rel over values and "
                   f"steps {worst:.2e} (tol {TRAJ_F64_RTOL:g}), {wall:.2f} s")

        # the f32 reference workload (bench.py mixing_workload's settings)
        # through the device loop, to its end
        fv0_ref, J_t = float(ref["fv_full"][0]), float(self.truthm["J"])
        p, x, d, args = self.mixing("float32", "--device-loop")
        opt, aux = cli.device_optimiser(p, d, args), cli.loop_aux(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = opt(x, aux=aux)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k = int(r.iterations)
        fvd = r.function_values[:k].cpu().numpy()
        sphere = abs(float(p.inner_product(r.x_opt[0], r.x_opt[0])) / p.radii[0] - 1)
        loop = opt.last_loop
        ok = (k >= 1 and bool(np.all(np.diff(fvd) >= 0)) and sphere <= SPHERE_TOL
              and abs(fvd[0] - fv0_ref) <= TOL_MIX_J32 * abs(fv0_ref)
              and bool(torch.isfinite(r.x_opt[0]).all()))
        self.check("Z", ok,
                   f"mixing f32 reference workload, device loop on CUDA graphs: {k} "
                   f"iterations to J {float(fvd[-1]) if k else None!r}, first "
                   f"{float(fvd[0])!r} vs JAX f64 {fv0_ref!r} (rel tol "
                   f"{TOL_MIX_J32:g}; J(x0) = {J_t!r}), |<x,x>/r-1| {sphere:.1e}; "
                   f"steps replayed {dict(loop.replays)}; {wall:.2f} s with the warm-up "
                   f"and capture [{self.card}]")
        print(f"[Z] device-loop values: {[float(v) for v in fvd]}", flush=True)

        # the host loop: the same workload's first iterations (a host-loop
        # unit is launch-bound, ~3 s; the whole run would take minutes)
        p, x, d, args = self.mixing("float32", "--max-iters", str(MIX_HOST_ITERS))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.optimise(p, x, d, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fv = np.asarray(res.function_values)
        sphere = abs(float(p.inner_product(res.x_opt[0], res.x_opt[0])) / p.radii[0] - 1)
        ok = (res.iterations == MIX_HOST_ITERS and bool(np.all(np.diff(fv) >= 0))
              and abs(fv[0] - fv0_ref) <= TOL_MIX_J32 * abs(fv0_ref)
              and sphere <= SPHERE_TOL)
        self.check("Z", ok,
                   f"mixing f32 reference workload, host loop, its first "
                   f"{MIX_HOST_ITERS} iterations: values {[float(v) for v in fv]} "
                   f"(device loop {[float(v) for v in fvd[:MIX_HOST_ITERS]]}), first vs "
                   f"JAX f64 {fv0_ref!r}, |<x,x>/r-1| {sphere:.1e}, {res.function_evals} "
                   f"evaluations, {wall:.2f} s [{self.card}]")

        # the device loop's graphs against the same steps run eagerly, at a
        # tenth of the horizon (the eager loop at full depth is launch-bound)
        p, x, d, args = self.mixing("float32", "--device-loop", "--n-iters",
                                    str(MIX_CUT), "--max-iters", "3")
        opt, aux = cli.device_optimiser(p, d, args), cli.loop_aux(p)
        r = opt(x, aux=aux)
        r2 = opt(x, aux=aux)
        re = cli.optimise(p, x, d, args, graphs=False)
        torch.cuda.synchronize()
        same = [torch.equal(r.function_values, re.function_values),
                torch.equal(r.step_sizes, re.step_sizes),
                all(torch.equal(a, b) for a, b in zip(r.x_opt, re.x_opt)),
                torch.equal(r.function_values, r2.function_values),
                int(r.iterations) == 3]
        self.check("Z", all(same),
                   f"mixing f32 device loop at N={MIX_CUT}, 3 iterations, on CUDA "
                   f"graphs against the same steps run eagerly: J history, step sizes "
                   f"and x_opt bitwise, a replay-only call bitwise the first, 3 "
                   f"iterations: {same}")
        # one Wolfe trial (a fwd+grad unit and the search's transition)
        # replayed, at a tenth of the horizon (the profiler's own cost grows
        # with the trial's ~85 launches a step: 11.0 s at full depth)
        wall_t, busy, rows = self.print_trace(
            "Z", f"one Wolfe-trial graph replay at N={MIX_CUT}",
            lambda: opt.last_loop.run("trial"))
        n_k = sum(c for _, _, c in rows)
        print(f"[Z] the trial graph: {n_k} kernel launches, "
              f"{1e6 * (wall_t - busy) / max(n_k, 1):.2f} us of idle time a launch; "
              "its device time by kernel: " + "; ".join(
                  f"{k[:90]} {ms:.3f} ms x{c}" for k, ms, c in rows[:12]), flush=True)

        # trust-region Newton through the command line's own entry point
        out = os.path.join(OUT, "mixing_rtr_cli")
        t0 = time.perf_counter()
        rc = cli.main(["mixing", "--direction", "rtr", "--max-iters", "1",
                       "--n-iters", str(MIX_CUT), "--quiet", "--out-dir", out])
        summary = os.path.join(out, "summary.json")
        sj = json.load(open(summary)) if os.path.exists(summary) else {}
        self.check("Z", rc == 0 and sj.get("iterations", 0) >= 1
                   and sj.get("config", {}).get("dtype") == "float32"
                   and np.isfinite(sj.get("J_final") or np.nan),
                   f"`spheremanopt_torch.run mixing --direction rtr --max-iters 1 "
                   f"--n-iters {MIX_CUT}` at the CUDA default: rc {rc}, "
                   f"{sj.get('iterations')} iterations to J {sj.get('J_final')!r}, "
                   f"{sj.get('message')!r}, {time.perf_counter() - t0:.1f} s")

    # -- KDyn: continuous adjoint, remat modes, df64, Rm route (1-4) ------------

    def phase_1(self):
        ext = self.refkx
        np.testing.assert_array_equal(ext["b0"], self.truthk["b0"])
        np.testing.assert_array_equal(ext["u0"], self.truthk["u0"])
        for cost in ("Final", "Integrated"):
            args = problem_args("kdyn", "float64", "plain", "--n-iters", str(KDYN_CUT),
                                "--cost", cost, "--adjoint", "continuous")
            p, x, _ = cli.make_problem(args, x0=self.kdyn_x0(np.float64))
            t0 = time.perf_counter()
            d = p.adjoint_diagnostics(x)
            wall = time.perf_counter() - t0
            gc = [p.to_coeff(g).cpu() for g in d["gradient"]]
            e = max(crel(a, ext[f"gc{k}_{cost}"]) for a, k in zip(gc, "bu"))
            scale = float(p._kt.abs().max()) * float(gc[0].abs().max())
            inv = {k: float(d[k].max()) for k in ("max_div_G", "max_div_nu", "max_flux_G")}
            pin = {k: float(ext[f"{n}_{cost}"].max())
                   for k, n in (("max_div_G", "div_g"), ("max_div_nu", "div_nu"),
                                ("max_flux_G", "flux_g"))}
            ok = (e <= TOL_CONT_F64 and d["max_div_G"].shape == (KDYN_CUT,)
                  and max(inv["max_div_G"], inv["max_div_nu"]) < TOL_KCONT_INV * scale
                  and inv["max_flux_G"] == 0.0)
            self.check("1", ok,
                       f"kdyn f64 continuous adjoint, cost={cost}, N={KDYN_CUT}: "
                       f"gradient vs JAX's pinned one rel {e:.2e} (tol {TOL_CONT_F64:g}); "
                       f"invariant series max {inv} (JAX {pin}; tol "
                       f"{TOL_KCONT_INV:g} x {scale:.3e}, flux exactly 0); {wall:.2f} s")

        # the card's default route: J from the forward kernel (row 5), the
        # gradient from the f32 continuous sweep, at full depth, against the
        # port's f64 continuous run; each gradient's wall time
        args = problem_args("kdyn", "float32", "cuda", "--adjoint", "continuous")
        p32, x32, _ = cli.make_problem(args, x0=self.kdyn_x0(np.float32))
        t0 = time.perf_counter()
        J32, g32 = self.main_path("1", ("kdyn_fwd",),
                                  lambda: p32.objective_and_gradient(x32), record=())
        walls = {"f32": time.perf_counter() - t0}
        p64, x64, _ = cli.make_problem(
            problem_args("kdyn", "float64", "plain", "--adjoint", "continuous"),
            x0=self.kdyn_x0(np.float64))
        J64 = p64.objective(x64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g64 = p64.gradient(x64)
        torch.cuda.synchronize()
        walls["f64"] = time.perf_counter() - t0
        e = (abs(float(J32) - float(J64)) / abs(float(J64)),
             *(nrel(a, b) for a, b in zip(g32, g64)))
        fmt = "rel_J {:.3e} rel_gB {:.3e} rel_gU {:.3e}".format
        finite = all(bool(torch.isfinite(g).all()) for g in g32)
        self.check("1", max(e) <= TOL_KDYN_VS_F64 and finite,
                   f"kdyn f32 method=cuda continuous (J from kdyn_fwd, N="
                   f"{p32.cfg.n_iters}) vs the port's f64 continuous run: {fmt(*e)} "
                   f"(tol {TOL_KDYN_VS_F64:g})")
        truth = [torch.as_tensor(self.truthk[k], device=g64[0].device).double()
                 for k in ("gb", "gu")]
        print(f"[1] continuous vs discrete (kdyn24_truth, unprojected) at full "
              f"depth, f64: rel_gB {nrel(g64[0], truth[0]):.3e}, rel_gU "
              f"{nrel(g64[1], truth[1]):.3e} (reported, not gated: the continuous "
              "adjoint is first order in dt)", flush=True)
        for tag, dtype, method in (("f32", "float32", "cuda"), ("f64", "float64", "plain")):
            pc, xc, _ = cli.make_problem(
                problem_args("kdyn", dtype, method, "--adjoint", "continuous",
                             "--n-iters", str(KDYN_TRACE_CUT)),
                x0=self.kdyn_x0(np.float32 if tag == "f32" else np.float64))
            pc.gradient(xc)
            wt, busy, rows = trace(lambda: pc.gradient(xc))
            n_k = sum(c for _, _, c in rows)
            print(f"[1] one continuous gradient, {tag}, N={p32.cfg.n_iters}: "
                  f"{walls[tag]:.3f} s wall" + (" (with J from kdyn_fwd)" if tag == "f32"
                                               else "") +
                  f"; traced at N={KDYN_TRACE_CUT}: {n_k} kernel launches "
                  f"({n_k / KDYN_TRACE_CUT:.1f}"
                  f" a step of forward and adjoint), device busy {1e3 * busy:.1f} of "
                  f"{1e3 * wt:.1f} ms, idle share {100 * (1 - busy / wt):.1f} % "
                  f"[{self.card}]", flush=True)

    def phase_2(self):
        x0 = self.kdyn_x0(np.float32)
        modes = ("step", "nested", "offload", "none")
        for cost, n in REMAT_STEPS.items():
            out = {}
            for mode in modes:
                args = problem_args("kdyn", "float32", "plain", "--cost", cost,
                                    "--remat", mode, "--n-iters", str(n))
                p, x, _ = cli.make_problem(args, x0=x0)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                J, g = p.objective_and_gradient(x)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated()
                out[mode] = (J, g, peak - base, peak, wall)
                del p, x
            J0, g0 = out["step"][:2]
            lines, ok = [], True
            for mode in modes:
                J, g, own, peak, wall = out[mode]
                e = max(rel(J, J0), *(rel(a, b) for a, b in zip(g, g0)))
                bitwise = torch.equal(J, J0) and all(torch.equal(a, b) for a, b in zip(g, g0))
                ok &= e <= TOL_REMAT32 and all(bool(torch.isfinite(a).all()) for a in g)
                if mode in ("nested", "offload"):
                    ok &= own < MEM_FRACTION * out["step"][2]
                lines.append(f"{mode}: rel vs step {e:.2e} (bitwise {bitwise}), peak "
                             f"{own / 1e6:.1f} MB above the {(peak - own) / 1e6:.1f} MB "
                             f"resident, {wall:.2f} s")
            self.check("2", ok,
                       f"kdyn f32 plain fwd+grad, cost={cost}, N={n}, by remat "
                       f"mode: " + "; ".join(lines) + f" (tol {TOL_REMAT32:g}; nested and "
                       f"offload peaks below {MEM_FRACTION:g} of step's) [{self.card}]")

    def df64_loops(self, what, args, x0):
        """Two iterations of a df64 problem on the device loop (its aux form)
        against the host loop's (J at f64)."""
        os.makedirs(args.out_dir, exist_ok=True)
        p, x, defaults = cli.make_problem(args, x0=x0)
        opt, aux = cli.device_optimiser(p, defaults, args), cli.loop_aux(p)
        t0 = time.perf_counter()
        r = opt(x, aux=aux)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        host = cli.optimise(p, x, defaults, _no_loop(args))
        k = int(r.iterations)
        fv = r.function_values[:k].double().cpu().numpy()
        fh = np.asarray(host.function_values)
        worst = (float(np.max(np.abs(fv - fh) / np.abs(fh)))
                 if k == host.iterations >= 1 else float("inf"))
        ok = (r.function_values.dtype == torch.float32 and aux is not None
              and bool(np.all(np.isfinite(fv))) and worst <= TOL_DF_LOOP)
        self.check("3", ok,
                   f"{what} df64 on the device loop (aux form, f32 search state): {k} "
                   f"iterations (host loop {host.iterations}, of 2 asked), values {fv.tolist()} vs the host loop's (J at f64) "
                   f"{fh.tolist()}, worst rel {worst:.2e} (tol {TOL_DF_LOOP:g}); "
                   f"steps replayed {dict(opt.last_loop.replays)}; {wall:.2f} s with the "
                   "warm-up and capture")

    def phase_3(self):
        truth, refk = self.truthk, self.refk
        x32 = self.kdyn_x0(np.float32)
        J_t = float(truth["J"])
        g_t = [torch.as_tensor(truth[k]).double() for k in ("gb", "gu")]
        # the truths' gradients are unprojected: compare unprojected ones,
        # and the f64 config's (phase N's, if it ran)
        g64 = getattr(self, "kdyn_g64", None)
        if g64 is None:
            p64, x64, _ = cli.make_problem(problem_args("kdyn", "float64", "plain"),
                                           x0=self.kdyn_x0(np.float64))
            g64 = KinematicDynamo(dataclasses.replace(p64.cfg, project_gradients=False),
                                  device=p64.device).objective_and_gradient(x64)[1]
        # --df-adjoint runs the same f64 sweep: held at N = 200 against the
        # pinned values there (projected gradients, stored in f32)
        for extra, n in (((), None), (("--df-adjoint",), KDYN_CUT)):
            cut = () if n is None else ("--n-iters", str(n))
            p, x, _ = cli.make_problem(
                problem_args("kdyn", "float32", "plain", "--precision", "df64", *extra,
                             *cut), x0=x32)
            if n is None:
                q = KinematicDynamo(dataclasses.replace(p.cfg, project_gradients=False),
                                    device=p.device)
                want_J, want_g, want_64 = J_t, g_t, g64
            else:
                q = p
                want_J = float(refk["J200_Final"])
                want_g = [torch.as_tensor(refk[f"{k}200_Final"]).double()
                          for k in ("gb", "gu")]
                p64, x64, _ = cli.make_problem(
                    problem_args("kdyn", "float64", "plain", *cut),
                    x0=self.kdyn_x0(np.float64))
                want_64 = p64.gradient(x64)
            t0 = time.perf_counter()
            J = q.objective_f64(x)
            g = q.gradient(x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            eJ = abs(J - want_J) / abs(want_J)
            eg = [nrel(a.cpu(), b) for a, b in zip(g, want_g)]
            same = all(torch.equal(a, b.float()) for a, b in zip(g, want_64))
            ok = (eJ <= TOL_DF_J and max(eg) <= TOL_DF_G and same
                  and all(a.dtype == torch.float32 for a in g)
                  and q.objective(x).dtype == torch.float32)
            self.check("3", ok,
                       f"kdyn f32 config, --precision df64 {' '.join(extra)}, N="
                       f"{q.cfg.n_iters}, vs "
                       + ("kdyn24_truth (unprojected)" if n is None else
                          "kdyn_port_ref's pinned f64 values (projected)")
                       + f": J {J!r} rel {eJ:.2e} (tol {TOL_DF_J:g}); gradients rel "
                       f"{eg[0]:.2e} / {eg[1]:.2e} (tol {TOL_DF_G:g}); equal to the f64 "
                       f"config's cast to f32: {same}; {wall:.2f} s")
        tm = self.truthm
        p, x, _, _ = self.mixing("float32", "--precision", "df64")
        t0 = time.perf_counter()
        J = p.objective_f64(x)
        g = p.gradient(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g64 = getattr(self, "mix_g64", None)   # phase Y's, if it ran
        if g64 is None:
            p64, x64, _, _ = self.mixing("float64")
            g64 = p64.gradient(x64)
        eJ = abs(J - float(tm["J"])) / abs(float(tm["J"]))
        eg = nrel(g[0].cpu(), torch.as_tensor(tm["g"]).double())
        same = torch.equal(g[0], g64[0].float())
        self.check("3", eJ <= TOL_DF_J and eg <= TOL_DF_G and same
                   and g[0].dtype == torch.float32,
                   f"mixing f32 config, --precision df64, full depth, vs mixing256_truth: "
                   f"J {J!r} rel {eJ:.2e} (tol {TOL_DF_J:g}); gradient rel {eg:.2e} (tol "
                   f"{TOL_DF_G:g}); equal to the f64 config's cast to f32: {same}; "
                   f"{wall:.2f} s")
        self.df64_loops("kdyn", problem_args(
            "kdyn", "float32", "plain", "--precision", "df64", "--device-loop",
            "--n-iters", str(KDYN_LOOP_CUT), "--max-iters", "2"), x32)
        self.df64_loops("mixing", cli.build_parser().parse_args(
            ["mixing", "--device", "cuda", "--dtype", "float32", "--precision", "df64",
             "--device-loop", "--n-iters", str(MIX_CUT), "--max-iters", "2", "--quiet",
             "--out-dir", OUT]), [self.truthm["x0"]])

    def phase_4(self):
        from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere

        args = problem_args("kdyn", "float64", "plain", "--n-iters", str(RM_CUT))
        p, x, _ = cli.make_problem(args, x0=self.kdyn_x0(np.float64))
        fg, make_ops = p.objective_and_gradient_rm
        same = all(torch.equal(make_ops(p.cfg.rm)[k], t)
                   for k, t in (("lhs_inv", p._lhs_invt), ("rhs_fac", p._rhs_fact)))

        def loop(f_and_g, graphs=None):
            return jit_optimise_on_multi_sphere(
                f_and_g, p.inner_product, p.radii, max_iters=RM_ITERS, alpha0=100.0,
                cg=True, line_search="wolfe", err_tol=1e-12, graphs=graphs)

        opt = loop(fg)
        lines, ok, values = [], same, {}
        t0 = time.perf_counter()
        for rm in RM_VALUES:
            r = opt(x, aux=make_ops(rm))
            q = KinematicDynamo(dataclasses.replace(p.cfg, rm=rm), device=p.device)
            # the reference loops run their steps eagerly (graphs replay the
            # eager steps bitwise: U, V)
            rq = loop(q.objective_and_gradient, graphs=False)(x)
            k = int(r.iterations)
            e = max(rel(r.function_values[:k], rq.function_values[:k]),
                    rel(r.step_sizes[:k], rq.step_sizes[:k]))
            ok &= k == RM_ITERS == int(rq.iterations) and e <= TOL_RM
            values[rm] = float(r.function_values[k - 1]) if k else None
            lines.append(f"Rm={rm:g}: {k} iterations to {values[rm]!r}, worst rel vs a "
                         f"loop on a problem built at that Rm (eager steps) {e:.2e}")
        ok &= len(opt.loops) == 1 and values[RM_VALUES[0]] != values[RM_VALUES[1]]
        self.check("4", ok,
                   f"kdyn f64 Rm route (N={RM_CUT}, Wolfe + CG, alpha0 100): make_ops("
                   f"cfg.rm) bitwise the problem's factors {same}; one optimise object, "
                   f"{len(opt.loops)} capture(s) for {len(RM_VALUES)} Rm values: "
                   + "; ".join(lines) + f" (tol {TOL_RM:g}); "
                   f"{time.perf_counter() - t0:.1f} s")
        for extra in (("--adjoint", "continuous"),
                      ("--dtype", "float64", "--remat", "nested")):
            out = os.path.join(OUT, "kdyn_cli_" + extra[-1])
            t0 = time.perf_counter()
            rc = cli.main(["kdyn", *extra, "--max-iters", "1", "--n-iters",
                           str(RM_CUT), "--quiet", "--out-dir", out])
            summary = os.path.join(out, "summary.json")
            sj = json.load(open(summary)) if os.path.exists(summary) else {}
            cfg = sj.get("config", {})
            self.check("4", rc == 0 and sj.get("iterations", 0) >= 1
                       and np.isfinite(sj.get("J_final") or np.nan),
                       f"`spheremanopt_torch.run kdyn {' '.join(extra)} --max-iters 1 "
                       f"--n-iters {RM_CUT}`: rc {rc}, {sj.get('iterations')} iterations "
                       f"to J {sj.get('J_final')!r}, method {cfg.get('method')!r}, dtype "
                       f"{cfg.get('dtype')!r}, adjoint {cfg.get('adjoint')!r}, remat "
                       f"{cfg.get('remat')!r}, {time.perf_counter() - t0:.1f} s")

    # -- sweeps over rows (5) and the server (6) ---------------------------------

    def sweep_case(self, what, opt, x0, radii, aux=None, rtol=None, counts=(),
                   gate=True):
        """A sweep (warm-up and capture, then a call of replays only) against
        each row's unbatched run on the same optimiser (its own capture, then
        replays): bitwise (rtol None) or to rtol, equal iteration counts and
        the result fields in `counts`; with `gate` False, the comparison is
        reported only. Returns (sweep result, first sweep s, warm sweep s,
        sequential s, worst difference)."""
        R = x0[0].shape[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.sweep(x0, radii, aux=aux)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        rb = opt.sweep(x0, radii, aux=aux)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        rows = [[x[i] for x in x0] for i in range(R)]
        opt(rows[0], radii_dyn=list(radii[0]), aux=aux)   # the unbatched capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        singles = [opt(rows[i], radii_dyn=list(radii[i]), aux=aux) for i in range(R)]
        torch.cuda.synchronize()
        seq = time.perf_counter() - t0
        worst, same = 0.0, True
        for i, r1 in enumerate(singles):
            same &= int(rb.iterations[i]) == int(r1.iterations)
            same &= all(int(getattr(rb, c)[i]) == int(getattr(r1, c)) for c in counts)
            pairs = [(rb.function_values[i], r1.function_values),
                     (rb.step_sizes[i], r1.step_sizes)]
            pairs += [(xb[i], x1) for xb, x1 in zip(rb.x_opt, r1.x_opt)]
            for a, b in pairs:
                if rtol is None:
                    same &= torch.equal(a, b)
                d = rel(a, b) if float(b.abs().max()) > 0 else float(a.abs().max())
                worst = max(worst, d)
        ok = (same and (rtol is None or worst <= rtol)) or not gate
        its = [int(v) for v in rb.iterations]
        single_its = [int(r1.iterations) for r1 in singles]
        extra = "".join(f", {c} {[int(v) for v in getattr(rb, c)]}" for c in counts)
        want = ("bitwise" if rtol is None else f"within rtol {rtol:g} of") if gate \
            else "reported against"
        self.check("5", ok and all(np.isfinite(rb.function_values.cpu().numpy().ravel())),
                   f"{what}: B = {R}, iterations {its} (unbatched {single_its}; "
                   f"{sum(its)} row-iterations, unbatched {sum(single_its)}){extra}; "
                   f"every row {want} its unbatched run ({same}), worst rel "
                   f"{worst:.2e}; sweep {first:.3f} s "
                   f"with the warm-up and capture, {warm:.3f} s replaying; sequential "
                   f"{seq:.3f} s replaying [{self.card}]")
        return rb, first, warm, seq, worst

    def row_kernels(self, p, q):
        """Each row kernel called directly at R = SWEEP_B rows and full width
        (p: SH23, mg 512, N 1000; q: SHB23, mg 512, N 2000, both f32
        `cuda`): every row's u_T, J, trajectory and lambda_0 bitwise the
        one-row kernel on that row; the rows against the plain rows in
        f32; CUDA-event times at R = SWEEP_B and at R = 1 beside the plain
        rows' (once each) and R one-row calls'."""
        R = SWEEP_B
        mg, n, lin = p.basis.n_grid, p.cfg.n_iters, 1.0 / p.cfg.dt
        b = p._Mt.float().contiguous()
        w = torch.full((mg,), 1.0 / mg, device="cuda")
        x = torch.stack([p.generate_ic(seed=s)[0] for s in range(R)]).float()
        u0 = torch.matmul(x, p._Pt.float().t()).contiguous()
        s1 = (-2.0 * p.cfg.dt) * torch.linspace(0.5, 1.5, R, device="cuda")
        a2, b2 = q._Alt.float().contiguous(), q._Ant.float().contiguous()
        w2, n2 = q._wt.float().contiguous(), q.cfg.n_iters
        u2 = torch.stack([q.generate_ic(seed=s)[0] for s in range(R)]).float().contiguous()
        s2 = (-2.0 * q.cfg.dt) * torch.linspace(0.5, 1.5, R, device="cuda")
        cases = (
            ("sh23", "fused_fwd_shared_rows", "fused_bwd_shared_rows", u0, s1, n, 1,
             lambda u: fk.fused_fwd_shared_rows(b, w, u, C2, C3, lin, n),
             lambda uT, t, sc: fk.fused_bwd_shared_rows(b, w, uT, t, C2, C3, lin, sc, n),
             lambda u: fk.fused_fwd_shared(b, w, u, C2, C3, lin, n)[:3],
             lambda uT, t, sc: fk.fused_bwd_shared(b, w, uT, t, C2, C3, lin, sc, n)[0],
             lambda u: fk.fused_fwd_shared_rows_plain(b, w, u, C2, C3, lin, n),
             lambda uT, t, sc: fk.fused_bwd_shared_rows_plain(b, w, uT, t, C2, C3, lin,
                                                              sc, n)),
            ("shb23", "fused_fwd_rows", "fused_bwd_rows", u2, s2, n2, 2,
             lambda u: fk.fused_fwd_rows(a2, b2, w2, u, C2B, C3B, n2),
             lambda uT, t, sc: fk.fused_bwd_rows(a2, b2, w2, uT, t, C2B, C3B, sc, n2),
             lambda u: fk.fused_fwd(a2, b2, w2, u, C2B, C3B, n2)[:3],
             lambda uT, t, sc: fk.fused_bwd(a2, b2, w2, uT, t, C2B, C3B, sc, n2)[0],
             lambda u: fk.fused_fwd_rows_plain(a2, b2, w2, u, C2B, C3B, n2),
             lambda uT, t, sc: fk.fused_bwd_rows_plain(a2, b2, w2, uT, t, C2B, C3B, sc, n2)),
        )
        for what, kf, kb, U, sc, steps, n_mats, fr, br, f1, b1, fp, bp in cases:
            uT, J, traj = fr(U)
            lam = br(uT, traj, sc)
            torch.cuda.synchronize()
            same = True
            for r in range(R):
                u1, j1, t1 = f1(U[r])
                l1 = b1(u1, t1, sc[r])
                same &= (torch.equal(uT[r], u1) and torch.equal(J[r], j1)
                         and torch.equal(traj[r], t1) and torch.equal(lam[r], l1))
            pu, pj, pt = fp(U)
            pl = bp(uT, traj, sc)
            rel_f = max(rel(uT, pu), rel(J, pj), rel(traj, pt))
            rel_b = rel(lam, pl)
            self.kernels[kf]["max_abs_err"] = max_abs([(uT, pu), (J, pj), (traj, pt)])
            self.kernels[kb]["max_abs_err"] = max_abs([(lam, pl)])
            pf_ms, f_ms = interleaved_ms(lambda: fp(U), lambda: fr(U), 1, 10, warm_plain=0,
                                         plain_once=True)
            pb_ms, b_ms = interleaved_ms(lambda: bp(uT, traj, sc), lambda: br(uT, traj, sc),
                                         1, 10, warm_plain=0, plain_once=True)
            f1_ms = gpu_ms(lambda: fr(U[:1]), 10)
            b1_ms = gpu_ms(lambda: br(uT[:1], traj[:1], sc[:1]), 10)
            fseq = gpu_ms(lambda: [f1(U[r]) for r in range(R)], 3)
            bseq = gpu_ms(lambda: [b1(uT[r], traj[r], sc[r]) for r in range(R)], 3)
            self.kernels[kf].update(ms=f_ms, plain_ms=pf_ms,
                                    work=rows_work(U.shape[1], steps, n_mats, True, R))
            self.kernels[kb].update(ms=b_ms, plain_ms=pb_ms,
                                    work=rows_work(U.shape[1], steps, n_mats, False, R))
            self.check("5", same and rel_f <= TOL_VS_PLAIN and rel_b <= TOL_VS_PLAIN,
                       f"{what} row kernels at R = {R}, mg {U.shape[1]}, N {steps}: every "
                       f"row's u_T, J, trajectory and lambda_0 bitwise the one-row kernels' "
                       f"({same}); vs the plain rows f32 rel {rel_f:.2e} / {rel_b:.2e}; "
                       f"forward {f_ms:.3f} ms (R = 1 {f1_ms:.3f}; {R} one-row calls "
                       f"{fseq:.3f}; plain {pf_ms:.3f}), reverse {b_ms:.3f} ms (R = 1 "
                       f"{b1_ms:.3f}; {R} one-row calls {bseq:.3f}; plain {pb_ms:.3f}) "
                       f"[{self.card}]")

    def kdyn_row_kernels(self, p):
        """KDyn's row kernels called directly at full width and depth (p:
        `KDynConfig()` f32 `cuda`: 24^3 modes on 36^3, 2000 steps): at
        R = SWEEP_B, both costs, every row's b_T, J, trajectory, b0_bar and
        u_bar bitwise the one-row kernels' on that row; at
        R = KDYN_PLAIN_ROWS, cost Final, against the plain rows (each timed
        once); CUDA-event times at R = SWEEP_B and at R = 1 beside SWEEP_B
        one-row calls."""
        R, C, n, dt = SWEEP_B, p._consts, p.cfg.n_iters, p.cfg.dt
        with torch.no_grad():
            preps = [p._prepare(p.generate_ic(seed=s)) for s in range(R)]
        br0 = torch.stack([c.real for c, _ in preps])
        bi0 = torch.stack([c.imag for c, _ in preps])
        u = torch.stack([v for _, v in preps])
        gbar = -torch.linspace(0.5, 1.5, R, device="cuda")
        same = {}
        for cost in ("Integrated", "Final"):   # Final last: its sweeps are timed
            integrated = cost == "Integrated"
            f = kd.run_forward_rows(br0, bi0, u, C, n, integrated, dt)
            t = kd.run_fwd_traj_rows(br0, bi0, u, C, n, integrated, dt)
            b = kd.run_bwd_rows(u, t[0], t[1], gbar, t[3], t[4], C, n, integrated, dt)
            ok = True
            for r in range(R):
                one = kd.run_fwd_traj(br0[r], bi0[r], u[r], C, n, integrated, dt)
                one0 = kd.run_forward(br0[r], bi0[r], u[r], C, n, integrated, dt)
                back = kd.run_bwd(u[r], one[0], one[1], gbar[r].contiguous(), one[3],
                                  one[4], C, n, integrated, dt)
                ok &= (all(torch.equal(x[r], y) for x, y in zip(t, one))
                       and all(torch.equal(x[r], y) for x, y in zip(f, one0))
                       and all(torch.equal(x[r], y) for x, y in zip(b, back)))
            same[cost] = ok
            del one, one0, back
        fwd_r = lambda k: kd.run_forward_rows(br0[:k], bi0[:k], u[:k], C, n, False, dt)  # noqa: E731
        traj_r = lambda k: kd.run_fwd_traj_rows(br0[:k], bi0[:k], u[:k], C, n, False, dt)  # noqa: E731
        bwd_r = lambda k: kd.run_bwd_rows(u[:k], t[0][:k], t[1][:k], gbar[:k],  # noqa: E731
                                          t[3][:k], t[4][:k], C, n, False, dt)
        ms = {k: [gpu_ms(lambda: fn(k), 3, 1) for fn in (fwd_r, traj_r, bwd_r)]
              for k in (R, 1)}
        seq = [gpu_ms(lambda: [kd.run_forward(br0[r], bi0[r], u[r], C, n, False, dt)
                               for r in range(R)], 1, 1),
               gpu_ms(lambda: [kd.run_fwd_traj(br0[r], bi0[r], u[r], C, n, False, dt)
                               for r in range(R)], 1, 1),
               gpu_ms(lambda: [kd.run_bwd(u[r], t[0][r], t[1][r], gbar[r].contiguous(),
                                          t[3][r], t[4][r], C, n, False, dt)
                               for r in range(R)], 1, 1)]
        # against the plain rows, once each (a plain row takes seconds)
        k = KDYN_PLAIN_ROWS
        kern = (fwd_r(k), traj_r(k), bwd_r(k))
        plain = [timed_once(lambda: kd.run_forward_rows_plain(
                     br0[:k], bi0[:k], u[:k], C, n, False, dt)),
                 timed_once(lambda: kd.run_fwd_traj_rows_plain(
                     br0[:k], bi0[:k], u[:k], C, n, False, dt)),
                 timed_once(lambda: kd.run_bwd_rows_plain(
                     u[:k], t[0][:k], t[1][:k], gbar[:k], t[3][:k], t[4][:k], C, n, False,
                     dt))]
        errs = {}
        npts, mg = br0.shape[2], u.shape[2]
        for i, (name, fwd, traj) in enumerate(zip(KDYN_ROWS, (True, True, False),
                                                  (False, True, True))):
            pairs = list(zip(kern[i], plain[i][0]))
            errs[name] = max(rel(a, b) for a, b in pairs)
            self.kernels[name].update(
                ms=ms[R][i], plain_ms=plain[i][1], max_abs_err=max_abs(pairs),
                work=kdyn_rows_work(npts, mg, n, fwd, traj, R))
        self.check("5", all(same.values()) and max(errs.values()) <= TOL_KDYN_VS_PLAIN,
                   f"kdyn row kernels at R = {R}, n {npts}, mg {mg}, N {n}: every row's "
                   f"b_T, J, trajectory, b0_bar and u_bar bitwise the one-row kernels' "
                   f"{same}; vs the plain rows at R = {k} (Final) f32 rel "
                   + ", ".join(f"{key} {v:.2e}" for key, v in errs.items())
                   + f" (tol {TOL_KDYN_VS_PLAIN:g}); "
                   + "; ".join(f"{key} {ms[R][i]:.3f} ms (R = 1 {ms[1][i]:.3f}; {R} one-row "
                               f"calls {seq[i]:.3f}; plain at R = {k} {plain[i][1]:.1f})"
                               for i, key in enumerate(("forward", "with the trajectory",
                                                        "reverse")))
                   + f" [{self.card}]")

    def kdyn_sweeps(self, p, jit, row_forms):
        """KDyn f32 `cuda` sweeps of KDYN_SWEEP_B rows at full width and
        depth on native rows (the row kernels), each row on its own radii:
        Wolfe + CG (KDYN_SWEEP_ITERS iterations), every row bitwise its
        unbatched run, and a warm sweep a main path of the row kernels; a
        warm Armijo sweep (KDYN_ARMIJO_ITERS) the main path of the forward
        without the trajectory (its J-only trials); neither launches a
        one-row kernel."""
        B = KDYN_SWEEP_B
        ics = [p.generate_ic(seed=s) for s in range(B)]
        x0 = [torch.stack([ic[j] for ic in ics]) for j in range(2)]
        radii = [[1.0, 1.0], [1.0, 1.0], [0.5, 1.0], [1.0, 2.0]][:B]
        forms = row_forms(p)
        for ls, iters, record in (("wolfe", KDYN_SWEEP_ITERS, KDYN_ROWS[1:]),
                                  ("armijo", KDYN_ARMIJO_ITERS, KDYN_ROWS[:1])):
            opt = jit(p.objective_and_gradient, p.inner_product, p.radii,
                      max_iters=iters, alpha0=100.0, cg=True, line_search=ls,
                      f=p.objective, rows=forms)
            self.check("5", forms is not None and opt.native_rows,
                       f"kdyn method=cuda {ls} sweeps on native rows (FusedEnergyRows: "
                       "the row kernels)")
            if ls == "wolfe":
                _, _, warm, seq, _ = self.sweep_case(
                    f"kdyn f32 kernels (method=cuda, native rows) at full width and "
                    f"depth, radii {radii}, {iters} Wolfe + CG iterations (cut from "
                    f"{SWEEP_F64_ITERS})", opt, x0, radii)
                speed = f"; batched {warm:.3f} s, sequential {seq:.3f} s ({seq / warm:.2f}x)"
            else:
                opt.sweep(x0, radii)   # warm-up and capture
                speed = ""
            rb = self.main_path("5", KDYN_ROWS if ls == "armijo" else KDYN_ROWS[1:],
                                lambda: opt.sweep(x0, radii), record=record)
            one_row = {k: launches()[k] for k in KDYN_ONE_ROW}
            self.check("5", not any(one_row.values())
                       and bool(torch.isfinite(rb.function_values).all()),
                       f"the warm kdyn {ls} sweep (iterations "
                       f"{[int(v) for v in rb.iterations]}) launched no one-row kernel "
                       f"{one_row}{speed} [{self.card}]")

    def phase_5(self):
        from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
        from spheremanopt_torch.optim.jit_rtr import jit_optimise_rtr
        from spheremanopt_torch.problems.base import row_forms
        from spheremanopt_torch.problems.optimal_mixing import MixingConfig, OptimalMixing
        from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg
        from spheremanopt_torch.problems.swift_hohenberg_bounded import (
            SHB23Config,
            SwiftHohenbergBounded,
        )

        cli.set_precision()
        p = SwiftHohenberg(SH23Config(dtype="float32", method="cuda"), device="cuda")
        qb = SwiftHohenbergBounded(SHB23Config(dtype="float32", method="cuda"), device="cuda")
        self.row_kernels(p, qb)
        e0 = np.linspace(0.02, 0.10, SWEEP_B)
        # SH23 f32 kernels at full width on their native rows: every
        # gradient of the sweep one row-forward and one row-reverse launch
        x0 = [torch.stack([p.generate_ic(seed=s)[0] for s in range(SWEEP_B)])]
        radii = [[float(r)] for r in e0]
        forms = row_forms(p)

        def kernel_opt(iters):
            return jit_optimise_on_multi_sphere(
                p.objective_and_gradient, p.inner_product, p.radii, max_iters=iters,
                alpha0=float(np.pi), cg=True, line_search="wolfe", f=p.objective,
                rows=forms)

        opt5 = kernel_opt(SWEEP_F64_ITERS)
        self.check("5", forms is not None and opt5.native_rows,
                   "sh23 method=cuda sweeps on native rows (FusedObjectiveSharedRows: "
                   "the row kernels)")
        self.sweep_case(
            f"sh23 f32 kernels (method=cuda, native rows) at full width, E0 = "
            f"linspace(0.02, 0.10), {SWEEP_F64_ITERS} Wolfe + CG iterations", opt5, x0,
            radii)
        # a warm sweep is the main path: graph replays only, the row kernels
        # and never the one-row kernels
        self.main_path("5", ("fused_fwd_shared_rows", "fused_bwd_shared_rows"),
                       lambda: opt5.sweep(x0, radii))
        one_row = {k: launches()[k] for k in ("fused_fwd_shared_grid", "fused_bwd_shared")}
        self.check("5", not any(one_row.values()),
                   f"the warm sweep launched no one-row kernel {one_row}")
        # the same sweep one row at a time (rows=None: the route of the
        # continuous adjoints and the widths without row kernels), each
        # row on the unbatched loop's graphs and bitwise its unbatched run;
        # a warm sweep launches the one-row kernels (their counts stay
        # phase 1's)
        opt1 = jit_optimise_on_multi_sphere(
            p.objective_and_gradient, p.inner_product, p.radii, max_iters=SWEEP_F64_ITERS,
            alpha0=float(np.pi), cg=True, line_search="wolfe", f=p.objective, rows=None)
        self.check("5", not opt1.native_rows,
                   "sh23 method=cuda with rows=None sweeps one row at a time")
        self.sweep_case(
            f"sh23 f32 kernels (method=cuda, one row at a time) at full width, E0 = "
            f"linspace(0.02, 0.10), {SWEEP_F64_ITERS} Wolfe + CG iterations", opt1, x0,
            radii)
        self.main_path("5", ("fused_fwd_shared_grid", "fused_bwd_shared"),
                       lambda: opt1.sweep(x0, radii), record=())
        rows_k = {k: launches()[k] for k in ("fused_fwd_shared_rows", "fused_bwd_shared_rows")}
        self.check("5", not any(rows_k.values()),
                   f"the one-row-at-a-time sweep launched no row kernel {rows_k}")
        # the study's 30 iterations: every row's decisions its unbatched
        # run's, bit for bit (the f32 end points against JAX are not gated)
        opt = kernel_opt(SWEEP_ITERS)
        rb, first, warm, seq, worst = self.sweep_case(
            f"sh23 f32 kernels (native rows) at full width, {SWEEP_ITERS} Wolfe + CG "
            f"iterations", opt, x0, radii)
        j_final = [float(rb.function_values[i, max(int(rb.iterations[i]) - 1, 0)])
                   for i in range(SWEEP_B)]
        print(f"[5] sh23 f32 sweep of {SWEEP_B} on native rows, {SWEEP_ITERS} iterations: "
              f"iterations {[int(v) for v in rb.iterations]}, J_final {j_final}; batched "
              f"{warm:.3f} s, sequential {seq:.3f} s ({seq / warm:.2f}x) [{self.card}]",
              flush=True)
        wall_t, busy, rows_t = self.print_trace("5", "a warm sh23 f32 sweep (graph replays)",
                                                lambda: opt.sweep(x0, radii))
        loop = opt.last_loop
        steps = sum(opt.last_replays.values())
        n_k = sum(c for _, _, c in rows_t)
        held = sum(sum(v for k, v in loop.graph_launches(st).items() if k.endswith("_rows")) * n
                   for st, n in opt.last_replays.items())
        print(f"[5] sh23 sweep: {steps} graph replays, {n_k} kernel launches, "
              f"{n_k / steps:.1f} a replay ({held / steps:.2f} of them row kernels); "
              f"idle share {100 * (1 - busy / wall_t):.1f} %, "
              f"{1e6 * (wall_t - busy) / steps:.1f} us of idle time a replay; "
              f"replays by step {dict(opt.last_replays)}", flush=True)

        # SHB23 f32 kernels at full width on their native rows
        xb = [torch.stack([qb.generate_ic(seed=s)[0] for s in range(SHB_SWEEP_B)])]
        mb = [[qb.cfg.m0]] * SHB_SWEEP_B
        formsb = row_forms(qb)
        optb = jit_optimise_on_multi_sphere(
            qb.objective_and_gradient, qb.inner_product, qb.radii,
            max_iters=SWEEP_F64_ITERS, alpha0=1.0, cg=True, line_search="wolfe",
            f=qb.objective, rows=formsb)
        self.check("5", formsb is not None and optb.native_rows,
                   "shb23 method=cuda sweeps on native rows (FusedObjectiveRows)")
        _, _, warm_b, seq_b, _ = self.sweep_case(
            f"shb23 f32 kernels (method=cuda, native rows) at full width, M0 "
            f"{qb.cfg.m0}, seeds 0..{SHB_SWEEP_B - 1}, {SWEEP_F64_ITERS} Wolfe + CG "
            f"iterations", optb, xb, mb)
        self.main_path("5", ("fused_fwd_rows", "fused_bwd_rows"), lambda: optb.sweep(xb, mb))
        one_row = {k: launches()[k] for k in ("fused_fwd_grid", "fused_bwd")}
        self.check("5", not any(one_row.values()),
                   f"the warm shb23 sweep launched no one-row kernel {one_row}; batched "
                   f"{warm_b:.3f} s, sequential {seq_b:.3f} s ({seq_b / warm_b:.2f}x) "
                   f"[{self.card}]")

        # KDyn f32 kernels at full width and depth: the row kernels called
        # directly, then the sweeps on native rows
        pk = KinematicDynamo(KDynConfig(dtype="float32", method="cuda"), device="cuda")
        self.kdyn_row_kernels(pk)
        self.kdyn_sweeps(pk, jit_optimise_on_multi_sphere, row_forms)

        # the same sweep on SH23's native f32 matmul rows (one product of R
        # columns a step, no kernel), at SWEEP_CUT steps (an eager step of
        # the warm-up and a capture record ~36 launches a step): a warm
        # sweep timed and one trial replay traced
        pm = SwiftHohenberg(SH23Config(dtype="float32", n_iters=SWEEP_CUT), device="cuda")
        optm = jit_optimise_on_multi_sphere(
            pm.objective_and_gradient, pm.inner_product, pm.radii,
            max_iters=SWEEP_ITERS, alpha0=float(np.pi), cg=True, line_search="wolfe",
            f=pm.objective, rows=row_forms(pm))
        optm.sweep(x0, radii)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rm = optm.sweep(x0, radii)
        torch.cuda.synchronize()
        wm = time.perf_counter() - t0
        steps_m = sum(optm.last_replays.values())
        wall_m, busy_m, rows_m = self.print_trace(
            "5", f"one trial replay of the sh23 f32 matmul sweep (native rows, N = "
            f"{SWEEP_CUT})", lambda: optm.last_loop.run("trial"))
        n_m = sum(c for _, _, c in rows_m)
        print(f"[5] sh23 f32 matmul native-row sweep of {SWEEP_B} at N = {SWEEP_CUT} "
              f"(cut from 1000): {wm:.3f} s replaying {steps_m} steps, iterations "
              f"{[int(v) for v in rm.iterations]}; a trial replay {n_m} kernel launches "
              f"({n_m / SWEEP_CUT:.1f} a time step; the kernel sweep's trial at N = 1000: "
              f"{n_k / steps:.1f} a replay), {1e3 * wall_m:.3f} ms, idle share "
              f"{100 * (1 - busy_m / wall_m):.1f} % [{self.card}]", flush=True)
        # what the row masks cost: a sweep of one row on the native forms
        # against the unbatched call of the same optimiser (warm walls, and
        # the launches of one trial replay of each)
        x1, r1 = [x0[0][:1]], radii[:1]
        walls, trial = {}, {}
        for tag, fn in (("sweep R=1", lambda: optm.sweep(x1, r1)),
                        ("unbatched", lambda: optm([x0[0][0]], radii_dyn=r1[0]))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r1_res = fn()
            torch.cuda.synchronize()
            walls[tag] = (time.perf_counter() - t0, int(r1_res.iterations.reshape(-1)[0]),
                          sum(optm.last_replays.values()))
            trial[tag] = sum(c for _, _, c in trace(lambda: optm.last_loop.run("trial"))[2])
        print("[5] sh23 f32 matmul at N = {0}, the row masks' cost: ".format(SWEEP_CUT)
              + "; ".join(f"{t}: {w:.3f} s for {k} iterations ({n} replays), a trial "
                          f"replay {trial[t]} kernel launches"
                          for t, (w, k, n) in walls.items())
              + f" [{self.card}]", flush=True)

        # SH23 f64 matmul at full width: native rows (one product of R columns
        # a step); the optimisation cut to SWEEP_F64_ITERS, the solve to
        # SWEEP_CUT steps
        q = SwiftHohenberg(SH23Config(n_iters=SWEEP_CUT), device="cuda")
        e3 = [[0.02], [0.0725], [0.1]]
        xq = [torch.stack([q.generate_ic(seed=s)[0] for s in range(3)])]
        optq = jit_optimise_on_multi_sphere(
            q.objective_and_gradient, q.inner_product, q.radii,
            max_iters=SWEEP_F64_ITERS, alpha0=float(np.pi), cg=True,
            line_search="wolfe", f=q.objective, rows=row_forms(q))
        self.sweep_case(
            f"sh23 f64 matmul (native rows) at full width, N = {SWEEP_CUT} (cut from "
            f"1000), {SWEEP_F64_ITERS} Wolfe + CG iterations (cut from {SWEEP_ITERS})",
            optq, xq, e3, rtol=ROW_RTOL)

        # mixing at 256 x 128, one shared operator-stack operand, depth cut
        e4 = [[v] for v in MIX_SWEEP_E0]
        for dtype in ("float64", "float32"):
            m = OptimalMixing(MixingConfig(dtype=dtype, n_iters=MIX_SWEEP_CUT),
                              device="cuda")
            fg, ops = m.objective_and_gradient_aux
            xm = [torch.stack([m.generate_ic(seed=s)[0] for s in range(len(e4))])]
            optm = jit_optimise_on_multi_sphere(
                fg, m.inner_product, m.radii, max_iters=MIX_SWEEP_ITERS, alpha0=100.0,
                cg=True, line_search="wolfe", f=m.objective_ops,
                rows=row_forms(m, aux=True))
            worst = self.sweep_case(
                f"mixing {dtype} 256x128 at N = {MIX_SWEEP_CUT} (cut from 1000), native rows, "
                f"one shared stack operand, E0 {MIX_SWEEP_E0}, {MIX_SWEEP_ITERS} "
                f"iterations", optm, xm, e4, aux=ops,
                rtol=ROW_RTOL, gate=dtype == "float64")[-1]
            print(f"[5] mixing {dtype} sweep: the stacks are one operand of the "
                  f"loop ({sum(t.numel() for t in ops.values())} elements, once), "
                  f"worst rel vs the unbatched rows {worst:.3e}", flush=True)

        # device RTR on SH23 f64: per-row decisions
        r = SwiftHohenberg(SH23Config(n_iters=RTR_SWEEP_CUT), device="cuda")
        xr = [torch.stack([r.generate_ic(seed=s)[0] for s in (1, 2, 42)])]
        optr = jit_optimise_rtr(r.objective, r.gradient, r.inner_product, r.radii,
                                err_tol=1e-6, max_iters=100, rows=row_forms(r))
        self.sweep_case(
            f"sh23 f64 device RTR (native rows) at N = {RTR_SWEEP_CUT} (cut from 1000)",
            optr, xr, [[r.radii[0]]] * 3, rtol=ROW_RTOL,
            counts=("trials", "hvp_evals", "converged"))

    def phase_6(self):
        import tempfile
        import threading

        from spheremanopt_torch import serve as srv

        tmp = tempfile.mkdtemp(prefix="smo_serve_")
        sock = os.path.join(tmp, "smo.sock")
        ready = threading.Event()
        t = threading.Thread(target=srv.serve, args=(sock,),
                             kwargs={"ready_event": ready, "device": "cuda"},
                             daemon=True)
        t.start()
        self.check("6", ready.wait(60), f"server listening on {sock}")
        st = srv.request(sock, {"cmd": "status"})
        self.check("6", st["ok"] and st["executables"] == [] and st["busy"] is None,
                   f"status: {st}")
        cfg = {"dtype": "float32", "method": "cuda"}
        driver = {"max_iters": 5, "line_search": "wolfe", "cg": True,
                  "alpha0": float(np.pi)}
        req = {"cmd": "optimise", "problem": "sh23", "config": cfg, "driver": driver,
               "seed": 0}
        cold = srv.request(sock, req)
        reset_launches()
        warm = srv.request(sock, req)
        n = launches()
        self.check("6", cold["ok"] and warm["ok"] and not cold["cache_hit"]
                   and warm["cache_hit"] and warm["J"] == cold["J"]
                   and n["fused_fwd_shared_grid"] > 0 and n["fused_bwd_shared"] > 0,
                   f"optimise sh23 f32 cuda at full width, 5 Wolfe iterations: cold "
                   f"{cold.get('wall_s')} s (cache_hit {cold.get('cache_hit')}), warm "
                   f"{warm.get('wall_s')} s (cache_hit {warm.get('cache_hit')}), "
                   f"{warm.get('iterations')} iterations to J "
                   f"{warm.get('J', [None])[-1]!r}, the warm call's launches "
                   f"fwd {n['fused_fwd_shared_grid']} bwd {n['fused_bwd_shared']} "
                   f"[{self.card}]")
        sweep = {"cmd": "sweep", "problem": "sh23", "config": cfg, "driver": driver,
                 "seeds": list(range(SWEEP_B)),
                 "e0": [0.0725] + [float(v) for v in np.linspace(0.02, 0.10, SWEEP_B - 1)]}
        sw = srv.request(sock, sweep)
        sw2 = srv.request(sock, sweep)
        ok = sw["ok"] and sw2["ok"] and len(sw["points"]) == SWEEP_B
        row0 = sw["points"][0] if ok else {}
        # the sweep runs on the row kernels (native rows), each row bitwise
        # its unbatched run
        self.check("6", ok and row0["J"] == warm["J"]
                   and row0["iterations"] == warm["iterations"]
                   and sw2["points"] == sw["points"],
                   f"sweep of {SWEEP_B} seeds with e0 (native rows): row 0 equals the "
                   f"optimise reply bitwise, iterations "
                   f"{[r['iterations'] for r in sw.get('points', [])]}; "
                   f"cold {sw.get('wall_s')} s, warm {sw2.get('wall_s')} s [{self.card}]")
        mix = {"cmd": "sweep", "problem": "mixing", "config": {"n_iters": MIX_CUT},
               "driver": {"max_iters": 2, "line_search": "wolfe", "cg": True,
                          "alpha0": 100.0}, "seeds": [0, 1]}
        mx = srv.request(sock, mix)
        self.check("6", mx["ok"] and all(r["iterations"] >= 1 and np.all(np.isfinite(r["J"]))
                                         for r in mx.get("points", [])),
                   f"sweep on mixing (256x128 f64, N = {MIX_CUT}, 2 seeds, 2 iterations): "
                   f"{[(r['iterations'], r['J'][-1]) for r in mx.get('points', [])]} "
                   f"in {mx.get('wall_s')} s {mx.get('error', '')}")
        path = os.path.join(tmp, "out.npz")
        sv = srv.request(sock, dict(req, save=path))
        dat = np.load(path) if sv.get("saved") == path else {}
        self.check("6", sv["ok"] and sorted(getattr(dat, "files", [])) == [
            "function_values", "iterations", "residuals", "step_sizes", "x_opt_0"]
            and int(dat["iterations"]) == sv["iterations"],
            f"save: {path} with {sorted(getattr(dat, 'files', []))}")
        bad = srv.request(sock, {"cmd": "optimise", "problem": "nope"})
        self.check("6", not bad["ok"] and "unknown problem" in bad["error"],
                   f"an error reply: {bad}")
        done = {}
        th = threading.Thread(target=lambda: done.update(srv.request(sock, sweep)),
                              daemon=True)
        th.start()
        seen, lat = None, []
        while th.is_alive():
            t0 = time.perf_counter()
            s2 = srv.request(sock, {"cmd": "status"})
            lat.append(time.perf_counter() - t0)
            if s2.get("busy"):
                seen = s2["busy"]
            time.sleep(0.01)
        th.join()
        self.check("6", seen is not None and seen["cmd"] == "sweep" and done.get("ok")
                   and max(lat) < 1.0,
                   f"status answered while a sweep is busy: busy {seen}, {len(lat)} "
                   f"status replies, slowest {1e3 * max(lat):.1f} ms")
        st = srv.request(sock, {"cmd": "status"})
        bye = srv.request(sock, {"cmd": "shutdown"})
        t.join(30)
        self.check("6", bye["ok"] and not t.is_alive() and not os.path.exists(sock),
                   f"shutdown; {st['requests']} requests, {st['cache_hits']} cache hits, "
                   f"{len(st['executables'])} cached loops")

    # -- I/O and --resume ----------------------------------------------------

    def cli_main(self, tag, argv, x0=None):
        """`spheremanopt_torch.run.main(argv)` in-process with its printing
        captured: (the `out` dict, stdout, wall s, summary.json or None)."""
        d = os.path.join(OUT, "io", tag)
        shutil.rmtree(d, ignore_errors=True)
        out, buf = {}, io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv) + ["--out-dir", d, "--quiet"], x0=x0, out=out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        path = os.path.join(d, "summary.json")
        summary = json.load(open(path)) if os.path.exists(path) else None
        out.update(rc=rc, dir=d)
        return out, buf.getvalue(), wall, summary

    def archived_pair(self, what, argv, x0, fwd, bwd, light=False):
        """A plain run and an `--archive-full` run (and, with `light`, an
        `--archive-every 1` run), each a main path:
        the archived run launches the series forward as often as the plain
        run the plain forward, the plain forward never, the reverse as
        often; J histories bitwise; no recompute; the last archive's
        u_initial bitwise the checkpoint's x_opt_0."""
        from spheremanopt_torch.io.checkpoint import load_progress

        ser = fwd + "_ser"
        runs, counts = {}, {}
        for tag in ("plain", "fused", "light") if light else ("plain", "fused"):
            extra = ARCHIVE_FLAGS[tag]
            if tag == "light" and not self.no_h5py:
                extra = extra + ["--h5"]
            kernels = (ser, bwd) if tag == "fused" else (fwd, bwd)
            runs[tag] = self.main_path("7", kernels, lambda: self.cli_main(
                f"{what}_{tag}", argv + extra, x0), record=(ser,) if tag == "fused" else ())
            counts[tag] = launches()
        (po, _, pw, ps), (fo, _, fw, fs) = runs["plain"], runs["fused"]
        lp, lf = counts["plain"], counts["fused"]
        arch = fo.get("archiver")
        ck = load_progress(os.path.join(fo["dir"], "DAL_PROGRESS.npz"))
        with np.load(arch.paths[-1]) as last:
            u_init = last["u_initial"]
        fv_p, fv_f = po["result"].function_values, fo["result"].function_values
        ok = (po["rc"] == fo["rc"] == 0 and lf[ser] == lp[fwd] > 0 and lf[fwd] == 0
              and lf[bwd] == lp[bwd] and type(arch).__name__ == "FusedArchiver"
              and arch.fallback_recomputes == 0 and fv_f == fv_p
              and len(arch.paths) == fo["result"].iterations
              and u_init.dtype == ck.x_opt[0].dtype and np.array_equal(u_init, ck.x_opt[0]))
        self.check("7", ok,
                   f"{what} --archive-full: {fo['result'].iterations} iterations, launches "
                   f"{ser} {lf[ser]} / {fwd} {lf[fwd]} / {bwd} {lf[bwd]} against the "
                   f"plain run's {fwd} {lp[fwd]} / {bwd} {lp[bwd]}; J history bitwise "
                   f"{fv_f == fv_p}; fallback_recomputes {arch.fallback_recomputes}; "
                   f"{len(arch.paths)} archives; last u_initial bitwise the checkpoint's "
                   f"x_opt_0 {bool(np.array_equal(u_init, ck.x_opt[0]))}")
        return runs

    def phase_7(self):
        import importlib.util

        from spheremanopt_torch.io import native_io
        from spheremanopt_torch.io.checkpoint import load_pde_state, load_progress

        self.no_h5py = importlib.util.find_spec("h5py") is None
        no_mpl = importlib.util.find_spec("matplotlib") is None
        sh = ["sh23", "--device", "cuda", "--dtype", "float32", "--method", "cuda"]
        shb = ["shb23", "--device", "cuda", "--dtype", "float32", "--method", "cuda"]
        x_sh, x_shb = [self.ref["x0_f32"]], [self.refb["x0_f32"]]

        # SH23: plain, --archive-full, --archive-every 1 (with --h5)
        argv = sh + ["--max-iters", "5"]
        runs = self.archived_pair("sh23", argv, x_sh, "fused_fwd_shared_grid",
                                  "fused_bwd_shared", light=True)
        lo, lout, lw, ls = runs["light"]
        light = lo["archiver"]
        self.check("7", lo["rc"] == 0 and type(light).__name__ == "LightArchiver"
                   and len(light.paths) == lo["result"].iterations
                   and lo["result"].function_values == runs["plain"][0]["result"].function_values,
                   f"sh23 --archive-every 1: {len(light.paths)} light archives, J history "
                   "bitwise the plain run's"
                   + ("" if self.no_h5py else f"; --h5 wrote {sorted(lo['outputs']['h5'])}"))
        # the walls of warm runs, in the order plain, light, fused, fused,
        # light, plain (the runs above include first-use costs)
        walls = {tag: [] for tag in ARCHIVE_FLAGS}
        for tag in ("plain", "light", "fused", "fused", "light", "plain"):
            o, _, w, summary = self.cli_main(f"sh23_time_{tag}", argv + ARCHIVE_FLAGS[tag],
                                             x_sh)
            walls[tag].append((w, summary["optimise_wall_s"], o["result"].iterations))
        mean = {t: np.mean([v[1] for v in ws]) for t, ws in walls.items()}
        print("[7] sh23 f32 cuda, 5 iterations, warm runs: " + "; ".join(
            f"{t} run.main {', '.join(f'{v[0]:.4f}' for v in ws)} s, optimisation (with "
            f"callbacks, checkpoints, writes flushed) {', '.join(f'{v[1]:.4f}' for v in ws)} s"
            f" ({', '.join(str(v[2]) for v in ws)} iterations)" for t, ws in walls.items())
            + f"; archiving overhead of the optimisation wall: LightArchiver "
            f"{100 * (mean['light'] / mean['plain'] - 1):+.1f} %, FusedArchiver "
            f"{100 * (mean['fused'] / mean['plain'] - 1):+.1f} % [{self.card}]", flush=True)
        if self.no_h5py or no_mpl:
            print(f"[7] not installed on this machine: "
                  f"{', '.join(m for m, n in (('h5py', self.no_h5py), ('matplotlib', no_mpl)) if n)}"
                  f" (--h5 not run; the CLI's line: "
                  f"{[ln for ln in lout.splitlines() if 'not written' in ln]})", flush=True)

        # SHB23: plain and --archive-full, 3 iterations
        self.archived_pair("shb23", shb + ["--max-iters", "3"], x_shb, "fused_fwd_grid",
                           "fused_bwd")

        # --resume the SH23 run for 2 more iterations
        first = runs["fused"][0]
        ck_path = os.path.join(first["dir"], "DAL_PROGRESS.npz")
        ck = load_progress(ck_path)
        ro, rout, _, _ = self.cli_main("sh23_resume", sh + ["--max-iters", "2", "--resume",
                                                              ck_path])
        x0 = ro["x0"][0].cpu().numpy()
        fv0, fvr = first["result"].function_values, ro["result"].function_values
        self.check("7", ro["rc"] == 0 and "warm-starting from iteration 5" in rout
                   and x0.dtype == ck.x_opt[0].dtype and np.array_equal(x0, ck.x_opt[0])
                   and ro["result"].iterations == 2 and min(fvr) >= fv0[-1],
                   f"sh23 --resume: '{rout.splitlines()[0]}', x0 bitwise the checkpoint's "
                   f"{bool(np.array_equal(x0, ck.x_opt[0]))}, J {fvr} after {fv0[-1]!r}")

        # KDyn (rows 5-7): 2 iterations, then --resume for 1
        kd = ["kdyn", "--device", "cuda", "--dtype", "float32", "--method", "cuda"]
        ko, _, kw, _ = self.main_path("7", ("kdyn_fwd", "kdyn_fwd_traj", "kdyn_bwd"),
                                      lambda: self.cli_main("kdyn", kd + ["--max-iters", "2"],
                                                            self.kdyn_x0(np.float32)),
                                      record=())
        kpath = os.path.join(ko["dir"], "DAL_PROGRESS.npz")
        kck = load_progress(kpath)
        kr, kout, krw, _ = self.cli_main("kdyn_resume", kd + ["--max-iters", "1", "--resume",
                                                              kpath])
        res_x = [x.cpu().numpy() for x in ko["result"].x_opt]
        got = [x.cpu().numpy() for x in kr["x0"]]
        same = [np.array_equal(a, b) and np.array_equal(b, c) and a.dtype == c.dtype
                for a, b, c in zip(res_x, kck.x_opt, got)]
        self.check("7", ko["rc"] == kr["rc"] == 0 and len(same) == 2 and all(same)
                   and f"warm-starting from iteration {ko['result'].iterations}" in kout
                   and kr["result"].iterations == 1,
                   f"kdyn f32 cuda: {ko['result'].iterations} iterations ({kw:.1f} s), then "
                   f"--resume for {kr['result'].iterations} ({krw:.1f} s); x_opt_0 / x_opt_1 "
                   f"result -> checkpoint -> x0 bitwise {same}")

        # --regrid: the resumed SH23 run (npts 256) continued at npts 512
        go, gout, gw, _ = self.cli_main(
            "sh23_regrid", sh + ["--npts", "512", "--max-iters", "1", "--resume",
                                 os.path.join(ro["dir"], "DAL_PROGRESS.npz"), "--regrid"])
        p = go["problem"]
        spheres = [abs(float(p.inner_product(x, x)) / p.radii[0] - 1.0)
                   for x in (go["x0"][0], go["result"].x_opt[0])]
        self.check("7", go["rc"] == 0 and tuple(go["x0"][0].shape) == (1024,)
                   and max(spheres) <= SPHERE_TOL and go["result"].iterations == 1,
                   f"sh23 --regrid 512 -> 1024 points: "
                   f"'{[ln for ln in gout.splitlines() if 'regridded' in ln]}', |<x,x>/r-1| "
                   f"of x0 and the iterate {spheres[0]:.1e}, {spheres[1]:.1e} (tol "
                   f"{SPHERE_TOL:g}), {gw:.1f} s")

        # --solve-steps restarts: a + b steps bitwise one run of a + b
        cases = (("sh23", sh, x_sh, 500), ("shb23", shb, x_shb, 500),
                 ("kdyn", kd, self.kdyn_x0(np.float32), KDYN_CUT // 2),
                 ("mixing", ["mixing", "--device", "cuda", "--dtype", "float32"],
                  [self.truthm["x0"]], MIX_CUT // 2))
        for name, argv, x0, half in cases:
            t0 = time.perf_counter()
            d = os.path.join(OUT, "io", f"{name}_state")
            os.makedirs(d, exist_ok=True)
            a, b, c = (os.path.join(d, f"{t}.npz") for t in "abc")
            outs = [self.cli_main(f"{name}_solve_{i}", argv + extra, x0=x)
                    for i, (extra, x) in enumerate((
                        (["--solve-steps", str(half), "--state-out", a], x0),
                        (["--solve-steps", str(half), "--state-in", a, "--state-out", b],
                         None),
                        (["--solve-steps", str(2 * half), "--state-out", c], x0)))]
            lines = [json.loads([ln for ln in o[1].splitlines() if ln.startswith("{")][-1])
                     for o in outs]
            sb, nb, _ = load_pde_state(b)
            sc, nc, _ = load_pde_state(c)
            same = {k: bool(np.array_equal(sb[k], sc[k])) for k in sc}
            self.check("7", all(o[0]["rc"] == 0 for o in outs) and nb == nc == 2 * half
                       and all(same.values()) and sorted(sb) == sorted(sc)
                       and lines[1]["field_norms"] == lines[2]["field_norms"],
                       f"{name} --solve-steps {half} + --state-in {half} bitwise one run "
                       f"of {2 * half}: {same}; steps {[(ln['from_step'], ln['to_step']) for ln in lines]}"
                       f", {time.perf_counter() - t0:.1f} s for the three runs")

        # the native record writer on this host, on the SH23 archive's arrays
        path = os.path.join(OUT, "io", "archive.smo")
        with np.load(runs["fused"][0]["archiver"].paths[-1]) as arch:
            recs = {k: arch[k] for k in arch.files}
        with native_io.AsyncRecordWriter(path) as w:
            for k, v in recs.items():
                w.write(k, v)
            w.flush()
        back = native_io.read_records(path, verify_crc=True)
        ok = sorted(back) == sorted(recs) and all(
            back[k].dtype == v.dtype and np.array_equal(back[k], v) for k, v in recs.items())
        self.check("7", ok, f"native SMO1 round trip of {len(recs)} arrays "
                   f"({os.path.getsize(path)} bytes), CRC verified; built with "
                   f"'{native_io.compiler_version()}'")

    # -- profiling, the doctor and sharding ----------------------------------

    def phase_8(self):
        """An SH23 f32 `cuda` run of 2 iterations through `run.main` with
        `--profile-dir` (a main path), `time_solve` and `roofline` of the
        fwd+grad unit, then the doctor in a child process (at the end of
        phase 9 when that runs: no timed work shares the card with it)."""
        from spheremanopt_torch.utils.profiling import roofline, sh23_cost_model, time_solve

        prof_dir = os.path.join(OUT, "profile_sh23")
        shutil.rmtree(prof_dir, ignore_errors=True)
        argv = ["sh23", "--device", "cuda", "--dtype", "float32", "--method", "cuda",
                "--max-iters", "2", "--profile-dir", prof_dir]
        o, _, wall, summary = self.main_path(
            "8", ("fused_fwd_shared_grid", "fused_bwd_shared"),
            lambda: self.cli_main("sh23_profile", argv, [self.ref["x0_f32"]]), record=())
        path = os.path.join(prof_dir, "trace.json")
        names = set()
        if os.path.exists(path):
            with open(path) as f:
                names = {e.get("name", "") for e in json.load(f).get("traceEvents", [])}
        named = {k: any(k in n for n in names)
                 for k in ("fused_fwd_shared_grid", "fused_bwd_shared")}
        self.check("8", o["rc"] == 0 and summary is not None
                   and summary["iterations"] == 2 and all(named.values()),
                   f"sh23 f32 cuda --max-iters 2 --profile-dir: {wall:.2f} s, trace.json "
                   f"{os.path.getsize(path) if os.path.exists(path) else 0} bytes, "
                   f"{len(names)} event names; the kernels named: {named}")

        p, x = o["problem"], o["x0"]
        first, steady, (J, g) = time_solve(lambda: p.objective_and_gradient(x), repeats=5)
        flops, nbytes = sh23_cost_model(p.cfg.npts, p.cfg.n_iters)
        r = roofline(steady, flops, nbytes)
        d = getattr(self, "unit_ms", None)
        self.check("8", steady > 0 and bool(torch.isfinite(g[0]).all()),
                   f"time_solve of the SH23 f32 cuda fwd+grad unit (N = {p.cfg.n_iters}): "
                   f"first call {first:.4f} s, steady {steady:.4f} ms (best of 5, host "
                   f"clock, synchronised); phase D's CUDA-event mean "
                   f"{'not run' if d is None else f'{d:.4f} ms'}; roofline "
                   f"(sh23_cost_model, f32 peak) {r} [{self.card}]")
        if self.only is not None and "9" not in self.only:
            self.doctor_check()

    def doctor_check(self):
        """Phase 8's `run doctor` in a child process, waited for: after
        the last timed work of phase 9, or of phase 8 alone."""
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        t0 = time.perf_counter()
        doc = subprocess.Popen(
            [sys.executable, "-m", "spheremanopt_torch.run", "doctor"], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            out, err = doc.communicate(timeout=300)
        finally:
            if doc.poll() is None:
                doc.kill()
                doc.wait()
        doc_s = time.perf_counter() - t0
        try:
            rep = json.loads(out[out.index("{"):out.rindex("}") + 1])
        except ValueError:
            rep = {}
        name = self.card.split(",")[0].strip()
        gpu = rep.get("gpu", {})
        self.check("8", doc.returncode == 0 and rep.get("gpu_ok") is True
                   and rep.get("cpu_ok") is True and gpu.get("name") == name
                   and rep.get("kernel_library", {}).get("current") is True,
                   f"`run doctor` (a child process, {doc_s:.1f} s): exit {doc.returncode}, gpu_ok {rep.get('gpu_ok')}, cpu_ok "
                   f"{rep.get('cpu_ok')}, device {gpu.get('name')!r} (nvidia-smi {name!r}), "
                   f"SMs {gpu.get('sms')}, opt-in shared memory {gpu.get('smem_optin_bytes')} "
                   f"B, GPU probe {gpu.get('seconds')} s, CPU probe "
                   f"{rep.get('cpu', {}).get('seconds')} s, kernel library current "
                   f"{rep.get('kernel_library', {}).get('current')}, nvcc "
                   f"{rep.get('compilers', {}).get('nvcc')}"
                   + (f", stderr {err.strip().splitlines()[-1:]}" if doc.returncode else ""))

    def phase_9(self):
        """Sharding at one rank: an in-process one-rank NCCL group. KDyn
        transform="distributed" (slab, and the (1, 1) pencil) f64 at N =
        DIST_CUT from kdyn24_truth's x0 against the matmul transform; the
        device loop on CUDA graphs with the distributed problem against the
        unsharded matmul loop (N = DIST_LOOP_CUT); SHB23 f32 and mixing f64
        (N = MIX_CUT) with the state a one-rank DTensor, J and g bitwise
        the unsharded calls. Then phase 8's doctor, when phase 8 ran."""
        try:
            self.sharding_checks()
        finally:
            self.close_group()
            if self.only is None or "8" in self.only:
                self.doctor_check()

    def close_group(self):
        """Destroy the one-rank group once phase 9's loops (their CUDA
        graphs hold captured collectives) are freed; in a thread, so that a
        teardown that blocks cannot stop the script (it reports it, and
        `main` leaves through `os._exit`)."""
        import gc
        import threading

        import torch.distributed as dist

        gc.collect()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        th = threading.Thread(target=dist.destroy_process_group, daemon=True)
        th.start()
        th.join(20)
        print(f"[9] destroy_process_group: "
              + (f"done in {time.perf_counter() - t0:.2f} s" if not th.is_alive()
                 else "still blocked after 20 s (left behind)"), flush=True)

    def sharding_checks(self):
        import torch.distributed as dist

        from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
        from spheremanopt_torch.parallel.mesh import init_distributed, make_mesh, shard_fields
        from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig
        from spheremanopt_torch.problems.swift_hohenberg_bounded import (
            SHB23Config, SwiftHohenbergBounded)

        dev = init_distributed("cuda")
        self.check("9", dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                   f"process group: {dist.get_backend()}, {dist.get_world_size()} rank, "
                   f"on {dev}")

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        def close(a, b, rtol):
            return bool(torch.allclose(a, b, rtol=rtol, atol=1e-12 * float(b.abs().max())))

        def kdyn(n, **kw):
            return KinematicDynamo(KDynConfig(dtype="float64", n_iters=n, **kw), device=dev)

        xs = [torch.as_tensor(self.truthk[k], dtype=torch.float64, device=dev)
              for k in ("b0", "u0")]
        pm = kdyn(DIST_CUT)
        (Jm, gm), _ = timed(lambda: pm.objective_and_gradient(xs))
        _, t_m = timed(lambda: pm.objective_and_gradient(xs))
        for shape in ((), (1, 1)):
            pd = kdyn(DIST_CUT, transform="distributed", mesh_shape=shape)
            xd = pd.shard_state(xs)
            (Jd, gd), t_d = timed(lambda: pd.objective_and_gradient(xd))
            what = "first call"
            if not shape:   # the slab's unit again, warm
                _, t_d = timed(lambda: pd.objective_and_gradient(xd))
                what = "second call"
            ok = (abs(float(Jd) / float(Jm) - 1) <= TOL_DIST_J
                  and all(close(a, b, TOL_DIST_G) for a, b in zip(gd, gm)))
            self.check("9", ok,
                       f"kdyn f64 N={DIST_CUT} transform='distributed' mesh_shape={shape}: "
                       f"J rel {abs(float(Jd) / float(Jm) - 1):.2e} (tol {TOL_DIST_J:g}), "
                       f"gradients rel {max(rel(a, b) for a, b in zip(gd, gm)):.2e} "
                       f"(elementwise rtol {TOL_DIST_G:g}); fwd+grad unit {t_d:.3f} s "
                       f"({what}) against the matmul transform's {t_m:.3f} s (second "
                       f"call; host clock) [{self.card}]")

        def loop(p, x):
            opt = jit_optimise_on_multi_sphere(
                p.objective_and_gradient, p.inner_product, p.radii,
                max_iters=DIST_LOOP_ITERS, alpha0=100.0, cg=True, line_search="wolfe",
                graphs=True)
            r, wall = timed(lambda: opt(x))
            return r, wall, opt.last_loop

        pl, pdl = kdyn(DIST_LOOP_CUT), kdyn(DIST_LOOP_CUT, transform="distributed")
        rm, w_m, _ = loop(pl, xs)
        rd, w_d, L = loop(pdl, pdl.shard_state(xs))
        k = int(rd.iterations)
        fm, fd = rm.function_values[:k], rd.function_values[:k]
        am, ad = rm.step_sizes[:k], rd.step_sizes[:k]
        ok = (k == int(rm.iterations) == DIST_LOOP_ITERS and L.graphs
              and close(fd, fm, TOL_DIST_LOOP) and close(ad, am, TOL_DIST_LOOP))
        self.check("9", ok,
                   f"device loop on CUDA graphs ({'graphs' if L.graphs else 'eager'}), "
                   f"{DIST_LOOP_ITERS} iterations, distributed KDyn f64 N={DIST_LOOP_CUT} "
                   f"(full width): values {fd.tolist()} against the matmul loop's "
                   f"{fm.tolist()}, steps rel {rel(ad, am):.2e} (rtol {TOL_DIST_LOOP:g}); "
                   f"{w_d:.2f} s against {w_m:.2f} s with the warm-up and capture")

        mesh = make_mesh()
        pb = SwiftHohenbergBounded(SHB23Config(dtype="float32", method="matmul"), device=dev)
        xb = [torch.as_tensor(self.refb["x0_f32"], device=dev)]
        (J1, g1), t1 = timed(lambda: pb.objective_and_gradient(xb))
        xsb = shard_fields(mesh, xb, 0)
        (JP, gP), tP = timed(lambda: pb.on_mesh(mesh).objective_and_gradient(xsb))
        self.check("9", float(JP) == float(J1) and torch.equal(gP[0].full_tensor(), g1[0])
                   and tuple(gP[0].placements) == tuple(xsb[0].placements),
                   f"shb23 f32 plain (npts {pb.cfg.npts}, N {pb.cfg.n_iters}), the state a "
                   f"one-rank Shard(0) DTensor: J and g bitwise the unsharded call, g "
                   f"{gP[0].placements}; {tP:.3f} s against {t1:.3f} s")

        pmix, xm, _, _ = self.mixing("float64", "--n-iters", str(MIX_CUT))
        fg, ops = pmix.objective_and_gradient_aux
        (J1, g1), t1 = timed(lambda: fg(ops, xm))
        fgP, opsP = pmix.on_mesh(mesh).objective_and_gradient_aux
        xsm = shard_fields(mesh, xm, 1)
        (JP, gP), tP = timed(lambda: fgP(opsP, xsm))
        self.check("9", float(JP) == float(J1) and torch.equal(gP[0].full_tensor(), g1[0])
                   and tuple(gP[0].placements) == tuple(xsm[0].placements),
                   f"mixing f64 (256x128, N {MIX_CUT}), the state a one-rank Shard(1) "
                   f"DTensor: J and g bitwise the unsharded call; {tP:.3f} s against "
                   f"{t1:.3f} s")

    # -- the example studies ------------------------------------------------

    def example(self, name, argv, kernels=None):
        """`examples/torch_<name>.py`'s `main(argv)` in-process on the card,
        a main path of `kernels` when given: (its result, the JSON object
        of its last output line, wall s). Its own lines stay out of this
        log."""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            f"torch_example_{name}", os.path.join(HERE, "examples", f"torch_{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()

        def run():
            try:
                with contextlib.redirect_stdout(buf):
                    return mod.main(argv + ["--device", "cuda"])
            except SystemExit as e:   # an example's refusal fails the phase
                raise RuntimeError(f"torch_{name}.py exited: {e}") from e

        t0 = time.perf_counter()
        ret = run() if kernels is None else self.main_path("0", kernels, run, record=())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lines = buf.getvalue().strip().splitlines()
        return ret, json.loads(lines[-1]) if lines else None, wall

    def start_children(self):
        """Start the sharded examples' torchrun children (SHARDED); phase 0
        collects them. Phase X starts them, when phase 0 runs, so that
        their ~35 s (mostly their imports and NCCL's start) overlap phase
        X's f64 loops, which time no kernel."""
        self.children = {name: self.sharded_child(name, argv)
                         for name, argv in SHARDED.items()}
        return self.children

    def sharded_child(self, name, argv):
        """One rank of a sharded example under torchrun, in a child process
        (its own NCCL group: phase 9's is not reused)."""
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        # "--": torchrun's parser would take the example's `--s` for its own
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", "--", os.path.join(HERE, "examples", f"torch_{name}.py"),
               *argv, "--device", "cuda", "--dtype", "float64"]
        proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        t0, done = time.perf_counter(), {}

        def wait():
            try:
                done["out"] = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                done["out"] = proc.communicate()
            done["s"] = time.perf_counter() - t0

        import threading

        done["thread"] = threading.Thread(target=wait, daemon=True)
        done["thread"].start()
        return proc, done

    def phase_0(self):
        """The example studies (EXAMPLES, SHARDED): each one's JSON line
        must be its result, its values finite and its gates met."""
        os.makedirs(os.path.join(OUT, "examples"), exist_ok=True)
        children = self.children or self.start_children()
        try:
            for name, argv, kernels in EXAMPLES:
                ret, line, wall = self.example(name, argv, kernels)
                self.example_check(name, argv, ret, line, wall)
            self.sharded_checks(children)
        finally:
            for proc, done in children.values():
                if proc.poll() is None:
                    proc.kill()
                done["thread"].join(30)

    def example_check(self, name, argv, ret, line, wall):
        finite = all(np.isfinite(v) for v in _numbers(ret))
        what = f"torch_{name}.py {' '.join(argv[:2])}"
        if name == "sh23_critical_seed":
            lo, hi = ret["bracket"]
            e_lo, e_hi = ret["ends"]
            ok = (ret["captures"] == 1 and e_hi["J_opt"] > ret["threshold"] > e_lo["J_opt"]
                  and lo < ret["critical_seed_energy"] < hi
                  and ret["sphere_err"] <= SPHERE_TOL)
            msg = (f"E_c {ret['critical_seed_energy']!r} in [{lo!r}, {hi!r}], J_opt "
                   f"{e_lo['J_opt']:.4g} / {e_hi['J_opt']:.4g} at the ends (threshold "
                   f"{ret['threshold']:.4g}), decisions "
                   f"{[b['triggered'] for b in ret['bisections']]}, {ret['captures']} capture")
        elif name == "kdyn_critical_rm":
            lo, hi = ret["bracket"]
            probes = ret["probes"]
            ok = (ret["captures"] == 1 and not ret["eager"] and lo < ret["rm_c"] < hi
                  and probes[0]["J_opt"] < 1.0 < probes[1]["J_opt"]
                  and all(p["growth"] == (p["J_opt"] > 1.0) for p in probes)
                  and ret["sphere_err"] <= SPHERE_TOL)
            msg = (f"rm_c {ret['rm_c']!r} +- {ret['plus_minus']:.4g} in [{lo:.4g}, {hi:.4g}], "
                   f"J_opt {[round(p['J_opt'], 6) for p in probes]}, {ret['captures']} "
                   f"capture, first probe (warm-up and capture) {ret['first_probe_s']:.2f} s, "
                   f"host peak RSS {ret['host_max_rss_mb']:.0f} MB")
        elif name == "lbfgs_vs_cg":
            runs = [ret[d] for d in ("cg", "lbfgs")]
            ok = all(r["iterations"] >= 1 and bool(np.all(np.diff(r["J_history"]) >= 0))
                     and r["sphere_err"] <= SPHERE_TOL for r in runs)
            msg = "; ".join(f"{d} {r['iterations']} iterations to J {r['J_final']!r}, "
                            f"first {r['first_s']:.2f} s, steady {r['steady_s']:.3f} s"
                            for d, r in zip(("cg", "lbfgs"), runs))
        elif name == "rtr_newton_vs_cg":
            runs = [ret[d] for d in ("cg", "rtr")]
            ok = all(r["iterations"] >= 1 and bool(np.all(np.diff(r["J_history"]) >= 0))
                     and r["sphere_err"] <= SPHERE_TOL for r in runs)
            msg = "; ".join(f"{d} {r['iterations']} iterations, f {r['function_evals']}, g "
                            f"{r['gradient_evals']}, HVPs {r['hvp_evals']}, J "
                            f"{r['J_history'][-1]!r}, cold {r['cold_s']:.2f} s, warm "
                            f"{r['warm_s']:.2f} s" for d, r in zip(("cg", "rtr"), runs))
        elif name == "regrid_warmstart":
            ok = (ret["captures"] == 2 and ret["sphere_err"] <= SPHERE_TOL
                  and all(ret[k]["iters"] >= 1 for k in ("cold", "coarse", "warm")))
            msg = (f"cold {ret['cold']['iters']} / warm {ret['warm']['iters']} iterations "
                   f"(to target {ret['cold']['iters_to_target']} / "
                   f"{ret['warm']['iters_to_target']}), J start {ret['cold']['J_start']:.6g} "
                   f"/ {ret['warm']['J_start']:.6g}, coarse {ret['coarse']['iters']}")
        else:   # the two mixing host-loop studies: mix-norm histories
            hists = ([ret["coarse"]["mixnorm"], ret["warm_fine"]["mixnorm"]]
                     if "coarse" in ret else [ret["mixnorm"]])
            ok = (all(len(h) >= 1 and bool(np.all(np.diff(h) <= 0)) for h in hists)
                  and ret["sphere_err"] <= SPHERE_TOL and ret["solve_precision"] == "df64")
            msg = f"mix-norm histories {hists}"
        self.check("0", ok and finite and line == ret,
                   f"{what}: {msg}; |<x,x>/r-1| {ret.get('sphere_err', 0.0):.1e}, finite "
                   f"{finite}, JSON line = result {line == ret}, {wall:.2f} s [{self.card}]")

    def sharded_checks(self, children):
        """The sharded children's trajectories against the unsharded loops
        on the same widths, depths and seeds, run here meanwhile."""
        from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
        from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig
        from spheremanopt_torch.problems.optimal_mixing import MixingConfig, OptimalMixing

        def loop(fg, p, x0, alpha0, aux=None):
            opt = jit_optimise_on_multi_sphere(
                fg, p.inner_product, p.radii, max_iters=SHARDED_ITERS, alpha0=alpha0,
                cg=True, err_tol=1e-12, line_search="wolfe")
            r = opt(x0, aux=aux)
            k = int(r.iterations)
            return r.function_values[:k].cpu().numpy(), r.step_sizes[:k].cpu().numpy()

        pk = KinematicDynamo(KDynConfig(npts=16, n_iters=20, dt=1e-3, dtype="float64"),
                             device="cuda")
        pm = OptimalMixing(MixingConfig(nx=32, nz=16, n_iters=20, prep_steps=5, s=0,
                                        dtype="float64"), device="cuda")
        fgm, ops = pm.objective_and_gradient_aux
        refs = {"kdyn_sharded_optimisation": loop(pk.objective_and_gradient, pk,
                                                  pk.generate_ic(seed=3), 100.0),
                "mixing_sharded_optimisation": loop(fgm, pm, pm.generate_ic(seed=3), 10.0,
                                                    ops)}
        for name, (proc, done) in children.items():
            done["thread"].join(330)
            out, err = done.get("out", ("", "still running"))
            try:
                rec = json.loads(out.strip().splitlines()[-1])
            except (ValueError, IndexError):
                rec = None
            fv, steps = refs[name]
            ok = (proc.returncode == 0 and rec is not None and rec["ranks"] == 1
                  and rec["torchrun"] and rec["backend"] == "nccl"
                  and rec["iterations"] == len(fv) >= 1
                  and np.allclose(rec["J_trajectory"], fv, rtol=TOL_DIST_LOOP,
                                  atol=1e-12 * float(np.abs(fv).max()))
                  and np.allclose(rec["step_sizes"], steps, rtol=TOL_DIST_LOOP, atol=0.0))
            self.check("0", ok,
                       f"torchrun --nproc-per-node 1 torch_{name}.py --dtype float64: exit "
                       f"{proc.returncode}, " + (
                           f"{rec['iterations']} iterations, J {rec['J_trajectory']} against "
                           f"the unsharded loop's {fv.tolist()} (rtol {TOL_DIST_LOOP:g}), "
                           f"{rec['grid']}, memory and work split "
                           f"{rec['memory_and_work_split']}, loop {rec['wall_s']:.2f} s"
                           if rec else f"no JSON line; stderr {err.strip().splitlines()[-3:]}")
                       + f"; the child {done.get('s', float('nan')):.1f} s [{self.card}]")

    def start_beside(self):
        """Run the BESIDE phases that this run selects in a second process
        (`chip_smoke.py --beside ...`); join_beside prints its lines."""
        names = "".join(c for c in BESIDE if not self.only or c in self.only)
        if not names:
            return
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--beside",
                                 names], cwd=HERE, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        t0, done = time.perf_counter(), {"names": names, "proc": proc}

        def wait():
            try:
                done["out"] = proc.communicate(timeout=900)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                done["out"] = proc.communicate()[0] + "\n(killed after 900 s)"
            done["s"] = time.perf_counter() - t0

        import threading

        done["thread"] = threading.Thread(target=wait, daemon=True)
        done["thread"].start()
        self.beside = done

    def join_beside(self):
        done = self.beside
        if not done:
            return
        done["thread"].join()
        names = ", ".join(done["names"].upper())
        print(f"[{done['names'][0].upper()}] phases {names} in a second process "
              f"({done['s']:.1f} s, beside phases {', '.join(ALONGSIDE.upper())}):",
              flush=True)
        print(done["out"].rstrip(), flush=True)
        if done["proc"].returncode != 0:
            self.failures.append(f"{names}: the second process exited "
                                 f"{done['proc'].returncode}")

    def run(self, only=None, beside=False):
        """The phases in ORDER (with `only`, A, B and those named); with
        `beside`, phase A and the phases `only` names, in this order (the
        second process)."""
        self.only = only
        for name in ("a" + only if beside else ORDER):
            if name in "<>":
                if not beside:
                    self.start_beside() if name == "<" else self.join_beside()
                continue
            if only and name not in "ab" + only:
                continue
            phase = getattr(self, f"phase_{name}")
            t0 = time.perf_counter()
            try:
                if name not in "ab" + NO_KERNELS + BESIDE:
                    self.built()
                phase()
            except Exception:  # report every phase, then fail the run
                traceback.print_exc()
                self.failures.append(f"{name.upper()}: raised")
                print(f"[{name.upper()}] FAIL: raised", flush=True)
            print(f"[{name.upper()}] {time.perf_counter() - t0:.1f} s", flush=True)
        return not self.failures

    def kernel_records(self):
        recs = []
        for name, rec in self.kernels.items():
            rec = dict(rec)
            b_ms, bound_by = bound_ms(*rec.pop("work"))
            recs.append(dict(
                name=name, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name], launches=rec["launches"],
                max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                plain_ms=rec["plain_ms"], bound_ms=b_ms, bound_by=bound_by,
                library_ms=rec.get("library_ms")))
        return recs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here",
              file=sys.stderr)
        return 2
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv else None
    beside = "--beside" in sys.argv
    if beside:   # the second process: phase A and BESIDE phases
        only = sys.argv[sys.argv.index("--beside") + 1]
    smoke = Smoke()
    if not smoke.run(only, beside):
        print("chip_smoke FAILED: " + "; ".join(smoke.failures), file=sys.stderr)
        return 1
    if only:   # a part of the phases: no kernels line and no result line
        return 0
    kernels = smoke.kernel_records()
    print(smoke.card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # no interpreter teardown: a process group whose collectives CUDA graphs
    # captured (phase 9) may block in its destructor
    os._exit(code)
