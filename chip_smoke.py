"""Smoke test of the PyTorch/CUDA port (`spheremanopt_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only uvwx     # phases A, B and the ones named

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
    the host and on the device.

Inputs come from `baselines/sh23_port_ref.npz`,
`baselines/sh23_ext_port_ref.npz`, `baselines/sh23_rtr_port_ref.npz`,
`baselines/shb23_port_ref.npz`,
`baselines/kdyn_port_ref.npz` and `baselines/kdyn24_truth.npz` (the JAX
package's seed-42 initial conditions, trajectories and f64 values; this
script imports no JAX).

Phases, one line each; any failure exits non-zero without a result line:
  A  card, power limit, torch/CUDA versions, TF32 flags (off)
  B  kernel build (nvcc, sm_90a, one process per source), timed
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
     stages a step) and the fwd+grad unit, kernel vs plain
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

Each main path (G, H, L, M, R, S, T, U, V) runs with the launch counters set to 0
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
from spheremanopt_torch.problems.kinematic_dynamo import KinematicDynamo

HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(HERE, "baselines", "sh23_port_ref.npz")
REF_X = os.path.join(HERE, "baselines", "sh23_ext_port_ref.npz")
REF_B = os.path.join(HERE, "baselines", "shb23_port_ref.npz")
REF_K = os.path.join(HERE, "baselines", "kdyn_port_ref.npz")
TRUTH_K = os.path.join(HERE, "baselines", "kdyn24_truth.npz")
REF_R = os.path.join(HERE, "baselines", "sh23_rtr_port_ref.npz")
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
# the continuous adjoint is the same FFT recursion in both packages (f64)
TOL_CONT_F64 = 1e-10
# the JAX package's bench record (iterations, J): another workload, with
# unprojected gradients through its device-resident optimiser loop
KDYN_BENCH_END = (10, 2.518)
# H100 SXM data-sheet peaks (dense f32 outside the tensor cores, dense
# TF32 on the tensor cores, HBM3)
F32_PEAK, TF32_PEAK, HBM_RATE = 67e12, 495e12, 3.35e12
# the routes above the reverse clusters' widths (H): SHB23's and SH23's
# grid-wide sweeps at BLOCK_MG, held to the one-block kernels; SHB23's
# grid-wide sweeps with B rows and columns from L2 at WIDE_MG
BLOCK_MG, BLOCK_N, WIDE_MG = 1024, 200, 2048
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


def max_abs(pairs):
    return max(float((torch.as_tensor(a).double() - torch.as_tensor(b).double())
                     .abs().max()) for a, b in pairs)


def gpu_ms(fn, reps, warm=2):
    """Mean ms per call by CUDA events, after `warm` warm-up calls."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(plain, kernel, reps_plain, reps_kernel, warm_plain=2):
    """(plain ms, kernel ms), measured plain, kernel, kernel, plain."""
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


def bound(flop, nbytes, peak=F32_PEAK):
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and flop over `peak` (default the f32 peak outside the tensor cores)."""
    t_ops, t_bytes = flop / peak, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


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
        self.failures = []
        self.kernels = {name: {} for name in SOURCES}
        self.card = ""
        self.launched, self.host_iters = {}, {}   # main paths' launches, iterations

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
        self.card = card_line()
        print(self.card, flush=True)
        cli.set_precision()
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        self.check("A", flags == (False, False),
                   f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
                   f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
                   f"tf32 matmul/cudnn = {flags}")

    def phase_b(self):
        t0 = time.perf_counter()
        kbuild.load()
        dt = time.perf_counter() - t0
        ptxas = [ln.strip() for ln in kbuild.build_log.splitlines() if "ptxas info" in ln]
        for ln in ptxas:
            print("  " + ln)
        self.check("B", True, f"built {kbuild.library_path().relative_to(HERE)} "
                   f"in {dt:.1f} s")

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
        pairs = {k: [] for k in kd.KERNEL_SOURCES}
        reset_launches()
        for integrated, n in ((False, cfg.n_iters), (True, KDYN_CUT)):
            k = kd.run_fwd_traj(br0, bi0, u, C, n, integrated, cfg.dt)
            k0 = kd.run_forward(br0, bi0, u, C, n, integrated, cfg.dt)
            r = kd.run_fwd_traj_plain(br0, bi0, u, C, n, integrated, cfg.dt)
            bk = kd.run_bwd(u, k[0], k[1], gbar, k[3], k[4], C, n, integrated, cfg.dt)
            bp = kd.run_bwd_plain(u, k[0], k[1], gbar, k[3], k[4], C, n, integrated,
                                  cfg.dt)
            torch.cuda.synchronize()
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
            q, x, _ = cli.make_problem(args, x0=self.kdyn_x0(dtype))
            q = KinematicDynamo(dataclasses.replace(q.cfg, project_gradients=False),
                                device=q.device)
            J, g = q.objective_and_gradient(x)
            return float(J), [a.double() for a in g]

        def against(J, g, J64, g64):
            return (abs(J - J64) / abs(J64),
                    *(float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
                      for a, b in zip(g, g64)))

        dev = u.device
        J64 = float(self.truthk["J"])
        g64 = [torch.as_tensor(self.truthk[k], device=dev).double() for k in ("gb", "gu")]
        e_k = against(*unprojected(problem_args("kdyn", "float32", "cuda"), np.float32),
                      J64, g64)
        e_p = against(*unprojected(problem_args("kdyn", "float32", "plain"), np.float32),
                      J64, g64)
        e_d = against(*unprojected(problem_args("kdyn", "float64", "plain"), np.float64),
                      J64, g64)
        fmt = "rel_J {:.3e} rel_gB {:.3e} rel_gU {:.3e}".format
        self.check("N", max(e_k) <= TOL_KDYN_VS_F64,
                   f"KDyn full depth vs pinned f64: method=cuda {fmt(*e_k)} (plain "
                   f"f32: {fmt(*e_p)}), tol {TOL_KDYN_VS_F64:g}")
        self.check("N", e_d[0] <= TOL_KDYN_J64 and max(e_d[1:]) <= TOL_KDYN_G64,
                   f"KDyn full depth plain f64 vs pinned f64: {fmt(*e_d)}, tol "
                   f"{TOL_KDYN_J64:g} / {TOL_KDYN_G64:g}")
        self.pk_cuda, self.xk32 = p, x0
        self.pk_plain32 = cli.make_problem(problem_args("kdyn", "float32", "plain"),
                                           x0=self.kdyn_x0(np.float32))[0]

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
        # the plain versions take seconds a sweep and were run in phase N:
        # one call each way, no warm-up
        f_pl, f_k = interleaved_ms(
            lambda: kd.run_forward_plain(br0, bi0, u, C, n, False, dt),
            lambda: kd.run_forward(br0, bi0, u, C, n, False, dt), 1, 5, 0)
        t_pl, t_k = interleaved_ms(
            lambda: kd.run_fwd_traj_plain(br0, bi0, u, C, n, False, dt),
            lambda: kd.run_fwd_traj(br0, bi0, u, C, n, False, dt), 1, 5, 0)
        b_pl, b_k = interleaved_ms(
            lambda: kd.run_bwd_plain(u, brT, biT, gbar, trr, tri, C, n, False, dt),
            lambda: kd.run_bwd(u, brT, biT, gbar, trr, tri, C, n, False, dt), 1, 5, 0)
        u_pl, u_k = interleaved_ms(
            lambda: self.pk_plain32.objective_and_gradient(self.xk32),
            lambda: self.pk_cuda.objective_and_gradient(self.xk32), 1, 5, 0)
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
                   f"plain {b_pl:.3f} ms; fwd+grad unit kernel path {u_k:.3f} ms vs "
                   f"plain f32 path {u_pl:.3f} ms")

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
            "R", tuple(kd.KERNEL_SOURCES),
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
            pb, _ = bound(*op_grads_work(mg_, n_, n_out))   # 3xTF32
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

    def run(self, only=None):
        for name in "abcdefghijklmnopqrstuvwx":
            if only and name not in "ab" + only:
                continue
            phase = getattr(self, f"phase_{name}")
            t0 = time.perf_counter()
            try:
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
            bound_ms, bound_by = bound(*rec.pop("work"))
            recs.append(dict(
                name=name, route="cuda", source=SOURCES[name],
                replaces=REPLACES[name], launches=rec["launches"],
                max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                plain_ms=rec["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
                library_ms=rec.get("library_ms")))
        return recs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here",
              file=sys.stderr)
        return 2
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv else None
    smoke = Smoke()
    if not smoke.run(only):
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
    sys.exit(main())
