"""Smoke test of the PyTorch/CUDA port (`spheremanopt_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through the same entry points as the
command line (`spheremanopt_torch.run.make_problem` and `run.optimise`),
after building the CUDA kernels from `spheremanopt_torch/csrc` and
holding each against its plain PyTorch version on the card:

  * SH23: 256 Fourier modes on a 512-point grid, 1000 SBDF1 steps,
    strong-Wolfe + hybrid CG, alpha0 = pi (shared-matrix kernels);
  * SHB23: 512 Chebyshev roots points, 2000 SBDF1 steps, alpha0 = 1,
    max_iters = 50, err_tol = 1e-5 (two-matrix kernels);
  * the fused diagnostics of both (the series variants of the forward
    kernels).

Inputs come from `baselines/sh23_port_ref.npz` and
`baselines/shb23_port_ref.npz` (the JAX package's seed-42 initial
conditions and trajectories; this script imports no JAX).

Phases, one line each; any failure exits non-zero without a result line:
  A  card, power limit, torch/CUDA versions, TF32 flags (off)
  B  kernel build (nvcc, sm_90a, one process per source), timed
  C  SH23 kernels vs plain f32 vs plain f64 on the card, full width
  D  SH23 CUDA-event timings: each sweep and the fwd+grad unit
  E  Taylor test of the SH23 f64 plain path (gamma2 within 0.05 of 2)
  F  SH23 f64 workload (method=matmul) vs the pinned JAX f64 trajectory
  G  SH23 f32 workload through the kernels (method=cuda): a main path,
     then a torch.profiler trace of a second run
  H  SHB23 kernels vs plain f32 vs plain f64, full width; the series
     variants of both forwards bitwise the plain ones (J, u_T, lambda)
  I  CUDA-event timings: the SHB23 sweeps, both series forwards and the
     SHB23 fwd+grad unit, kernel vs plain
  J  Taylor test of the SHB23 f64 plain path
  K  SHB23 f64 workload (method=matmul) vs the pinned JAX f64 trajectory
  L  SHB23 f32 workload through the kernels (method=cuda): a main path,
     then a torch.profiler trace of a second run
  M  fused diagnostics on method=cuda, both problems: a main path of the
     series kernels; J and the gradient bitwise the plain objective's

Each main path (G, L, M) runs with the launch counters set to 0 just
before it and read just after; a kernel of that path that was not
launched fails it. The last lines are the card, the kernels' JSON line
and `{"ok": true, ...}`. Without CUDA it exits non-zero: there is no
CPU path.
"""

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

HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(HERE, "baselines", "sh23_port_ref.npz")
REF_B = os.path.join(HERE, "baselines", "shb23_port_ref.npz")
OUT = os.path.join(HERE, "build", "chip_smoke")   # run logs (git-ignored)
C2, C3 = 1.8, -1.0     # SH23:  g(u) = 1.8 u^2 - u^3
C2B, C3B = 2.0, -1.0   # SHB23: g(u) = 2 u^2 - u^3
# kernel vs plain f32: both f32, summed in another order over 1000-2000
# nonlinear steps. Kernel vs plain f64: SH23 at the TPU kernel's recorded
# class; SHB23's A_lin has entries ~1/dt = 100, so its gradient gets 1e-4.
TOL_VS_PLAIN, TOL_VS_F64, TOL_G_VS_F64_SHB = 1e-4, 1e-5, 1e-4
GAMMA2_TOL, TRAJ_F64_RTOL, FV0_ATOL, FV0_RTOL, SPHERE_TOL = 0.05, 1e-6, 1e-4, 1e-4, 1e-5
# H100 SXM data-sheet peaks (dense f32 outside the tensor cores, HBM3)
F32_PEAK, HBM_RATE = 67e12, 3.35e12
PALLAS = "spheremanopt_tpu/ops/pallas/fused_two_matrix.py"
REPLACES = {
    "fused_fwd_shared": f"{PALLAS}:150",        # _fwd_kernel_shared
    "fused_fwd_shared_ser": f"{PALLAS}:150",    # same, has_ser=True
    "fused_bwd_shared": f"{PALLAS}:185",        # _bwd_kernel_shared
    "fused_fwd": f"{PALLAS}:60",                # _fwd_kernel
    "fused_fwd_ser": f"{PALLAS}:60",            # same, has_ser=True
    "fused_bwd": f"{PALLAS}:102",               # _bwd_kernel
}


def problem_args(problem, dtype, method):
    return cli.build_parser().parse_args(
        [problem, "--device", "cuda", "--dtype", dtype, "--method", method,
         "--quiet", "--out-dir", OUT])


def rel(a, b):
    """max |a - b| / max |b| over tensors (or 0-dim values)."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max())


def max_abs(pairs):
    return max(float((torch.as_tensor(a).double() - torch.as_tensor(b).double())
                     .abs().max()) for a, b in pairs)


def gpu_ms(fn, reps):
    """Mean ms per call by CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(plain, kernel, reps_plain, reps_kernel):
    """(plain ms, kernel ms), measured plain, kernel, kernel, plain."""
    t = [gpu_ms(plain, reps_plain), gpu_ms(kernel, reps_kernel),
         gpu_ms(kernel, reps_kernel), gpu_ms(plain, reps_plain)]
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


def bound(flop, nbytes):
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and flop over the f32 peak."""
    t_ops, t_bytes = flop / F32_PEAK, nbytes / HBM_RATE
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


class Smoke:
    def __init__(self):
        self.ref, self.refb = np.load(REF), np.load(REF_B)
        self.failures = []
        self.kernels = {name: {} for name in fk.KERNEL_SOURCES}
        self.card = ""

    def check(self, phase, ok, msg):
        print(f"[{phase}] {'ok' if ok else 'FAIL'}: {msg}", flush=True)
        if not ok:
            self.failures.append(f"{phase}: {msg}")

    def main_path(self, phase, kernels, fn, record=None):
        """Run `fn` with the launch counters set to 0 just before and read
        just after; every kernel in `kernels` must have launched. The
        counts of `record` (default: `kernels`) go to the JSON line."""
        fk.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launched = {k: fk.LAUNCHES[k] for k in kernels}
        for k in (kernels if record is None else record):
            self.kernels[k]["launches"] = launched[k]
        self.check(phase, all(v > 0 for v in launched.values()),
                   f"main-path launches {launched}")
        return out

    def report_trace(self, phase, problem, ref):
        """Trace a second run of the f32 kernel workload (the optimisation
        only; the problem is built before)."""
        args = problem_args(problem, "float32", "cuda")
        p, x, defaults = cli.make_problem(args, x0=[ref["x0_f32"]])
        wall, busy, rows = trace(lambda: cli.optimise(p, x, defaults, args))
        top = "; ".join(f"{k[:40]} {ms:.1f} ms x{n}" for k, ms, n in rows[:4])
        idle = f"{100 * (1 - busy / wall):.1f} %" if busy > 0 else "not measured"
        print(f"[{phase}] trace of a second run: wall {wall:.3f} s, device busy "
              f"{busy:.3f} s, idle share {idle}; by kernel: {top} "
              f"({len(rows)} kernel names) [{self.card}]", flush=True)

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
        launched = {k: fk.LAUNCHES[k] for k in ("fused_fwd_shared", "fused_bwd_shared")}
        e_fwd = max(rel(uT_k, uT_p), rel(tr_k, tr_p), rel(js_k, js_p))
        e_bwd = rel(lam_k, lam_p)
        abs_fwd = max_abs([(uT_k, uT_p), (tr_k, tr_p), (js_k, js_p)])
        abs_bwd = max_abs([(lam_k, lam_p)])
        self.kernels["fused_fwd_shared"]["max_abs_err"] = abs_fwd
        self.kernels["fused_bwd_shared"]["max_abs_err"] = abs_bwd
        self.check("C", e_fwd <= TOL_VS_PLAIN and e_bwd <= TOL_VS_PLAIN,
                   f"kernel vs plain f32 (mg={b.shape[0]}, N={n}): fwd rel "
                   f"{e_fwd:.2e} (abs {abs_fwd:.2e}), bwd rel {e_bwd:.2e} "
                   f"(abs {abs_bwd:.2e}), tol {TOL_VS_PLAIN:g}")
        self.check("C", all(v > 0 for v in launched.values()),
                   f"launch counters moved: {launched}")

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
        self.kernels["fused_fwd_shared"].update(
            ms=f_k, plain_ms=f_pl, work=sweep_work(mg, n, 1, fwd=True))
        self.kernels["fused_bwd_shared"].update(
            ms=b_k, plain_ms=b_pl, work=sweep_work(mg, n, 1, fwd=False))
        self.check("D", True,
                   f"[{self.card}] SH23 fwd sweep (traj) kernel {f_k:.3f} ms vs plain "
                   f"{f_pl:.3f} ms; bwd sweep kernel {b_k:.3f} ms vs plain "
                   f"{b_pl:.3f} ms; fwd+grad unit kernel path {u_k:.3f} ms vs "
                   f"plain f32 path {u_pl:.3f} ms")

    def taylor(self, phase, problem, ref):
        p, x0, _ = cli.make_problem(problem_args(problem, "float64", "matmul"),
                                    x0=[ref["x0_f64"]])
        dx0 = p.generate_ic(seed=43)
        r = adjoint_gradient_test(x0, dx0, p.objective, p.gradient, p.inner_product,
                                  epsilon=1e-4, verbose=False)
        self.check(phase, abs(r.gamma2 - 2.0) <= GAMMA2_TOL,
                   f"Taylor {problem} f64 plain path: gamma1 {r.gamma1:.4f}, "
                   f"gamma2 {r.gamma2:.4f} (tol {GAMMA2_TOL})")

    def phase_e(self):
        self.taylor("E", "sh23", self.ref)

    def workload(self, problem, dtype, method, x0):
        args = problem_args(problem, dtype, method)
        os.makedirs(OUT, exist_ok=True)
        p, x, defaults = cli.make_problem(args, x0=[x0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.optimise(p, x, defaults, args)
        torch.cuda.synchronize()
        return p, res, time.perf_counter() - t0

    def pinned_f64(self, phase, problem, ref):
        pin_fv, pin_k = ref["fv_f64_matmul"], int(ref["iters_f64_matmul"])
        _, res, wall = self.workload(problem, "float64", "matmul", ref["x0_f64"])
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
            lambda: self.workload(problem, "float32", "cuda", ref["x0_f32"]))
        fv = np.asarray(res.function_values)
        x = res.x_opt[0]
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
        self.report_trace(phase, problem, ref)

    def phase_g(self):
        self.f32_workload("G", "sh23", self.ref,
                          ("fused_fwd_shared", "fused_bwd_shared"),
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
        torch.cuda.synchronize()
        fwd_pairs = list(zip(k[:3], r[:3]))
        ser_pairs = list(zip(ks, r))
        e_fwd = max(rel(x, y) for x, y in fwd_pairs)
        e_ser = max(rel(x, y) for x, y in ser_pairs)
        e_bwd = rel(lk, lp)
        self.kernels["fused_fwd"]["max_abs_err"] = max_abs(fwd_pairs)
        self.kernels["fused_fwd_ser"]["max_abs_err"] = max_abs(ser_pairs)
        self.kernels["fused_bwd"]["max_abs_err"] = max_abs([(lk, lp)])
        self.check("H", max(e_fwd, e_ser, e_bwd) <= TOL_VS_PLAIN,
                   f"SHB23 kernel vs plain f32 (mg={a.shape[0]}, N={n}): fwd "
                   f"(u_T, J, traj) rel {e_fwd:.2e}, with series {e_ser:.2e}, bwd "
                   f"rel {e_bwd:.2e}, tol {TOL_VS_PLAIN:g}")
        same = [torch.equal(x, y) for x, y in zip(k[:3], ks[:3])] + [torch.equal(lk, lks)]
        self.check("H", all(same), f"two-matrix series variant bitwise the plain "
                   f"one (u_T, J, traj, lambda): {same}")

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
        self.kernels["fused_fwd_shared_ser"]["max_abs_err"] = max_abs(s_pairs)
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
        self.kernels["fused_fwd"].update(
            ms=f_k, plain_ms=f_pl, work=sweep_work(mg, n, 2, fwd=True))
        self.kernels["fused_fwd_ser"].update(
            ms=fs_k, plain_ms=fs_pl, work=sweep_work(mg, n, 2, fwd=True, ser=True))
        self.kernels["fused_bwd"].update(
            ms=b_k, plain_ms=b_pl, work=sweep_work(mg, n, 2, fwd=False))
        self.kernels["fused_fwd_shared_ser"].update(
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
        self.taylor("J", "shb23", self.refb)

    def phase_k(self):
        self.pinned_f64("K", "shb23", self.refb)

    def phase_l(self):
        self.f32_workload("L", "shb23", self.refb, ("fused_fwd", "fused_bwd"),
                          lambda a, b: abs(a - b) <= FV0_RTOL * abs(b), (5, 50))

    # -- fused diagnostics -------------------------------------------------

    def phase_m(self):
        pairs = ((self.p_cuda, self.x32), (self.pb_cuda, self.xb32))

        def diagnostics():
            return [(p.objective_gradient_and_diagnostics(x),
                     p.objective_and_diagnostics(x)) for p, x in pairs]

        # only the diagnostics calls run in the counted window; the plain
        # objective they are held to runs after it
        outs = self.main_path("M", ("fused_fwd_shared_ser", "fused_fwd_ser",
                                    "fused_bwd_shared", "fused_bwd"), diagnostics,
                              record=("fused_fwd_shared_ser", "fused_fwd_ser"))
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

    def run(self):
        for name in "abcdefghijklm":
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
                name=name, route="cuda", source=fk.KERNEL_SOURCES[name],
                replaces=REPLACES[name], launches=rec["launches"],
                max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                plain_ms=rec["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None))
        return recs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU path here",
              file=sys.stderr)
        return 2
    smoke = Smoke()
    if not smoke.run():
        print("chip_smoke FAILED: " + "; ".join(smoke.failures), file=sys.stderr)
        return 1
    kernels = smoke.kernel_records()
    print(smoke.card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
