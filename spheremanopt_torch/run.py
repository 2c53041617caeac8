"""Command line of the port: the `sh23`, `shb23`, `kdyn` and `pca` subset
of the JAX package's `run.py`.

    python -m spheremanopt_torch.run sh23 --device cuda --method cuda --dtype float32
    python -m spheremanopt_torch.run sh23 --device cuda --dtype float64
    python -m spheremanopt_torch.run sh23 --test-grad      # Taylor test only
    python -m spheremanopt_torch.run sh23 --direction lbfgs --lbfgs-memory 8
    python -m spheremanopt_torch.run sh23 --dtype float64 --adjoint continuous
    python -m spheremanopt_torch.run shb23                 # kernels, f32, on a GPU
    python -m spheremanopt_torch.run shb23 --dtype float64 --adjoint continuous
    python -m spheremanopt_torch.run kdyn --cost Final     # kernels, f32, on a GPU
    python -m spheremanopt_torch.run kdyn --dtype float64 --n-iters 200
    python -m spheremanopt_torch.run pca --dim 100
    python -m spheremanopt_torch.run sh23 --device-loop    # the loop on CUDA graphs
    python -m spheremanopt_torch.run sh23 --direction rtr [--device-loop]

`--device` defaults to `cuda` and fails when no GPU is found; it never
drops to the CPU on its own (`--device cpu` asks for it). On CUDA the
SH23, SHB23 and KDyn default is the hand-written kernel path (`--method
cuda`, f32), as the JAX CLI defaults to its Pallas kernels on a TPU for
SH23 and SHB23. (For KDyn the JAX CLI defaults to `xla`, only because its
Pallas kernel took a quarter of an hour to compile there; the CUDA
kernels build in seconds.) TF32 is off: f32 matmuls run in full f32.

`--device-loop` runs the SD/CG/L-BFGS loop with its line search on the
device (`optim/jit_driver.py`, on CUDA graphs on a GPU); with
`--direction rtr`, the trust-region loop (`optim/jit_rtr.py`). Trust-region
Newton needs forward-mode derivatives of the gradient, which the CUDA
kernels' autograd Functions do not have: with `--direction rtr` a
`--method cuda` (given or the GPU default) becomes the same
discretisation's plain method (`matmul` for sh23 and shb23, `plain` for
kdyn), with a printed notice, as the JAX CLI substitutes its XLA path for
its Pallas kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from spheremanopt_torch.convert import state_to_torch
from spheremanopt_torch.problems.base import DTYPES

_METHODS = {"sh23": ("matmul", "fft", "cuda"), "shb23": ("matmul", "cuda"),
            "kdyn": ("plain", "cuda")}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="spheremanopt_torch.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("problem", choices=["sh23", "shb23", "kdyn", "pca"])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out-dir", default="runs/latest")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="default: float32 for --method cuda, else float64")
    ap.add_argument("--method", default=None,
                    choices=sorted({m for ms in _METHODS.values() for m in ms}),
                    help="step method (sh23: matmul|fft|cuda, shb23: "
                         "matmul|cuda, kdyn: plain|cuda; default: cuda on a "
                         "GPU in f32, else matmul, or plain for kdyn)")
    ap.add_argument("--cost", choices=["Final", "Integrated"], default="Final",
                    help="kdyn cost functional")
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--err-tol", type=float, default=None)
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--ls", choices=["wolfe", "armijo"], default="wolfe")
    ap.add_argument("--sd", action="store_true", help="steepest descent (no CG)")
    ap.add_argument("--direction", choices=["sd", "cg", "lbfgs", "rtr"],
                    default=None,
                    help="search direction (default: cg, or sd with --sd; "
                         "lbfgs = Riemannian L-BFGS and rtr = trust-region "
                         "Newton with forward-over-reverse Hessian-vector "
                         "products, both beyond the reference)")
    ap.add_argument("--lbfgs-memory", type=int, default=8,
                    help="curvature-pair history length for --direction lbfgs")
    ap.add_argument("--tr-delta0", type=float, default=None,
                    help="rtr: initial trust radius (default: sphere "
                         "scale / 4)")
    ap.add_argument("--tr-max-cg", type=int, default=50,
                    help="rtr: cap on truncated-CG iterations per "
                         "subproblem")
    ap.add_argument("--device-loop", action="store_true",
                    help="run the optimisation loop on the device "
                         "(optim.jit_driver / optim.jit_rtr: CUDA graphs on "
                         "a GPU, one flag read per step)")
    ap.add_argument("--test-grad", action="store_true", help="Taylor test, then exit")
    ap.add_argument("--test-grad-eps", type=float, default=1e-4)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--adjoint", choices=["discrete", "continuous"],
                    default="discrete")
    ap.add_argument("--diag-stride", type=int, default=None,
                    help="energy-series cadence of the fused diagnostics "
                         "(sh23/shb23; any >= 1)")
    ap.add_argument("--npts", type=int, default=None,
                    help="sh23 Fourier modes / shb23 grid points / kdyn "
                         "modes per axis")
    ap.add_argument("--n-iters", type=int, default=None, help="time steps")
    ap.add_argument("--dt", type=float, default=None, help="time step")
    ap.add_argument("--dim", type=int, default=100, help="PCA dimension")
    return ap


def set_precision() -> None:
    """Full-f32 matmuls and convolutions (no TF32), as every parity check
    against the JAX package assumes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_problem(args, x0=None):
    """(problem, x0, defaults) for the parsed `args`. `x0` (a list of
    arrays, e.g. pinned inputs) replaces the seeded initial condition."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA GPU found (use --device cpu "
                         "to run on the CPU)")
    set_precision()
    device = torch.device(args.device)
    if args.problem == "pca":
        from spheremanopt_torch.problems.pca import PCAProblem, random_spd_matrix

        dtype = DTYPES[args.dtype or "float64"]
        p = PCAProblem(random_spd_matrix(args.dim, seed=args.seed),
                       device=device, dtype=dtype)
        if x0 is None:
            x0 = [np.random.RandomState(args.seed).rand(args.dim)]
        return p, state_to_torch(x0, device, dtype), dict(alpha=1.0, max_iters=2000)

    method = args.method
    if method is None:
        method = "cuda" if (args.device == "cuda"
                            and args.dtype in (None, "float32")) \
            else _METHODS[args.problem][0]
    if method not in _METHODS[args.problem]:
        raise SystemExit(f"--method {method}: {args.problem} takes "
                         f"{'|'.join(_METHODS[args.problem])}")
    dtype = args.dtype or ("float32" if method == "cuda" else "float64")
    if args.direction == "rtr" and method == "cuda":
        # RTR's Hessian-vector products are forward over reverse; the
        # kernels' autograd Functions define reverse rules only, so the
        # same discretisation's plain method serves the trust-region path
        method = _METHODS[args.problem][0]
        print(f"[{args.problem}] --direction rtr: the CUDA kernels define "
              "reverse (autograd.Function) rules only - substituting the "
              f"equivalent method={method!r} plain objective for the "
              "HVP-linearizable trust-region path (same discretisation)",
              flush=True)
    kw = dict(dtype=dtype, method=method)
    for name, val in (("npts", args.npts), ("n_iters", args.n_iters),
                      ("dt", args.dt)):
        if val is not None:
            kw[name] = val
    if args.problem == "kdyn":
        from spheremanopt_torch.problems.kinematic_dynamo import (
            KDynConfig, KinematicDynamo)

        if args.adjoint != "discrete":
            raise SystemExit("--adjoint continuous: not ported for kdyn")
        p = KinematicDynamo(KDynConfig(cost=args.cost, **kw), device=device)
        x0 = (p.generate_ic(seed=args.seed) if x0 is None
              else state_to_torch(x0, device, p.dtype))
        return p, x0, dict(alpha=100.0, max_iters=10)
    kw["adjoint"] = args.adjoint
    if args.diag_stride is not None:
        kw["diag_stride"] = args.diag_stride
    if args.problem == "shb23":
        from spheremanopt_torch.problems.swift_hohenberg_bounded import (
            SHB23Config, SwiftHohenbergBounded)

        p = SwiftHohenbergBounded(SHB23Config(**kw), device=device)
        defaults = dict(alpha=1.0, max_iters=50, err_tol=1e-5)
    else:
        from spheremanopt_torch.problems.swift_hohenberg import (
            SH23Config, SwiftHohenberg)

        p = SwiftHohenberg(SH23Config(**kw), device=device)
        defaults = dict(alpha=np.pi, max_iters=200)
    x0 = (p.generate_ic(seed=args.seed) if x0 is None
          else state_to_torch(x0, device, p.dtype))
    return p, x0, defaults


def _settings(defaults, args):
    """(err_tol, max_iters, alpha0): the CLI's values, else the problem's
    defaults."""
    return (args.err_tol if args.err_tol is not None
            else defaults.get("err_tol", 1e-6),
            args.max_iters if args.max_iters is not None
            else defaults["max_iters"],
            args.alpha if args.alpha is not None else defaults["alpha"])


def device_optimiser(problem, defaults, args, graphs=None):
    """The device loop's `optimise(x0_list)` for the parsed `args`:
    `jit_optimise_rtr` for `--direction rtr`, else
    `jit_optimise_on_multi_sphere`. Its CUDA graphs are captured at its
    first call and replayed at later calls. `graphs=False` runs the same
    steps eagerly (to hold the graphs against)."""
    radii = problem.radii if hasattr(problem, "radii") else [1.0]
    err_tol, max_iters, alpha = _settings(defaults, args)
    if args.direction == "rtr":
        from spheremanopt_torch.optim.jit_rtr import jit_optimise_rtr

        return jit_optimise_rtr(
            problem.objective, problem.gradient, problem.inner_product,
            radii, max_iters=max_iters, err_tol=err_tol,
            delta0=args.tr_delta0, max_cg=args.tr_max_cg, graphs=graphs)
    if args.direction == "lbfgs" and args.ls != "wolfe":
        raise SystemExit("--direction lbfgs needs --ls wolfe in the device "
                         "loop")
    from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere

    f_and_g = getattr(problem, "objective_and_gradient", None)
    if f_and_g is None:
        def f_and_g(xs):
            return problem.objective(xs), problem.gradient(xs)
    return jit_optimise_on_multi_sphere(
        f_and_g, problem.inner_product, radii, max_iters=max_iters,
        alpha0=float(alpha), err_tol=err_tol, cg=not args.sd,
        line_search=args.ls, direction=args.direction,
        lbfgs_memory=args.lbfgs_memory, f=problem.objective, graphs=graphs)


def optimise(problem, x0, defaults, args, graphs=None):
    """The optimisation exactly as `main` runs it: the host loop, or with
    `--device-loop` the device loop (a `JitOptResult`, or a
    `JitRTRResult` for `--direction rtr`; `graphs` as in
    `device_optimiser`)."""
    radii = problem.radii if hasattr(problem, "radii") else [1.0]
    err_tol, max_iters, alpha = _settings(defaults, args)
    if args.device_loop:
        return device_optimiser(problem, defaults, args, graphs)(x0)
    if args.direction == "rtr":
        from spheremanopt_torch.optim.rtr import optimise_rtr

        # trust-region Newton: no line search (--ls/--alpha unused)
        return optimise_rtr(
            x0, radii, problem.objective, problem.gradient,
            problem.inner_product, err_tol=err_tol, max_iters=max_iters,
            delta0=args.tr_delta0, max_cg=args.tr_max_cg,
            verbose=not args.quiet,
            log_path=os.path.join(args.out_dir, "optimize_result.txt"))

    from spheremanopt_torch.optim.optimiser import optimise_on_multi_sphere

    return optimise_on_multi_sphere(
        x0,
        radii,
        problem.objective,
        problem.gradient,
        problem.inner_product,
        err_tol=err_tol,
        max_iters=max_iters,
        alpha_k=alpha,
        line_search=args.ls,
        cg=not args.sd,
        method=args.direction,
        lbfgs_memory=args.lbfgs_memory,
        verbose=not args.quiet,
        log_path=os.path.join(args.out_dir, "optimize_result.txt"),
        f_and_g=getattr(problem, "objective_and_gradient", None),
    )


def taylor_test(problem, x0, args):
    from spheremanopt_torch.grad.testgrad import adjoint_gradient_test

    if args.problem == "pca":
        dx0 = [torch.as_tensor(np.random.RandomState(args.seed + 1).rand(args.dim),
                               dtype=x0[0].dtype, device=x0[0].device)]
    else:
        dx0 = problem.generate_ic(seed=args.seed + 1)
    return adjoint_gradient_test(
        x0, dx0, problem.objective, problem.gradient, problem.inner_product,
        epsilon=args.test_grad_eps, verbose=not args.quiet,
        save_path=os.path.join(args.out_dir, "eps_TestR_TestR2_h_h2.npy"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()
    problem, x0, defaults = make_problem(args)
    print(f"[{args.problem}] setup {time.time()-t0:.1f}s on {args.device}"
          + (f" ({torch.cuda.get_device_name(0)})" if args.device == "cuda" else ""))

    if args.test_grad:
        r = taylor_test(problem, x0, args)
        ok = abs(r.gamma2 - 2.0) < 0.05 or (abs(r.gamma1 - 1.0) < 0.1
                                             and abs(r.gamma2 - 2.0) < 0.1)
        print(f"gradient test {'PASSED' if ok else 'FAILED'}")
        return 0 if ok else 1

    if args.device_loop:
        t0 = time.perf_counter()
        r = optimise(problem, x0, defaults, args)
        k = int(r.iterations)
        summary = {
            "problem": args.problem,
            "device": args.device,
            "driver": ("device-resident (CUDA graphs)" if args.device == "cuda"
                       else "device-resident (eager steps)"),
            "iterations": k,
            # k == 0: history slot 0 holds its zero fill, not a result
            "J_final": float(r.function_values[k - 1]) if k > 0 else None,
            "residuals_final": (r.residuals[k - 1].tolist() if k > 0
                                else None),
            "wall_time_total_s": round(time.perf_counter() - t0, 3),
        }
        if hasattr(r, "converged"):   # JitRTRResult extras
            summary["converged"] = bool(r.converged)
            summary["trust_region_trials"] = int(r.trials)
            summary["hvp_evals"] = int(r.hvp_evals)
        with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        print(json.dumps(summary))
        return 0

    res = optimise(problem, x0, defaults, args)
    summary = {
        "problem": args.problem,
        "device": args.device,
        "config": (dict(problem.cfg.__dict__) if hasattr(problem, "cfg")
                   else {"dim": args.dim}),
        "iterations": res.iterations,
        "converged": res.converged,
        "message": res.message,
        "J_final": res.function_values[-1] if res.function_values else None,
        "residuals_final": [r[-1] for r in res.residuals if r],
        "wall_time_total_s": round(sum(res.wall_times), 3),
    }
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
