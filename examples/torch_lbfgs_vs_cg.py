"""Riemannian L-BFGS against the reference's Wolfe + CG on complete
workloads, on the PyTorch port.

The port's counterpart of `examples/lbfgs_vs_cg.py`: the SH23 reference
optimisation (N = 256, T = 50, the `FWD_Solve_SH23.py __main__` config,
200 iterations at most) or the KDyn two-sphere workload (24^3, 2000
steps, 10 iterations, `FWD_Solve_KDyn.py:1028-1036`), each under both
search directions on the device loop, with a first call (on a GPU: the
warm-up and the capture of the steps as CUDA graphs) and then a steady
call. L-BFGS is beyond the reference (`Sphere_Grad_Descent.py` has SD
and hybrid FR-PR CG only).

On a GPU both problems run the f32 kernels (`method="cuda"`: SH23's
forward and reverse sweeps, `csrc/fused_shared.cu`; KDyn's forward with
the trajectory and its reverse, `csrc/kdyn_step.cu`); on the CPU the f64
plain methods.

Run: python examples/torch_lbfgs_vs_cg.py [sh23|kdyn] [--device cpu]
     (small config: sh23 --npts 32 --steps 50 --max-iters 10;
      kdyn --npts 8 --steps 20 --max-iters 3)
The last line of the output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# runnable without installing the package: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from spheremanopt_torch.manifold.sphere import sphere_error
from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
from spheremanopt_torch.utils.profiling import card_name

# the JAX example's workloads: (npts, steps, dt, max_iters, alpha0)
DEFAULTS = {"sh23": (256, 1000, 0.05, 200, float(np.pi)),
            "kdyn": (24, 2000, 5e-4, 10, 100.0)}


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def steady(opt, x0, device):
    """A first call (on a GPU with the warm-up and capture), then the
    steady call that is timed."""
    t0 = time.perf_counter()
    r = opt(x0)
    int(r.iterations)   # the value pull waits for the loop
    first = time.perf_counter() - t0
    sync(device)
    t0 = time.perf_counter()
    r = opt(x0)
    k = int(r.iterations)
    return r, k, first, time.perf_counter() - t0


def make_problem(which, npts, steps, dt, dtype, method, device):
    if which == "sh23":
        from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg

        return SwiftHohenberg(SH23Config(npts=npts, n_iters=steps, dt=dt, dtype=dtype,
                                         method=method), device=device)
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    return KinematicDynamo(KDynConfig(npts=npts, n_iters=steps, dt=dt, dtype=dtype,
                                      method=method), device=device)


def main(argv=None, x0=None) -> dict:
    """Run both directions; `x0` (the problem's state list) replaces the
    torch draw of `generate_ic(42)`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("problem", nargs="?", choices=sorted(DEFAULTS), default="sh23")
    ap.add_argument("--npts", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="default: float32 on a GPU, float64 on the CPU")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    on_gpu = device.type == "cuda"
    if on_gpu:
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA GPU found (use --device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False
    npts, steps, dt, max_iters, alpha0 = DEFAULTS[args.problem]
    npts = args.npts or npts
    steps = args.steps or steps
    max_iters = args.max_iters or max_iters
    method = "cuda" if on_gpu else {"sh23": "matmul", "kdyn": "plain"}[args.problem]
    dtype = args.dtype or ("float32" if on_gpu else "float64")

    p = make_problem(args.problem, npts, steps, dt, dtype, method, device)
    x0 = (p.generate_ic(42) if x0 is None
          else [torch.as_tensor(np.asarray(x), dtype=p.dtype, device=device) for x in x0])
    runs = {}
    for direction in ("cg", "lbfgs"):
        opt = jit_optimise_on_multi_sphere(
            p.objective_and_gradient, p.inner_product, p.radii, max_iters=max_iters,
            alpha0=alpha0, line_search="wolfe", direction=direction)
        r, k, first, dt_s = steady(opt, x0, device)
        fv = r.function_values.double().cpu().numpy()[:k]
        runs[direction] = {"iterations": k, "J_final": float(fv[-1]) if k else None,
                           "J_history": fv.tolist(), "first_s": first, "steady_s": dt_s,
                           "captures": len(opt.loops),
                           "sphere_err": sphere_error(r.x_opt, p.radii, p.inner_product)}
        print(f"{args.problem:5s} {direction:5s}: iters={k:3d} steady={dt_s:7.3f}s "
              f"J={runs[direction]['J_final']:.6f}", flush=True)
    out = {"problem": args.problem, "npts": npts, "steps": steps, "max_iters": max_iters,
           "method": method, "dtype": dtype, **runs,
           "device": card_name() if on_gpu else "CPU"}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
