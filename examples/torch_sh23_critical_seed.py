"""Minimal-seed critical energy for Swift-Hohenberg by bisection, on the
PyTorch port.

The port's counterpart of `examples/sh23_critical_seed.py`: the smallest
initial energy E0 whose OPTIMAL seed still triggers the nonlinear
patterned state (arXiv:2210.17194). At each probe E0 a complete
device-loop optimisation (Armijo backtracking + hybrid CG, alpha0 = pi)
maximises J(u0) on the sphere <u0,u0> = E0; the seed "triggers" iff the
optimised J exceeds a threshold far above the decaying branch, and the
bracket [lo, hi] is bisected on that decision.

The radius enters the loop as `radii_dyn`, so one device loop serves
every probe: on a GPU its steps are captured once as CUDA graphs and
replayed for every E0 (`captures` in the JSON line). On a GPU the SH23
unit runs the f32 kernels (`method="cuda"`: the forward and reverse
sweeps of `csrc/fused_shared.cu`); on the CPU the f64 `matmul` method.

Run: python examples/torch_sh23_critical_seed.py [--npts 256] [--t-final 50]
         [--bisections 8] [--device cpu]
     (small config: --npts 48 --t-final 10 --bisections 3 --max-iters 20)
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
from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg
from spheremanopt_torch.utils.profiling import card_name


def main(argv=None, x0=None) -> dict:
    """Run the bisection; `x0` (one array of the grid's size on the unit
    sphere, as `generate_ic(seed=42, e0=1.0)` gives) replaces the torch
    draw."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--npts", type=int, default=256)
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--t-final", type=float, default=50.0)
    ap.add_argument("--bisections", type=int, default=8)
    ap.add_argument("--max-iters", type=int, default=60)
    ap.add_argument("--lo", type=float, default=0.005)
    ap.add_argument("--hi", type=float, default=0.08)
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
    method = "cuda" if on_gpu else "matmul"
    dtype = args.dtype or ("float32" if on_gpu else "float64")
    n_iters = int(round(args.t_final / args.dt))

    # one problem; the sphere radius enters only through the optimiser
    p = SwiftHohenberg(SH23Config(npts=args.npts, dt=args.dt, n_iters=n_iters,
                                  dtype=dtype, method=method), device=device)
    x0 = (p.generate_ic(seed=42, e0=1.0) if x0 is None
          else [torch.as_tensor(np.asarray(x), dtype=p.dtype, device=device) for x in x0])

    # decay-branch scale: J of a tiny seed (pure linear decay) sets the
    # "did not trigger" baseline; triggering exceeds it by orders
    j_tiny = -float(p.objective([x0[0] * np.sqrt(1e-8)]))

    # ONE device loop with the radius as a per-call operand
    opt = jit_optimise_on_multi_sphere(
        p.objective_and_gradient, p.inner_product, [1.0],
        max_iters=args.max_iters, alpha0=float(np.pi), cg=True, f=p.objective)

    spheres = []

    def optimal_J(e0: float) -> tuple:
        r = opt(x0, radii_dyn=[e0])
        k = int(r.iterations)
        fv = r.function_values.double().cpu().numpy()
        spheres.append(sphere_error(r.x_opt, [e0], p.inner_product))
        return float(fv[max(k - 1, 0)]), k, fv[:k].tolist()

    t0 = time.perf_counter()
    (j_lo, k_lo, h_lo), (j_hi, k_hi, h_hi) = optimal_J(args.lo), optimal_J(args.hi)
    # threshold: an order above the larger of the decay-scale J and J_opt(lo)
    threshold = 10.0 * max(j_lo, j_tiny * (args.lo / 1e-8))
    print(f"J_opt({args.lo}) = {j_lo:.4f}  J_opt({args.hi}) = {j_hi:.4f}  "
          f"threshold = {threshold:.4f}", flush=True)
    if not j_hi > threshold > j_lo:
        raise SystemExit("bracket does not straddle the transition; widen [lo, hi]")

    lo, hi = args.lo, args.hi
    history = []
    for i in range(args.bisections):
        mid = 0.5 * (lo + hi)
        j_mid, k, hist = optimal_J(mid)
        triggered = j_mid > threshold
        history.append({"E0": mid, "J_opt": j_mid, "triggered": bool(triggered),
                        "iterations": k, "J_history": hist})
        print(f"  bisect {i + 1}: E0={mid:.6f}  J_opt={j_mid:.4f}  "
              f"{'TRIGGERED' if triggered else 'decayed'}", flush=True)
        if triggered:
            hi = mid
        else:
            lo = mid
    if on_gpu:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    result = {
        "critical_seed_energy": 0.5 * (lo + hi),
        "bracket": [lo, hi],
        "ends": [{"E0": args.lo, "J_opt": j_lo, "iterations": k_lo, "J_history": h_lo},
                 {"E0": args.hi, "J_opt": j_hi, "iterations": k_hi, "J_history": h_hi}],
        "threshold": threshold,
        "j_tiny": j_tiny,
        "bisections": history,
        "wall_time_s": wall,
        "captures": len(opt.loops),
        "sphere_err": max(spheres),
        "config": {"npts": args.npts, "dt": args.dt, "T": args.t_final,
                   "n_steps": n_iters, "max_iters_per_optim": args.max_iters,
                   "method": method, "dtype": dtype},
        "device": card_name() if on_gpu else "CPU",
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
