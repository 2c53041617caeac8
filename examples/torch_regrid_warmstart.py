"""Measured value of resolution continuation (`utils/regrid.py`) on SH23,
on the PyTorch port.

The port's counterpart of `examples/regrid_warmstart.py`. All three
studies run on the device loop (strong Wolfe + CG, alpha0 = pi):
  1. COLD fine study: `--fine` modes from the seeded initial condition;
  2. coarse study: the SAME physical problem at `--coarse` modes from its
     own seeded initial condition;
  3. WARM fine study: the coarse optimum regridded onto the fine grid
     (`regrid_state`: spectral zero-pad + sphere renormalisation), then
     the fine study from it.
Reported: the J histories, the warm run's starting J against the cold
run's, and the first iteration at which each run reaches the cold run's
final J within `rel_tol`: the saving the reference cannot realise (its
restart needs the identical resolution, `FWD_Solve_SH23.py:787-800`).

On a GPU the studies run the f32 kernels (`method="cuda"`:
`csrc/fused_shared.cu`'s forward and reverse sweeps, at both widths); on
the CPU the f64 `matmul` method. The JAX example's `SMO_WS_*`
environment variables are the flags `--fine`, `--coarse`, `--n-steps`
and `--max-iters` here.

Run: python examples/torch_regrid_warmstart.py [--device cpu]
     (small config: --fine 64 --coarse 32 --max-iters 20)
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
from spheremanopt_torch.utils.regrid import regrid_state

DT, E0 = 0.05, 0.0725
REL_TOL = 1e-3


def iters_to(jf, target):
    hit = np.nonzero(jf >= target)[0]
    return int(hit[0]) + 1 if hit.size else None


def main(argv=None, x0=None, out=None) -> dict:
    """Run the three studies. `x0` ({"fine": [...], "coarse": [...]})
    replaces the torch draws of `generate_ic(seed=42)` at each width;
    `out` (a dict), when given, receives the coarse optimum and the
    regridded warm state as numpy arrays."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fine", type=int, default=256, help="fine grid's modes")
    ap.add_argument("--coarse", type=int, default=128, help="coarse grid's modes")
    ap.add_argument("--n-steps", type=int, default=50, help="SBDF1 steps of a solve")
    ap.add_argument("--max-iters", type=int, default=200)
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

    def make(npts):
        p = SwiftHohenberg(SH23Config(npts=npts, n_iters=args.n_steps, dt=DT, e0=E0,
                                      dtype=dtype, method=method), device=device)
        opt = jit_optimise_on_multi_sphere(
            p.objective_and_gradient, p.inner_product, p.radii,
            max_iters=args.max_iters, alpha0=float(np.pi), cg=True, line_search="wolfe")
        return p, opt

    def run(p, opt, x):
        t0 = time.perf_counter()
        r = opt([torch.as_tensor(np.asarray(a), dtype=p.dtype, device=device) for a in x])
        k = int(r.iterations)
        jf = r.function_values.double().cpu().numpy()[:k]
        wall = time.perf_counter() - t0
        spheres.append(sphere_error(r.x_opt, p.radii, p.inner_product))
        return jf, [a.cpu().numpy() for a in r.x_opt], wall

    x0, spheres = x0 or {}, []
    p_f, opt_f = make(args.fine)
    p_c, opt_c = make(args.coarse)

    # cold fine study (the first call warms up and captures; timed warm)
    x0_f = x0.get("fine") or [a.cpu() for a in p_f.generate_ic(seed=42)]
    run(p_f, opt_f, x0_f)
    j_cold, _, w_cold = run(p_f, opt_f, x0_f)

    x0_c = x0.get("coarse") or [a.cpu() for a in p_c.generate_ic(seed=42)]
    run(p_c, opt_c, x0_c)
    j_coarse, x_coarse, w_coarse = run(p_c, opt_c, x0_c)

    x_warm = regrid_state(p_f, x_coarse)
    j_warm, _, w_warm = run(p_f, opt_f, x_warm)
    if out is not None:
        out.update(x_coarse=x_coarse, x_warm=x_warm)

    target = float(j_cold[-1]) * (1.0 - REL_TOL)
    res = {
        "cold": {"iters": len(j_cold), "J_final": float(j_cold[-1]),
                 "J_start": float(j_cold[0]), "wall_s": w_cold,
                 "iters_to_target": iters_to(j_cold, target), "J_history": j_cold.tolist()},
        "coarse": {"iters": len(j_coarse), "J_final": float(j_coarse[-1]),
                   "wall_s": w_coarse, "J_history": j_coarse.tolist()},
        "warm": {"iters": len(j_warm), "J_final": float(j_warm[-1]),
                 "J_start": float(j_warm[0]), "wall_s": w_warm,
                 "iters_to_target": iters_to(j_warm, target), "J_history": j_warm.tolist()},
        "target_J": target,
        "rel_tol": REL_TOL,
        "config": {"fine": args.fine, "coarse": args.coarse, "n_steps": args.n_steps,
                   "max_iters": args.max_iters, "method": method, "dtype": dtype},
        "captures": len(opt_f.loops) + len(opt_c.loops),
        "sphere_err": max(spheres),
        "device": card_name() if on_gpu else "CPU",
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
