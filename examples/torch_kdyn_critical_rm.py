"""Critical magnetic Reynolds number of the optimal kinematic dynamo, on
the PyTorch port.

The port's counterpart of `examples/kdyn_critical_rm.py`: the smallest
Rm at which the OPTIMAL pair (seed field B0, stirring U, both on unit
spheres) amplifies the magnetic energy over the horizon, J_opt(Rm) =
<B_T,B_T> > <B0,B0> = 1 (`FWD_Solve_KDyn.py:7-23`). Each probe is a
complete strong-Wolfe + CG device-loop optimisation; the bracket is
bisected in log2 Rm.

Rm's CNAB1 factors enter as the loop's `aux` operand through
`KinematicDynamo.objective_and_gradient_rm`, so one device loop serves
every probe: on a GPU its steps are captured once as CUDA graphs
(`captures` in the JSON line) and replayed for every Rm. The Rm route
is the plain step at any method, as in the JAX package, so no kernel of
the port runs here. On the CPU the steps run eagerly (`"eager": true`).

Run: python examples/torch_kdyn_critical_rm.py                 # 24^3, 2000 steps
     python examples/torch_kdyn_critical_rm.py --npts 8 --steps 50 --device cpu
The last line of the output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import resource
import sys
import time

# runnable without installing the package: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from spheremanopt_torch.manifold.sphere import sphere_error
from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo
from spheremanopt_torch.utils.profiling import card_name


def main(argv=None, x0=None) -> dict:
    """Run the bisection; `x0` ([B0, U] arrays of the grid's size)
    replaces the torch draw of `generate_ic(seed=42)`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--npts", type=int, default=24)
    ap.add_argument("--dt", type=float, default=5e-4)
    ap.add_argument("--steps", type=int, default=2000,
                    help="time steps (T = steps * dt; ref T=1)")
    ap.add_argument("--iters", type=int, default=10,
                    help="optimisation iterations per probe (ref max_iters)")
    ap.add_argument("--alpha", type=float, default=100.0)
    ap.add_argument("--lo", type=float, default=0.5)
    ap.add_argument("--hi", type=float, default=16.0)
    ap.add_argument("--bisections", type=int, default=8)
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
    dtype = args.dtype or ("float32" if on_gpu else "float64")

    p = KinematicDynamo(KDynConfig(npts=args.npts, n_iters=args.steps, dt=args.dt,
                                   dtype=dtype), device=device)
    fg, make_ops = p.objective_and_gradient_rm
    opt = jit_optimise_on_multi_sphere(
        fg, p.inner_product, [1.0, 1.0], max_iters=args.iters, alpha0=args.alpha,
        cg=True, line_search="wolfe", err_tol=1e-12)
    x0 = (p.generate_ic(seed=42) if x0 is None
          else [torch.as_tensor(np.asarray(x), dtype=p.dtype, device=device) for x in x0])

    history = []

    def j_opt(rm: float) -> float:
        """Best <B_T,B_T> the optimiser reaches at this Rm."""
        t0 = time.perf_counter()
        res = opt(x0, aux=make_ops(rm))
        fv = res.function_values.double().cpu().numpy()
        j = float(np.nanmax(fv))
        k = int(res.iterations)
        history.append({"rm": rm, "J_opt": j, "growth": bool(j > 1.0), "iterations": k,
                        "J_history": fv[:k].tolist(),
                        "sphere_err": sphere_error(res.x_opt, [1.0, 1.0], p.inner_product),
                        "wall_s": time.perf_counter() - t0})
        print(f"  Rm = {rm:8.4f}: J_opt = {j:.6f} "
              f"({'growth' if j > 1.0 else 'decay'}) "
              f"[{history[-1]['wall_s']:.3f} s]", flush=True)
        return j

    print(f"bracketing on [{args.lo}, {args.hi}] "
          f"(grid {args.npts}^3, T = {args.steps * args.dt}, "
          f"{args.iters} Wolfe+CG iterations per probe, {dtype})", flush=True)
    j_lo, j_hi = j_opt(args.lo), j_opt(args.hi)
    # the first probe holds the warm-up and the capture of the steps
    first_probe_s = history[0]["wall_s"]
    if not j_lo < 1.0 < j_hi:
        raise SystemExit(
            f"bracket invalid: J_opt({args.lo}) = {j_lo:.4f}, "
            f"J_opt({args.hi}) = {j_hi:.4f}; need J<1 at lo, J>1 at hi "
            "(widen --lo/--hi or increase --iters)")

    lo, hi = math.log2(args.lo), math.log2(args.hi)
    for _ in range(args.bisections):
        mid = 0.5 * (lo + hi)
        if j_opt(2.0 ** mid) > 1.0:
            hi = mid
        else:
            lo = mid
    rm_c = 2.0 ** (0.5 * (lo + hi))
    err = 2.0 ** hi - 2.0 ** lo

    out = {
        "metric": "critical Rm for optimal transient dynamo amplification",
        "rm_c": rm_c,
        "plus_minus": 0.5 * err,
        "bracket": [2.0 ** lo, 2.0 ** hi],
        "horizon_T": args.steps * args.dt,
        "grid": f"{args.npts}^3",
        "dtype": dtype,
        "opt_iters_per_probe": args.iters,
        "n_probes": len(history),
        "total_wall_s": sum(h["wall_s"] for h in history),
        "first_probe_s": first_probe_s,
        "captures": len(opt.loops),
        "sphere_err": max(h["sphere_err"] for h in history),
        "eager": not on_gpu,
        # peak resident host memory of this process (Linux: KiB)
        "host_max_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
        "probes": history,
        "device": card_name() if on_gpu else "CPU",
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
