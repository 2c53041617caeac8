"""Riemannian trust-region Newton (RTR) against the reference's Wolfe +
CG, on the PyTorch port.

The port's counterpart of `examples/rtr_newton_vs_cg.py`: a complete SH23
optimisation (the `FWD_Solve_SH23.py __main__` config by default;
--npts/--n-iters trim it) under the host CG + strong-Wolfe driver
(`optim/optimiser.py`) and under `optim/rtr.py` `optimise_rtr`, each run
twice (cold, then warm), with the outer iterations, the evaluation
ledger (f, g and Hessian-vector products), the walls and the final J.
RTR's Hessian-vector products are forward over reverse through the
Steihaug-Toint truncated-CG subproblem, so the residual squares per
outer step near the optimum.

Both drivers run the plain `matmul` method (in f32 on a GPU, f64 on the
CPU): the kernels' autograd Functions have no forward-mode rule, as in
the JAX package, whose example runs XLA matmul on the TPU for RTR.

Run: python examples/torch_rtr_newton_vs_cg.py [--npts 256] [--n-iters 1000]
         [--device cpu]
     (small config: --npts 32 --n-iters 50 --max-iters 10)
The last line of the output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

# runnable without installing the package: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from spheremanopt_torch.manifold.sphere import sphere_error
from spheremanopt_torch.optim.optimiser import optimise_on_multi_sphere
from spheremanopt_torch.optim.rtr import optimise_rtr
from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg
from spheremanopt_torch.utils.profiling import card_name


def main(argv=None, x0=None) -> dict:
    """Run both drivers; `x0` (one array of the grid's size) replaces
    the torch draw of `generate_ic(42)`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--npts", type=int, default=256)
    ap.add_argument("--n-iters", type=int, default=1000)
    ap.add_argument("--max-iters", type=int, default=50)
    ap.add_argument("--err-tol", type=float, default=1e-6)
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

    p = SwiftHohenberg(SH23Config(npts=args.npts, n_iters=args.n_iters, dt=0.05,
                                  dtype=dtype, method="matmul"), device=device)
    x0 = (p.generate_ic(42) if x0 is None
          else [torch.as_tensor(np.asarray(x), dtype=p.dtype, device=device) for x in x0])

    def run_cg():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return optimise_on_multi_sphere(
                x0, p.radii, p.objective, p.gradient, p.inner_product,
                err_tol=args.err_tol, max_iters=args.max_iters, alpha_k=float(np.pi),
                line_search="wolfe", method="cg", verbose=False,
                f_and_g=p.objective_and_gradient)

    def run_tr():
        return optimise_rtr(x0, p.radii, p.objective, p.gradient, p.inner_product,
                            err_tol=args.err_tol, max_iters=args.max_iters,
                            verbose=False)

    out = {"npts": args.npts, "n_iters": args.n_iters, "max_iters": args.max_iters,
           "err_tol": args.err_tol, "method": "matmul", "dtype": dtype}
    # cold: the first run (allocations, cuBLAS set-up); warm: the second
    for name, fn in (("cg", run_cg), ("rtr", run_tr)):
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            r = fn()
            if on_gpu:
                torch.cuda.synchronize(device)
            walls.append(time.perf_counter() - t0)
        rec = {"iterations": r.iterations, "function_evals": r.function_evals,
               "gradient_evals": r.gradient_evals, "hvp_evals": r.hvp_evals,
               "cold_s": walls[0], "warm_s": walls[1],
               "J_history": [float(v) for v in r.function_values],
               "residuals": [float(v) for v in r.residuals[0]],
               "converged": bool(r.converged), "message": r.message,
               "sphere_err": sphere_error(r.x_opt, p.radii, p.inner_product)}
        out[name] = rec
        extra = f" hvp={r.hvp_evals:3d}" if name == "rtr" else ""
        print(f"{name:3s}: iters={r.iterations:3d} f={r.function_evals:3d} "
              f"g={r.gradient_evals:3d}{extra} cold={walls[0]:7.3f}s "
              f"warm={walls[1]:7.3f}s J={r.function_values[-1]:.8f} "
              f"conv={r.converged}", flush=True)
        if name == "rtr":
            if not r.converged:
                print(f"rtr stop: {r.message}")
            tail = np.asarray(r.residuals[0])[-4:]
            rec["residual_tail"] = tail.tolist()
            print("rtr residual tail:", " -> ".join(f"{v:.2e}" for v in tail), flush=True)
    out["device"] = card_name() if on_gpu else "CPU"
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
