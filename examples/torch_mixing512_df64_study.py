"""512x256 optimal-mixing study with df64 solves, on the PyTorch port.

The port's counterpart of `examples/mixing512_df64_study.py`: the mixing
problem (s = 1: minimise the mix-norm) at double the reference
resolution, 1000 steps, E0 = 0.02, through the host loop (strong Wolfe +
hybrid CG, alpha0 = 100) with J from `objective_f64` and a line per
iteration.

The JAX package needs its f64-emulating double-float machinery here
because the TPU's f32 gradient cannot bracket past iteration 2 at this
resolution. The H100 has native f64: `solve_precision="df64"` of an f32
config runs the solves and their reverse sweep in float64 from the f32
state (the TPU's `--n-bits` has no counterpart and is not a flag here).
`--df-adjoint` is kept; the f64 reverse sweep is already of the class the
JAX package's double-float adjoint lifts its gradient to, so it runs the
same sweep. On the CPU the config is float64, where df64 is that solve.

The one-time cost is the f64 operator assembly at 512x256 (the tau
stacks, cached on disk in `build/op_cache`, `SMO_OP_CACHE`); the JSON
line reports it as `build_s`.

Run: python examples/torch_mixing512_df64_study.py [--device cpu]
     (small config: --small, 64x32; --n-iters cuts the 1000 steps)
The last line of the output is one JSON object; the histories are also
written to `--out`.
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
from spheremanopt_torch.optim.optimiser import optimise_on_multi_sphere
from spheremanopt_torch.problems.optimal_mixing import MixingConfig, OptimalMixing
from spheremanopt_torch.utils.profiling import card_name


def main(argv=None, x0=None) -> dict:
    """Run the study; `x0` (the problem's state list) replaces the torch
    draw of `generate_ic(seed=42)`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="64x32 wiring check instead of the full study")
    ap.add_argument("--max-iters", type=int, default=10)
    ap.add_argument("--n-iters", type=int, default=1000, help="time steps of a solve")
    ap.add_argument("--df-adjoint", action="store_true",
                    help="the JAX package's double-float adjoint; here the same "
                         "f64 reverse sweep")
    ap.add_argument("--out", default="runs/mixing512_df64_study.npz")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="default: float32 (df64 solves) on a GPU, float64 on the CPU")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    on_gpu = device.type == "cuda"
    if on_gpu:
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA GPU found (use --device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False
    dtype = args.dtype or ("float32" if on_gpu else "float64")
    df64 = dtype == "float32"

    nx, nz = (64, 32) if args.small else (512, 256)
    t0 = time.perf_counter()
    p = OptimalMixing(MixingConfig(
        nx=nx, nz=nz, dt=5e-3, n_iters=args.n_iters, s=1, dtype=dtype,
        solve_precision="df64" if df64 else "native",
        df_adjoint=args.df_adjoint and df64), device=device)
    build_s = time.perf_counter() - t0
    print(f"problem built: {build_s:.1f}s", flush=True)
    x0 = (p.generate_ic(seed=42) if x0 is None
          else [torch.as_tensor(np.asarray(x), dtype=p.dtype, device=device) for x in x0])

    def cb(k, result):
        print(f"iter {k}: mix-norm={-result.function_values[-1]:.8f} "
              f"alpha={result.step_sizes[-1]:.4g}", flush=True)

    t0 = time.perf_counter()
    res = optimise_on_multi_sphere(
        x0, p.radii, p.objective_f64 if df64 else p.objective, p.gradient,
        p.inner_products, max_iters=args.max_iters, alpha_k=100.0, line_search="wolfe",
        cg=True, f_and_g=p.objective_and_gradient, callback=cb, verbose=False)
    wall = time.perf_counter() - t0
    print(f"{res.iterations} iterations in {wall:.1f}s; mix-norm "
          f"{-res.function_values[0]:.6f} -> {-res.function_values[-1]:.6f}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        np.savez(args.out, function_values=np.asarray(res.function_values),
                 step_sizes=np.asarray(res.step_sizes), iterations=res.iterations)
    out = {"nx": nx, "nz": nz, "n_iters": args.n_iters, "dtype": dtype,
           "solve_precision": p.cfg.solve_precision, "df_adjoint": p.cfg.df_adjoint,
           "iterations": res.iterations, "function_evals": res.function_evals,
           "gradient_evals": res.gradient_evals,
           "function_values": [float(v) for v in res.function_values],
           "mixnorm": [-float(v) for v in res.function_values],
           "step_sizes": [float(v) for v in res.step_sizes],
           "sphere_err": sphere_error(res.x_opt, p.radii, p.inner_product),
           "build_s": build_s, "wall_s": wall,
           "device": card_name() if on_gpu else "CPU"}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
