"""Coarse -> fine mixing study by spectral resolution continuation, on the
PyTorch port.

The port's counterpart of `examples/mixing_regrid_continuation.py`: run
the reference-resolution 256x128 mixing study (s = 1: minimise the
mix-norm), re-express its optimum on the 512x256 grid (`regrid_state`:
rfft pad in x, Chebyshev coefficient pad in z, sphere renormalisation)
and continue the fine study warm. Both studies run the host loop (strong
Wolfe + hybrid CG, alpha0 = 100) with J from `objective_f64`.

On a GPU the problems are f32 configs with `solve_precision="df64"`,
which the port runs as float64 solves (the TPU's double-float machinery
and its `--n-bits` have no counterpart); on the CPU they are float64
configs, where df64 is the same solve.

The JAX example compares the warm fine study with a cold one stored in
`runs/r4_mixing512_df64_nb32_postfix.npz`. That file is not in the
repository, so this example leaves that comparison out: its JSON says
`"cold_fine_reference": null`.

Run: python examples/torch_mixing_regrid_continuation.py [--device cpu]
     (small config: --small, 64x32 -> 128x64 at 100 steps; --n-steps
      and the iteration flags cut it further)
The last line of the output is one JSON object; it is also written to
`--out`.
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
from spheremanopt_torch.utils.regrid import regrid_state


def objective_host(p):
    """J for the host loop's comparisons: the f64 solve's J as a float
    (`objective_f64`) for a df64 config, else `objective`."""
    return p.objective_f64 if p.cfg.solve_precision == "df64" else p.objective


def study(p, x0, max_iters, label):
    def cb(k, result):
        print(f"[{label}] iter {k}: mix-norm={-result.function_values[-1]:.8f} "
              f"alpha={result.step_sizes[-1]:.4g}", flush=True)

    t0 = time.perf_counter()
    res = optimise_on_multi_sphere(
        x0, p.radii, objective_host(p), p.gradient, p.inner_products,
        max_iters=max_iters, alpha_k=100.0, line_search="wolfe", cg=True,
        f_and_g=p.objective_and_gradient, callback=cb, verbose=False)
    wall = time.perf_counter() - t0
    print(f"[{label}] {res.iterations} iterations in {wall:.1f}s; mix-norm "
          f"{-res.function_values[0]:.6f} -> {-res.function_values[-1]:.6f}", flush=True)
    return res, wall, [x.detach().cpu().numpy() for x in res.x_opt], \
        sphere_error(res.x_opt, p.radii, p.inner_product)


def main(argv=None, x0=None, out=None) -> dict:
    """Run the continuation; `x0` (the coarse problem's state list)
    replaces the torch draw of `generate_ic(seed=42)`; `out` (a dict),
    when given, receives the regridded warm state as numpy arrays."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="64x32 -> 128x64 wiring check")
    ap.add_argument("--coarse-iters", type=int, default=10)
    ap.add_argument("--fine-iters", type=int, default=5)
    ap.add_argument("--n-steps", type=int, default=None,
                    help="time steps of a solve (default: 100 with --small, else 1000)")
    ap.add_argument("--out", default="runs/mixing_regrid_continuation.json")
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

    (cx, cz), (fx, fz) = ((64, 32), (128, 64)) if args.small else ((256, 128), (512, 256))
    n_steps = args.n_steps or (100 if args.small else 1000)

    def build(nx, nz):
        t0 = time.perf_counter()
        p = OptimalMixing(MixingConfig(
            nx=nx, nz=nz, dt=5e-3, n_iters=n_steps, s=1, dtype=dtype,
            solve_precision="df64" if dtype == "float32" else "native"), device=device)
        print(f"{nx}x{nz} problem built: {time.perf_counter() - t0:.1f}s", flush=True)
        return p, time.perf_counter() - t0

    p_c, build_c = build(cx, cz)
    x0_c = (p_c.generate_ic(seed=42) if x0 is None
            else [torch.as_tensor(np.asarray(x), dtype=p_c.dtype, device=device) for x in x0])
    res_c, wall_c, x_c, sph_c = study(p_c, x0_c, args.coarse_iters, f"{cx}x{cz}")

    p_f, build_f = build(fx, fz)
    x_warm = regrid_state(p_f, x_c)
    if out is not None:
        out.update(x_coarse=x_c, x_warm=x_warm)
    xw = [torch.as_tensor(x, device=device) for x in x_warm]
    j_start = float(objective_host(p_f)(xw))
    print(f"regridded optimum: {[tuple(np.shape(x)) for x in x_c]} -> "
          f"{[tuple(np.shape(x)) for x in x_warm]}; J_fine(start) = {j_start:.8f} "
          f"(coarse final {float(res_c.function_values[-1]):.8f})", flush=True)
    res_f, wall_f, _, sph_f = study(p_f, xw, args.fine_iters, f"{fx}x{fz} warm")

    res = {
        "coarse": {"nx": cx, "nz": cz, "iters": int(res_c.iterations),
                   "function_evals": res_c.function_evals,
                   "gradient_evals": res_c.gradient_evals, "wall_s": wall_c,
                   "build_s": build_c, "mixnorm": [-float(v) for v in res_c.function_values]},
        "warm_fine": {"nx": fx, "nz": fz, "iters": int(res_f.iterations),
                      "function_evals": res_f.function_evals,
                      "gradient_evals": res_f.gradient_evals, "wall_s": wall_f,
                      "build_s": build_f, "J_start": j_start,
                      "mixnorm": [-float(v) for v in res_f.function_values]},
        "n_steps": n_steps,
        "sphere_err": max(sph_c, sph_f),
        "dtype": dtype,
        "solve_precision": p_c.cfg.solve_precision,
        # the JAX example's cold 512x256 study is a file not in the repository
        "cold_fine_reference": None,
        "device": card_name() if on_gpu else "CPU",
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
