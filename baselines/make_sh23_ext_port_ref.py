"""Regenerate baselines/sh23_ext_port_ref.npz — the SH23 L-BFGS trajectory
and continuous-adjoint gradient that the PyTorch port (`spheremanopt_torch`)
is held against on a machine without JAX.

Inputs are the pinned seed-42 initial conditions of
`baselines/sh23_port_ref.npz` (x0_f64, x0_f32), at the full reference
config (npts=256, n_iters=1000, dt=0.05, e0=0.0725):

  fv_f64_lbfgs, iters_f64_lbfgs,   host-loop L-BFGS (`method="lbfgs"`,
  steps_f64_lbfgs                  lbfgs_memory=8, Wolfe, alpha0=pi,
                                   max_iters=200, fused f_and_g as
                                   `run.py --direction lbfgs` drives it)
                                   from x0_f64, method="matmul", f64
  fv_f32_lbfgs, iters_f32_lbfgs    the same in f32 from x0_f32 (an end
                                   point to print beside the port's f32
                                   kernel workload, not a gate: f32
                                   trajectories fork on roundoff)
  gc_f64                           the continuous-adjoint gradient
                                   (`adjoint="continuous"`) at x0_f64, f64

Run on a CPU: python baselines/make_sh23_ext_port_ref.py   (about 1 min)
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# shared in-process CPU force + x64 (utils/platform.py)
from spheremanopt_tpu.utils.platform import apply_platform  # noqa: E402

apply_platform("cpu", x64=True)

import jax.numpy as jnp  # noqa: E402

from spheremanopt_tpu.optim.optimiser import optimise_on_multi_sphere  # noqa: E402
from spheremanopt_tpu.problems.swift_hohenberg import (  # noqa: E402
    SH23Config,
    SwiftHohenberg,
)

HERE = os.path.dirname(__file__)
IN = os.path.join(HERE, "sh23_port_ref.npz")
OUT = os.path.join(HERE, "sh23_ext_port_ref.npz")


def lbfgs_workload(p, x0):
    """The L-BFGS optimisation exactly as `run.py sh23 --direction lbfgs`
    drives it."""
    r = optimise_on_multi_sphere(
        x0, p.radii, p.objective, p.gradient, p.inner_product,
        max_iters=200, alpha_k=float(np.pi), line_search="wolfe",
        method="lbfgs", lbfgs_memory=8, verbose=False,
        f_and_g=p.objective_and_gradient)
    return (np.asarray(r.function_values, np.float64), r.iterations,
            np.asarray(r.step_sizes, np.float64), r)


def main():
    ref = np.load(IN)
    out = {}
    for dtype, tag in (("float64", "f64"), ("float32", "f32")):
        p = SwiftHohenberg(SH23Config(dtype=dtype, method="matmul"))
        fv, k, steps, r = lbfgs_workload(p, [jnp.asarray(ref[f"x0_{tag}"])])
        out[f"fv_{tag}_lbfgs"], out[f"iters_{tag}_lbfgs"] = fv, k
        if tag == "f64":
            out["steps_f64_lbfgs"] = steps
        print(f"{dtype} matmul L-BFGS: {k} iterations, {r.function_evals} "
              f"function and {r.gradient_evals} gradient evaluations, "
              f"function values {fv.tolist()}", flush=True)

    p = SwiftHohenberg(SH23Config(dtype="float64", method="matmul",
                                  adjoint="continuous"))
    out["gc_f64"] = np.asarray(p.gradient([jnp.asarray(ref["x0_f64"])])[0])
    print(f"continuous gradient at x0_f64: |g| = "
          f"{float(np.linalg.norm(out['gc_f64']))!r}")

    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
