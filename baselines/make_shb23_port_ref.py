"""Regenerate baselines/shb23_port_ref.npz — the SHB23 inputs and reference
trajectories that the PyTorch port (`spheremanopt_torch`) is held
against on a machine without JAX.

`SwiftHohenbergBounded.generate_ic` draws its noise from `jax.random`,
which has no PyTorch counterpart, so the seed-42 inputs are pinned here
together with what the JAX package computes from them at the full
reference config (npts=512, dt=0.01, n_iters=2000, m0=0.0019, a=-0.1,
trapezoid weights; `SHB23Config()`):

  noise_f64, noise_f32   jax.random.normal(PRNGKey(42), (512,), dtype)
  x0_f64, x0_f32         generate_ic(seed=42) under each dtype
  J_f64, g_f64           -J and Riesz gradient at x0_f64, method="matmul"
  J_f32, g_f32           the same at x0_f32, method="pallas" (interpret)
  fv_*, iters_*          host-loop function_values / iterations of the
                         reference workload (Wolfe + hybrid CG, alpha0=1,
                         max_iters=50, err_tol=1e-5, fused f_and_g as in
                         run.py) for f64 matmul, f32 matmul and f32
                         pallas (interpret)

Run on CPU: python baselines/make_shb23_port_ref.py   (about 1.5 min)
tests/test_torch_shb23.py checks x0 and J/grad at x0 against the JAX
package as it stands; the trajectories are not re-run there.
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# shared in-process CPU force + x64 (utils/platform.py)
from spheremanopt_tpu.utils.platform import apply_platform  # noqa: E402

apply_platform("cpu", x64=True)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spheremanopt_tpu.optim.optimiser import optimise_on_multi_sphere  # noqa: E402
from spheremanopt_tpu.problems.swift_hohenberg_bounded import (  # noqa: E402
    SHB23Config,
    SwiftHohenbergBounded,
)

SEED = 42
OUT = os.path.join(os.path.dirname(__file__), "shb23_port_ref.npz")


def workload(p, x0):
    """The reference optimisation exactly as `run.py shb23` drives it."""
    r = optimise_on_multi_sphere(
        x0, p.radii, p.objective, p.gradient, p.inner_product,
        err_tol=1e-5, max_iters=50, alpha_k=1.0, line_search="wolfe",
        cg=True, verbose=False, f_and_g=p.objective_and_gradient)
    return np.asarray(r.function_values, np.float64), r.iterations


def main():
    out = {}
    for dt, method in (("float64", "matmul"), ("float32", "pallas")):
        tag = dt[-2:]
        t0 = time.time()
        p = SwiftHohenbergBounded(SHB23Config(dtype=dt, method=method))
        out[f"noise_f{tag}"] = np.asarray(jax.random.normal(
            jax.random.PRNGKey(SEED), (p.cfg.npts,), jnp.dtype(dt)))
        x0 = [jnp.asarray(np.asarray(p.generate_ic(seed=SEED)[0]))]
        out[f"x0_f{tag}"] = np.asarray(x0[0])
        J, g = p.objective_and_gradient(x0)
        out[f"J_f{tag}"] = np.asarray(J)
        out[f"g_f{tag}"] = np.asarray(g[0])
        print(f"{dt} {method}: J(x0) = {float(J)!r} ({time.time() - t0:.1f} s)",
              flush=True)

    for dt, method in (("float64", "matmul"), ("float32", "matmul"),
                       ("float32", "pallas")):
        tag = dt[-2:]
        t0 = time.time()
        p = SwiftHohenbergBounded(SHB23Config(dtype=dt, method=method))
        fv, k = workload(p, [jnp.asarray(out[f"x0_f{tag}"])])
        out[f"fv_f{tag}_{method}"], out[f"iters_f{tag}_{method}"] = fv, k
        print(f"{dt} {method}: {k} iterations, function values {fv.tolist()} "
              f"({time.time() - t0:.1f} s)", flush=True)

    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
