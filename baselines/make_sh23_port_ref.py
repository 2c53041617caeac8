"""Regenerate baselines/sh23_port_ref.npz — the SH23 inputs and reference
trajectories that the PyTorch port (`spheremanopt_torch`) is held
against on a machine without JAX.

`SwiftHohenberg.generate_ic` draws its noise from `jax.random`, which
has no PyTorch counterpart, so the seed-42 inputs are pinned here
together with what the JAX package computes from them at the full
reference config (npts=256, n_iters=1000, dt=0.05, e0=0.0725):

  noise_f64, noise_f32   jax.random.normal(PRNGKey(42), (512,), dtype)
  x0_f64, x0_f32         generate_ic(seed=42) under each dtype
  J_f64, g_f64           -J and Riesz gradient at x0_f64, method="matmul"
  J_f32, g_f32           the same at x0_f32, method="pallas" (interpret)
  fv_*, iters_*          host-loop function_values / iterations of the
                         reference workload (Wolfe + hybrid CG, alpha0=pi,
                         max_iters=200, fused f_and_g as in run.py) for
                         f64 matmul, f32 matmul and f32 pallas

Run on CPU: python baselines/make_sh23_port_ref.py   (about 30 s)
tests/test_torch_sh23.py checks x0 and J/grad at x0 against the JAX
package as it stands; the trajectories are not re-run there.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# shared in-process CPU force + x64 (utils/platform.py)
from spheremanopt_tpu.utils.platform import apply_platform  # noqa: E402

apply_platform("cpu", x64=True)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spheremanopt_tpu.optim.optimiser import optimise_on_multi_sphere  # noqa: E402
from spheremanopt_tpu.problems.swift_hohenberg import (  # noqa: E402
    SH23Config,
    SwiftHohenberg,
)

SEED = 42
OUT = os.path.join(os.path.dirname(__file__), "sh23_port_ref.npz")


def workload(p, x0):
    """The reference optimisation exactly as `run.py sh23` drives it."""
    r = optimise_on_multi_sphere(
        x0, p.radii, p.objective, p.gradient, p.inner_product,
        max_iters=200, alpha_k=float(np.pi), line_search="wolfe", cg=True,
        verbose=False, f_and_g=p.objective_and_gradient)
    return np.asarray(r.function_values, np.float64), r.iterations


def main():
    out = {}
    for dt, method in (("float64", "matmul"), ("float32", "pallas")):
        tag = dt[-2:]
        p = SwiftHohenberg(SH23Config(dtype=dt, method=method))
        out[f"noise_f{tag}"] = np.asarray(jax.random.normal(
            jax.random.PRNGKey(SEED), (p.basis.n_grid,), jnp.dtype(dt)))
        x0 = [jnp.asarray(np.asarray(p.generate_ic(seed=SEED)[0]))]
        out[f"x0_f{tag}"] = np.asarray(x0[0])
        J, g = p.objective_and_gradient(x0)
        out[f"J_f{tag}"] = np.asarray(J)
        out[f"g_f{tag}"] = np.asarray(g[0])
        fv, k = workload(p, x0)
        out[f"fv_f{tag}_{method}"], out[f"iters_f{tag}_{method}"] = fv, k
        print(f"{dt} {method}: J(x0) = {float(J)!r}, {k} iterations, "
              f"function values {fv.tolist()}", flush=True)

    p = SwiftHohenberg(SH23Config(dtype="float32", method="matmul"))
    fv, k = workload(p, [jnp.asarray(out["x0_f32"])])
    out["fv_f32_matmul"], out["iters_f32_matmul"] = fv, k
    print(f"float32 matmul: {k} iterations, function values {fv.tolist()}")

    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
