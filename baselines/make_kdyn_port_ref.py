"""Regenerate baselines/kdyn_port_ref.npz — the kinematic-dynamo inputs and
reference values that the PyTorch port (`spheremanopt_torch`) is held
against on a machine without JAX.

`KinematicDynamo.generate_ic` draws its noise from `jax.random`, which
has no PyTorch counterpart, so the seed-42 initial condition of the f32
problem is pinned here (it is the `b0`, `u0` of `kdyn24_truth.npz`;
asserted) together with what the JAX package computes from it at the
reference width (`KDynConfig()`: 24^3 modes on the 36^3 grid, Rm = 1,
dt = 5e-4, M0 = E0 = 1):

  b0, u0                 generate_ic(seed=42) of the f32 problem, stored
                         in f32 (the f64 inputs are these values cast)
  J200_<cost>            -J in f64 at x0 with n_iters=200 (a tenth of the
  gb200_<cost>           reference horizon), and both PROJECTED Riesz
  gu200_<cost>           gradients (stored in f32), cost = Final|Integrated
  fv200_f64, iters200_f64
                         host-loop function_values / iterations of the
                         reference workload (Wolfe + hybrid CG,
                         alpha0=100, max_iters=10, fused f_and_g as in
                         run.py) in f64 at n_iters=200, cost Final
  J0_f32_full            J(x0) of the f32 problem at the full 2000 steps
  fv_f32_full, iters_f32_full
                         host-loop function_values / iterations of the same
                         workload in f32 at the full 2000 steps (XLA on the
                         CPU; an f32 trajectory depends on roundoff after
                         its first values, so only the first is a gate)
  fv0_f32_full           its first function value (after iteration 0)
  fv_f64_full, iters_f64_full
                         the same workload in f64 at the full 2000 steps:
                         what the f32 end points are measured against

The full-depth f64 truth (J and both unprojected gradients) is
`baselines/kdyn24_truth.npz` (`make_kdyn24_truth.py`).

Run on CPU: python baselines/make_kdyn_port_ref.py   (about 12 min)
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

import jax.numpy as jnp  # noqa: E402

from spheremanopt_tpu.optim.optimiser import optimise_on_multi_sphere  # noqa: E402
from spheremanopt_tpu.problems.kinematic_dynamo import (  # noqa: E402
    KDynConfig,
    KinematicDynamo,
)

SEED = 42
HERE = os.path.dirname(__file__)
OUT = os.path.join(HERE, "kdyn_port_ref.npz")
N_CUT = 200


def workload(p, x0, max_iters):
    """The reference optimisation exactly as `run.py kdyn` drives it."""
    r = optimise_on_multi_sphere(
        x0, p.radii, p.objective, p.gradient, p.inner_product,
        max_iters=max_iters, alpha_k=100.0, line_search="wolfe", cg=True,
        verbose=False, f_and_g=p.objective_and_gradient)
    return np.asarray(r.function_values, np.float64), r.iterations


def main():
    out = {}
    t0 = time.time()
    p32 = KinematicDynamo(KDynConfig(dtype="float32"))
    x32 = [np.asarray(x) for x in p32.generate_ic(seed=SEED)]
    truth = np.load(os.path.join(HERE, "kdyn24_truth.npz"))
    assert np.array_equal(x32[0], truth["b0"]) and np.array_equal(x32[1], truth["u0"])
    out["b0"], out["u0"] = x32
    x64 = [jnp.asarray(x, jnp.float64) for x in x32]
    print(f"x0 equals kdyn24_truth's ({time.time() - t0:.1f} s)", flush=True)

    for cost in ("Final", "Integrated"):
        t0 = time.time()
        p = KinematicDynamo(KDynConfig(n_iters=N_CUT, cost=cost))
        J, g = p.objective_and_gradient(x64)
        out[f"J200_{cost}"] = np.float64(J)
        out[f"gb200_{cost}"] = np.asarray(g[0], np.float32)
        out[f"gu200_{cost}"] = np.asarray(g[1], np.float32)
        print(f"f64 {cost} n_iters={N_CUT}: J(x0) = {float(J)!r} "
              f"({time.time() - t0:.1f} s)", flush=True)

    t0 = time.time()
    p = KinematicDynamo(KDynConfig(n_iters=N_CUT))
    out["fv200_f64"], out["iters200_f64"] = workload(p, x64, 10)
    print(f"f64 n_iters={N_CUT}: {out['iters200_f64']} iterations, function "
          f"values {out['fv200_f64'].tolist()} ({time.time() - t0:.1f} s)",
          flush=True)

    t0 = time.time()
    x0 = [jnp.asarray(x) for x in x32]
    out["J0_f32_full"] = np.float64(p32.objective(x0))
    out["fv_f32_full"], out["iters_f32_full"] = workload(p32, x0, 10)
    out["fv0_f32_full"] = np.float64(out["fv_f32_full"][0])
    print(f"f32 full depth: J(x0) = {float(out['J0_f32_full'])!r}, "
          f"{out['iters_f32_full']} iterations, function values "
          f"{out['fv_f32_full'].tolist()} ({time.time() - t0:.1f} s)",
          flush=True)

    t0 = time.time()
    out["fv_f64_full"], out["iters_f64_full"] = workload(
        KinematicDynamo(KDynConfig()), x64, 10)
    print(f"f64 full depth: {out['iters_f64_full']} iterations, function values "
          f"{out['fv_f64_full'].tolist()} ({time.time() - t0:.1f} s)", flush=True)

    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
