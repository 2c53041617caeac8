"""Regenerate baselines/mixing_port_ref.npz — the optimal-mixing inputs and
reference values that the PyTorch port (`spheremanopt_torch`) is held
against on a machine without JAX.

`OptimalMixing.generate_ic` draws its noise from `jax.random`, which has
no PyTorch counterpart, so the draw is pinned with what the JAX package
computes from it, in f64, at a small config (nx=32, nz=16, n_iters=40,
dt=1e-2, prep_steps=10; the size of tests/test_rtr_pde.py and
tests/test_jit_rtr.py):

  noise, x0                the seed-0 draw jax.random.normal(PRNGKey(0),
                           (mgx, mgz), float64) and generate_ic(seed=0)
  J_s<s>_<adjoint>,        J and the gradient at x0, s = 0|1,
  g_s<s>_<adjoint>         adjoint = discrete|continuous
  fv_host, steps_host,     host loop, s=1 discrete: Wolfe + hybrid CG,
  iters_host, fevals_host, alpha0=100, max_iters=3, fused f_and_g as in
  gevals_host              run.py (function values -J, step sizes,
                           iterations, function and gradient evaluations)
  fv_dev, steps_dev,       the same through the device loop
  iters_dev                (`jit_optimise_on_multi_sphere`, the operator
                           stacks as its aux operand)
  fv_rtr, steps_rtr,       host trust-region Newton (err_tol=1e-6,
  iters_rtr, hvp_rtr       max_iters=3, max_cg=50)
  fv_jrtr, steps_jrtr,     device trust-region Newton, same settings
  iters_jrtr, trials_jrtr,
  hvp_jrtr

and at the reference width (256x128, dt=5e-3, s=1, discrete), from the
x0 of baselines/mixing256_truth.npz (the f32 seed-42 IC) in f64:

  fv_full100, steps_full100, the host loop (Wolfe + CG, alpha0=100,
  iters_full100            max_iters=3) at n_iters=100, a tenth of the
                           reference horizon
  fv_full, steps_full      the first iteration of the same host loop at
                           the full 1000 steps

The full-depth J and gradient are baselines/mixing256_truth.npz
(`make_mixing256_truth.py`), which this script does not rewrite.

Run on a CPU: python baselines/make_mixing_port_ref.py   (about 10 min)
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
# the JAX package's operator cache defaults to a directory outside the
# checkout, and a 256x128 f64 entry takes ~300 MB: off unless asked for
os.environ.setdefault("SMO_OP_CACHE", "0")
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# shared in-process CPU force + x64 (utils/platform.py)
from spheremanopt_tpu.utils.platform import apply_platform  # noqa: E402

apply_platform("cpu", x64=True)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from spheremanopt_tpu.optim.jit_driver import jit_optimise_on_multi_sphere  # noqa: E402
from spheremanopt_tpu.optim.jit_rtr import jit_optimise_rtr  # noqa: E402
from spheremanopt_tpu.optim.optimiser import optimise_on_multi_sphere  # noqa: E402
from spheremanopt_tpu.optim.rtr import optimise_rtr  # noqa: E402
from spheremanopt_tpu.problems.optimal_mixing import (  # noqa: E402
    MixingConfig,
    OptimalMixing,
)

HERE = os.path.dirname(__file__)
OUT = os.path.join(HERE, "mixing_port_ref.npz")
SMALL = dict(nx=32, nz=16, n_iters=40, dt=1e-2, prep_steps=10)
SEED = 0
WOLFE = dict(alpha_k=100.0, line_search="wolfe", cg=True)
RTR = dict(err_tol=1e-6, max_iters=3, max_cg=50)


def host_loop(p, x0, max_iters):
    """The reference optimisation exactly as `run.py mixing` drives it."""
    r = optimise_on_multi_sphere(
        x0, p.radii, p.objective, p.gradient, p.inner_product,
        max_iters=max_iters, verbose=False, f_and_g=p.objective_and_gradient,
        **WOLFE)
    return r


def main():
    out = {}
    t0 = time.time()
    p = OptimalMixing(MixingConfig(**SMALL))
    out["noise"] = np.asarray(jax.random.normal(
        jax.random.PRNGKey(SEED), (p.mgx, p.mgz), jnp.float64))
    x0 = p.generate_ic(seed=SEED)
    out["x0"] = np.asarray(x0[0])
    for s in (0, 1):
        for adj in ("discrete", "continuous"):
            q = OptimalMixing(MixingConfig(s=s, adjoint=adj, **SMALL))
            J, g = q.objective_and_gradient(x0)
            out[f"J_s{s}_{adj}"] = np.float64(J)
            out[f"g_s{s}_{adj}"] = np.asarray(g[0])
            print(f"s={s} {adj}: J = {float(J)!r}", flush=True)

    r = host_loop(p, x0, 3)
    out.update(fv_host=np.asarray(r.function_values, np.float64),
               steps_host=np.asarray(r.step_sizes, np.float64),
               iters_host=r.iterations, fevals_host=r.function_evals,
               gevals_host=r.gradient_evals)
    print(f"host loop: {r.iterations} iterations, {r.function_evals} "
          f"function and {r.gradient_evals} gradient evaluations, values "
          f"{out['fv_host'].tolist()}", flush=True)

    fg, ops = p.objective_and_gradient_aux
    d = jit_optimise_on_multi_sphere(
        fg, p.inner_product, p.radii, max_iters=3, alpha0=100.0, cg=True,
        line_search="wolfe")(x0, aux=ops)
    k = int(d.iterations)
    out.update(fv_dev=np.asarray(d.function_values[:k], np.float64),
               steps_dev=np.asarray(d.step_sizes[:k], np.float64),
               iters_dev=k)
    print(f"device loop: {k} iterations, values {out['fv_dev'].tolist()}",
          flush=True)

    r = optimise_rtr(x0, p.radii, p.objective, p.gradient, p.inner_product,
                     verbose=False, **RTR)
    out.update(fv_rtr=np.asarray(r.function_values, np.float64),
               steps_rtr=np.asarray(r.step_sizes, np.float64),
               iters_rtr=r.iterations, hvp_rtr=r.hvp_evals)
    print(f"host RTR: {r.iterations} iterations, {r.hvp_evals} HVPs, values "
          f"{out['fv_rtr'].tolist()}", flush=True)
    d = jit_optimise_rtr(lambda a, xs: fg(a, xs)[0],
                         lambda a, xs: fg(a, xs)[1],
                         p.inner_product, p.radii, **RTR)(x0, aux=ops)
    k = int(d.iterations)
    out.update(fv_jrtr=np.asarray(d.function_values[:k], np.float64),
               steps_jrtr=np.asarray(d.step_sizes[:k], np.float64),
               iters_jrtr=k, trials_jrtr=int(d.trials),
               hvp_jrtr=int(d.hvp_evals))
    print(f"device RTR: {k} iterations, {int(d.trials)} trials, "
          f"{int(d.hvp_evals)} HVPs, values {out['fv_jrtr'].tolist()} "
          f"({time.time() - t0:.1f} s so far)", flush=True)

    truth = np.load(os.path.join(HERE, "mixing256_truth.npz"))
    xt = [jnp.asarray(truth["x0"], jnp.float64)]
    t0 = time.time()
    r = host_loop(OptimalMixing(MixingConfig(n_iters=100)), xt, 3)
    out.update(fv_full100=np.asarray(r.function_values, np.float64),
               steps_full100=np.asarray(r.step_sizes, np.float64),
               iters_full100=r.iterations)
    print(f"256x128, n_iters=100: {r.iterations} iterations, values "
          f"{out['fv_full100'].tolist()} ({time.time() - t0:.1f} s)",
          flush=True)
    t0 = time.time()
    r = host_loop(OptimalMixing(MixingConfig()), xt, 1)
    out.update(fv_full=np.asarray(r.function_values, np.float64),
               steps_full=np.asarray(r.step_sizes, np.float64))
    print(f"256x128, n_iters=1000, first iteration: values "
          f"{out['fv_full'].tolist()}, steps {out['steps_full'].tolist()} "
          f"({time.time() - t0:.1f} s)", flush=True)

    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
