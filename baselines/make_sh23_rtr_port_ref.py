"""Regenerate baselines/sh23_rtr_port_ref.npz — the SH23 trust-region
Newton trajectories that the PyTorch port (`spheremanopt_torch`) is held
against on a machine without JAX.

The input is the pinned seed-42 initial condition x0_f64 of
`baselines/sh23_port_ref.npz`, at the full reference config (npts=256,
n_iters=1000, dt=0.05, e0=0.0725), method="matmul", f64, with the RTR
defaults of `run.py --direction rtr` (err_tol=1e-6, max_iters=200,
delta0 and delta_max from the sphere scale, max_cg=50):

  fv_f64_rtr, steps_f64_rtr,      host `optimise_rtr`: function values
  res_f64_rtr, iters_f64_rtr,     (-J), step sizes ||eta||, residuals,
  hvp_f64_rtr, conv_f64_rtr       accepted iterations, Hessian-vector
                                  products, converged
  fv_f64_jrtr, steps_f64_jrtr,    device `jit_optimise_rtr` (histories
  iters_f64_jrtr, trials_f64_jrtr, cut to the accepted iterations),
  hvp_f64_jrtr, conv_f64_jrtr     with its trial count
  fv_f64_rtr3, steps_f64_rtr3,    host `optimise_rtr` with max_iters=3: the
  hvp_f64_rtr3                    first three iterations of the full run
                                  (the same decisions), and the HVPs they
                                  take

Run on a CPU: python baselines/make_sh23_rtr_port_ref.py   (about 1 min)
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

from spheremanopt_tpu.optim.jit_rtr import jit_optimise_rtr  # noqa: E402
from spheremanopt_tpu.optim.rtr import optimise_rtr  # noqa: E402
from spheremanopt_tpu.problems.swift_hohenberg import (  # noqa: E402
    SH23Config,
    SwiftHohenberg,
)

HERE = os.path.dirname(__file__)
IN = os.path.join(HERE, "sh23_port_ref.npz")
OUT = os.path.join(HERE, "sh23_rtr_port_ref.npz")
KW = dict(err_tol=1e-6, max_iters=200, max_cg=50)


def main():
    ref = np.load(IN)
    p = SwiftHohenberg(SH23Config(dtype="float64", method="matmul"))
    x0 = [jnp.asarray(ref["x0_f64"])]
    out = {}

    r = optimise_rtr(x0, p.radii, p.objective, p.gradient, p.inner_product,
                     verbose=False, **KW)
    out.update(fv_f64_rtr=np.asarray(r.function_values, np.float64),
               steps_f64_rtr=np.asarray(r.step_sizes, np.float64),
               res_f64_rtr=np.asarray(r.residuals[0], np.float64),
               iters_f64_rtr=r.iterations, hvp_f64_rtr=r.hvp_evals,
               conv_f64_rtr=r.converged)
    print(f"host RTR: {r.iterations} iterations, {r.hvp_evals} HVPs, "
          f"{r.message!r}, function values {out['fv_f64_rtr'].tolist()}",
          flush=True)

    r3 = optimise_rtr(x0, p.radii, p.objective, p.gradient, p.inner_product,
                      verbose=False, **dict(KW, max_iters=3))
    out.update(fv_f64_rtr3=np.asarray(r3.function_values, np.float64),
               steps_f64_rtr3=np.asarray(r3.step_sizes, np.float64),
               hvp_f64_rtr3=r3.hvp_evals)
    assert np.array_equal(out["fv_f64_rtr3"], out["fv_f64_rtr"][:3])
    print(f"host RTR, max_iters=3: {r3.hvp_evals} HVPs, function values "
          f"{out['fv_f64_rtr3'].tolist()}", flush=True)

    d = jit_optimise_rtr(p.objective, p.gradient, p.inner_product, p.radii,
                         **KW)(x0)
    k = int(d.iterations)
    out.update(fv_f64_jrtr=np.asarray(d.function_values[:k], np.float64),
               steps_f64_jrtr=np.asarray(d.step_sizes[:k], np.float64),
               iters_f64_jrtr=k, trials_f64_jrtr=int(d.trials),
               hvp_f64_jrtr=int(d.hvp_evals),
               conv_f64_jrtr=bool(d.converged))
    print(f"device RTR: {k} iterations, {int(d.trials)} trials, "
          f"{int(d.hvp_evals)} HVPs, converged {bool(d.converged)}, function "
          f"values {out['fv_f64_jrtr'].tolist()}", flush=True)

    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
