"""Regenerate baselines/kdyn_ext_port_ref.npz — the kinematic dynamo's
continuous-adjoint values that the PyTorch port (`spheremanopt_torch`) is
held against on a machine without JAX.

From the pinned f32 initial condition of `kdyn24_truth.npz` (b0, u0; the
f64 inputs are these values cast), the JAX package in f64 on the CPU at
the reference width (`KDynConfig()`: 24^3 modes on the 36^3 grid, Rm = 1,
dt = 5e-4) with `adjoint="continuous"` and n_iters = 200 (a tenth of the
reference horizon), for cost = Final and Integrated:

  b0, u0                the initial condition, f32 (kdyn24_truth's)
  gcb_<cost>, gcu_<cost>
                        the continuous gradient [G(0), nu(0)] as truncated
                        coefficients (3, 24, 24, 13), complex128: to_coeff
                        of the grid gradient, which is band-limited, so the
                        grid form is to_grid of these
  div_g_<cost>, div_nu_<cost>, flux_g_<cost>
                        the sweep's invariant series (adjoint_diagnostics:
                        max|div G|, max|div nu|, |<G>|), (200,) f64 each,
                        in forward time order

Run on CPU: python baselines/make_kdyn_ext_port_ref.py   (well under a minute)
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
# the JAX package's operator cache defaults to a directory outside the
# checkout: off unless asked for
os.environ.setdefault("SMO_OP_CACHE", "0")
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# shared in-process CPU force + x64 (utils/platform.py)
from spheremanopt_tpu.utils.platform import apply_platform  # noqa: E402

apply_platform("cpu", x64=True)

import jax.numpy as jnp  # noqa: E402

from spheremanopt_tpu.problems.kinematic_dynamo import (  # noqa: E402
    KDynConfig,
    KinematicDynamo,
)

HERE = os.path.dirname(os.path.abspath(__file__))
N_CUT = 200


def main():
    truth = np.load(os.path.join(HERE, "kdyn24_truth.npz"))
    out = {"b0": truth["b0"], "u0": truth["u0"]}
    x0 = [jnp.asarray(truth[k].astype(np.float64)) for k in ("b0", "u0")]
    for cost in ("Final", "Integrated"):
        p = KinematicDynamo(KDynConfig(n_iters=N_CUT, cost=cost,
                                       adjoint="continuous"))
        d = p.adjoint_diagnostics(x0)
        gb, gu = (np.asarray(p.to_coeff(g)) for g in d["gradient"])
        out[f"gcb_{cost}"], out[f"gcu_{cost}"] = gb, gu
        out[f"div_g_{cost}"] = np.asarray(d["max_div_G"], np.float64)
        out[f"div_nu_{cost}"] = np.asarray(d["max_div_nu"], np.float64)
        out[f"flux_g_{cost}"] = np.asarray(d["max_flux_G"], np.float64)
        assert gb.dtype == np.complex128 and gb.shape == (3, 24, 24, 13)
        print(f"{cost}: |G(0)| {np.abs(gb).max():.6e}, |nu(0)| "
              f"{np.abs(gu).max():.6e}, max div G {out[f'div_g_{cost}'].max():.3e}, "
              f"max div nu {out[f'div_nu_{cost}'].max():.3e}, flux "
              f"{out[f'flux_g_{cost}'].max():.3e}", flush=True)
    path = os.path.join(HERE, "kdyn_ext_port_ref.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({os.path.getsize(path) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
