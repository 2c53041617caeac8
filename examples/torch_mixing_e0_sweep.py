"""Batched mixing study on the PyTorch port: mix-norm attainable against
perturbation energy E0, the whole E0 sweep as one device loop over rows.

The port's counterpart of `examples/mixing_e0_sweep.py`. B complete
strong-Wolfe + CG optimisations (1000-step Boussinesq forward and adjoint
solves per line-search trial) run as one loop whose state carries a
leading row axis. The R states ride in the planes' field axis, so each
step keeps its launches whatever B is, and the operator stacks are one
operand of the loop shared by every row (loaded once into the graphs'
state, not once a row): each implicit solve multiplies every operator
block by B right-hand sides.

Run: python examples/torch_mixing_e0_sweep.py [B] [--device cpu]
     (SMO_SWEEP_TINY=1: a small config for a quick check)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
from spheremanopt_torch.problems.base import row_forms
from spheremanopt_torch.problems.optimal_mixing import MixingConfig, OptimalMixing
from spheremanopt_torch.utils.profiling import card_name


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    on_gpu = device.type == "cuda"
    if on_gpu:
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA GPU found (use --device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False
    dtype = "float32" if on_gpu else "float64"
    if os.environ.get("SMO_SWEEP_TINY") == "1":
        cfg = MixingConfig(dtype=dtype, nx=16, nz=16, n_iters=16, prep_steps=4)
        max_iters = 3
    else:
        cfg = MixingConfig(dtype=dtype)   # 256x128, 1000 steps, s=1 mix-norm
        max_iters = 10
    p = OptimalMixing(cfg, device=device)
    fg, ops = p.objective_and_gradient_aux
    opt = jit_optimise_on_multi_sphere(
        fg, p.inner_product, p.radii, max_iters=max_iters, alpha0=100.0, cg=True,
        line_search="wolfe", f=p.objective_ops, rows=row_forms(p, aux=True))

    # E0 around the reference's 0.02, one IC seed per point
    B = args.batch
    e0s = np.geomspace(0.005, 0.08, B)
    x0s = torch.stack([p.generate_ic(seed=s)[0] for s in range(B)])
    radii = [[float(e)] for e in e0s]

    sync(device)
    t0 = time.perf_counter()
    opt.sweep([x0s], radii, aux=ops)
    sync(device)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = opt.sweep([x0s], radii, aux=ops)
    sync(device)
    t_batch = time.perf_counter() - t0

    opt([x0s[0]], radii_dyn=radii[0], aux=ops)
    sync(device)
    t0 = time.perf_counter()
    for i in range(B):
        opt([x0s[i]], radii_dyn=radii[i], aux=ops)
    sync(device)
    t_seq = time.perf_counter() - t0

    where = card_name() if on_gpu else "CPU"
    print(f"batch={B} x {max_iters} Wolfe+CG iterations (mixing {cfg.nx}x{cfg.nz}, "
          f"{cfg.n_iters} steps/solve, s={cfg.s}, {cfg.dtype}) on {where}")
    print(f"  batched: {t_batch:.2f}s total = {t_batch / B:.3f}s per optimisation "
          f"(first call {t_first:.1f}s; on a GPU with the warm-up and capture)")
    print(f"  sequential (same optimiser, one at a time): {t_seq:.2f}s "
          f"= {t_seq / B:.3f}s per optimisation")
    print(f"  sequential / batched: {t_seq / t_batch:.2f}x")
    # function_values record -J; the s=1 objective is the mix-norm (a
    # minimisation), so print -values
    jf = res.function_values.cpu().numpy()
    print("  E0        mix-norm(0) -> mix-norm(T_opt)")
    for i in range(B):
        k = int(res.iterations[i])
        print(f"  {e0s[i]:.5f}  {-jf[i, 0]:.6f} -> {-jf[i, max(k - 1, 0)]:.6f}  "
              f"(iters={k})")


if __name__ == "__main__":
    main()
