"""Batched optimisation sweep on the PyTorch port: a whole family of
sphere-constrained SH23 optimisations in one `sweep` call.

The port's counterpart of `examples/sh23_batch_sweep.py`. `sweep` runs B
complete strong-Wolfe + CG optimisations (forward solves, adjoint sweeps,
bracketing line searches, retractions). With `method="matmul"` they run
as one loop whose state carries a leading row axis: all rows step in one
product of B columns, each row makes the decisions of its own run, and a
row that has converged is frozen while the others go on. The f32 kernels
(`method="cuda"`, the default on a GPU) have no form over rows: the sweep
runs each row on the unbatched loop, its two sweeps launched by that
loop's graphs. On a GPU the loop's steps replay as CUDA graphs.

The sweep axis is the sphere radius E0 (the reference paper's bisection
axis) plus an independent initial-condition seed per point.

Run: python examples/torch_sh23_batch_sweep.py [B] [--device cpu] [--method matmul]
     (SMO_SWEEP_TINY=1: a small config for a quick check)
"""

import argparse
import os
import sys
import time

# runnable without installing the package: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
from spheremanopt_torch.problems.base import row_forms
from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg
from spheremanopt_torch.utils.profiling import card_name


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=8)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--method", choices=["cuda", "matmul"], default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    on_gpu = device.type == "cuda"
    if on_gpu:
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA GPU found (use --device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False
    method = args.method or ("cuda" if on_gpu else "matmul")
    dtype = "float32" if method == "cuda" else ("float32" if on_gpu else "float64")
    if os.environ.get("SMO_SWEEP_TINY") == "1":
        cfg = SH23Config(dtype=dtype, method=method, npts=48, n_iters=50)
        max_iters = 4
    else:
        cfg = SH23Config(dtype=dtype, method=method)   # N=256, 1000 steps
        max_iters = 30
    p = SwiftHohenberg(cfg, device=device)
    opt = jit_optimise_on_multi_sphere(
        p.objective_and_gradient, p.inner_product, p.radii, max_iters=max_iters,
        alpha0=float(np.pi), cg=True, line_search="wolfe", f=p.objective,
        rows=row_forms(p))

    B = args.batch
    e0s = np.linspace(0.02, 0.10, B)
    x0s = torch.stack([p.generate_ic(seed=s)[0] for s in range(B)])
    radii = [[float(e)] for e in e0s]

    sync(device)
    t0 = time.perf_counter()
    opt.sweep([x0s], radii)
    sync(device)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = opt.sweep([x0s], radii)
    sync(device)
    t_batch = time.perf_counter() - t0

    # sequential: the same optimiser, one run at a time
    opt([x0s[0]], radii_dyn=radii[0])
    sync(device)
    t0 = time.perf_counter()
    for i in range(B):
        opt([x0s[i]], radii_dyn=radii[i])
    sync(device)
    t_seq = time.perf_counter() - t0

    where = card_name() if on_gpu else "CPU"
    print(f"batch={B} x {max_iters} Wolfe+CG iterations (SH23 N={cfg.npts}, "
          f"{cfg.n_iters} steps/solve, {cfg.dtype} {cfg.method}) on {where}")
    print(f"  batched: {t_batch:.3f}s total = {t_batch / B:.4f}s per optimisation "
          f"(first call {t_first:.2f}s; on a GPU with the warm-up and capture)")
    print(f"  sequential (same optimiser, one at a time): {t_seq:.3f}s "
          f"= {t_seq / B:.4f}s per optimisation")
    print(f"  sequential / batched: {t_seq / t_batch:.2f}x")
    jf = res.function_values.cpu().numpy()
    for i in range(B):
        k = int(res.iterations[i])
        print(f"  E0={e0s[i]:.4f}  J_final={jf[i, max(k - 1, 0)]:+.5f}  iters={k}")


if __name__ == "__main__":
    main()
