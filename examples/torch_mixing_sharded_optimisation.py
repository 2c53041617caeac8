"""Optimisation of the Boussinesq mixing problem with its state as a
DTensor on `torch.distributed`, on the PyTorch port.

The port's counterpart of `examples/mixing_sharded_optimisation.py` (the
reference's second distributed workload, `mpiexec -np 4 python3
FWD_Solve_Poiseuille.py`, README.md:106-110): the complete device-loop
optimisation (Wolfe or Armijo, CG) with the initial state a DTensor
sharded over the ranks on the grid's x axis, the operator stacks the
loop's `aux` operand, replicated.

The port has no distributed transform for mixing. The sharded state goes
through the adapter of `parallel/sharded.py` (`problem.on_mesh`, and the
loop's DTensor entry): it is gathered, and every rank runs the whole
solve on the whole state. So memory and work are NOT split: P ranks do P
times one rank's work, each holding everything. The JSON line says so
(`"memory_and_work_split": false`). x_opt comes back with x0's
placements.

One process drives one device. Launch P ranks with torchrun:

    torchrun --standalone --nproc-per-node P -- \\
        examples/torch_mixing_sharded_optimisation.py --device cpu|cuda [--s 0]

(gloo on the CPU, NCCL on GPUs; the `--` keeps torchrun's own parser
from taking `--s` for one of its options). Without torchrun it runs as
one rank on `--device` and says so in its JSON line; it never moves to
another device or spawns a CPU mesh of its own.

Run: python examples/torch_mixing_sharded_optimisation.py [--nx 32] [--nz 16]
         [--steps 20] [--iters 5] [--ls wolfe] [--device cpu]
The last line of rank 0's output is one JSON object.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

# runnable without installing the package: put the repo root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.distributed as dist

from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
from spheremanopt_torch.parallel.mesh import init_distributed, make_mesh, shard_fields
from spheremanopt_torch.problems.optimal_mixing import MixingConfig, OptimalMixing
from spheremanopt_torch.utils.profiling import card_name


def main(argv=None, x0=None, out=None) -> dict:
    """Run the optimisation on this process group (made here as one rank
    when there is none). `x0` (the full state list) replaces the torch
    draw of `generate_ic(seed=3)`; `out` (a dict), when given, receives
    the full x_opt as numpy arrays."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=32,
                    help="Fourier-x modes; 1.5*nx must divide over the ranks")
    ap.add_argument("--nz", type=int, default=16)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--s", type=int, choices=[0, 1], default=1)
    ap.add_argument("--ls", choices=["wolfe", "armijo"], default="wolfe")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--dtype", choices=["float32", "float64"], default=None,
                    help="default: float32 on a GPU, float64 on the CPU")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA GPU found (use --device cpu)")
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    made_group = not dist.is_initialized()
    device = init_distributed(args.device)
    on_gpu = device.type == "cuda"
    if on_gpu:
        torch.backends.cuda.matmul.allow_tf32 = False
    dtype = args.dtype or ("float32" if on_gpu else "float64")
    world, rank = dist.get_world_size(), dist.get_rank()

    p = OptimalMixing(MixingConfig(nx=args.nx, nz=args.nz, n_iters=args.steps,
                                   prep_steps=5, s=args.s, dtype=dtype), device=device)
    if p.mgx % world:
        raise SystemExit(f"--nx {args.nx}: the grid's {p.mgx} x points do not "
                         f"divide over {world} ranks")
    mesh = make_mesh()
    fg, ops = p.on_mesh(mesh).objective_and_gradient_aux
    x_full = (p.generate_ic(seed=3) if x0 is None
              else [torch.as_tensor(np.asarray(x), dtype=p.dtype, device=device) for x in x0])
    xs = shard_fields(mesh, x_full, 1)

    opt = jit_optimise_on_multi_sphere(
        fg, p.inner_product, p.radii, max_iters=args.iters, alpha0=10.0, cg=True,
        err_tol=1e-12, line_search=args.ls)
    t0 = time.perf_counter()
    res = opt(xs, aux=ops)
    k = int(res.iterations)
    if on_gpu:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    full = [x.full_tensor() for x in res.x_opt]
    if out is not None:
        out["x_opt"] = [x.cpu().numpy() for x in full]

    rec = {
        "ranks": world,
        "torchrun": torchrun,
        "backend": dist.get_backend(),
        "mesh_shape": [world],
        "grid": f"{p.mgx}x{p.mgz}",
        "objective": "mix-norm (s=1)" if args.s == 1 else "KE (s=0)",
        "dtype": dtype,
        "line_search": args.ls,
        "iterations": k,
        "J_trajectory": res.function_values.double().cpu().numpy()[:k].tolist(),
        "step_sizes": res.step_sizes.double().cpu().numpy()[:k].tolist(),
        "final_placements": [str(pl) for pl in res.x_opt[0].placements],
        "local_shape": list(res.x_opt[0].to_local().shape),
        "memory_and_work_split": False,
        "note": "the state is gathered and every rank solves it whole "
                "(parallel/sharded.py): no memory or work is split",
        "wall_s": wall,
        "device": card_name() if on_gpu else "CPU",
    }
    if rank == 0:
        print(json.dumps(rec), flush=True)
    if made_group:
        del opt, res, full, xs, fg, ops, p
        gc.collect()
        dist.destroy_process_group()
    return rec


if __name__ == "__main__":
    main()
