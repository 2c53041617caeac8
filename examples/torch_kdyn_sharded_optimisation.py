"""Sharded optimisation of the kinematic dynamo on `torch.distributed`,
on the PyTorch port.

The port's counterpart of `examples/kdyn_sharded_optimisation.py` (the
reference's distributed run mode, `mpiexec -np 4 python3
FWD_Solve_KDyn.py`, README.md:79-83): the complete device-loop
optimisation (forward scans, adjoint sweeps, strong-Wolfe or Armijo
searches, CG directions, retractions) with the transforms run as
distributed FFTs over the ranks (`KDynConfig(transform="distributed")`):
the 1-D slab by default, the 2-D pencil with `--mesh-shape PX,PY`. Every
rank holds and steps only its shards of the fields, so memory and work
are split.

One process drives one device. Launch P ranks with torchrun:

    torchrun --standalone --nproc-per-node P \\
        examples/torch_kdyn_sharded_optimisation.py --device cpu|cuda [--shards P]

(gloo on the CPU, NCCL on GPUs, rank r on `cuda:LOCAL_RANK`). Without
torchrun it runs as one rank on `--device` and says so in its JSON line;
it never moves to another device or spawns a CPU mesh of its own.

Run: python examples/torch_kdyn_sharded_optimisation.py [--npts 16]
         [--steps 50] [--iters 10] [--ls wolfe] [--mesh-shape PX,PY] [--device cpu]
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
from spheremanopt_torch.parallel.mesh import init_distributed
from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo
from spheremanopt_torch.utils.profiling import card_name


def main(argv=None, x0=None, out=None) -> dict:
    """Run the sharded optimisation on this process group (made here as
    one rank when there is none). `x0` ([B0, U] full arrays) replaces the
    torch draw of `generate_ic(seed=3)`; `out` (a dict), when given,
    receives the full x_opt as numpy arrays."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--npts", type=int, default=16)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--ls", choices=["wolfe", "armijo"], default="wolfe")
    ap.add_argument("--shards", type=int, default=0,
                    help="slab ranks; must equal the number of processes (0: all)")
    ap.add_argument("--mesh-shape", default=None, metavar="PX,PY",
                    help="2-D PENCIL decomposition instead of the 1-D slab")
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

    kw = dict(npts=args.npts, n_iters=args.steps, dt=1e-3, dtype=dtype,
              transform="distributed")
    if args.mesh_shape:
        try:
            shape = tuple(int(v) for v in args.mesh_shape.split(","))
            px, py = shape
        except ValueError:
            raise SystemExit(f"--mesh-shape {args.mesh_shape!r}: expected PX,PY")
        if px * py != world:
            raise SystemExit(f"--mesh-shape {px},{py}: {px * py} ranks asked for, "
                             f"but {world} process(es) run (torchrun --nproc-per-node)")
        kw["mesh_shape"] = shape
    elif args.shards and args.shards != world:
        raise SystemExit(f"--shards {args.shards}: {world} process(es) run "
                         "(torchrun --nproc-per-node)")
    p = KinematicDynamo(KDynConfig(**kw), device=device)
    x0 = (p.generate_ic(seed=3) if x0 is None
          else p.shard_state([torch.as_tensor(np.asarray(x), dtype=p.dtype) for x in x0]))

    opt = jit_optimise_on_multi_sphere(
        p.objective_and_gradient, p.inner_product, p.radii, max_iters=args.iters,
        alpha0=100.0, cg=True, err_tol=1e-12, line_search=args.ls)
    t0 = time.perf_counter()
    res = opt(x0)
    k = int(res.iterations)
    if on_gpu:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    if out is not None:
        out["x_opt"] = [x.cpu().numpy() for x in p.gather_state(res.x_opt)]

    rec = {
        "ranks": world,
        "torchrun": torchrun,
        "backend": dist.get_backend(),
        "mesh_shape": list(kw.get("mesh_shape", (world,))),
        "decomposition": f"pencil {args.mesh_shape}" if args.mesh_shape else "slab",
        "transform": "distributed",
        "memory_and_work_split": True,
        "grid": f"{p.mg}^3",
        "dtype": dtype,
        "line_search": args.ls,
        "iterations": k,
        "J_trajectory": res.function_values.double().cpu().numpy()[:k].tolist(),
        "step_sizes": res.step_sizes.double().cpu().numpy()[:k].tolist(),
        "local_shape": list(res.x_opt[0].shape),
        "wall_s": wall,
        "device": card_name() if on_gpu else "CPU",
    }
    if rank == 0:
        print(json.dumps(rec), flush=True)
    if made_group:
        # free the loop first: its CUDA graphs hold captured collectives,
        # and the group's teardown waits for them
        del opt, res, p, x0
        gc.collect()
        dist.destroy_process_group()
    return rec


if __name__ == "__main__":
    main()
