"""Command line of the port: the `sh23`, `shb23`, `kdyn`, `mixing` and `pca`
subset of the JAX package's `run.py`.

    python -m spheremanopt_torch.run sh23 --device cuda --method cuda --dtype float32
    python -m spheremanopt_torch.run sh23 --device cuda --dtype float64
    python -m spheremanopt_torch.run sh23 --test-grad      # Taylor test only
    python -m spheremanopt_torch.run sh23 --direction lbfgs --lbfgs-memory 8
    python -m spheremanopt_torch.run sh23 --dtype float64 --adjoint continuous
    python -m spheremanopt_torch.run shb23                 # kernels, f32, on a GPU
    python -m spheremanopt_torch.run shb23 --dtype float64 --adjoint continuous
    python -m spheremanopt_torch.run kdyn --cost Final     # kernels, f32, on a GPU
    python -m spheremanopt_torch.run kdyn --dtype float64 --n-iters 200
    python -m spheremanopt_torch.run kdyn --adjoint continuous  # kernel J, adjoint PDE gradient
    python -m spheremanopt_torch.run kdyn --dtype float64 --remat nested
    python -m spheremanopt_torch.run kdyn --precision df64   # f32 problem, f64 solves
    python -m spheremanopt_torch.run pca --dim 100
    python -m spheremanopt_torch.run mixing --device-loop  # 256x128, s=1, f32
    python -m spheremanopt_torch.run mixing --dtype float64 --adjoint continuous
    python -m spheremanopt_torch.run mixing --precision df64 [--df-adjoint]
    python -m spheremanopt_torch.run sh23 --device-loop    # the loop on CUDA graphs
    python -m spheremanopt_torch.run sh23 --direction rtr [--device-loop]
    python -m spheremanopt_torch.run sh23 --archive-full --h5
    python -m spheremanopt_torch.run sh23 --resume runs/latest/DAL_PROGRESS.npz
    python -m spheremanopt_torch.run sh23 --npts 512 --resume coarse.npz --regrid
    python -m spheremanopt_torch.run kdyn --solve-steps 500 --state-out s.npz
    python -m spheremanopt_torch.run kdyn --solve-steps 500 --state-in s.npz
    python -m spheremanopt_torch.run doctor                # environment report
    python -m spheremanopt_torch.run sh23 --profile-dir runs/trace
    torchrun --nproc-per-node 2 -m spheremanopt_torch.run kdyn --shards 2
    torchrun --nproc-per-node 4 -m spheremanopt_torch.run kdyn --mesh-shape 2,2

Outputs in `--out-dir`, as the JAX CLI writes them: `summary.json`,
`optimize_result.txt`, the progress checkpoint `DAL_PROGRESS.npz` after
every iteration of the host loop and host RTR (`--resume` reads it, or a
reference `DAL_PROGRESS.h5`, or the JAX package's), the per-iteration
archives (`--archive-every N`: `progress_iter_<k>.npz`, the histories and
the iterate; `--archive-full`: `diag_iter_<k>.npz`, the full diagnostics,
from the optimisation's own solves where the problem has a fused form),
`convergence.pdf` and the problem's figures (matplotlib), and with `--h5`
the reference's h5 files (h5py). Without matplotlib a line says which
files were not written; `--h5` without h5py fails. `--solve-steps`
advances the PDE state from x0 (or `--state-in`) and saves it, with no
optimisation.

`--device` defaults to `cuda` and fails when no GPU is found; it never
drops to the CPU on its own (`--device cpu` asks for it). On CUDA the
SH23, SHB23 and KDyn default is the hand-written kernel path (`--method
cuda`, f32), as the JAX CLI defaults to its Pallas kernels on a TPU for
SH23 and SHB23. (For KDyn the JAX CLI defaults to `xla`, only because its
Pallas kernel took a quarter of an hour to compile there; the CUDA
kernels build in seconds.) Mixing has one method, `plain` (torch products;
f32 on a GPU, f64 on the CPU by default). TF32 is off: f32 matmuls run
in full f32.

`--precision df64` (kdyn, mixing) is the JAX CLI's accuracy mode of an
f32 problem: the solves and their reverse sweeps run in float64 from the
f32 state (`solve_precision="df64"`; `--df-adjoint` is accepted and runs
the same f64 sweep; kdyn then defaults to `--method plain`). The host
loop compares J at f64 (`objective_f64`), `--test-grad` tests against
it, and the device loop takes the problem's aux form (an f32 J beside the
f32 search state). The JAX CLI's other `--precision` names are TPU solve
modes and are refused: `--dtype float64` is the accuracy mode on the
H100. `--remat step|nested|offload|none` sets KDyn's trajectory memory on
the plain method.

`doctor` prints an environment report as JSON (versions, a CPU and a
GPU probe in child processes, nvcc and g++, whether the kernels' library
and the g++ record writer are built for the current sources, the build and operator-cache
directories) and exits 0 when the CPU path works; it builds nothing and
initialises no CUDA in its own process. `--profile-dir DIR` writes a
torch.profiler Chrome trace of the optimisation (not the problem build)
into DIR (`utils/profiling.py`).

`--shards N` (kdyn) runs the transforms as the slab distributed FFT over
N processes (`transform="distributed"`, `parallel/fft.py`), `--mesh-shape
PX,PY` as the 2-D pencil over PX x PY; launch with `torchrun
--nproc-per-node N` (NCCL on GPUs, gloo with `--device cpu`); without
torchrun a one-rank group is made, so only `--shards 1` runs. N must be
the number of processes. Every rank optimises its shards of the state;
rank 0 alone prints and writes `--out-dir` (`summary.json` with the J
history); across more than one rank there are no checkpoints, archives
or figures (the state is sharded).

`--device-loop` runs the SD/CG/L-BFGS loop with its line search on the
device (`optim/jit_driver.py`, on CUDA graphs on a GPU); with
`--direction rtr`, the trust-region loop (`optim/jit_rtr.py`). A problem
whose `objective_and_gradient_aux` has an operand (mixing's operator
stacks; KDyn's empty one under df64) runs the loop on that form. Trust-region
Newton needs forward-mode derivatives of the gradient, which the CUDA
kernels' autograd Functions do not have: with `--direction rtr` a
`--method cuda` (given or the GPU default) becomes the same
discretisation's plain method (`matmul` for sh23 and shb23, `plain` for
kdyn), with a printed notice, as the JAX CLI substitutes its XLA path for
its Pallas kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__" and sys.argv[1:] == ["doctor"]:
    # the report starts its probes before this process imports torch,
    # which takes seconds and may be what is broken
    from spheremanopt_torch.utils.doctor import run_doctor

    sys.exit(0 if run_doctor()["cpu_ok"] else 1)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from spheremanopt_torch.convert import state_to_torch  # noqa: E402
from spheremanopt_torch.io.checkpoint import to_numpy  # noqa: E402
from spheremanopt_torch.problems.base import DTYPES  # noqa: E402

_METHODS = {"sh23": ("matmul", "fft", "cuda"), "shb23": ("matmul", "cuda"),
            "kdyn": ("plain", "cuda"), "mixing": ("plain",)}
# the JAX CLI's --precision names: df64 (kdyn, mixing) runs in float64;
# the others are TPU solve modes and are refused
_TPU_PRECISIONS = ("bfloat16", "compensated", "compensated2", "high",
                   "highest", "df64", "default")
_DF64_PROBLEMS = ("kdyn", "mixing")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="spheremanopt_torch.run",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("problem", choices=["sh23", "shb23", "kdyn", "mixing", "pca",
                                        "doctor"],
                    help="problem to run, or 'doctor' for an environment "
                         "report (CPU and GPU probes, compilers, caches)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out-dir", default="runs/latest")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="default: float32 for --method cuda, else float64")
    ap.add_argument("--method", default=None,
                    choices=sorted({m for ms in _METHODS.values() for m in ms}),
                    help="step method (sh23: matmul|fft|cuda, shb23: "
                         "matmul|cuda, kdyn: plain|cuda, mixing: plain; "
                         "default: cuda on a GPU in f32, else matmul, or "
                         "plain for kdyn and mixing)")
    ap.add_argument("--cost", choices=["Final", "Integrated"], default="Final",
                    help="kdyn cost functional")
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--err-tol", type=float, default=None)
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--ls", choices=["wolfe", "armijo"], default="wolfe")
    ap.add_argument("--sd", action="store_true", help="steepest descent (no CG)")
    ap.add_argument("--direction", choices=["sd", "cg", "lbfgs", "rtr"],
                    default=None,
                    help="search direction (default: cg, or sd with --sd; "
                         "lbfgs = Riemannian L-BFGS and rtr = trust-region "
                         "Newton with forward-over-reverse Hessian-vector "
                         "products, both beyond the reference)")
    ap.add_argument("--lbfgs-memory", type=int, default=8,
                    help="curvature-pair history length for --direction lbfgs")
    ap.add_argument("--tr-delta0", type=float, default=None,
                    help="rtr: initial trust radius (default: sphere "
                         "scale / 4)")
    ap.add_argument("--tr-max-cg", type=int, default=50,
                    help="rtr: cap on truncated-CG iterations per "
                         "subproblem")
    ap.add_argument("--device-loop", action="store_true",
                    help="run the optimisation loop on the device "
                         "(optim.jit_driver / optim.jit_rtr: CUDA graphs on "
                         "a GPU, one flag read per step)")
    ap.add_argument("--test-grad", action="store_true", help="Taylor test, then exit")
    ap.add_argument("--test-grad-eps", type=float, default=1e-4)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--adjoint", choices=["discrete", "continuous"],
                    default="discrete")
    ap.add_argument("--diag-stride", type=int, default=None,
                    help="energy-series cadence of the fused diagnostics "
                         "(sh23/shb23; any >= 1)")
    ap.add_argument("--npts", type=int, default=None,
                    help="sh23 Fourier modes / shb23 grid points / kdyn "
                         "modes per axis")
    ap.add_argument("--n-iters", type=int, default=None, help="time steps")
    ap.add_argument("--dt", type=float, default=None, help="time step")
    ap.add_argument("--dim", type=int, default=100, help="PCA dimension")
    ap.add_argument("--s", type=int, choices=[0, 1], default=1,
                    help="mixing objective: 0 time-averaged KE (maximised), "
                         "1 mix-norm (minimised)")
    ap.add_argument("--nx", type=int, default=None, help="mixing Fourier modes")
    ap.add_argument("--nz", type=int, default=None, help="mixing Chebyshev modes")
    ap.add_argument("--precision", choices=_TPU_PRECISIONS, default=None,
                    help="df64 (kdyn, mixing): the f32 problem's solves in "
                         "float64; the other names are the JAX package's "
                         "TPU solve modes, refused (use --dtype float64)")
    ap.add_argument("--df-adjoint", action="store_true",
                    help="df64 only: the JAX package's double-float reverse "
                         "sweep; here the same f64 sweep")
    ap.add_argument("--remat", choices=["step", "nested", "offload", "none"],
                    default=None,
                    help="kdyn trajectory memory of the plain method's "
                         "reverse sweep: per-step device remat | sqrt(N) "
                         "nested | pinned-host offload | store-all "
                         "(default: step)")
    ap.add_argument("--shards", type=int, default=0,
                    help="kdyn: 1-D slab distributed FFT over this many "
                         "processes (transform='distributed'; launch with "
                         "torchrun --nproc-per-node N)")
    ap.add_argument("--mesh-shape", default=None, metavar="PX,PY",
                    help="kdyn: 2-D pencil decomposition over a PX x PY "
                         "process mesh (overrides --shards)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the optimisation "
                         "here (trace.json, Chrome format)")
    ap.add_argument("--resume", default=None,
                    help="warm-start from a DAL_PROGRESS checkpoint (.npz, "
                         "or a reference-format DAL_PROGRESS.h5)")
    ap.add_argument("--regrid", action="store_true",
                    help="with --resume: re-express the saved state on this "
                         "config's grid (coarse-to-fine continuation)")
    ap.add_argument("--archive-every", type=int, default=0,
                    help="archive every N iterations (0 = off); by default "
                         "the histories and the iterate, no extra solve")
    ap.add_argument("--archive-full", action="store_true",
                    help="archive the full diagnostics (alone: every "
                         "iteration); from the optimisation's own solves "
                         "where the problem has a fused form, else a "
                         "re-run of diagnostics()")
    ap.add_argument("--no-archive", action="store_true",
                    help="no archives (--archive-every 0)")
    ap.add_argument("--h5", action="store_true",
                    help="also export the reference's h5 files "
                         "(DAL_PROGRESS.h5, scalar_data_s1.h5, "
                         "CheckPoints_s1.h5 and the Dedalus-layout "
                         "*_iter_0.h5) into --out-dir; needs h5py")
    ap.add_argument("--solve-steps", type=int, default=None,
                    help="forward-solve mode: advance the PDE state this "
                         "many steps (no optimisation) and save it")
    ap.add_argument("--state-in", default=None,
                    help="--solve-steps: start from this saved state")
    ap.add_argument("--state-out", default=None,
                    help="--solve-steps: where to save the state (default "
                         "<out-dir>/pde_state.npz)")
    return ap


def normalise_archive_flags(args) -> None:
    """--no-archive turns archiving off; --archive-full alone archives
    every iteration."""
    if args.no_archive:
        args.archive_every = 0
        args.archive_full = False
    elif args.archive_full and args.archive_every == 0:
        args.archive_every = 1


def set_precision() -> None:
    """Full-f32 matmuls and convolutions (no TF32), as every parity check
    against the JAX package assumes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_precision(args) -> None:
    """The JAX CLI's checks of --precision and --df-adjoint. With
    --direction rtr, df64 is dropped with a notice (its objective has no
    forward-mode rule in the JAX package; the same discretisation runs)."""
    if args.direction == "rtr" and args.precision == "df64":
        print(f"[{args.problem}] --direction rtr: the df64 Ozaki ops define "
              "reverse (custom_vjp) rules only in the JAX package - "
              "substituting the standard-precision objective for the "
              "trust-region path (same discretisation; RTR's rho acceptance "
              "needs no df64 Wolfe bracketing)", flush=True)
        args.precision = None
        args.df_adjoint = False   # rides the df64 mode being dropped
    if args.df_adjoint:
        if args.problem not in _DF64_PROBLEMS:
            raise SystemExit(
                "--df-adjoint applies to the df64 modes (mixing, kdyn) - "
                f"{args.problem} has no df64 mode")
        if args.precision != "df64":
            raise SystemExit("--df-adjoint requires --precision df64 (it is "
                             "the df64 mode's reverse-sweep option)")
    if args.precision is not None and (args.precision != "df64"
                                       or args.problem not in _DF64_PROBLEMS):
        raise SystemExit(f"--precision {args.precision}: the TPU's solve "
                         "modes (bf16 and compensated products) are not "
                         "ported, and df64 applies to kdyn and mixing; on "
                         "the H100 use --dtype float64 as the accuracy mode")


def make_problem(args, x0=None):
    """(problem, x0, defaults) for the parsed `args`. `x0` (a list of
    arrays, e.g. pinned inputs) replaces the seeded initial condition."""
    problem, defaults = build_problem(args)
    return problem, initial_point(problem, args, x0), defaults


def _device_dtype(problem):
    if hasattr(problem, "device"):
        return problem.device, problem.dtype
    return problem.m.device, problem.m.dtype   # PCA


def initial_point(problem, args, x0=None):
    """`x0` (a list of arrays) as tensors on the problem's device in its
    dtype, or the seeded initial condition when it is None."""
    if x0 is None:
        if args.problem != "pca":
            return problem.generate_ic(seed=args.seed)
        x0 = [np.random.RandomState(args.seed).rand(args.dim)]
    xs = state_to_torch(x0, *_device_dtype(problem))
    # distributed KDyn: this rank's shards of the full fields
    return problem.shard_state(xs) if hasattr(problem, "shard_state") else xs


def build_problem(args):
    """(problem, defaults) for the parsed `args`."""
    check_precision(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA GPU found (use --device cpu "
                         "to run on the CPU)")
    set_precision()
    device = torch.device(args.device)
    if sharded(args):
        device = _init_shards(args, device)
    if args.problem == "pca":
        from spheremanopt_torch.problems.pca import PCAProblem, random_spd_matrix

        dtype = DTYPES[args.dtype or "float64"]
        p = PCAProblem(random_spd_matrix(args.dim, seed=args.seed),
                       device=device, dtype=dtype)
        return p, dict(alpha=1.0, max_iters=2000)

    if args.problem == "mixing":
        return _make_mixing(args, device)
    method = args.method
    gpu_f32 = args.device == "cuda" and args.dtype in (None, "float32")
    if method is None:
        # df64 and the distributed transforms solve on the plain method
        # (the kernels are f32 matmul-transform integrators)
        method = ("cuda" if gpu_f32 and args.precision != "df64"
                  and not sharded(args) else _METHODS[args.problem][0])
    if method not in _METHODS[args.problem]:
        raise SystemExit(f"--method {method}: {args.problem} takes "
                         f"{'|'.join(_METHODS[args.problem])}")
    dtype = args.dtype or ("float32" if method == "cuda"
                           or (gpu_f32 and args.precision == "df64")
                           else "float64")
    if args.direction == "rtr" and method == "cuda":
        # RTR's Hessian-vector products are forward over reverse; the
        # kernels' autograd Functions define reverse rules only, so the
        # same discretisation's plain method serves the trust-region path
        method = _METHODS[args.problem][0]
        print(f"[{args.problem}] --direction rtr: the CUDA kernels define "
              "reverse (autograd.Function) rules only - substituting the "
              f"equivalent method={method!r} plain objective for the "
              "HVP-linearizable trust-region path (same discretisation)",
              flush=True)
    kw = dict(dtype=dtype, method=method)
    for name, val in (("npts", args.npts), ("n_iters", args.n_iters),
                      ("dt", args.dt)):
        if val is not None:
            kw[name] = val
    if args.problem == "kdyn":
        from spheremanopt_torch.problems.kinematic_dynamo import (
            KDynConfig, KinematicDynamo)

        kw.update(cost=args.cost, adjoint=args.adjoint)
        if args.precision == "df64":
            kw.update(solve_precision="df64", df_adjoint=args.df_adjoint)
        if args.remat is not None:
            kw["remat"] = False if args.remat == "none" else args.remat
        if args.mesh_shape is not None:
            kw.update(transform="distributed", mesh_shape=_mesh_shape(args))
        elif args.shards:
            kw.update(transform="distributed", n_shards=args.shards)
        return KinematicDynamo(KDynConfig(**kw), device=device), dict(
            alpha=100.0, max_iters=10)
    kw["adjoint"] = args.adjoint
    if args.diag_stride is not None:
        kw["diag_stride"] = args.diag_stride
    if args.problem == "shb23":
        from spheremanopt_torch.problems.swift_hohenberg_bounded import (
            SHB23Config, SwiftHohenbergBounded)

        p = SwiftHohenbergBounded(SHB23Config(**kw), device=device)
        defaults = dict(alpha=1.0, max_iters=50, err_tol=1e-5)
    else:
        from spheremanopt_torch.problems.swift_hohenberg import (
            SH23Config, SwiftHohenberg)

        p = SwiftHohenberg(SH23Config(**kw), device=device)
        defaults = dict(alpha=np.pi, max_iters=200)
    return p, defaults


def sharded(args) -> bool:
    """Whether `args` ask for the distributed transforms."""
    return bool(args.shards) or args.mesh_shape is not None


def _mesh_shape(args):
    try:
        px, py = (int(v) for v in args.mesh_shape.split(","))
    except ValueError:
        raise SystemExit(f"--mesh-shape {args.mesh_shape!r}: expected PX,PY")
    return px, py


def _init_shards(args, device):
    """The process group of a sharded run (torchrun's, or one rank), its
    size checked against --shards / --mesh-shape; this rank's device."""
    import torch.distributed as dist

    from spheremanopt_torch.parallel.mesh import init_distributed

    if args.problem != "kdyn":
        raise SystemExit("--shards / --mesh-shape apply to kdyn (its "
                         "distributed FFT transform)")
    want = (np.prod(_mesh_shape(args)) if args.mesh_shape is not None
            else args.shards)
    device = init_distributed(device)
    world = dist.get_world_size()
    if world != want:
        raise SystemExit(
            f"--{'mesh-shape' if args.mesh_shape else 'shards'}: {want} ranks "
            f"asked for, but {world} process(es) run; launch with torchrun "
            f"--nproc-per-node {want}")
    return device


def rank0() -> bool:
    """Whether this process is rank 0 (or the only process)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _make_mixing(args, device):
    from spheremanopt_torch.problems.optimal_mixing import (MixingConfig,
                                                            OptimalMixing)

    if args.method not in (None, "plain"):
        raise SystemExit(f"--method {args.method}: mixing takes plain")
    dtype = args.dtype or ("float32" if args.device == "cuda" else "float64")
    kw = dict(dtype=dtype, s=args.s, adjoint=args.adjoint)
    if args.precision == "df64":
        kw.update(solve_precision="df64", df_adjoint=args.df_adjoint)
    for name, val in (("nx", args.nx), ("nz", args.nz), ("dt", args.dt),
                      ("n_iters", args.n_iters)):
        if val is not None:
            kw[name] = val
    return OptimalMixing(MixingConfig(**kw), device=device), dict(
        alpha=100.0, max_iters=200)


def df64(problem) -> bool:
    """Whether `problem` runs its solves in df64 mode (f64 from f32)."""
    return getattr(problem, "_df", None) is not None


def loop_aux(problem):
    """The device loop's `aux` operand of `problem` (mixing's operator
    stacks, KDyn's empty dict under df64), or None."""
    pair = getattr(problem, "objective_and_gradient_aux", None)
    return None if pair is None else pair[1]


def _settings(defaults, args):
    """(err_tol, max_iters, alpha0): the CLI's values, else the problem's
    defaults."""
    return (args.err_tol if args.err_tol is not None
            else defaults.get("err_tol", 1e-6),
            args.max_iters if args.max_iters is not None
            else defaults["max_iters"],
            args.alpha if args.alpha is not None else defaults["alpha"])


def device_optimiser(problem, defaults, args, graphs=None):
    """The device loop's `optimise(x0_list)` for the parsed `args`:
    `jit_optimise_rtr` for `--direction rtr`, else
    `jit_optimise_on_multi_sphere`. Its CUDA graphs are captured at its
    first call and replayed at later calls. `graphs=False` runs the same
    steps eagerly (to hold the graphs against). A problem with
    `objective_and_gradient_aux` operand is called as `f(aux, xs)`, with
    the problem's `objective_ops` / `gradient_ops` as its J-only and
    gradient-only forms: pass `aux=loop_aux(problem)` to the returned
    optimiser. Its `sweep` runs the problem's native forms over rows where
    it has them (`problems.base.row_forms`)."""
    from spheremanopt_torch.problems.base import row_forms

    radii = problem.radii if hasattr(problem, "radii") else [1.0]
    err_tol, max_iters, alpha = _settings(defaults, args)
    with_aux = loop_aux(problem) is not None
    rows = row_forms(problem, aux=with_aux)
    if args.direction == "rtr":
        from spheremanopt_torch.optim.jit_rtr import jit_optimise_rtr

        return jit_optimise_rtr(
            problem.objective_ops if with_aux else problem.objective,
            problem.gradient_ops if with_aux else problem.gradient,
            problem.inner_product,
            radii, max_iters=max_iters, err_tol=err_tol,
            delta0=args.tr_delta0, max_cg=args.tr_max_cg, graphs=graphs,
            rows=rows)
    if args.direction == "lbfgs" and args.ls != "wolfe":
        raise SystemExit("--direction lbfgs needs --ls wolfe in the device "
                         "loop")
    from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere

    if with_aux:
        f_and_g, f = problem.objective_and_gradient_aux[0], problem.objective_ops
    else:
        f_and_g, f = getattr(problem, "objective_and_gradient", None), problem.objective
    if f_and_g is None:
        def f_and_g(xs):
            return problem.objective(xs), problem.gradient(xs)
    return jit_optimise_on_multi_sphere(
        f_and_g, problem.inner_product, radii, max_iters=max_iters,
        alpha0=float(alpha), err_tol=err_tol, cg=not args.sd,
        line_search=args.ls, direction=args.direction,
        lbfgs_memory=args.lbfgs_memory, f=f, graphs=graphs, rows=rows)


def make_archiver(problem, args):
    """The per-iteration archiver `main` runs for `args`, or None
    (`--archive-every 0`). `--archive-full` takes `FusedArchiver` where the
    problem has a fused-diagnostics form, and `IterationArchiver` (a re-run
    of `diagnostics`) where it has none, under df64 (whose objective is
    the f64 twin's) and under RTR (which calls the plain forms only);
    else `LightArchiver`."""
    from spheremanopt_torch.io.timeseries import (FusedArchiver,
                                                  IterationArchiver,
                                                  LightArchiver)

    if args.archive_every <= 0:
        return None
    if args.archive_full and (df64(problem) or args.direction == "rtr"):
        if not hasattr(problem, "diagnostics"):
            raise SystemExit("--archive-full needs problem.diagnostics on the "
                             "df64 and rtr paths")
        return IterationArchiver("diag", problem.diagnostics, args.out_dir)
    if args.archive_full and getattr(problem, "has_fused_diagnostics", False):
        return FusedArchiver("diag", problem, args.out_dir)
    if args.archive_full and hasattr(problem, "diagnostics"):
        return IterationArchiver("diag", problem.diagnostics, args.out_dir)
    return LightArchiver("progress", args.out_dir)


def optimise(problem, x0, defaults, args, graphs=None):
    """The optimisation exactly as `main` runs it: the host loop, or with
    `--device-loop` the device loop (a `JitOptResult`, or a
    `JitRTRResult` for `--direction rtr`; `graphs` as in
    `device_optimiser`). On the host loops, `args.archiver` (an archiver
    of `io.timeseries`, called every `args.archive_every` iterations; a
    `FusedArchiver` also supplies the objective forms) and
    `args.checkpoint_path` (written after every iteration) are used when
    present: `main` sets them, other callers need not. With
    `args.profile_dir`, the optimisation runs under `profiling.trace`."""
    if getattr(args, "profile_dir", None):
        from spheremanopt_torch.utils.profiling import trace

        with trace(args.profile_dir):
            return _optimise(problem, x0, defaults, args, graphs)
    return _optimise(problem, x0, defaults, args, graphs)


def _optimise(problem, x0, defaults, args, graphs):
    radii = problem.radii if hasattr(problem, "radii") else [1.0]
    err_tol, max_iters, alpha = _settings(defaults, args)
    if args.device_loop:
        return device_optimiser(problem, defaults, args, graphs)(
            x0, aux=loop_aux(problem))
    archiver = getattr(args, "archiver", None)
    callback = None
    if archiver is not None:
        every = max(1, getattr(args, "archive_every", 1))

        def callback(k, result):
            if k % every == 0:
                archiver(k, result)
    hooks = dict(callback=callback,
                 checkpoint_path=getattr(args, "checkpoint_path", None),
                 verbose=not args.quiet and rank0(),
                 log_path=(os.path.join(args.out_dir, "optimize_result.txt")
                           if rank0() else None))
    if args.direction == "rtr":
        from spheremanopt_torch.optim.rtr import optimise_rtr

        # trust-region Newton: no line search (--ls/--alpha unused)
        return optimise_rtr(
            x0, radii, problem.objective, problem.gradient,
            problem.inner_product, err_tol=err_tol, max_iters=max_iters,
            delta0=args.tr_delta0, max_cg=args.tr_max_cg, **hooks)

    from spheremanopt_torch.io.timeseries import FusedArchiver
    from spheremanopt_torch.optim.optimiser import optimise_on_multi_sphere

    if isinstance(archiver, FusedArchiver):
        # every solve of the run also gives its diagnostics
        f, grad_f, f_and_g = archiver.f, archiver.grad_f, archiver.f_and_g
    else:
        # df64: the host search compares J at f64 (the f32 scalar rounds
        # every trial to ~ulp(J))
        f = problem.objective_f64 if df64(problem) else problem.objective
        grad_f = problem.gradient
        f_and_g = getattr(problem, "objective_and_gradient", None)
    return optimise_on_multi_sphere(
        x0,
        radii,
        f,
        grad_f,
        problem.inner_product,
        err_tol=err_tol,
        max_iters=max_iters,
        alpha_k=alpha,
        line_search=args.ls,
        cg=not args.sd,
        method=args.direction,
        lbfgs_memory=args.lbfgs_memory,
        f_and_g=f_and_g,
        **hooks,
    )


def taylor_test(problem, x0, args):
    from spheremanopt_torch.grad.testgrad import adjoint_gradient_test

    if args.problem == "pca":
        dx0 = [torch.as_tensor(np.random.RandomState(args.seed + 1).rand(args.dim),
                               dtype=x0[0].dtype, device=x0[0].device)]
    else:
        dx0 = problem.generate_ic(seed=args.seed + 1)
    # df64: the f32 objective rounds J to ~ulp(J), which swamps the Taylor
    # increments; test against J at f64
    return adjoint_gradient_test(
        x0, dx0, problem.objective_f64 if df64(problem) else problem.objective,
        problem.gradient, problem.inner_product,
        epsilon=args.test_grad_eps, verbose=not args.quiet,
        save_path=os.path.join(args.out_dir, "eps_TestR_TestR2_h_h2.npy"))


def resume_point(problem, args):
    """x0 from the `--resume` checkpoint (a flat reference vector shaped
    to the problem's layout; with `--regrid` re-expressed on its grid)."""
    from spheremanopt_torch.io.checkpoint import load_progress_any
    from spheremanopt_torch.utils.regrid import regrid_state, reshape_flat_state

    loaded = load_progress_any(args.resume)
    try:
        xs = reshape_flat_state(problem, loaded.x_opt)
    except ValueError as e:
        raise SystemExit(f"--resume {args.resume}: {e}")
    print(f"[resume] warm-starting from iteration {loaded.iterations}")
    if args.regrid:
        shapes_in = [tuple(x.shape) for x in xs]
        xs = regrid_state(problem, xs)
        print(f"[resume] regridded {shapes_in} -> {[tuple(x.shape) for x in xs]}")
    return initial_point(problem, args, xs)


def solve_forward(problem, x0, args) -> dict:
    """`--solve-steps`: advance the PDE state from x0 (or `--state-in`) and
    save it; restartable, advance(s, a + b) == advance(advance(s, a), b)
    bit for bit (the reference's `IVP_FWD.load_state`,
    `FWD_Solve_SH23.py:459-460`)."""
    from spheremanopt_torch.io.checkpoint import load_pde_state, save_pde_state

    if not hasattr(problem, "advance_state"):
        raise SystemExit(f"--solve-steps: {args.problem} has no PDE state")
    if args.state_in:
        state_np, step0, _ = load_pde_state(args.state_in)
        device = _device_dtype(problem)[0]
        state = {k: torch.as_tensor(v, device=device) for k, v in state_np.items()}
    else:
        state, step0 = problem.initial_state(x0), 0
    state = problem.advance_state(state, args.solve_steps)
    step1 = step0 + args.solve_steps
    out_path = args.state_out or os.path.join(args.out_dir, "pde_state.npz")
    save_pde_state(out_path, state, step1, meta={"problem": args.problem})
    norms = {k: float(np.linalg.norm(to_numpy(v)))
             for k, v in problem.state_fields(state).items()}
    return {"mode": "forward-solve", "problem": args.problem,
            "from_step": step0, "to_step": step1, "state_path": out_path,
            "field_norms": norms}


def write_outputs(problem, result, args) -> dict:
    """`convergence.pdf`, the problem's figures and, with `--h5`, the
    reference's h5 files for a finished run (`result`: an OptimiseResult,
    or the device loop's record as one). Returns {kind: path}. Without
    matplotlib one line names the files not written; `--h5` without h5py
    raises ImportError."""
    import importlib.util

    from spheremanopt_torch.io.figures import PROBLEM_FIGURES, plot_energy_series
    from spheremanopt_torch.optim.plotting import plot_optimisation

    out = {}
    if importlib.util.find_spec("matplotlib") is None:
        figures = (args.problem in PROBLEM_FIGURES
                   or hasattr(problem, "diagnostics"))
        print(f"[{args.problem}] not written: convergence.pdf"
              + (f", the {args.problem} figures" if figures else "")
              + " (matplotlib is not installed)", flush=True)
    else:
        out["convergence"] = plot_optimisation(
            result, save_path=os.path.join(args.out_dir, "convergence.pdf"))
        if args.problem in PROBLEM_FIGURES:
            # the reference's per-problem figures (plot_figure_*.py)
            out["figures"] = PROBLEM_FIGURES[args.problem](
                problem, result.x_opt, args.out_dir)
        elif hasattr(problem, "diagnostics"):
            out["figures"] = [plot_energy_series(
                problem.diagnostics(result.x_opt),
                os.path.join(args.out_dir, "energy_series.pdf"))]
    if args.h5:
        from spheremanopt_torch.io.dedalus_export import export_dedalus_h5
        from spheremanopt_torch.io.h5compat import export_run_h5

        diag = (problem.diagnostics(result.x_opt)
                if hasattr(problem, "diagnostics") else {})
        paths = export_run_h5(args.out_dir, args.problem, result, diag)
        paths.update(export_dedalus_h5(args.out_dir, args.problem, problem,
                                       result, diag))
        out["h5"] = paths
        if not args.quiet:
            print("h5 exports:", json.dumps(paths))
    return out


def _loop_record(r, n_spheres):
    """The device loop's result as the host OptimiseResult's fields that
    the outputs read (histories cut to the iterations taken). The device
    loop counts no line-search trials: the evaluation counts are the
    iterations (a lower bound)."""
    import types

    k = int(r.iterations)
    res = to_numpy(r.residuals)
    return types.SimpleNamespace(
        iterations=k, x_opt=list(r.x_opt), n_components=len(r.x_opt),
        function_evals=k, gradient_evals=k,
        residuals=[res[:k, i] for i in range(n_spheres)],
        step_sizes=to_numpy(r.step_sizes)[:k],
        function_values=to_numpy(r.function_values)[:k])


def main(argv=None, x0=None, out=None) -> int:
    """The command line. In-process callers may pass `x0` (a list of
    arrays, in place of the seeded initial condition) and a dict `out`,
    which receives the run's problem, x0, result and archiver."""
    args = build_parser().parse_args(argv)
    if args.problem == "doctor":
        # diagnostics only: no problem, no CUDA in this process
        from spheremanopt_torch.utils.doctor import run_doctor

        return 0 if run_doctor()["cpu_ok"] else 1
    normalise_archive_flags(args)
    if args.regrid and not args.resume:
        raise SystemExit("--regrid requires --resume <state file>")
    if args.h5:
        from spheremanopt_torch.io.h5compat import _h5py

        _h5py()   # fail before the run, not after it
    out = {} if out is None else out
    t0 = time.time()
    problem, defaults = build_problem(args)
    many = world_size() > 1
    if many and (args.resume or args.archive_every or args.h5 or args.device_loop
                 or args.solve_steps is not None or args.test_grad):
        raise SystemExit(f"--shards over {world_size()} ranks: the host loop only "
                         "(no --resume, archives, --h5, --device-loop, "
                         "--solve-steps or --test-grad across ranks)")
    if rank0():
        os.makedirs(args.out_dir, exist_ok=True)
    if args.resume:
        x0 = resume_point(problem, args)
    elif x0 is not None or not (args.solve_steps is not None and args.state_in):
        x0 = initial_point(problem, args, x0)
    out.update(problem=problem, x0=x0)
    if rank0():
        print(f"[{args.problem}] setup {time.time()-t0:.1f}s on {args.device}"
              + (f" ({torch.cuda.get_device_name(0)})" if args.device == "cuda"
                 else "") + (f", {world_size()} ranks" if many else ""))

    if args.solve_steps is not None:
        print(json.dumps(solve_forward(problem, x0, args)))
        return 0

    if args.test_grad:
        r = taylor_test(problem, x0, args)
        ok = abs(r.gamma2 - 2.0) < 0.05 or (abs(r.gamma1 - 1.0) < 0.1
                                             and abs(r.gamma2 - 2.0) < 0.1)
        print(f"gradient test {'PASSED' if ok else 'FAILED'}")
        return 0 if ok else 1

    if args.device_loop:
        t0 = time.perf_counter()
        r = optimise(problem, x0, defaults, args)
        out["result"] = r
        k = int(r.iterations)
        summary = {
            "problem": args.problem,
            "device": args.device,
            "driver": ("device-resident (CUDA graphs)" if args.device == "cuda"
                       else "device-resident (eager steps)"),
            "iterations": k,
            # k == 0: history slot 0 holds its zero fill, not a result
            "J_final": float(r.function_values[k - 1]) if k > 0 else None,
            "residuals_final": (r.residuals[k - 1].tolist() if k > 0
                                else None),
            "wall_time_total_s": round(time.perf_counter() - t0, 3),
        }
        if hasattr(r, "converged"):   # JitRTRResult extras
            summary["converged"] = bool(r.converged)
            summary["trust_region_trials"] = int(r.trials)
            summary["hvp_evals"] = int(r.hvp_evals)
        with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        print(json.dumps(summary))
        n = len(problem.radii) if hasattr(problem, "radii") else 1
        out["outputs"] = write_outputs(problem, _loop_record(r, n), args)
        return 0

    archiver = args.archiver = out["archiver"] = make_archiver(problem, args)
    args.checkpoint_path = (None if many
                            else os.path.join(args.out_dir, "DAL_PROGRESS.npz"))
    t0 = time.perf_counter()
    res = optimise(problem, x0, defaults, args)
    if hasattr(archiver, "flush"):
        archiver.flush()   # the archive writes have landed
    wall = time.perf_counter() - t0
    out["result"] = res
    if many:
        # every rank made the same decisions; rank 0 reports them
        if not rank0():
            return 0
        print(f"[{args.problem}] {world_size()} ranks: no checkpoint, archive "
              "or figures (the state is sharded)", flush=True)
    else:
        out["outputs"] = write_outputs(problem, res, args)
    summary = {
        "problem": args.problem,
        "device": args.device,
        "config": (dict(problem.cfg.__dict__) if hasattr(problem, "cfg")
                   else {"dim": args.dim}),
        "iterations": res.iterations,
        "converged": res.converged,
        "message": res.message,
        "J_final": res.function_values[-1] if res.function_values else None,
        "function_values": list(res.function_values),
        "residuals_final": [r[-1] for r in res.residuals if r],
        "wall_time_total_s": round(sum(res.wall_times), 3),
        # the loop with its callbacks and checkpoints, archive writes flushed
        "optimise_wall_s": wall,
    }
    if archiver is not None:
        summary["archive"] = {
            "kind": type(archiver).__name__, "every": args.archive_every,
            "files": len(archiver.paths),
            "fallback_recomputes": getattr(archiver, "fallback_recomputes", None)}
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
