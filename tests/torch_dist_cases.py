"""A world of local gloo worker processes (`LocalWorld`) and the cases
that run on each of its ranks, for the port's sharding tests
(`test_torch_parallel.py`, `test_torch_sharded.py`,
`test_torch_regrid.py`, `test_torch_examples_dist.py`), and
`load_example`, which the example tests share.

`LocalWorld(P, store_dir)` starts P spawned processes, kept for many
calls; `world.run(fn, *args)` runs `fn(*args)` on every rank and returns
the ranks' results in rank order. Each worker sets one intra-op thread
and joins a gloo group through a `file://` store in `store_dir`, so
worlds of parallel test workers never compete for a TCP port. An
exception in a rank, a rank that dies or a call that outlasts the
timeout tears the world down and raises in the caller.

The workers import this module, so it imports torch and the port only:
the JAX side of each comparison runs in the pytest process and reaches
the workers as numpy arrays. Each case returns numpy results (full
arrays, gathered where the port holds shards) for the test to compare.
"""

from __future__ import annotations

import os
import queue
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, Replicate, Shard

from spheremanopt_torch.parallel import fft as pf
from spheremanopt_torch.parallel.mesh import make_mesh, make_mesh2d, shard_fields


def _worker(rank: int, world: int, store: str, inq, outq, threads: int):
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        while True:
            item = inq.get()
            if item is None:
                break
            fn, args = item
            try:
                outq.put((rank, True, fn(*args)))
            except Exception:  # noqa: BLE001 - reported to the caller
                outq.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class LocalWorld:
    def __init__(self, n: int, store_dir: str, timeout_s: float = 300.0,
                 threads: int = 1):
        self.n, self.timeout_s = n, timeout_s
        ctx = mp.get_context("spawn")
        store = os.path.join(store_dir, f"store_{n}_{os.getpid()}")
        self.inqs = [ctx.Queue() for _ in range(n)]
        self.outq = ctx.Queue()
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, n, store, self.inqs[r], self.outq, threads))
                      for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args):
        """`fn(*args)` on every rank; the results in rank order."""
        if not self.procs:
            raise RuntimeError("LocalWorld: closed")
        for q in self.inqs:
            q.put((fn, args))
        outs, got = [None] * self.n, 0
        deadline = time.monotonic() + self.timeout_s
        while got < self.n:
            try:
                rank, ok, val = self.outq.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self.procs) if p.exitcode is not None]
                late = time.monotonic() > deadline
                if dead or late:
                    self.close(force=True)
                    raise RuntimeError(
                        f"LocalWorld: {fn.__name__}: rank(s) {dead} exited"
                        if dead else f"LocalWorld: {fn.__name__} did not return "
                        f"on all {self.n} ranks within {self.timeout_s:.0f} s")
                continue
            if not ok:
                self.close(force=True)
                raise RuntimeError(f"rank {rank} of {self.n} raised:\n{val}")
            outs[rank], got = val, got + 1
        return outs

    def close(self, force: bool = False):
        if not self.procs:
            return
        if not force:
            for q in self.inqs:
                q.put(None)
            for p in self.procs:
                p.join(timeout=30)
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self.procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(force=exc[0] is not None)


def _np(xs):
    return [x.detach().cpu().numpy() for x in xs]


def _slab(v, dim=-3):
    """This rank's block of `v` along `dim` (a 1-D slab of the world)."""
    p, r = dist.get_world_size(), dist.get_rank()
    b = v.shape[dim] // p
    return v.narrow(dim % v.dim(), r * b, b)


def _pencil(v, mesh):
    """This rank's (X, Y) block of `v` on a 2-D mesh."""
    (ix, iy), (px, py) = mesh.get_coordinate(), mesh.shape
    v = v.narrow(v.dim() - 3, ix * (v.shape[-3] // px), v.shape[-3] // px)
    return v.narrow(v.dim() - 2, iy * (v.shape[-2] // py), v.shape[-2] // py)


def _gather(x, mesh, placements):
    return DTensor.from_local(x.contiguous(), mesh, placements,
                              run_check=False).full_tensor()


def _sharded_like(x, x0):
    """Whether DTensor `x` has DTensor `x0`'s mesh and placements."""
    return (isinstance(x, DTensor) and x.device_mesh == x0.device_mesh
            and tuple(x.placements) == tuple(x0.placements)
            and x.device_mesh.size() == dist.get_world_size())


# ---------------------------------------------------------------------------
# the distributed FFTs and the mesh (test_torch_parallel.py)
# ---------------------------------------------------------------------------


def slab_fft(v):
    """rfftn and its inverse of full `v` sharded over X: the gathered
    coefficients (sharded over Y) and round trip."""
    mesh = make_mesh()
    t = torch.as_tensor(v)
    c = pf.distributed_rfftn(_slab(t), mesh)
    back = pf.distributed_irfftn(c, mesh, n_z=v.shape[-1])
    nd = c.dim()
    return (_gather(c, mesh, (Shard(nd - 2),)).numpy(),
            _gather(back, mesh, (Shard(nd - 3),)).numpy(), tuple(c.shape))


def pencil_fft(px, py, v):
    """The same on a px x py mesh: the coefficients gathered (Y sharded
    jointly, axes[1] major) and the round trip."""
    mesh = make_mesh2d(px, py)
    t = torch.as_tensor(v)
    c = pf.distributed_rfftn_2d(_pencil(t, mesh), mesh)
    back = pf.distributed_irfftn_2d(c, mesh, n_z=v.shape[-1])
    ix, iy = mesh.get_coordinate()
    return (ix, iy), c.numpy(), back.numpy()


def pencil_indivisible(px, py):
    """X = Y = 2 px py - 2: not divisible by px*py; the message."""
    mesh = make_mesh2d(px, py)
    n = 2 * px * py - 2
    try:
        pf.distributed_rfftn_2d(torch.zeros(n // px, n // py, n), mesh)
    except ValueError as e:
        return str(e)
    return None


def mean_product(x, y):
    mesh = make_mesh()
    xs, ys = shard_fields(mesh, [x, y], sharded_dim=0)
    return float(pf.distributed_mean_product(xs.to_local(), ys.to_local(), mesh))


def energy_gradient(v):
    """d/dv sum |rfftn(v)|^2 through the distributed transform, gathered."""
    mesh = make_mesh()
    vl = _slab(torch.as_tensor(v)).clone().requires_grad_(True)
    c = pf.distributed_rfftn(vl, mesh)
    e = pf.sum_over_ranks(torch.sum(c.real ** 2 + c.imag ** 2))
    e.backward()
    return _gather(vl.grad, mesh, (Shard(0),)).numpy()


def _global(f, mesh, in_pl, out_pl):
    """`f` of this rank's shards as a function of full tensors that every
    rank holds: the input cut to shards (whose backward gathers the
    gradient), the output gathered (whose backward cuts it)."""
    def F(x):
        d = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim).redistribute(mesh, in_pl)
        return DTensor.from_local(f(d.to_local()), mesh, out_pl).full_tensor()
    return F


def gradchecks(pencil):
    """torch.autograd.gradcheck (f64, fast mode: random projections of
    the Jacobian) of the forward and inverse transforms as functions of
    the whole field."""
    rng = np.random.RandomState(5)
    n = 4
    v = torch.as_tensor(rng.randn(n, n, 3)).requires_grad_(True)
    c = torch.as_tensor(np.fft.rfftn(rng.randn(n, n, 3))).requires_grad_(True)
    if pencil:
        mesh = make_mesh2d(2, 2)
        fwd = _global(lambda x: pf.distributed_rfftn_2d(x, mesh), mesh,
                      [Shard(0), Shard(1)], [Shard(1), Shard(1)])
        inv = _global(lambda x: pf.distributed_irfftn_2d(x, mesh, n_z=3), mesh,
                      [Shard(1), Shard(1)], [Shard(0), Shard(1)])
    else:
        mesh = make_mesh()
        fwd = _global(lambda x: pf.distributed_rfftn(x, mesh), mesh, [Shard(0)], [Shard(1)])
        inv = _global(lambda x: pf.distributed_irfftn(x, mesh, n_z=3), mesh,
                      [Shard(1)], [Shard(0)])
    kw = dict(check_undefined_grad=False, fast_mode=True)
    return (torch.autograd.gradcheck(fwd, (v,), **kw),
            torch.autograd.gradcheck(inv, (c,), **kw))


def mesh_errors():
    """The messages of a mesh larger than the world, 1-D and 2-D, and the
    placements of `field_sharding` and `replicated` on the world's mesh."""
    from spheremanopt_torch.parallel.mesh import field_sharding, replicated

    w = dist.get_world_size()
    out = []
    for make in (lambda: make_mesh(w + 1), lambda: make_mesh2d(w, 2)):
        try:
            make()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    mesh = make_mesh()
    return out + [str(field_sharding(mesh, 4, -3)), str(replicated(mesh))]


def kdyn_distributed(x0, npts, mesh_shape, remat, n_iters=5, project=True):
    """KDyn transform="distributed" (slab over the world, or a pencil)
    against the one-process matmul transform, f64, at the numpy state
    `x0` (None: both problems' own seeded initial conditions, compared):
    (J matmul, J distributed, gradients matmul, gradients distributed
    gathered, IC difference)."""
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    cfg = dict(npts=npts, n_iters=n_iters, dt=1e-3, dtype="float64",
               remat=remat, project_gradients=project)
    pm = KinematicDynamo(KDynConfig(**cfg), device="cpu")
    pd = KinematicDynamo(KDynConfig(transform="distributed", mesh_shape=mesh_shape,
                                    **cfg), device="cpu")
    ic = None
    if x0 is None:
        xm = pm.generate_ic(seed=11)
        ic = max(float((a - b).abs().max() / b.abs().max())
                 for a, b in zip(pd.gather_state(pd.generate_ic(seed=11)), xm))
        x0 = _np(xm)
    xs = [torch.as_tensor(x) for x in x0]
    Jm, gm = pm.objective_and_gradient(xs)
    Jd, gd = pd.objective_and_gradient(pd.shard_state(xs))
    return float(Jm), float(Jd), _np(gm), _np(pd.gather_state(gd)), ic


# ---------------------------------------------------------------------------
# sharded state with the operators replicated (test_torch_sharded.py)
# ---------------------------------------------------------------------------


def _kdyn(**kw):
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    cfg = dict(npts=8, n_iters=5, dt=1e-3, dtype="float64", remat=True)
    cfg.update(kw)
    return KinematicDynamo(KDynConfig(**cfg), device="cpu")


def _mixing(**kw):
    from spheremanopt_torch.problems.optimal_mixing import MixingConfig, OptimalMixing

    return OptimalMixing(MixingConfig(**kw), device="cpu")


def _shb23():
    from spheremanopt_torch.problems.swift_hohenberg_bounded import (
        SHB23Config, SwiftHohenbergBounded)

    return SwiftHohenbergBounded(SHB23Config(npts=64, n_iters=40, dt=0.01), device="cpu")


def _loop_record(r):
    k = int(r.iterations)
    return dict(J=r.function_values.numpy()[:k], a=r.step_sizes.numpy()[:k], k=k)


def _run_pair(opt, x0, sharded_dim, aux=None):
    """The device loop `opt` from plain x0 and from x0 sharded over the
    world (Shard(sharded_dim)): both records, the sharded x_opt gathered,
    whether it kept x0's placements."""
    r1 = opt([torch.as_tensor(x) for x in x0], aux=aux)
    xs = shard_fields(make_mesh(), x0, sharded_dim)
    rP = opt(xs, aux=aux)
    kept = all(_sharded_like(x, x0_) for x, x0_ in zip(rP.x_opt, xs))
    return (_loop_record(r1), _np(r1.x_opt), _loop_record(rP),
            _np([x.full_tensor() for x in rP.x_opt]), kept)


def kdyn_loop(x0, direction):
    """KDyn matmul f64 on the device loop (eager steps on the CPU), one
    process and the state sharded over X: CG (armijo, alpha0 0.5, 10
    iterations) or L-BFGS (Wolfe, alpha0 10, 6). Also the spheres' constraints of the sharded x_opt."""
    from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere

    p = _kdyn()
    if direction == "cg":
        opt = jit_optimise_on_multi_sphere(
            p.objective_and_gradient, p.inner_product, p.radii,
            max_iters=10, alpha0=0.5, cg=True, err_tol=1e-12)
    else:
        opt = jit_optimise_on_multi_sphere(
            p.objective_and_gradient, p.inner_product, p.radii,
            max_iters=6, alpha0=10.0, line_search="wolfe", direction="lbfgs",
            err_tol=1e-12)
    out = _run_pair(opt, x0, 1)
    ips = [float(p.inner_product(torch.as_tensor(x), torch.as_tensor(x))) for x in out[3]]
    return out + (ips, p.radii)


def kdyn_host_loop(x0):
    """The host loop (Wolfe + CG, alpha0 10, 3 iterations) from plain and
    sharded x0."""
    from spheremanopt_torch.optim.optimiser import optimise_on_multi_sphere

    p = _kdyn()
    kw = dict(max_iters=3, alpha_k=10.0, f_and_g=p.objective_and_gradient, verbose=False)
    r1 = optimise_on_multi_sphere([torch.as_tensor(x) for x in x0], p.radii, p.objective,
                                  p.gradient, p.inner_product, **kw)
    xs = shard_fields(make_mesh(), x0, 1)
    rP = optimise_on_multi_sphere(xs, p.radii, p.objective, p.gradient, p.inner_product,
                                  **kw)
    kept = all(_sharded_like(x, x0_) for x, x0_ in zip(rP.x_opt, xs))
    return r1.function_values, rP.function_values, kept


def kdyn_gradient(x0):
    """The fused objective and gradient, one process and through
    `on_mesh` with the state sharded over X."""
    p = _kdyn()
    J1, g1 = p.objective_and_gradient([torch.as_tensor(x) for x in x0])
    mesh = make_mesh()
    xs = shard_fields(mesh, x0, 1)
    JP, gP = p.on_mesh(mesh).objective_and_gradient(xs)
    kept = all(_sharded_like(g, x) for g, x in zip(gP, xs))
    return float(J1), _np(g1), float(JP), _np([g.full_tensor() for g in gP]), kept


def mixing_loop(x0):
    """Mixing (nx 32, nz 16, N 20, s 1) on the device loop, Wolfe + CG,
    5 iterations, its operator stacks the loop's aux operand: one process
    and the grid state sharded over x (axis 1)."""
    from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere

    p = _mixing(nx=32, nz=16, n_iters=20, prep_steps=5, s=1)
    fg, ops = p.objective_and_gradient_aux
    opt = jit_optimise_on_multi_sphere(fg, p.inner_product, p.radii, max_iters=5,
                                       alpha0=10.0, cg=True, line_search="wolfe")
    out = _run_pair(opt, x0, 1, aux=ops)
    ip = float(p.inner_product(torch.as_tensor(out[3][0]), torch.as_tensor(out[3][0])))
    return out + (ip, p.radii)


def mixing_gradient_dims(x0, cfg, dims):
    """The aux-form objective and gradient with the state sharded over
    each of `dims` (x: 1, Chebyshev z: 2), against one process."""
    p = _mixing(**cfg)
    fg, ops = p.objective_and_gradient_aux
    J1, g1 = fg(ops, [torch.as_tensor(x0[0])])
    mesh = make_mesh()
    fgP, opsP = p.on_mesh(mesh).objective_and_gradient_aux
    out = []
    for d in dims:
        xs = shard_fields(mesh, x0, d)
        JP, gP = fgP(opsP, xs)
        out.append((d, float(JP), gP[0].full_tensor().numpy(), _sharded_like(gP[0], xs[0]),
                    tuple(gP[0].to_local().shape)))
    return float(J1), g1[0].numpy(), out


def mixing_df64(x0):
    """Mixing df64 (the f32 problem's f64 solves): one process and the
    state sharded over x."""
    p = _mixing(nx=32, nz=16, n_iters=20, prep_steps=5, s=1, dtype="float32",
                solve_precision="df64")
    fg, ops = p.objective_and_gradient_aux
    J1, g1 = fg(ops, [torch.as_tensor(x0[0])])
    mesh = make_mesh()
    xs = shard_fields(mesh, x0, 1)
    fgP, opsP = p.on_mesh(mesh).objective_and_gradient_aux
    JP, gP = fgP(opsP, xs)
    return (float(J1), g1[0].numpy(), float(JP), gP[0].full_tensor().numpy(),
            _sharded_like(gP[0], xs[0]))


def kdyn_df64(x0):
    """KDyn df64 (npts 8, N 10, f32 state): one process and sharded."""
    p = _kdyn(n_iters=10, dtype="float32", solve_precision="df64")
    fg, ops = p.objective_and_gradient_aux
    J1, g1 = fg(ops, [torch.as_tensor(x) for x in x0])
    mesh = make_mesh()
    xs = shard_fields(mesh, x0, 1)
    fgP, opsP = p.on_mesh(mesh).objective_and_gradient_aux
    JP, gP = fgP(opsP, xs)
    return (ops, float(J1), _np(g1), float(JP), _np([g.full_tensor() for g in gP]),
            all(_sharded_like(g, x) for g, x in zip(gP, xs)))


def shb23_gradient(x0):
    """SHB23 (npts 64, N 40): the grid vector sharded over the world."""
    p = _shb23()
    J1, g1 = p.objective_and_gradient([torch.as_tensor(x0[0])])
    mesh = make_mesh()
    xs = shard_fields(mesh, x0, 0)
    JP, gP = p.on_mesh(mesh).objective_and_gradient(xs)
    return (float(J1), g1[0].numpy(), float(JP), gP[0].full_tensor().numpy(),
            _sharded_like(gP[0], xs[0]))


def shb23_loop(x0):
    """SHB23 on the device loop (Wolfe + CG, 6 iterations), one process and
    the grid vector sharded."""
    from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere

    p = _shb23()
    opt = jit_optimise_on_multi_sphere(
        p.objective_and_gradient, p.inner_product, p.radii, max_iters=6,
        alpha0=1.0, line_search="wolfe", cg=True)
    return _run_pair(opt, x0, 0)


def kdyn_nested_distributed(x0, npts, mesh_shape):
    """remat="nested" with transform="distributed" (slab over the world,
    or a pencil; N 9) against the matmul transform with step remat."""
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    cfg = dict(npts=npts, n_iters=9, dt=1e-3, dtype="float64")
    pm = KinematicDynamo(KDynConfig(transform="matmul", remat=True, **cfg), device="cpu")
    pd = KinematicDynamo(KDynConfig(transform="distributed", mesh_shape=mesh_shape,
                                    remat="nested", **cfg), device="cpu")
    xs = [torch.as_tensor(x) for x in x0]
    Jm, gm = pm.objective_and_gradient(xs)
    local = pd.shard_state(xs)
    Jd, gd = pd.objective_and_gradient(local)
    same_shape = all(g.shape == x.shape for g, x in zip(gd, local))
    return float(Jm), _np(gm), float(Jd), _np(pd.gather_state(gd)), same_shape


def pencil_loop(x0):
    """The device loop (Wolfe + CG, 6 iterations) on KDyn with the 2 x 2
    pencil transform (each rank its shards) against the matmul problem
    on one process."""
    from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere

    def build(p):
        return jit_optimise_on_multi_sphere(
            p.objective_and_gradient, p.inner_product, p.radii, max_iters=6,
            alpha0=1.0, line_search="wolfe", cg=True)

    p1 = _kdyn()
    p2 = _kdyn(transform="distributed", mesh_shape=(2, 2))
    xs = [torch.as_tensor(x) for x in x0]
    r1 = build(p1)(xs)
    r2 = build(p2)(p2.shard_state(xs))
    return _loop_record(r1), _loop_record(r2), _np(p2.gather_state(r2.x_opt))


def _comm_names(cm):
    """A CommDebugMode's counts keyed by the collectives' short names."""
    return {str(k).split("'")[1 if "'" in str(k) else 0].split(".")[-1]: v
            for k, v in cm.get_comm_counts().items()}


def comm_counts(x0_kdyn, x0_shb, x0_mix, npts_dist):
    """CommDebugMode counts of one fwd+grad of each sharded problem (the
    state sharded over the world) and of the distributed KDyn transform."""
    from torch.distributed.tensor.debug import CommDebugMode

    mesh = make_mesh()
    out = {}

    def count(name, fn):
        with CommDebugMode() as cm:
            fn()
        out[name] = _comm_names(cm)

    pk = _kdyn()
    count("kdyn_matmul_sharded", lambda: pk.on_mesh(mesh).objective_and_gradient(
        shard_fields(mesh, x0_kdyn, 1)))
    ps = _shb23()
    count("shb23_sharded", lambda: ps.on_mesh(mesh).objective_and_gradient(
        shard_fields(mesh, x0_shb, 0)))
    pm = _mixing(nx=32, nz=16, n_iters=20, prep_steps=5, s=1)
    fg, ops = pm.on_mesh(mesh).objective_and_gradient_aux
    count("mixing_sharded_x", lambda: fg(ops, shard_fields(mesh, x0_mix, 1)))
    pd = _kdyn(npts=npts_dist, transform="distributed")
    xd = pd.shard_state([torch.as_tensor(x) for x in pd.gather_state(pd.generate_ic(seed=1))])
    count("kdyn_distributed", lambda: pd.objective_and_gradient(xd))
    return out


def loop_comm_counts(x0_kdyn):
    """CommDebugMode counts of a host loop (3 iterations) and a device loop
    (2 iterations) of KDyn matmul from x0 sharded over X: the loops gather
    the state once at entry and cut x_opt back to shards without sending."""
    from torch.distributed.tensor.debug import CommDebugMode

    from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
    from spheremanopt_torch.optim.optimiser import optimise_on_multi_sphere

    mesh, p = make_mesh(), _kdyn()
    out = {}
    runs = {
        "host": lambda xs: optimise_on_multi_sphere(
            xs, p.radii, p.objective, p.gradient, p.inner_product, max_iters=3,
            alpha_k=10.0, f_and_g=p.objective_and_gradient, verbose=False),
        "device": jit_optimise_on_multi_sphere(
            p.objective_and_gradient, p.inner_product, p.radii, max_iters=2,
            alpha0=10.0, cg=True, line_search="wolfe"),
    }
    for name, run in runs.items():
        xs = shard_fields(mesh, x0_kdyn, 1)
        with CommDebugMode() as cm:
            r = run(xs)
        out[name] = (_comm_names(cm),
                     int(r.iterations), all(_sharded_like(x, x0_) for x, x0_ in zip(r.x_opt, xs)))
    return out


# ---------------------------------------------------------------------------
# regrid onto a distributed target (test_torch_regrid.py)
# ---------------------------------------------------------------------------


def regrid_distributed_target(x_coarse):
    """A coarse fft-config KDyn state regridded onto a distributed target
    (npts 16, slab over the world) and onto a matmul target: the full
    outputs, and J of each at its regridded state."""
    from spheremanopt_torch.utils.regrid import regrid_state

    pd = _kdyn(npts=16, n_iters=4, transform="distributed")
    pm = _kdyn(npts=16, n_iters=4, transform="fft")
    xd = regrid_state(pd, x_coarse)
    xm = regrid_state(pm, x_coarse)
    Jd = float(pd.objective(pd.shard_state([torch.as_tensor(x) for x in xd])))
    Jm = float(pm.objective([torch.as_tensor(x) for x in xm]))
    return xd, xm, Jd, Jm, pd.mg


def load_example(name):
    """The module `examples/torch_<name>.py` (the examples are scripts,
    not a package)."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(root, "examples", f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_case(name, argv, x0):
    """`examples/torch_<name>.py`'s `main(argv, x0=x0)` on this rank:
    (its return value, the JSON object of its last output line or None
    where the rank printed none, its full x_opt)."""
    import contextlib
    import io
    import json

    buf, out = io.StringIO(), {}
    with contextlib.redirect_stdout(buf):
        ret = load_example(name).main(argv, x0=x0, out=out)
    lines = buf.getvalue().strip().splitlines()
    return ret, (json.loads(lines[-1]) if lines else None), out["x_opt"]
