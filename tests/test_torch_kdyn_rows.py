"""KDyn row kernels: R sweeps of one constant pack in one launch of each
kernel (the port of the JAX package's `jax.vmap` over the three
`pallas_call`s of `ops/pallas/kdyn_step.py`, where `pallas_call`'s
batching rule gives each kernel a grid over the rows).

  `run_forward_rows`, `run_fwd_traj_rows`, `run_bwd_rows`,
  `FusedEnergyRows`, KDyn `cuda` `row_forms`

CPU cases (npts 8 on the 12^3 grid, N = 10 steps at dt = 1e-3; on the
CPU the wrappers run their plain row versions, which take a row at a
time):
  * the f32 `cuda` row forms against `jax.vmap` of the JAX problem's
    `method="pallas"` `objective_and_gradient` (interpret mode), 3 rows,
    both costs: J rel 1e-5, gradients rel 5e-5
    (`tests/test_torch_kdyn_kernel.py`'s limits: the same f32 recurrence,
    sums in another order);
  * every row of the row forms (J, gradient, J only, gradient only, inner
    product) bitwise the port's unbatched call on that row, and the plain
    row versions bitwise the one-row plain versions row by row;
  * a device-loop sweep of 2 rows, 2 Wolfe + CG iterations, each row
    bitwise its unbatched run; the CLI's and the server's optimisers take
    the native rows;
  * `row_forms` None for the aux forms, the continuous adjoint, df64,
    "plain" and the distributed transform (their sweeps run one row at a
    time);
  * the wrappers refuse operands without a row axis, on the CPU too.
The card cases (`requires_cuda`; this module imports JAX only inside the
CPU cases that need it):

    python -m pytest --noconftest -m requires_cuda tests/test_torch_kdyn_rows.py

hold each row of the three row kernels bitwise the one-row kernels at
R = 1, 2, 3, 4, 5, 8, 11, at npts 8 and at the 24^3 width, both costs; the rows
against the plain rows in f32 (rel 1e-4 at 40 steps); a call past
ROWS_MAX rows in chunks; a CUDA graph of the row Function replayed
bitwise; the `cuda` row forms at full width and R = 8 bitwise the
unbatched calls; and a device-loop sweep on the card bitwise its
unbatched runs, the warm sweep launching the row kernels only.
"""

import re

import numpy as np
import pytest
import torch

from spheremanopt_torch.ops.cuda import build as kbuild
from spheremanopt_torch.ops.cuda import kdyn_step as kd
from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere as t_jit
from spheremanopt_torch.problems.base import row_forms
from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

NPTS, N, DT = 8, 10, 1e-3
COSTS = ["Final", "Integrated"]
ONE_ROW = ("kdyn_fwd", "kdyn_fwd_traj", "kdyn_bwd")
ROW_KERNELS = ("kdyn_fwd_rows", "kdyn_fwd_traj_rows", "kdyn_bwd_rows")


@pytest.fixture
def one_thread():
    """Long loops of small products: one intra-op thread, so several test
    workers on one host do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _problem(cost="Final", device="cpu", **kw):
    cfg = dict(npts=NPTS, n_iters=N, dt=DT, dtype="float32", method="cuda", cost=cost)
    cfg.update(kw)
    return KinematicDynamo(KDynConfig(**cfg), device=device)


def _rows(p, seeds):
    """[B0 (R, 3, mg, mg, mg), U (R, ...)] from `generate_ic` with numpy
    noise drawn from each seed, and the per-row initial conditions."""
    shape = (p.mg,) * 3
    ics = []
    for s in seeds:
        rs = np.random.RandomState(s)
        ics.append(p.generate_ic(noise=(rs.randn(*shape), rs.randn(*shape))))
    return [torch.stack([ic[j] for ic in ics]) for j in range(2)], ics


@pytest.fixture(scope="module")
def rows3():
    """Three rows of f32 KDyn states as numpy (one set for both costs)."""
    X, _ = _rows(_problem(), (3, 4, 5))
    return [x.numpy() for x in X]


# ---------------------------------------------------------------------------
# the f32 row forms against jax.vmap of the Pallas objective (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cost", COSTS)
def test_cuda_row_forms_match_jax_vmap_of_pallas(rows3, cost, one_thread):
    import jax
    import jax.numpy as jnp

    from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig as JConfig
    from spheremanopt_tpu.problems.kinematic_dynamo import KinematicDynamo as JKDyn

    p = _problem(cost)
    forms = row_forms(p)
    assert forms is not None
    X = [torch.as_tensor(x) for x in rows3]
    kd.reset_launches()
    J, g = forms.f_and_g(X)
    assert not any(kd.LAUNCHES.values())
    jp = JKDyn(JConfig(npts=NPTS, n_iters=N, dt=DT, dtype="float32", method="pallas",
                       cost=cost))
    Jj, gj = jax.vmap(lambda b, u: jp.objective_and_gradient([b, u]))(
        *(jnp.asarray(x) for x in rows3))
    assert J.dtype == torch.float32 and J.shape == (3,)
    for r in range(3):
        assert abs(float(J[r]) - float(Jj[r])) <= 1e-5 * abs(float(Jj[r])), r
        for a, b in zip(g, gj):
            assert _rel(a[r], np.asarray(b)[r]) <= 5e-5, r


# ---------------------------------------------------------------------------
# rows bitwise the unbatched calls (CPU: the plain versions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cost", COSTS)
def test_row_forms_rows_bitwise_unbatched(rows3, cost, one_thread):
    """J, the gradient of both spheres, J only, the gradient only and the
    inner products of the row forms: every row bitwise the unbatched call."""
    p = _problem(cost)
    forms = row_forms(p)
    X = [torch.as_tensor(x) for x in rows3]
    Y = [x.flip(0) for x in X]
    J, g = forms.f_and_g(X)
    f = forms.f(X)
    g2 = forms.grad(X)
    ips = [forms.inner_product(x, y) for x, y in zip(X, Y)]
    for r in range(3):
        xr = [x[r] for x in X]
        J1, g1 = p.objective_and_gradient(xr)
        assert torch.equal(J[r], J1) and torch.equal(f[r], p.objective(xr)), r
        for a, b, c in zip(g, g2, g1):
            assert torch.equal(a[r], c) and torch.equal(b[r], c), r
        for ip, x, y in zip(ips, X, Y):
            assert torch.equal(ip[r], p.inner_product(x[r], y[r])), r


@pytest.mark.parametrize("integrated", [False, True])
def test_plain_rows_bitwise_one_row_plain(rows3, integrated):
    """The plain row versions (and the wrappers on CPU tensors, which run
    them, with no launch) row by row bitwise the one-row plain versions;
    `FusedEnergyRows`' J and cotangents bitwise `FusedEnergy`'s a row."""
    p = _problem()
    C = p._consts
    with torch.no_grad():
        preps = [p._prepare([torch.as_tensor(b), torch.as_tensor(u)])
                 for b, u in zip(*rows3)]
    br0 = torch.stack([c.real for c, _ in preps])
    bi0 = torch.stack([c.imag for c, _ in preps])
    u = torch.stack([v for _, v in preps])
    gbar = torch.tensor([-1.0, 0.5, 2.0])
    kd.reset_launches()
    f = kd.run_forward_rows(br0, bi0, u, C, N, integrated, DT)
    t = kd.run_fwd_traj_rows(br0, bi0, u, C, N, integrated, DT)
    b = kd.run_bwd_rows(u, t[0], t[1], gbar, t[3], t[4], C, N, integrated, DT)
    assert not any(kd.LAUNCHES.values())
    assert t[2].shape == (3,) and t[3].shape == (3, N, 3, NPTS, NPTS, NPTS // 2 + 1)
    for got, want in ((f, kd.run_forward_rows_plain(br0, bi0, u, C, N, integrated, DT)),
                      (t, kd.run_fwd_traj_rows_plain(br0, bi0, u, C, N, integrated, DT)),
                      (b, kd.run_bwd_rows_plain(u, t[0], t[1], gbar, t[3], t[4], C, N,
                                                integrated, DT))):
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    ins = [a.clone().requires_grad_(True) for a in (br0, bi0, u)]
    Jr = kd.FusedEnergyRows.apply(*ins, C, N, integrated, DT)
    gr = torch.autograd.grad(Jr, ins, gbar)
    for r in range(3):
        one = kd.run_fwd_traj_plain(br0[r], bi0[r], u[r], C, N, integrated, DT)
        assert all(torch.equal(x[r], y) for x, y in zip(t, one)), r
        back = kd.run_bwd_plain(u[r], one[0], one[1], gbar[r], one[3], one[4], C, N,
                                integrated, DT)
        assert all(torch.equal(x[r], y) for x, y in zip(b, back)), r
        ins1 = [a[r].clone().requires_grad_(True) for a in (br0, bi0, u)]
        J1 = kd.FusedEnergy.apply(*ins1, C, N, integrated, DT)
        g1 = torch.autograd.grad(J1, ins1, gbar[r])
        assert torch.equal(Jr[r].detach(), J1.detach()), r
        assert all(torch.equal(x[r], y) for x, y in zip(gr, g1)), r


def _rows_match(rb, singles):
    for i, r1 in enumerate(singles):
        assert int(rb.iterations[i]) == int(r1.iterations), i
        assert torch.equal(rb.function_values[i], r1.function_values), i
        assert torch.equal(rb.step_sizes[i], r1.step_sizes), i
        assert torch.equal(rb.residuals[i], r1.residuals), i
        for xb, x1 in zip(rb.x_opt, r1.x_opt):
            assert torch.equal(xb[i], x1), i


def test_device_loop_sweep_rows_bitwise_unbatched(one_thread):
    """A sweep of 2 rows on the native rows (2 Wolfe + CG iterations, the
    second row on its own radii): each row bitwise its unbatched run."""
    p = _problem()
    X, ics = _rows(p, (7, 8))
    radii = [[1.0, 1.0], [0.5, 2.0]]
    X = [X[0] * torch.tensor([1.0, 0.5]).sqrt().view(2, 1, 1, 1, 1),
         X[1] * torch.tensor([1.0, 2.0]).sqrt().view(2, 1, 1, 1, 1)]
    opt = t_jit(p.objective_and_gradient, p.inner_product, p.radii, max_iters=2,
                alpha0=5.0, cg=True, line_search="wolfe", f=p.objective,
                rows=row_forms(p))
    assert opt.native_rows
    rb = opt.sweep(X, radii)
    singles = [opt([x[i] for x in X], radii_dyn=radii[i]) for i in range(2)]
    _rows_match(rb, singles)
    assert all(int(k) >= 1 for k in rb.iterations)


def test_cli_and_server_optimisers_take_native_rows():
    """`run.device_optimiser` and the server's loops pass KDyn's f32 `cuda`
    row forms to the sweep (one loop over rows), and keep the one-row
    route for `plain`."""
    from spheremanopt_torch import run as cli
    from spheremanopt_torch import serve as srv

    def cli_opt(method):
        args = cli.build_parser().parse_args(
            ["kdyn", "--device", "cpu", "--dtype", "float32", "--method", method,
             "--npts", str(NPTS), "--n-iters", "2", "--device-loop", "--quiet"])
        p, _, defaults = cli.make_problem(args)
        return cli.device_optimiser(p, defaults, args)

    assert cli_opt("cuda").native_rows and not cli_opt("plain").native_rows
    service = srv.OptimisationService(device="cpu")
    cfg = {"npts": NPTS, "n_iters": 2, "dtype": "float32"}
    for method, native in (("cuda", True), ("plain", False)):
        _, opt, aux, _ = service._get_optimiser("kdyn", dict(cfg, method=method),
                                                {"max_iters": 1})
        assert aux is None and opt.native_rows == native, method


def _kdyn_none_cases():
    return {
        "aux": (dict(), True),
        "continuous": (dict(adjoint="continuous"), False),
        "df64": (dict(method="plain", solve_precision="df64"), False),
        "plain-f32": (dict(method="plain"), False),
        "plain-f64": (dict(method="plain", dtype="float64"), False),
        "distributed": (dict(method="plain", dtype="float64", transform="distributed"),
                        False),
    }


@pytest.mark.parametrize("case", list(_kdyn_none_cases()))
def test_row_forms_none_elsewhere(case):
    """Only f32 `cuda` with the discrete adjoint has native rows; every
    other configuration sweeps one row at a time."""
    import torch.distributed as dist

    kw, aux = _kdyn_none_cases()[case]
    started = not dist.is_initialized()
    try:
        p = _problem(n_iters=2, **kw)
        assert row_forms(p, aux=aux) is None
    finally:
        if case == "distributed" and started and dist.is_initialized():
            dist.destroy_process_group()
    assert row_forms(_problem(n_iters=2)) is not None


def test_row_wrappers_refuse_operands_without_a_row_axis():
    p = _problem(n_iters=2)
    C = p._consts
    with torch.no_grad():
        b, u = p._prepare(p.generate_ic(seed=1))
    br, bi = b.real.contiguous(), b.imag.contiguous()
    with pytest.raises(ValueError, match="row axis"):
        kd.run_forward_rows(br, bi, u, C, 2)
    with pytest.raises(ValueError, match="same number of rows"):
        kd.run_fwd_traj_rows(br[None], bi[None], torch.stack([u, u]), C, 2)
    with pytest.raises(ValueError, match="row axis"):
        kd.FusedEnergyRows.apply(br, bi, u, C, 2)
    with pytest.raises(ValueError, match="dt"):
        kd.FusedEnergyRows.apply(br[None], bi[None], u[None], C, 2, True)


def test_row_launch_limit_and_signatures():
    """ROWS_MAX rows a launch, the kernels' kMaxRows (one warp's Kahan sum
    a row); a call of R rows runs ceil(R / ROWS_MAX) launches; each
    exported row launcher has a ctypes signature of its C arity."""
    assert kd.ROWS_MAX == 8
    assert kd._row_chunks(8) == [(0, 8)]
    assert kd._row_chunks(11) == [(0, 8), (8, 11)]
    src = (kbuild.CSRC / "kdyn_step.cu").read_text()
    assert re.search(r"constexpr int kPartWarps = kPartThreads / 32;", src)
    assert re.search(r"constexpr int kPartThreads = (\d+);", src).group(1) == str(
        32 * kd.ROWS_MAX)
    assert re.search(r"constexpr int kMaxRows = kPartWarps;", src)
    found = dict(re.findall(r"^int (sm_kdyn_\w+_rows)\(([^)]*)\)", src, re.M))
    assert sorted(found) == ["sm_kdyn_bwd_rows", "sm_kdyn_fwd_rows",
                             "sm_kdyn_fwd_traj_rows"]
    for name, params in found.items():
        assert len(kbuild.SIGNATURES[name]) == len(params.split(",")), name
    assert set(kd.KERNEL_SOURCES) == set(ONE_ROW + ROW_KERNELS)


# row counts of the card's bitwise cases: each row-group size filled exactly
# and partly, and a call past ROWS_MAX (8 + 3 rows)
CARD_ROWS = [1, 2, 3, 4, 5, 8, 11]


def test_row_groups_and_the_card_cases():
    """A row launch's stage tasks step 1 (the one-row kernel), 2 or 4 rows
    (the kernels' row_group, which the card test holds to it), and the
    card's bitwise cases launch each size with its group full and partly
    filled (3 rows in a group of 4, 5 rows in groups of 2), and several
    groups of 2 (5 and 8 rows)."""
    assert kd.ROW_GROUPS == (1, 2, 4)
    groups = [kd.row_group(R) for R in range(1, kd.ROWS_MAX + 1)]
    assert groups == [1, 2, 4, 4, 2, 2, 2, 2]
    for bad in (0, kd.ROWS_MAX + 1):
        with pytest.raises(ValueError, match="row launch"):
            kd.row_group(bad)
    launched = [j - i for R in CARD_ROWS for i, j in kd._row_chunks(R)]
    for G in kd.ROW_GROUPS:
        sizes = {R for R in launched if kd.row_group(R) == G}
        assert G in sizes, G                                   # one full group
        if G > 1:
            assert any(R % G for R in sizes), G                # a partial group
    assert {5, 8} <= set(launched)                             # several groups of 2
    assert max(CARD_ROWS) > kd.ROWS_MAX


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_rows(cuda, R, npts, cost="Final", n=40, seed=0):
    """(problem, br0, bi0, u (R, ...), gbar (R,)) on the card."""
    p = _problem(cost, cuda, npts=npts, n_iters=n)
    with torch.no_grad():
        preps = [p._prepare(p.generate_ic(seed=seed + r)) for r in range(R)]
    br0 = torch.stack([c.real for c, _ in preps])
    bi0 = torch.stack([c.imag for c, _ in preps])
    u = torch.stack([v for _, v in preps])
    gbar = torch.linspace(-1.5, 0.5, R, device=cuda) - 0.01   # no row at 0
    return p, br0, bi0, u, gbar


def _launched():
    return {k: v for k, v in kd.LAUNCHES.items() if v}


def _bitwise_rows(p, br0, bi0, u, gbar, integrated):
    """The three row kernels against the one-row kernels row by row."""
    C, n, dt = p._consts, p.cfg.n_iters, p.cfg.dt
    kd.reset_launches()
    f = kd.run_forward_rows(br0, bi0, u, C, n, integrated, dt)
    t = kd.run_fwd_traj_rows(br0, bi0, u, C, n, integrated, dt)
    b = kd.run_bwd_rows(u, t[0], t[1], gbar, t[3], t[4], C, n, integrated, dt)
    torch.cuda.synchronize()
    chunks = -(-br0.shape[0] // kd.ROWS_MAX)
    assert _launched() == {k: chunks for k in ROW_KERNELS}
    for r in range(br0.shape[0]):
        one = kd.run_fwd_traj(br0[r], bi0[r], u[r], C, n, integrated, dt)
        one0 = kd.run_forward(br0[r], bi0[r], u[r], C, n, integrated, dt)
        back = kd.run_bwd(u[r], one[0], one[1], gbar[r].contiguous(), one[3], one[4], C,
                          n, integrated, dt)
        assert all(torch.equal(x[r], y) for x, y in zip(t, one)), r
        assert all(torch.equal(x[r], y) for x, y in zip(f, one0)), r
        assert all(torch.equal(x[r], y) for x, y in zip(b, back)), r
    return f, t, b


@pytest.mark.requires_cuda
@pytest.mark.parametrize("R", CARD_ROWS)
@pytest.mark.parametrize("npts", [8, 24])
@pytest.mark.parametrize("cost", COSTS)
def test_row_kernels_bitwise_one_row_kernels_on_card(cuda, R, npts, cost):
    """Each row's b_T, J, trajectory, b0_bar and u_bar bitwise the one-row
    kernels' on that row, at npts 8 (the generic instance) and 24 (the
    24^3 / 36^3 instance), 40 steps, at row counts that fill a row group
    exactly, partly, or several (and past ROWS_MAX: 8 + 3 rows)."""
    p, br0, bi0, u, gbar = _card_rows(cuda, R, npts, cost)
    _bitwise_rows(p, br0, bi0, u, gbar, cost == "Integrated")


@pytest.mark.requires_cuda
def test_row_group_matches_the_kernels_on_card(cuda):
    lib = kbuild.load()
    assert [lib.sm_kdyn_row_group(R) for R in range(1, kd.ROWS_MAX + 1)] == [
        kd.row_group(R) for R in range(1, kd.ROWS_MAX + 1)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cost", COSTS)
def test_row_kernels_match_plain_rows_on_card(cuda, cost):
    """f32 row kernels against the f32 plain rows on the same card inputs
    at the 24^3 width, rel 1e-4 at 40 steps (sums in another order)."""
    integrated = cost == "Integrated"
    p, br0, bi0, u, gbar = _card_rows(cuda, 2, 24, cost)
    C, n = p._consts, p.cfg.n_iters
    t = kd.run_fwd_traj_rows(br0, bi0, u, C, n, integrated, DT)
    b = kd.run_bwd_rows(u, t[0], t[1], gbar, t[3], t[4], C, n, integrated, DT)
    tp = kd.run_fwd_traj_rows_plain(br0, bi0, u, C, n, integrated, DT)
    bp = kd.run_bwd_rows_plain(u, t[0], t[1], gbar, t[3], t[4], C, n, integrated, DT)
    torch.cuda.synchronize()
    for got, want in list(zip(t, tp)) + list(zip(b, bp)):
        for r in range(2):
            assert _rel(got[r].cpu(), want[r].cpu()) <= 1e-4, r


@pytest.mark.requires_cuda
def test_rows_past_the_limit_in_chunks_on_card(cuda):
    p, br0, bi0, u, gbar = _card_rows(cuda, 11, 8, "Integrated", n=20, seed=3)
    _bitwise_rows(p, br0, bi0, u, gbar, True)


@pytest.mark.requires_cuda
def test_row_wrappers_reject_what_they_cannot_run(cuda):
    p, br0, bi0, u, gbar = _card_rows(cuda, 2, 8, n=4)
    C = p._consts
    with pytest.raises(TypeError, match="float32"):
        kd.run_forward_rows(br0.double(), bi0, u, C, 4)
    with pytest.raises(ValueError, match="shape"):
        kd.run_forward_rows(br0[:, :, :4].contiguous(), bi0, u, C, 4)
    with pytest.raises(ValueError, match="contiguous"):
        kd.run_forward_rows(br0, bi0, u.transpose(2, 3), C, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kd.run_forward_rows(br0, bi0, u.cpu(), C, 4)
    with pytest.raises(ValueError, match="n_steps"):
        kd.run_fwd_traj_rows(br0, bi0, u, C, 0)
    t = kd.run_fwd_traj_rows(br0, bi0, u, C, 4)
    with pytest.raises(ValueError, match="gbar"):
        kd.run_bwd_rows(u, t[0], t[1], gbar[:1], t[3], t[4], C, 4)
    with pytest.raises(ValueError, match="trr"):
        kd.run_bwd_rows(u, t[0], t[1], gbar, t[3][:, :3].contiguous(), t[4], C, 4)


@pytest.mark.requires_cuda
def test_row_function_capture_and_replay_bitwise_on_card(cuda):
    """`FusedEnergyRows` forward and backward (as a sweep's trial step runs
    them) captured in a CUDA graph: a replay from new inputs equals eager
    calls on them bit for bit."""
    p, br0, bi0, u, _ = _card_rows(cuda, 3, 8, "Integrated")
    C, n = p._consts, p.cfg.n_iters
    ins = [br0.clone(), bi0.clone(), u.clone()]

    def step():
        xs = [a.detach().requires_grad_(True) for a in ins]
        J = kd.FusedEnergyRows.apply(*xs, C, n, True, DT)
        return (J.detach(), *torch.autograd.grad(J, xs, -torch.ones_like(J)))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    _, b2, c2, v2, _ = _card_rows(cuda, 3, 8, "Integrated", seed=5)
    for a, v in zip(ins, (b2, c2, v2)):
        a.copy_(v)
    graph.replay()
    torch.cuda.synchronize()
    want = step()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cost", COSTS)
def test_cuda_row_forms_bitwise_unbatched_on_card(cuda, cost):
    """At full width and depth (24^3 on 36^3, 2000 steps) and R = 8, every
    row's J, gradient of both spheres, objective and inner products from
    the `cuda` row forms bitwise the unbatched calls'."""
    p = KinematicDynamo(KDynConfig(dtype="float32", method="cuda", cost=cost),
                        device=cuda)
    forms = row_forms(p)
    ics = [p.generate_ic(seed=s) for s in range(8)]
    X = [torch.stack([ic[j] for ic in ics]) for j in range(2)]
    kd.reset_launches()
    J, g = forms.f_and_g(X)
    f = forms.f(X)
    torch.cuda.synchronize()
    assert _launched() == {"kdyn_fwd_traj_rows": 1, "kdyn_bwd_rows": 1,
                           "kdyn_fwd_rows": 1}
    ips = [forms.inner_product(x, x.flip(0)) for x in X]
    for r in range(8):
        J1, g1 = p.objective_and_gradient(ics[r])
        assert torch.equal(J[r], J1) and torch.equal(f[r], p.objective(ics[r])), r
        assert all(torch.equal(a[r], b) for a, b in zip(g, g1)), r
        for ip, x in zip(ips, X):
            assert torch.equal(ip[r], p.inner_product(x[r], x.flip(0)[r])), r


@pytest.mark.requires_cuda
def test_kernel_sweep_rows_bitwise_and_warm_replay_on_card(cuda):
    """A KDyn f32 `cuda` sweep of 3 rows on the device loop's CUDA graphs
    (npts 8, 40 steps, 3 Wolfe + CG iterations): each row bitwise its
    unbatched run; a warm sweep replays bitwise and launches the row
    kernels only."""
    p = _problem("Final", cuda, n_iters=40)
    ics = [p.generate_ic(seed=s) for s in (3, 4, 5)]
    X = [torch.stack([ic[j] for ic in ics]) for j in range(2)]
    radii = [[1.0, 1.0], [1.0, 0.5], [2.0, 1.0]]
    X = [X[0] * torch.tensor([1.0, 1.0, 2.0], device=cuda).sqrt().view(3, 1, 1, 1, 1),
         X[1] * torch.tensor([1.0, 0.5, 1.0], device=cuda).sqrt().view(3, 1, 1, 1, 1)]
    opt = t_jit(p.objective_and_gradient, p.inner_product, p.radii, max_iters=3,
                alpha0=5.0, cg=True, line_search="wolfe", f=p.objective,
                rows=row_forms(p))
    assert opt.native_rows
    rb = opt.sweep(X, radii)
    singles = [opt([x[i] for x in X], radii_dyn=radii[i]) for i in range(3)]
    _rows_match(rb, singles)
    kd.reset_launches()
    rb2 = opt.sweep(X, radii)
    torch.cuda.synchronize()
    launched = dict(kd.LAUNCHES)
    held = {}
    for step, n in opt.last_replays.items():
        for k, v in opt.last_loop.graph_launches(step).items():
            held[k] = held.get(k, 0) + v * n
    assert all(launched[k] == 0 for k in ONE_ROW), launched
    assert launched["kdyn_fwd_traj_rows"] > 0 and launched["kdyn_bwd_rows"] > 0
    assert {k: launched[k] for k in ROW_KERNELS} == {k: held.get(k, 0) for k in ROW_KERNELS}
    assert torch.equal(rb2.function_values, rb.function_values)
    assert all(torch.equal(a, b) for a, b in zip(rb2.x_opt, rb.x_opt))
