"""Row kernels: R sweeps of one operator in one launch (the port of the
JAX package's `jax.vmap` over its Pallas kernels, where `pallas_call`'s
batching rule gives each kernel a grid over the rows).

  SH23   `fused_fwd_shared_rows`, `fused_bwd_shared_rows`,
         `FusedObjectiveSharedRows`, SH23 `cuda` `row_forms`
  SHB23  `fused_fwd_rows`, `fused_bwd_rows`, `FusedObjectiveRows`,
         SHB23 `matmul` and `cuda` `row_forms`

CPU cases (seeded numpy inputs; the row kernels' plain versions):
  * each plain row version in f64 against the one-row plain version, row
    by row: rel 1e-12 (one product of R rows a step in place of R
    matvecs: another summation order);
  * the f32 `cuda` row forms (plain on the CPU) against `jax.vmap` of the
    JAX problem's `method="pallas"` `objective_and_gradient` in interpret
    mode, SH23 at npts = 64 (mg = 128), SHB23 at npts = 128 (the row
    kernels' narrowest width), 40 steps: J rel 1e-5, gradients rel 1e-4
    (`tests/test_torch_fused_kernel.py`'s limits: the same f32 recurrence,
    sums in another order);
  * an f32 `cuda` sweep of 3 rows, 3 Wolfe + CG iterations, against the
    JAX package's `jax.jit(jax.vmap(...))` device loop on `pallas`
    (interpret): equal iteration counts, J histories and step sizes rel
    1e-4;
  * SHB23 `matmul` f64 rows against the unbatched runs (rtol 1e-10, as
    `tests/test_torch_batched.py`'s native rows) and against JAX's vmap
    sweep (rtol 1e-9, equal iteration counts);
  * the `cuda` row forms' inner product bitwise the unbatched one a row;
  * the wrappers raise on misuse and at widths without row kernels, where
    `row_forms` is None.
The card cases (`requires_cuda`; this module imports JAX only inside the
CPU cases that need it):

    python -m pytest --noconftest -m requires_cuda tests/test_torch_rows_kernel.py

hold each row of the four row kernels bitwise the one-row kernels (SH23's
at R = 1, 3, 8 and mg 128, 512; SHB23's at R = 1, 2, 3, 4, 5, 8 and mg 128,
384, 512, 640: every row group the wrapper chooses, and the register-only
and part-shared instances), the rows against the plain rows in f32 (rel
1e-5 at 40 steps), a call past ROWS_MAX rows in chunks, a CUDA graph of
a row forward and reverse replayed bitwise, and the `cuda` row forms at
full width and R = 8 (J, gradient, objective, inner product) bitwise the
unbatched calls row by row.
"""

import functools
import re

import numpy as np
import pytest
import torch

from spheremanopt_torch.ops.cuda import build as kbuild
from spheremanopt_torch.ops.cuda import fused_two_matrix as fk
from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere as t_jit
from spheremanopt_torch.problems.base import row_forms
from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg
from spheremanopt_torch.problems.swift_hohenberg_bounded import (
    SHB23Config,
    SwiftHohenbergBounded,
)

C2, C3, C2B, C3B = 1.8, -1.0, 2.0, -1.0
N = 40
ROW_RTOL, JAX_RTOL = 1e-10, 1e-9


@pytest.fixture
def one_thread():
    """Long loops of small products: one intra-op thread, so several test
    workers on one host do not fight over the cores (and one BLAS thread
    for the operators' numpy assembly)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _close(a, b, rtol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(b), np.abs(b).max() * 1e-3 if b.size else 1.0)
    worst = float(np.max(np.abs(a - b) / scale)) if b.size else 0.0
    assert worst <= rtol, f"{what}: worst rel {worst:.2e} > {rtol:g}"


def _operators(two_matrix, mg, dtype, device="cpu"):
    """(mats, w, c2, c3, lin): SH23's step matrix at width mg (npts =
    mg / 2) or SHB23's two propagators (npts = mg), as the problems build
    them, and their cost weights."""
    mats, w, c = _operators_f64(two_matrix, mg)
    conv = lambda t: t.to(dtype).contiguous().to(device)   # noqa: E731
    return tuple(conv(m) for m in mats), conv(w), c


@functools.lru_cache(maxsize=None)
def _operators_f64(two_matrix, mg):
    """The f64 operators of `_operators`, built once a width."""
    if two_matrix:
        p = SwiftHohenbergBounded(SHB23Config(npts=mg), device="cpu")
        mats = (p._Alt, p._Ant)
        w = p._wt
        c = (C2B, C3B, 0.0)
    else:
        p = SwiftHohenberg(SH23Config(npts=mg // 2), device="cpu")
        mats = (p._Mt,)
        w = torch.full((mg,), 1.0 / mg, dtype=torch.float64)
        c = (C2, C3, 1.0 / p.cfg.dt)
    return mats, w, c


def _states(R, mg, dtype, device="cpu", seed=0, amp=0.3):
    u = np.random.RandomState(seed).randn(R, mg) * amp
    return torch.as_tensor(u, dtype=dtype).to(device)


# ---------------------------------------------------------------------------
# the plain row versions against the one-row plain versions (f64)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("two_matrix", [False, True], ids=["shared", "two"])
def test_plain_rows_match_one_row_plain_f64(two_matrix, one_thread):
    mg, R = 128, 3
    mats, w, (c2, c3, lin) = _operators(two_matrix, mg, torch.float64)
    u0 = _states(R, mg, torch.float64, amp=0.05 if two_matrix else 0.3)
    scale = torch.tensor([-0.1, -0.05, 0.2], dtype=torch.float64)
    if two_matrix:
        uT, J, traj = fk.fused_fwd_rows_plain(*mats, w, u0, c2, c3, N)
        lam = fk.fused_bwd_rows_plain(*mats, w, uT, traj, c2, c3, scale, N)
    else:
        uT, J, traj = fk.fused_fwd_shared_rows_plain(*mats, w, u0, c2, c3, lin, N)
        lam = fk.fused_bwd_shared_rows_plain(*mats, w, uT, traj, c2, c3, lin, scale, N)
    assert uT.shape == (R, mg) and J.shape == (R,) and traj.shape == (R, N, mg)
    for r in range(R):
        if two_matrix:
            u1, j1, t1, _ = fk.fused_fwd_plain(*mats, w, u0[r], c2, c3, N)
            l1, _, _ = fk.fused_bwd_plain(*mats, w, u1, t1, c2, c3, scale[r], N)
        else:
            u1, j1, t1, _ = fk.fused_fwd_shared_plain(*mats, w, u0[r], c2, c3, lin, N)
            l1, _ = fk.fused_bwd_shared_plain(*mats, w, u1, t1, c2, c3, lin, scale[r], N)
        for got, want in ((uT[r], u1), (J[r], j1), (traj[r], t1), (lam[r], l1)):
            assert _rel(got, want) <= 1e-12, r


@pytest.mark.parametrize("two_matrix", [False, True], ids=["shared", "two"])
def test_row_objective_gradients_match_one_row_objective(two_matrix, one_thread):
    """The row Functions' J and du0 (per-row cotangents gbar) against the
    one-row Functions row by row, f64 plain."""
    mg, R = 128, 3
    mats, w, (c2, c3, lin) = _operators(two_matrix, mg, torch.float64)
    u0 = _states(R, mg, torch.float64, amp=0.05 if two_matrix else 0.3)
    uu = u0.clone().requires_grad_(True)
    if two_matrix:
        J = fk.FusedObjectiveRows.apply(*mats, w, uu, c2, c3, 0.01, N)
    else:
        J = fk.FusedObjectiveSharedRows.apply(*mats, w, uu, c2, c3, lin, 0.05, N)
    gbar = torch.tensor([1.0, -0.5, 2.0], dtype=torch.float64)
    (du,) = torch.autograd.grad(J, uu, gbar)
    for r in range(R):
        u1 = u0[r].clone().requires_grad_(True)
        if two_matrix:
            j1 = fk.FusedObjective.apply(*mats, w, u1, c2, c3, 0.01, N, False)
        else:
            j1 = fk.FusedObjectiveShared.apply(*mats, w, u1, c2, c3, lin, 0.05, N, False)
        (g1u,) = torch.autograd.grad(j1, u1, gbar[r])
        assert _rel(J[r].detach(), j1.detach()) <= 1e-12
        assert _rel(du[r], g1u) <= 1e-12, r


# ---------------------------------------------------------------------------
# the f32 row forms against jax.vmap of the Pallas objective (interpret)
# ---------------------------------------------------------------------------


def _pair(two_matrix, n_iters=N):
    """The port's f32 `cuda` problem (CPU) and the JAX package's f32
    `pallas` problem (interpret mode on the CPU) at one config."""
    if two_matrix:
        from spheremanopt_tpu.problems.swift_hohenberg_bounded import (
            SHB23Config as JConfig,
            SwiftHohenbergBounded as JP,
        )

        kw = dict(npts=128, n_iters=n_iters, dtype="float32")
        return (SwiftHohenbergBounded(SHB23Config(method="cuda", **kw), device="cpu"),
                JP(JConfig(method="pallas", **kw)))
    from spheremanopt_tpu.problems.swift_hohenberg import (
        SH23Config as JConfig,
        SwiftHohenberg as JP,
    )

    kw = dict(npts=64, n_iters=n_iters, dtype="float32")
    return (SwiftHohenberg(SH23Config(method="cuda", **kw), device="cpu"),
            JP(JConfig(method="pallas", **kw)))


def _sphere_rows(p, R, seeds):
    """R seeded numpy points, each scaled onto the problem's sphere under
    its inner product (f32)."""
    n = p.basis.n_grid if isinstance(p, SwiftHohenberg) else p.cfg.npts
    out = []
    for s in seeds[:R]:
        x = torch.as_tensor(np.random.RandomState(s).randn(n), dtype=p.dtype)
        out.append(x * torch.sqrt(p.radii[0] / p.inner_product(x, x)))
    return torch.stack(out).float()


@pytest.mark.parametrize("two_matrix", [False, True], ids=["sh23", "shb23"])
def test_cuda_row_forms_match_jax_vmap_of_pallas(two_matrix, one_thread):
    import jax
    import jax.numpy as jnp

    p, jp = _pair(two_matrix)
    X = _sphere_rows(p, 3, (11, 12, 13))
    forms = row_forms(p)
    assert forms is not None
    J, (g,) = forms.f_and_g([X])
    Jj, (gj,) = jax.vmap(lambda x: jp.objective_and_gradient([x]))(jnp.asarray(X.numpy()))
    assert J.dtype == torch.float32 and J.shape == (3,)
    for r in range(3):
        assert _rel(J[r], np.asarray(Jj)[r]) <= 1e-5, r
        assert _rel(g[r], np.asarray(gj)[r]) <= 1e-4, r
    Jo = forms.f([X])
    assert torch.equal(Jo, J)
    assert torch.equal(forms.grad([X])[0], g)


def test_cuda_sweep_matches_jax_vmap_device_loop(one_thread):
    """SH23 f32 `cuda` (plain row kernels on the CPU): a sweep of 3 rows,
    3 Wolfe + CG iterations, against `jax.jit(jax.vmap(...))` of the JAX
    package's device loop on `pallas` (interpret)."""
    import jax
    import jax.numpy as jnp

    from spheremanopt_tpu.optim.jit_driver import jit_optimise_on_multi_sphere as j_jit

    p, jp = _pair(False)
    X = _sphere_rows(p, 3, (21, 22, 23))
    e0 = [0.05, 0.0725, 0.1]
    X = X * torch.sqrt(torch.tensor(e0) / p.radii[0])[:, None]
    kw = dict(max_iters=3, alpha0=float(np.pi), cg=True, line_search="wolfe")
    opt = t_jit(p.objective_and_gradient, p.inner_product, p.radii, f=p.objective,
                rows=row_forms(p), **kw)
    assert opt.native_rows
    rb = opt.sweep([X], torch.tensor(e0)[:, None])
    jopt = j_jit(jp.objective_and_gradient, jp.inner_product, jp.radii, **kw)
    rj = jax.jit(jax.vmap(lambda x, r: jopt([x], radii_dyn=[r])))(
        jnp.asarray(X.numpy()), jnp.asarray(np.float32(e0)))
    for i in range(3):
        k = int(rb.iterations[i])
        assert k == int(rj.iterations[i]) and k >= 1, i
        _close(rb.function_values[i, :k + 1].numpy(), np.asarray(rj.function_values[i])[:k + 1],
               1e-4, f"row {i} J")
        _close(rb.step_sizes[i, :k].numpy(), np.asarray(rj.step_sizes[i])[:k], 1e-4,
               f"row {i} steps")


# ---------------------------------------------------------------------------
# SHB23 matmul rows (f64)
# ---------------------------------------------------------------------------


def test_shb23_matmul_sweep_matches_unbatched_and_jax_vmap(one_thread):
    import jax
    import jax.numpy as jnp

    from spheremanopt_tpu.optim.jit_driver import jit_optimise_on_multi_sphere as j_jit
    from spheremanopt_tpu.problems.swift_hohenberg_bounded import (
        SHB23Config as JConfig,
        SwiftHohenbergBounded as JP,
    )

    small = dict(npts=64, n_iters=50)
    p = SwiftHohenbergBounded(SHB23Config(**small), device="cpu")
    forms = row_forms(p)
    assert forms is not None and forms.f_and_g == p.objective_and_gradient_rows
    m0 = [0.001, 0.0019, 0.003]
    X = torch.stack([_sphere_rows(p, 1, (s,))[0].double() for s in (31, 32, 33)])
    X = X * torch.sqrt(torch.tensor(m0, dtype=torch.float64) / p.radii[0])[:, None]
    radii = torch.tensor(m0, dtype=torch.float64)[:, None]
    kw = dict(max_iters=4, alpha0=1.0, cg=True, line_search="wolfe")
    opt = t_jit(p.objective_and_gradient, p.inner_product, p.radii, f=p.objective,
                rows=forms, **kw)
    rb = opt.sweep([X], radii)
    singles = [opt([X[i]], radii_dyn=[m0[i]]) for i in range(3)]
    for i, r1 in enumerate(singles):
        assert int(rb.iterations[i]) == int(r1.iterations), i
        _close(rb.function_values[i].numpy(), r1.function_values.numpy(), ROW_RTOL, "J")
        _close(rb.step_sizes[i].numpy(), r1.step_sizes.numpy(), ROW_RTOL, "steps")
        _close(rb.x_opt[0][i].numpy(), r1.x_opt[0].numpy(), ROW_RTOL, "x")
    jp = JP(JConfig(**small))
    jopt = j_jit(jp.objective_and_gradient, jp.inner_product, jp.radii, **kw)
    rj = jax.jit(jax.vmap(lambda x, r: jopt([x], radii_dyn=[r])))(
        jnp.asarray(X.numpy()), jnp.asarray(m0))
    for i in range(3):
        assert int(rb.iterations[i]) == int(rj.iterations[i]), i
        _close(rb.function_values[i].numpy(), rj.function_values[i], JAX_RTOL, "J")
        _close(rb.step_sizes[i].numpy(), rj.step_sizes[i], JAX_RTOL, "steps")
        _close(rb.x_opt[0][i].numpy(), rj.x_opt[0][i], JAX_RTOL, "x")
    # the rows' inner product is the unbatched one's, row by row
    ip = forms.inner_product(X, X.flip(0))
    for i in range(3):
        assert _rel(ip[i], p.inner_product(X[i], X.flip(0)[i])) <= 1e-14


# ---------------------------------------------------------------------------
# misuse, widths without row kernels, chunks, the C signatures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mg,two_matrix,ok", [
    (64, False, False), (128, False, True), (896, False, True), (1024, False, False),
    (96, True, False), (128, True, True), (640, True, True), (768, True, False)])
def test_row_widths_and_row_forms(mg, two_matrix, ok, one_thread):
    """The row kernels take the reverse clusters' widths; elsewhere the
    row wrappers raise (on the CPU too) and `row_forms` of a `cuda`
    problem is None (a sweep runs its rows one at a time), while `matmul`
    keeps its rows at every width."""
    assert fk.rows_width_ok(mg, two_matrix) == ok
    mats, w, (c2, c3, lin) = _operators(two_matrix, mg, torch.float32)
    u0 = _states(2, mg, torch.float32, amp=0.01)
    fwd = ((lambda: fk.fused_fwd_rows(*mats, w, u0, c2, c3, 2)) if two_matrix
           else (lambda: fk.fused_fwd_shared_rows(*mats, w, u0, c2, c3, lin, 2)))
    if ok:
        assert fwd()[0].shape == (2, mg)
    else:
        with pytest.raises(ValueError, match="row kernels take"):
            fwd()
    if two_matrix:
        cfg = dict(npts=mg, n_iters=2, dtype="float32")
        cuda = SwiftHohenbergBounded(SHB23Config(method="cuda", **cfg), device="cpu")
        plain = SwiftHohenbergBounded(SHB23Config(**cfg), device="cpu")
    else:
        cfg = dict(npts=mg // 2, n_iters=2, dtype="float32")
        cuda = SwiftHohenberg(SH23Config(method="cuda", **cfg), device="cpu")
        plain = SwiftHohenberg(SH23Config(**cfg), device="cpu")
    assert (row_forms(cuda) is not None) == ok
    assert row_forms(plain) is not None
    cont = dict(cfg, adjoint="continuous")
    prob = (SwiftHohenbergBounded(SHB23Config(**cont), device="cpu") if two_matrix
            else SwiftHohenberg(SH23Config(**cont), device="cpu"))
    assert row_forms(prob) is None


@pytest.mark.parametrize("two_matrix", [False, True], ids=["sh23", "shb23"])
def test_cuda_row_inner_product_is_the_unbatched_one_a_row(two_matrix):
    """The `cuda` row forms' inner product is the unbatched inner product
    taken a row, bitwise, at R = 8 (a reduction over the rows' last axis
    changes its layout with R; the card cases below hold J and the
    gradient of the row forms bitwise too)."""
    p = (SwiftHohenbergBounded(SHB23Config(npts=128, n_iters=N, dtype="float32",
                                           method="cuda"), device="cpu")
         if two_matrix else
         SwiftHohenberg(SH23Config(npts=64, n_iters=N, dtype="float32", method="cuda"),
                        device="cpu"))
    x, y = _sphere_rows(p, 8, list(range(8))), _sphere_rows(p, 8, list(range(10, 18)))
    got = row_forms(p).inner_product(x, y)
    assert got.shape == (8,)
    for r in range(8):
        assert torch.equal(got[r], p.inner_product(x[r], y[r])), r


def test_row_wrappers_reject_misuse_on_cpu():
    mats, w, (c2, c3, lin) = _operators(False, 128, torch.float32)
    (b,) = mats
    u0 = _states(3, 128, torch.float32)
    with pytest.raises(ValueError, match=r"\(R, mg\)"):
        fk.fused_fwd_shared_rows(b, w, u0[0], c2, c3, lin, 4)
    with pytest.raises(ValueError, match="shapes"):
        fk.fused_fwd_shared_rows(b[:, :64], w, u0, c2, c3, lin, 4)
    uT, _, traj = fk.fused_fwd_shared_rows(b, w, u0, c2, c3, lin, 4)
    with pytest.raises(ValueError, match="scale"):
        fk.fused_bwd_shared_rows(b, w, uT, traj, c2, c3, lin, torch.ones(2), 4)
    with pytest.raises(ValueError, match="traj"):
        fk.fused_bwd_shared_rows(b, w, uT, traj[:, :3], c2, c3, lin, torch.ones(3), 4)
    for bb, ww in ((b.clone().requires_grad_(True), w), (b, w.clone().requires_grad_(True))):
        with pytest.raises(ValueError, match="operator cotangents"):
            fk.FusedObjectiveSharedRows.apply(bb, ww, u0, c2, c3, lin, 0.05, 4)
    (a, b2), w2, (c2b, c3b, _) = _operators(True, 128, torch.float32)
    with pytest.raises(ValueError, match="operator cotangents"):
        fk.FusedObjectiveRows.apply(a, b2.clone().requires_grad_(True), w2,
                                    _states(2, 128, torch.float32, amp=0.01), c2b, c3b,
                                    0.01, 4)


def test_rows_past_the_launch_limit_run_in_chunks():
    """ROWS_MAX rows a launch: a call of R rows runs ceil(R / ROWS_MAX)
    launches (`_row_chunks`), each on its own rows."""
    assert fk.ROWS_MAX == 8
    assert fk._row_chunks(8) == [(0, 8)]
    assert fk._row_chunks(11) == [(0, 8), (8, 11)]
    assert fk._row_chunks(17) == [(0, 8), (8, 16), (16, 17)]
    src = (kbuild.CSRC / "grid.cuh").read_text()
    assert re.search(r"constexpr int kMaxStates = (\d+);", src).group(1) == str(fk.ROWS_MAX)


@pytest.mark.parametrize("mg", [128, 256, 384, 512, 640, 768, 896])
def test_row_partition_covers_every_row_once(mg):
    """The row forwards' split: contiguous blocks of `rows` rows, the last
    one short, every row in one CTA, and at least ROWS_MAX CTAs (CTA s
    forms row s's J)."""
    rows, ctas = fk.rows_partition(mg)
    owned = [r for c in range(ctas) for r in range(c * rows, min((c + 1) * rows, mg))]
    assert owned == list(range(mg))
    assert ctas >= fk.ROWS_MAX and (ctas - 1) * rows < mg


def test_row_launchers_signatures_match_their_c_parameters():
    """The ctypes signature of each exported function has as many
    arguments as its C definition, and every signature has a definition;
    the launchers of one row group that fused_two_matrix.cu calls
    (csrc/fused_rows.cuh SMO_ROWS_DECLARE) take the parameters of their
    definitions (SMO_ROWS_DEFINE), and each exported row launcher passes
    its launcher as many arguments."""
    def arity(params):
        return len([x for x in params.split(",") if x.strip() and x.strip() != "void"])

    defined = set()
    for src in kbuild.CSRC.glob("*.cu"):
        for name, params in re.findall(r"^int (sm_\w+)\(([^)]*)\)", src.read_text(), re.M):
            assert len(kbuild.SIGNATURES[name]) == arity(params), name
            defined.add(name)
    assert set(kbuild.SIGNATURES) == defined
    rows = (kbuild.CSRC / "fused_rows.cuh").read_text().replace("\\\n", " ")
    macro = {m: dict(re.findall(r"int (fused_\w+)_g##G\(([^)]*)\)", body))
             for m, body in re.findall(r"#define (SMO_ROWS_\w+)\(G\)(.*)", rows)}
    decl, defn = macro["SMO_ROWS_DECLARE"], macro["SMO_ROWS_DEFINE"]
    assert sorted(decl) == sorted(defn) == ["fused_bwd_rows", "fused_bwd_rows_capacity",
                                            "fused_fwd_rows", "fused_fwd_rows_capacity"]
    for name in decl:
        assert arity(decl[name]) == arity(defn[name]), name
    two = (kbuild.CSRC / "fused_two_matrix.cu").read_text()
    for sym, launcher in (("sm_fused_fwd_rows", "fwd"), ("sm_fused_bwd_rows", "bwd")):
        body = two[two.index(f"int {sym}("):]
        call = re.search(rf"return {launcher}\(([^;]*)\);", body).group(1)
        assert arity(re.sub(r"\([^()]*\)", "", call)) == arity(decl[f"fused_{launcher}_rows"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _row_case(cuda, two_matrix, mg, R, n, seed=0):
    """Card operands at width mg: (fwd_rows, bwd_rows, fwd1, bwd1, u0, scale)."""
    mats, w, (c2, c3, lin) = _operators(two_matrix, mg, torch.float32, cuda)
    u0 = _states(R, mg, torch.float32, cuda, seed=seed, amp=0.02 if two_matrix else 0.3)
    scale = torch.linspace(-0.2, 0.1, R, device=cuda) + 0.01   # no row at 0
    if two_matrix:
        fr = lambda u: fk.fused_fwd_rows(*mats, w, u, c2, c3, n)   # noqa: E731
        br = lambda uT, t, s: fk.fused_bwd_rows(*mats, w, uT, t, c2, c3, s, n)  # noqa: E731
        f1 = lambda u: fk.fused_fwd(*mats, w, u, c2, c3, n)   # noqa: E731
        b1 = lambda uT, t, s: fk.fused_bwd(*mats, w, uT, t, c2, c3, s, n)[0]  # noqa: E731
    else:
        fr = lambda u: fk.fused_fwd_shared_rows(*mats, w, u, c2, c3, lin, n)  # noqa: E731
        br = lambda uT, t, s: fk.fused_bwd_shared_rows(  # noqa: E731
            *mats, w, uT, t, c2, c3, lin, s, n)
        f1 = lambda u: fk.fused_fwd_shared(*mats, w, u, c2, c3, lin, n)  # noqa: E731
        b1 = lambda uT, t, s: fk.fused_bwd_shared(  # noqa: E731
            *mats, w, uT, t, c2, c3, lin, s, n)[0]
    return fr, br, f1, b1, u0, scale


def _bitwise_rows(fr, br, f1, b1, u0, scale):
    uT, J, traj = fr(u0)
    lam = br(uT, traj, scale)
    torch.cuda.synchronize()
    for r in range(u0.shape[0]):
        u1, j1, t1, _ = f1(u0[r].contiguous())
        l1 = b1(u1, t1, scale[r].contiguous())
        assert torch.equal(uT[r], u1) and torch.equal(J[r], j1), r
        assert torch.equal(traj[r], t1), r
        assert torch.equal(lam[r], l1), r
    return uT, J, traj, lam


# the shared matrix's row kernels at two widths; the two-matrix ones at
# every R the wrapper groups differently (fwd_row_group, bwd_row_group) and
# at widths with every operator in registers (128, 384, 512) and with part
# of it in shared memory (640)
ROW_CARD_CASES = ([(False, mg, R) for mg in (128, 512) for R in (1, 3, 8)]
                  + [(True, mg, R) for mg in (128, 384, 512, 640) for R in (1, 2, 3, 4, 5, 8)])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("two_matrix,mg,R", ROW_CARD_CASES)
def test_row_kernels_bitwise_one_row_kernels_on_card(cuda, two_matrix, mg, R):
    fr, br, f1, b1, u0, scale = _row_case(cuda, two_matrix, mg, R, 200)
    fk.reset_launches()
    fr(u0)
    torch.cuda.synchronize()
    name = "fused_fwd_rows" if two_matrix else "fused_fwd_shared_rows"
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {name: 1}
    _bitwise_rows(fr, br, f1, b1, u0, scale)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("two_matrix", [False, True], ids=["shared", "two"])
def test_row_kernels_match_plain_rows_on_card(cuda, two_matrix):
    """f32 kernels against the f32 plain rows on the same card inputs, rel
    1e-5 at 40 steps (sums in another order)."""
    mg, R = 512, 4
    mats, w, (c2, c3, lin) = _operators(two_matrix, mg, torch.float32, cuda)
    u0 = _states(R, mg, torch.float32, cuda, amp=0.02 if two_matrix else 0.3)
    scale = torch.tensor([-0.2, -0.1, 0.05, 0.1], device=cuda)
    if two_matrix:
        k = fk.fused_fwd_rows(*mats, w, u0, c2, c3, N)
        p = fk.fused_fwd_rows_plain(*mats, w, u0, c2, c3, N)
        lk = fk.fused_bwd_rows(*mats, w, k[0], k[2], c2, c3, scale, N)
        lp = fk.fused_bwd_rows_plain(*mats, w, k[0], k[2], c2, c3, scale, N)
    else:
        k = fk.fused_fwd_shared_rows(*mats, w, u0, c2, c3, lin, N)
        p = fk.fused_fwd_shared_rows_plain(*mats, w, u0, c2, c3, lin, N)
        lk = fk.fused_bwd_shared_rows(*mats, w, k[0], k[2], c2, c3, lin, scale, N)
        lp = fk.fused_bwd_shared_rows_plain(*mats, w, k[0], k[2], c2, c3, lin, scale, N)
    torch.cuda.synchronize()
    for r in range(R):
        for got, want in ((k[0][r], p[0][r]), (k[1][r], p[1][r]), (k[2][r], p[2][r]),
                          (lk[r], lp[r])):
            assert _rel(got.cpu(), want.cpu()) <= 1e-5, r


@pytest.mark.requires_cuda
@pytest.mark.parametrize("two_matrix", [False, True], ids=["shared", "two"])
def test_rows_past_the_limit_in_chunks_on_card(cuda, two_matrix):
    fr, br, f1, b1, u0, scale = _row_case(cuda, two_matrix, 256, 11, 100, seed=3)
    fk.reset_launches()
    uT, _, traj = fr(u0)
    br(uT, traj, scale)
    torch.cuda.synchronize()
    pre = "fused_fwd_rows" if two_matrix else "fused_fwd_shared_rows"
    post = "fused_bwd_rows" if two_matrix else "fused_bwd_shared_rows"
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {pre: 2, post: 2}
    _bitwise_rows(fr, br, f1, b1, u0, scale)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("two_matrix", [False, True], ids=["shared", "two"])
def test_row_kernels_capture_and_replay_bitwise_on_card(cuda, two_matrix):
    """A row forward and reverse (through the row Function, as a sweep's
    trial step runs them) captured in a CUDA graph: a replay from new
    inputs equals eager calls on them bit for bit."""
    mg, R, n = 256, 5, 100
    mats, w, (c2, c3, lin) = _operators(two_matrix, mg, torch.float32, cuda)
    amp = 0.02 if two_matrix else 0.3
    x = _states(R, mg, torch.float32, cuda, seed=4, amp=amp)

    def step(u):
        uu = u.detach().requires_grad_(True)
        if two_matrix:
            J = fk.FusedObjectiveRows.apply(*mats, w, uu, c2, c3, 0.01, n)
        else:
            J = fk.FusedObjectiveSharedRows.apply(*mats, w, uu, c2, c3, lin, 0.05, n)
        (g,) = torch.autograd.grad(J, uu, torch.ones_like(J))
        return J.detach(), g

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(x)
    x.copy_(_states(R, mg, torch.float32, cuda, seed=5, amp=amp))
    graph.replay()
    torch.cuda.synchronize()
    want = step(x)
    torch.cuda.synchronize()
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("two_matrix", [False, True], ids=["sh23", "shb23"])
def test_cuda_row_forms_bitwise_unbatched_on_card(cuda, two_matrix):
    """At full width and R = 8, every row's J, gradient, objective and
    inner product from the `cuda` row forms bitwise the unbatched calls'
    (so an f32 sweep makes each row's unbatched decisions)."""
    p = (SwiftHohenbergBounded(SHB23Config(dtype="float32", method="cuda"), device=cuda)
         if two_matrix else
         SwiftHohenberg(SH23Config(dtype="float32", method="cuda"), device=cuda))
    forms = row_forms(p)
    assert forms is not None
    x = torch.stack([p.generate_ic(seed=s)[0] for s in range(8)]).float()
    y = torch.stack([p.generate_ic(seed=s + 10)[0] for s in range(8)]).float()
    J, (g,) = forms.f_and_g([x])
    f = forms.f([x])
    ip = forms.inner_product(x, y)
    for r in range(8):
        J1, (g1,) = p.objective_and_gradient([x[r]])
        assert torch.equal(J[r], J1.reshape(())) and torch.equal(g[r], g1), r
        assert torch.equal(f[r], p.objective([x[r]]).reshape(())), r
        assert torch.equal(ip[r], p.inner_product(x[r], y[r])), r
