"""Sweeps: R optimisations at once over a leading row axis
(`DeviceOptimiser.sweep`, the port of `jax.vmap` over the JAX package's
device loops).

Every row must make its unbatched run's decisions. A problem without
native forms over rows (`problems.base.row_forms` gives None: KDyn's
continuous adjoint, and SH23 / SHB23 `cuda` at widths without row
kernels) sweeps its rows one
after another on the unbatched loop, so the rows are bitwise the
unbatched runs; on the native batched forms (PCA, SH23 `matmul` and
`fft`, SHB23 `matmul`, mixing) only the reductions' order differs, and
the rows hold rtol 1e-10 of the unbatched runs. SH23's f64
sweep is also held against the JAX package's `jax.vmap` sweep on the same
numpy inputs (rtol 1e-9, equal iteration counts). The card tests
(`requires_cuda`; the card's machine has no JAX, so this module imports
it only inside the test that needs it: `python -m pytest --noconftest -m
requires_cuda tests/test_torch_batched.py`) run the f32 kernel sweep on
its native rows (the row kernels of `tests/test_torch_rows_kernel.py`),
each row bitwise its unbatched run and a warm sweep bitwise the first,
with the row kernels' launches equal to the replayed graphs', and the
same sweep one row at a time (`rows=None`), bitwise.
"""

import numpy as np
import pytest
import torch

from spheremanopt_torch.optim import device_wolfe as tdw
from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere as t_jit
from spheremanopt_torch.optim.jit_rtr import jit_optimise_rtr as t_jrtr
from spheremanopt_torch.problems.base import row_forms
from spheremanopt_torch.problems.pca import PCAProblem as TPCA
from spheremanopt_torch.problems.pca import random_spd_matrix

ROW_RTOL, JAX_RTOL = 1e-10, 1e-9


@pytest.fixture
def one_thread():
    """Long loops of small products: one intra-op thread, so several test
    workers on one host do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(b), np.abs(b).max() * 1e-3 if b.size else 1.0)
    worst = float(np.max(np.abs(a - b) / scale)) if b.size else 0.0
    assert worst <= rtol, f"{what}: worst rel {worst:.2e} > {rtol:g}"


def _rows_match(rb, singles, rtol=None):
    """Each row of the sweep `rb` against its unbatched run: bitwise
    (rtol None) or to rtol, with equal iteration counts."""
    for i, r1 in enumerate(singles):
        assert int(rb.iterations[i]) == int(r1.iterations), i
        pairs = [(rb.function_values[i], r1.function_values, "J"),
                 (rb.step_sizes[i], r1.step_sizes, "steps"),
                 (rb.residuals[i], r1.residuals, "residuals")]
        pairs += [(xb[i], x1, "x") for xb, x1 in zip(rb.x_opt, r1.x_opt)]
        for a, b, what in pairs:
            if rtol is None:
                assert torch.equal(a, b), (i, what)
            else:
                _close(a.numpy(), b.numpy(), rtol, f"row {i} {what}")


# ---------------------------------------------------------------------------
# the searches' transitions over rows
# ---------------------------------------------------------------------------

# (phi, derphi) of alpha, one row each: first-trial accept, zoom, a
# derphi >= 0 flip, an amax-capped failure (tests/test_torch_device_wolfe.py)
ROWS = [
    (lambda a: (a - 2.0) ** 2, lambda a: 2 * (a - 2.0)),
    (lambda a: a ** 4 - 3 * a ** 2 + 0.5 * a, lambda a: 4 * a ** 3 - 6 * a + 0.5),
    (lambda a: -a / (a * a + 1.0), lambda a: (a * a - 1.0) / (a * a + 1.0) ** 2),
    (lambda a: -a, lambda a: -1.0 + 0 * a),
    (lambda a: (a - 0.01) ** 2 - 1e-4, lambda a: 2 * (a - 0.01)),
    (lambda a: torch.exp(-a) + 0.05 * a, lambda a: -torch.exp(-a) + 0.05),
]


def _t(v):
    return torch.tensor(v, dtype=torch.float64)


def _same(a, b):
    """Bitwise equal, NaN where the other is NaN (a transition computes the
    next interpolant for rows whose search ended, as the unbatched one does)."""
    return torch.equal(a, b) or bool((a.isnan() & b.isnan()) | (a == b))


def _rows_eval(a):
    """Each row's (phi, derphi) at its own alpha, and a count of the trials
    each row was asked for (alpha is (R,))."""
    phi = torch.stack([f(a[i]) for i, (f, _) in enumerate(ROWS)])
    der = torch.stack([df(a[i]) for i, (_, df) in enumerate(ROWS)])
    return phi, der


@pytest.mark.parametrize("search", ["wolfe", "armijo"])
def test_search_transitions_over_rows_equal_unbatched(search):
    """The batched searches, each row frozen once its search ends, give
    every row the alpha, phi, ok and trial count of its unbatched
    search; the state after every transition equals the unbatched
    transitions row by row."""
    R = len(ROWS)
    phi0 = torch.stack([f(_t(0.0)) for f, _ in ROWS])
    der0 = torch.stack([df(_t(0.0)) for _, df in ROWS])
    old = _t([0.3, 0.0, -0.2, 0.0, 0.0, 1.2])
    has_old = torch.tensor([True, False, True, False, False, True])
    amax = 8.0

    def unbatched(i):
        f, df = ROWS[i]
        trials = []

        def ev(a):
            trials.append(float(a))
            return f(a), df(a), (a,)

        if search == "wolfe":
            out = tdw.device_wolfe(ev, phi0[i], der0[i], (_t(0.0),), old[i],
                                   has_old[i], amax=amax)
        else:
            out = tdw.device_armijo(ev, phi0[i], der0[i], (_t(0.0),), alpha0=1.5)
        return out, trials

    asked = []

    def ev_rows(a):
        asked.append(a.clone())
        phi, der = _rows_eval(a)
        return phi, der, (a,)

    if search == "wolfe":
        a_b, p_b, _, ok_b = tdw.device_wolfe(ev_rows, phi0, der0, (torch.zeros(R,
                                             dtype=torch.float64),), old, has_old,
                                             amax=amax)
    else:
        a_b, p_b, _, ok_b = tdw.device_armijo(ev_rows, phi0, der0, (torch.zeros(
            R, dtype=torch.float64),), alpha0=1.5)
    counts = []
    for i in range(R):
        (a1, p1, _, ok1), trials = unbatched(i)
        assert bool(ok_b[i]) == bool(ok1), i
        assert float(a_b[i]) == float(a1) and float(p_b[i]) == float(p1), i
        # the rows' trials, in order, are the unbatched search's trials
        assert [float(a[i]) for a in asked[:len(trials)]] == trials, i
        counts.append(len(trials))
    assert len(set(counts)) > 1, counts     # the rows stop at other trials

    # one transition of stacked states equals each row's transition
    if search == "wolfe":
        st = tdw.wolfe_init(phi0, der0, old, has_old, (torch.zeros(R, dtype=torch.float64),),
                            amax=amax)
        for _ in range(3):
            a_t = tdw.wolfe_trial(st)
            phi, der = _rows_eval(a_t)
            new = tdw.wolfe_step(st, phi, der, (a_t,), phi0=phi0, derphi0=der0,
                                 amax=amax)
            for i in range(R):
                s1 = tdw.WolfeState(*(f[i] if not isinstance(f, tuple)
                                      else (f[0][i],) for f in st))
                n1 = tdw.wolfe_step(s1, phi[i], der[i], (a_t[i],), phi0=phi0[i],
                                    derphi0=der0[i], amax=amax)
                for fb, f1 in zip(new, n1):
                    fb = fb[0][i] if isinstance(fb, tuple) else fb[i]
                    f1 = f1[0] if isinstance(f1, tuple) else f1
                    assert _same(fb, f1), i
            st = tdw.freeze(st.phase < tdw._DONE, new, st)
    else:
        st = tdw.armijo_init(phi0, (torch.zeros(R, dtype=torch.float64),), alpha0=1.5)
        for _ in range(3):
            phi, _ = _rows_eval(st.trial)
            new = tdw.armijo_step(st, phi, (st.trial,), phi0=phi0, derphi0=der0)
            for i in range(R):
                s1 = tdw.ArmijoState(*(f[i] if not isinstance(f, tuple)
                                       else (f[0][i],) for f in st))
                n1 = tdw.armijo_step(s1, phi[i], (s1.trial,), phi0=phi0[i],
                                     derphi0=der0[i])
                for fb, f1 in zip(new, n1):
                    fb = fb[0][i] if isinstance(fb, tuple) else fb[i]
                    f1 = f1[0] if isinstance(f1, tuple) else f1
                    assert _same(fb, f1), i
            st = tdw.freeze(st.phase < tdw._A_DONE, new, st)


# ---------------------------------------------------------------------------
# PCA: every direction and line search, native rows and one row at a time
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pca():
    p = TPCA(random_spd_matrix(32, seed=3), device="cpu")
    rs = np.random.RandomState(7)
    # the last row starts next to the leading eigenvector: it stops first
    x0 = np.concatenate([rs.rand(4, 32), p.ground_truth()[None] + 1e-6 * rs.rand(1, 32)])
    radii = torch.tensor([[1.0], [0.5], [2.0], [0.05], [1.0]], dtype=torch.float64)
    return p, torch.as_tensor(x0), radii


@pytest.mark.parametrize("forms", ["native", "adapter"])
@pytest.mark.parametrize("ls,direction", [
    ("wolfe", "sd"), ("wolfe", "cg"), ("wolfe", "lbfgs"),
    ("armijo", "sd"), ("armijo", "cg"), ("armijo", "lbfgs")])
def test_pca_rows_match_unbatched(pca, ls, direction, forms):
    """Rows that stop at other iterations (other radii, a converged row
    frozen while the others go on) against their unbatched runs, bitwise
    without the native forms ("adapter": one row at a time). PCA's native rows (products of R columns)
    hold rtol 1e-10 on runs cut before the near-converged iterations,
    where the Wolfe interpolants amplify ulp-level differences of the two
    product orders (as `tests/test_torch_jit_driver.py` cuts its JAX
    comparison). L-BFGS needs the Wolfe search in a sweep as in a single
    run."""
    p, x0, radii = pca
    native = forms == "native"
    if native:   # without the near-converged row
        x0, radii = x0[:4], radii[:4]
    kw = dict(max_iters=12 if native else 60, alpha0=1.0, direction=direction,
              line_search=ls, err_tol=1e-4, f=p.objective,
              rows=row_forms(p) if native else None)
    fg = lambda xs: (p.objective(xs), p.gradient(xs))   # noqa: E731
    if direction == "lbfgs" and ls == "armijo":
        with pytest.raises(ValueError, match="requires line_search='wolfe'"):
            t_jit(fg, p.inner_product, [1.0], **kw)
        return
    opt = t_jit(fg, p.inner_product, [1.0], **kw)
    rb = opt.sweep([x0], radii)
    singles = [opt([x0[i]], radii_dyn=[radii[i, 0]]) for i in range(len(x0))]
    _rows_match(rb, singles, ROW_RTOL if native else None)
    if native:
        return
    its = [int(v) for v in rb.iterations]
    assert len(set(its)) > 1, its
    # a frozen row's history is zeros past its last live iteration (the
    # row at `iterations` records the pass whose search ended it)
    k = min(its)
    i = its.index(k)
    assert torch.all(rb.function_values[i, k + 1:] == 0)
    assert torch.all(rb.step_sizes[i, k:] == 0)


# ---------------------------------------------------------------------------
# SH23 f64 matmul against the port unbatched and the JAX vmap sweep
# ---------------------------------------------------------------------------


SH23_SMALL = dict(npts=64, n_iters=50, dt=0.05)
E0S = [0.02, 0.0725, 0.1]


def test_sh23_sweep_matches_unbatched_and_jax_vmap(one_thread):
    import jax
    import jax.numpy as jnp

    from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg
    from spheremanopt_tpu.optim.jit_driver import jit_optimise_on_multi_sphere as j_jit
    from spheremanopt_tpu.problems.swift_hohenberg import (
        SH23Config as JConfig, SwiftHohenberg as JSH)

    p = SwiftHohenberg(SH23Config(**SH23_SMALL), device="cpu")
    x0 = torch.stack([p.generate_ic(noise=np.random.RandomState(s).randn(p.basis.n_grid))[0]
                      for s in range(3)])
    radii = torch.tensor(E0S, dtype=torch.float64)[:, None]
    kw = dict(max_iters=4, alpha0=float(np.pi), cg=True, line_search="wolfe")
    opt = t_jit(p.objective_and_gradient, p.inner_product, p.radii,
                rows=row_forms(p), **kw)
    rb = opt.sweep([x0], radii)
    singles = [opt([x0[i]], radii_dyn=[E0S[i]]) for i in range(3)]
    _rows_match(rb, singles, ROW_RTOL)

    jp = JSH(JConfig(**SH23_SMALL))
    jopt = j_jit(jp.objective_and_gradient, jp.inner_product, jp.radii, **kw)
    rj = jax.jit(jax.vmap(lambda x, r: jopt([x], radii_dyn=[r])))(
        jnp.asarray(x0.numpy()), jnp.asarray(E0S))
    for i in range(3):
        assert int(rb.iterations[i]) == int(rj.iterations[i]), i
        _close(rb.function_values[i].numpy(), rj.function_values[i], JAX_RTOL, "J")
        _close(rb.step_sizes[i].numpy(), rj.step_sizes[i], JAX_RTOL, "steps")
        _close(rb.x_opt[0][i].numpy(), rj.x_opt[0][i], JAX_RTOL, "x")


def test_sh23_fft_rows_and_armijo_sweep(one_thread):
    """The fft method's native rows, armijo mode with its J-only trials."""
    from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg

    p = SwiftHohenberg(SH23Config(method="fft", **SH23_SMALL), device="cpu")
    x0 = torch.stack([p.generate_ic(seed=s)[0] for s in range(3)])
    forms = row_forms(p)
    assert forms.f_and_g == p.objective_and_gradient_rows
    opt = t_jit(p.objective_and_gradient, p.inner_product, p.radii, max_iters=4,
                alpha0=float(np.pi), line_search="armijo", f=p.objective, rows=forms)
    rb = opt.sweep([x0], torch.tensor(E0S, dtype=torch.float64)[:, None])
    _rows_match(rb, [opt([x0[i]], radii_dyn=[E0S[i]]) for i in range(3)], ROW_RTOL)


# ---------------------------------------------------------------------------
# mixing: one shared operator-stack operand
# ---------------------------------------------------------------------------


def test_mixing_sweep_shares_one_aux_operand(one_thread, monkeypatch, tmp_path):
    from spheremanopt_torch.problems.optimal_mixing import MixingConfig, OptimalMixing

    monkeypatch.setenv("SMO_OP_CACHE", str(tmp_path))
    p = OptimalMixing(MixingConfig(nx=16, nz=16, n_iters=16, prep_steps=4, s=1),
                      device="cpu")
    fg, ops = p.objective_and_gradient_aux
    forms = row_forms(p, aux=True)
    assert forms.f_and_g == p.objective_and_gradient_ops   # native rows
    seen = []

    def fg_rows(a, xs):
        seen.append(a)
        return forms.f_and_g(a, xs)

    opt = t_jit(fg, p.inner_product, p.radii, max_iters=3, alpha0=10.0,
                line_search="wolfe", rows=forms._replace(f_and_g=fg_rows))
    x0 = torch.stack([p.generate_ic(seed=s)[0] for s in range(2)])
    radii = torch.tensor([[0.02], [0.05]], dtype=torch.float64)
    rb = opt.sweep([x0], radii, aux=ops)
    # one operand object for every row and every evaluation
    assert seen and all(a is ops for a in seen)
    assert all(t.shape[0] != 2 for t in ops.values())
    singles = [opt([x0[i]], radii_dyn=[radii[i, 0]], aux=ops) for i in range(2)]
    _rows_match(rb, singles, ROW_RTOL)


# ---------------------------------------------------------------------------
# device RTR over rows
# ---------------------------------------------------------------------------


def test_device_rtr_rows_make_the_unbatched_decisions(one_thread, pca):
    """The counterpart of the JAX package's vmapped RTR test: per-row
    iteration, trial and HVP counts and `converged` equal to the
    unbatched runs, trajectories to rtol 1e-10 on SH23's native matmul
    rows, and bitwise one row at a time (PCA without its rows)."""
    from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg

    p = SwiftHohenberg(SH23Config(npts=32, n_iters=20, dt=0.05), device="cpu")
    x0 = torch.stack([p.generate_ic(seed=s)[0] for s in (1, 2, 42)])
    q, xq, rq = pca
    for prob, x, radii, forms, rtol in (
            (p, x0, None, row_forms(p), ROW_RTOL),
            (q, xq, rq, None, None)):
        radius = getattr(prob, "radii", [1.0])
        opt = t_jrtr(prob.objective, prob.gradient, prob.inner_product, radius,
                     err_tol=1e-6, max_iters=20, rows=forms)
        rb = opt.sweep([x], radii)
        singles = [opt([x[i]], radii_dyn=None if radii is None else [radii[i, 0]])
                   for i in range(len(x))]
        for i, r1 in enumerate(singles):
            assert int(rb.trials[i]) == int(r1.trials), i
            assert int(rb.hvp_evals[i]) == int(r1.hvp_evals), i
            assert bool(rb.converged[i]) == bool(r1.converged), i
        _rows_match(rb, singles, rtol)
        assert len({int(t) for t in rb.hvp_evals}) > 1


# ---------------------------------------------------------------------------
# the problems without a native batched form: one row at a time
# ---------------------------------------------------------------------------


def _unbatched_case(name):
    if name == "sh23-cuda":
        from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg

        p = SwiftHohenberg(SH23Config(npts=32, n_iters=40, dtype="float32",
                                      method="cuda"), device="cpu")
        return p, [p.generate_ic(seed=s) for s in (3, 4)], float(np.pi)
    if name == "shb23":
        from spheremanopt_torch.problems.swift_hohenberg_bounded import (
            SHB23Config, SwiftHohenbergBounded)

        p = SwiftHohenbergBounded(SHB23Config(npts=32, n_iters=40, dtype="float32",
                                              method="cuda"), device="cpu")
        return p, [p.generate_ic(seed=s) for s in (3, 4)], 1.0
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    # the continuous adjoint under "cuda" has no native rows (the discrete
    # one runs the row kernels: tests/test_torch_kdyn_rows.py)
    p = KinematicDynamo(KDynConfig(npts=8, n_iters=10, dt=1e-3, dtype="float32",
                                   method="cuda", adjoint="continuous"), device="cpu")
    return p, [p.generate_ic(seed=s) for s in (3, 4)], 5.0


@pytest.mark.parametrize("name", ["sh23-cuda", "shb23", "kdyn"])
def test_row_adapter_rows_bitwise_unbatched(name, one_thread):
    """A sweep of a problem without native rows runs each row on the
    unbatched loop (in place of a row adapter): each row bitwise its own
    run, the steps of all rows counted in `last_replays`."""
    p, ics, alpha0 = _unbatched_case(name)
    assert row_forms(p) is None
    x0 = [torch.stack([ic[j] for ic in ics]) for j in range(len(ics[0]))]
    opt = t_jit(p.objective_and_gradient, p.inner_product, p.radii, max_iters=2,
                alpha0=alpha0, line_search="wolfe", rows=row_forms(p))
    rb = opt.sweep(x0)
    swept = dict(opt.last_replays)
    singles, steps = [], {}
    for ic in ics:
        singles.append(opt(ic))
        for k, v in opt.last_replays.items():
            steps[k] = steps.get(k, 0) + v
    _rows_match(rb, singles)
    assert swept == steps and rb.function_values.shape[0] == len(ics)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _kernel_sweep_case():
    """SH23 f32 `cuda` at npts 64, N 100, four rows over E0: the card
    tests' sweep."""
    from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg

    torch.backends.cuda.matmul.allow_tf32 = False
    p = SwiftHohenberg(SH23Config(npts=64, n_iters=100, dtype="float32",
                                  method="cuda"), device="cuda")
    x0 = torch.stack([p.generate_ic(seed=s)[0] for s in range(4)])
    radii = torch.tensor([[0.02], [0.05], [0.0725], [0.1]])
    return p, x0, radii


@pytest.mark.requires_cuda
def test_kernel_sweep_rows_bitwise_and_warm_replay():
    """The f32 kernel sweep (SH23 `cuda`) on its native rows: every
    gradient of the sweep one row-forward and one row-reverse launch for
    all rows, in the loop's CUDA graphs. Each row bitwise its unbatched run
    (the row kernels are bitwise the one-row kernels per row, and each
    row's u0 = P x takes the unbatched call's product); a second sweep
    replays the captured graphs (no new capture) bitwise the first, and
    the row kernels launch as many times as the replayed graphs hold (the
    one-row kernels never)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels "
                    "have no CPU mode)")
    from spheremanopt_torch.ops.cuda import fused_two_matrix as fk

    p, x0, radii = _kernel_sweep_case()
    opt = t_jit(p.objective_and_gradient, p.inner_product, p.radii, max_iters=6,
                alpha0=float(np.pi), line_search="wolfe", rows=row_forms(p))
    assert opt.native_rows
    rb = opt.sweep([x0], radii)
    singles = [opt([x0[i]], radii_dyn=[radii[i, 0]]) for i in range(4)]
    _rows_match(rb, singles)
    loops = dict(opt.loops)
    fk.reset_launches()
    rb2 = opt.sweep([x0], radii)
    torch.cuda.synchronize()
    assert opt.loops == loops            # no new capture for the same R
    for a, b in ((rb2.function_values, rb.function_values),
                 (rb2.step_sizes, rb.step_sizes), (rb2.x_opt[0], rb.x_opt[0])):
        assert torch.equal(a, b)
    L = opt.last_loop
    want = {}
    for step, n in opt.last_replays.items():
        for k, d in L.graph_launches(step).items():
            want[k] = want.get(k, 0) + n * d
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == want
    assert want.get("fused_fwd_shared_rows", 0) > 0 and want.get("fused_bwd_shared_rows", 0) > 0
    assert not want.get("fused_fwd_shared_grid") and not want.get("fused_bwd_shared")


@pytest.mark.requires_cuda
def test_kernel_sweep_one_row_at_a_time_bitwise():
    """The same sweep without row forms (`rows=None`, the route of KDyn,
    the continuous adjoint and the widths without row kernels): each row
    on the unbatched loop's CUDA graphs, bitwise its unbatched run, with
    the one-row kernels and never the row kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs and the CUDA kernels "
                    "have no CPU mode)")
    from spheremanopt_torch.ops.cuda import fused_two_matrix as fk

    p, x0, radii = _kernel_sweep_case()
    opt = t_jit(p.objective_and_gradient, p.inner_product, p.radii, max_iters=6,
                alpha0=float(np.pi), line_search="wolfe", rows=None)
    assert not opt.native_rows
    fk.reset_launches()
    rb = opt.sweep([x0], radii)
    torch.cuda.synchronize()
    swept = {k: v for k, v in fk.LAUNCHES.items() if v}
    singles = [opt([x0[i]], radii_dyn=[radii[i, 0]]) for i in range(4)]
    _rows_match(rb, singles)
    assert swept.get("fused_fwd_shared_grid", 0) > 0 and swept.get("fused_bwd_shared", 0) > 0
    assert not swept.get("fused_fwd_shared_rows") and not swept.get("fused_bwd_shared_rows")
