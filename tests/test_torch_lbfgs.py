"""Riemannian L-BFGS (`method="lbfgs"`) of the PyTorch port's host loop
against the JAX package's, and the port of the host cases of
`tests/test_lbfgs.py`.

Trajectories in f64 from the same seeded numpy inputs (function values
and iteration counts; a short history keeps the JAX side's compiles, one
per history length, few):
  * PCA (dim 64, memory 4, err_tol 1e-6), Wolfe and Armijo: rel 1e-10
    over the whole run (the same line searches; only the gemv summation
    order differs, at the ulp level). At err_tol 1e-8 the last iteration
    tests a residual at the ulp level and the two runs may stop one
    iteration apart;
  * SH23 at npts=64, n_iters=30 (memory 3, Wolfe, alpha0=pi, fused
    f_and_g as `run.py --direction lbfgs` drives it): rel 1e-9, and the
    step sizes too.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.optim.optimiser import (
    optimise_on_multi_sphere as t_optimise,
)
from spheremanopt_torch.problems.pca import PCAProblem as TPCA
from spheremanopt_torch.problems.pca import random_spd_matrix
from spheremanopt_torch.problems.swift_hohenberg import SH23Config as TConfig
from spheremanopt_torch.problems.swift_hohenberg import SwiftHohenberg as TSH
from spheremanopt_tpu.optim.optimiser import (
    optimise_on_multi_sphere as j_optimise,
)
from spheremanopt_tpu.problems.pca import PCAProblem as JPCA
from spheremanopt_tpu.problems.swift_hohenberg import SH23Config as JConfig
from spheremanopt_tpu.problems.swift_hohenberg import SwiftHohenberg as JSH


@pytest.fixture(scope="module")
def problem():
    return TPCA(random_spd_matrix(64, seed=3), device="cpu")


@pytest.fixture
def one_thread():
    """Long step loops of small matvecs: one intra-op thread, so that
    several test workers on one host do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x0(dim=64, seed=7):
    return [torch.as_tensor(np.random.RandomState(seed).rand(dim))]


def _run(p, x0, radii, method, ls="wolfe", mem=8, alpha=10.0, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return t_optimise(
            x0, radii, p.objective, p.gradient, p.inner_product,
            err_tol=kw.pop("err_tol", 1e-8), max_iters=kw.pop("max_iters", 3000),
            line_search=ls, method=method, lbfgs_memory=mem, alpha_k=alpha,
            verbose=False, **kw)


def _assert_same_trajectory(rj, rt, rtol):
    assert rt.iterations == rj.iterations
    np.testing.assert_allclose(rt.function_values, rj.function_values,
                               rtol=rtol, atol=0)
    assert rt.converged == rj.converged


@pytest.mark.parametrize("ls", ["wolfe", "armijo"])
def test_lbfgs_pca_trajectory_matches_jax(problem, ls):
    kw = dict(err_tol=1e-6, max_iters=2000, line_search=ls, method="lbfgs",
              lbfgs_memory=4, alpha_k=10.0, verbose=False)
    jp = JPCA(problem.m_np)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rj = j_optimise([jnp.asarray(_x0()[0].numpy())], [1.0], jp.objective,
                        jp.gradient, jp.inner_product, **kw)
        rt = t_optimise(_x0(), [1.0], problem.objective, problem.gradient,
                        problem.inner_product, **kw)
    assert rj.iterations > 5
    _assert_same_trajectory(rj, rt, 1e-10)


def test_lbfgs_sh23_host_trajectory_matches_jax(one_thread):
    cfg = dict(npts=64, n_iters=30)
    jp, tp = JSH(JConfig(**cfg)), TSH(TConfig(**cfg), device="cpu")
    x0 = np.array(jp.generate_ic(seed=42)[0])
    kw = dict(max_iters=8, alpha_k=float(np.pi), line_search="wolfe",
              method="lbfgs", lbfgs_memory=3, verbose=False)
    rj = j_optimise([jnp.asarray(x0)], jp.radii, jp.objective, jp.gradient,
                    jp.inner_product, f_and_g=jp.objective_and_gradient, **kw)
    rt = t_optimise([torch.as_tensor(x0)], tp.radii, tp.objective, tp.gradient,
                    tp.inner_product, f_and_g=tp.objective_and_gradient, **kw)
    assert rj.iterations >= 4
    _assert_same_trajectory(rj, rt, 1e-9)
    np.testing.assert_allclose(rt.step_sizes, rj.step_sizes, rtol=1e-9, atol=0)


# ---------------------------------------------------------------------------
# ports of the host cases of tests/test_lbfgs.py
# ---------------------------------------------------------------------------


def test_lbfgs_recovers_leading_eigenvector(problem):
    res = _run(problem, _x0(), [1.0], "lbfgs")
    v = problem.ground_truth()
    err = np.linalg.norm(np.abs(v) - np.abs(res.x_opt[0].numpy()))
    assert err < 1e-4, err
    lam = np.linalg.eigvalsh(problem.m_np).max()
    assert np.isclose(res.function_values[-1], 0.5 * lam, rtol=1e-6)
    # constraint maintained through every two-loop direction + retraction
    assert np.isclose(float(torch.dot(res.x_opt[0], res.x_opt[0])), 1.0,
                      rtol=1e-10)


def test_lbfgs_beats_cg_on_total_solves(problem):
    r_cg = _run(problem, _x0(), [1.0], "cg")
    r_lb = _run(problem, _x0(), [1.0], "lbfgs", mem=20)
    cost_cg = r_cg.function_evals + r_cg.gradient_evals
    cost_lb = r_lb.function_evals + r_lb.gradient_evals
    assert cost_lb < cost_cg, (cost_lb, cost_cg)
    lam = np.linalg.eigvalsh(problem.m_np).max()
    for r in (r_cg, r_lb):
        assert np.isclose(r.function_values[-1], 0.5 * lam, rtol=1e-5)


def test_lbfgs_sh23_matches_cg_optimum_with_fewer_solves(one_thread):
    import jax

    p = TSH(TConfig(npts=64, n_iters=60, dt=0.05), device="cpu")
    # the JAX test's x0: generate_ic(42) from jax.random's draw
    x0 = p.generate_ic(noise=np.asarray(jax.random.normal(
        jax.random.PRNGKey(42), (p.basis.n_grid,), jnp.float64)))
    kw = dict(err_tol=1e-6, max_iters=100, alpha=3.14159,
              f_and_g=p.objective_and_gradient)
    r_cg = _run(p, x0, p.radii, "cg", **kw)
    r_lb = _run(p, x0, p.radii, "lbfgs", **kw)
    assert np.isclose(r_lb.function_values[-1], r_cg.function_values[-1],
                      rtol=1e-5)
    assert (r_lb.function_evals + r_lb.gradient_evals
            < r_cg.function_evals + r_cg.gradient_evals)


def test_lbfgs_armijo_converges_via_curvature_skip(problem):
    """Armijo guarantees decrease but not the curvature condition, so
    some pairs are skipped; the optimiser must still make progress."""
    res = _run(problem, _x0(), [1.0], "lbfgs", ls="armijo",
               err_tol=1e-6, max_iters=3000)
    v = problem.ground_truth()
    err = np.linalg.norm(np.abs(v) - np.abs(res.x_opt[0].numpy()))
    assert err < 1e-3, err


def test_lbfgs_two_sphere_product(problem):
    p2 = TPCA(random_spd_matrix(32, seed=11), device="cpu")

    class Joint:
        def objective(self, xs):
            return problem.objective([xs[0]]) + p2.objective([xs[1]])

        def gradient(self, xs):
            return [problem.gradient([xs[0]])[0], p2.gradient([xs[1]])[0]]

        inner_product = staticmethod(problem.inner_product)

    x0 = [_x0(64, 1)[0], _x0(32, 2)[0]]
    res = _run(Joint(), x0, [1.0, 1.0], "lbfgs", err_tol=1e-7)
    e1 = np.linalg.norm(np.abs(problem.ground_truth()) - np.abs(res.x_opt[0].numpy()))
    e2 = np.linalg.norm(np.abs(p2.ground_truth()) - np.abs(res.x_opt[1].numpy()))
    assert e1 < 1e-3 and e2 < 1e-3, (e1, e2)


def test_method_validation(problem):
    with pytest.raises(ValueError, match="method"):
        t_optimise(_x0(), [1.0], problem.objective, problem.gradient,
                   problem.inner_product, method="newton", max_iters=1,
                   verbose=False)


def test_method_none_respects_legacy_cg_flag(problem):
    """method=None reproduces the cg=True/False behaviour exactly."""
    r_old = _run(problem, _x0(), [1.0], None, max_iters=25, cg=False)
    r_sd = _run(problem, _x0(), [1.0], "sd", max_iters=25)
    np.testing.assert_array_equal(r_old.x_opt[0].numpy(), r_sd.x_opt[0].numpy())
    np.testing.assert_array_equal(r_old.function_values, r_sd.function_values)


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------


def test_cli_direction_lbfgs_and_rtr(tmp_path):
    import json

    from spheremanopt_torch import run

    base = ["sh23", "--device", "cpu", "--npts", "32", "--n-iters", "20",
            "--max-iters", "4", "--quiet", "--out-dir", str(tmp_path)]
    assert run.main(base + ["--direction", "lbfgs", "--lbfgs-memory", "3"]) == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["iterations"] == 4
    # trust-region Newton runs through the same entry point
    args = run.build_parser().parse_args(base + ["--direction", "rtr"])
    p, x0, defaults = run.make_problem(args)
    res = run.optimise(p, x0, defaults, args)
    assert 1 <= res.iterations <= 4 and res.hvp_evals > 0
    assert all(b >= a for a, b in zip(res.function_values,
                                      res.function_values[1:]))
