"""The port's device-resident driver (`spheremanopt_torch/optim/jit_driver.py`)
against the JAX package's `jit_optimise_on_multi_sphere`, at f64 on the
CPU (where the port runs its steps eagerly; the card replays the same
steps as CUDA graphs, `tests/test_torch_graph_loop.py`).

The same seeded numpy inputs go through both drivers; every recorded
function value must agree to rtol 1e-12 and every step size and the end
point to rtol 1e-10, on PCA (wolfe and armijo modes, sd, cg, lbfgs),
SH23, SHB23 and the two-sphere KDyn. PCA runs are cut before the
near-converged iterations, where the Wolfe interpolants amplify the
ulp-level differences of the two gemv orders.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.optim.jit_driver import (
    jit_optimise_on_multi_sphere as t_jit,
)
from spheremanopt_torch.optim.optimiser import (
    optimise_on_multi_sphere as t_host,
)
from spheremanopt_torch.problems.pca import PCAProblem as TPCA
from spheremanopt_tpu.optim.jit_driver import (
    jit_optimise_on_multi_sphere as j_jit,
)
from spheremanopt_tpu.problems.pca import PCAProblem as JPCA
from spheremanopt_tpu.problems.pca import random_spd_matrix

J_RTOL, X_RTOL = 1e-12, 1e-10


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


def _same_run(rj, rt):
    k = int(rj.iterations)
    assert int(rt.iterations) == k
    _close(rt.function_values.numpy(), rj.function_values, J_RTOL, "J")
    _close(rt.step_sizes.numpy(), rj.step_sizes, X_RTOL, "step sizes")
    _close(rt.residuals.numpy(), rj.residuals, X_RTOL, "residuals")
    for xt, xj in zip(rt.x_opt, rj.x_opt):
        _close(xt.numpy(), xj, X_RTOL, "x")


@pytest.fixture(scope="module")
def pca():
    m = random_spd_matrix(48, seed=3)
    return JPCA(m), TPCA(m, device="cpu"), np.random.RandomState(7).rand(48)


def _pca_fg(p):
    return lambda xs: (p.objective(xs), p.gradient(xs))


@pytest.mark.parametrize("ls,direction", [
    ("wolfe", "sd"), ("wolfe", "cg"), ("wolfe", "lbfgs"),
    ("armijo", "sd"), ("armijo", "cg")])
def test_pca_matches_jax(pca, ls, direction):
    jp, tp, x0 = pca
    kw = dict(max_iters=12, alpha0=1.0, direction=direction, line_search=ls,
              err_tol=1e-9)
    rj = j_jit(_pca_fg(jp), jp.inner_product, [1.0], **kw)([jnp.asarray(x0)])
    rt = t_jit(_pca_fg(tp), tp.inner_product, [1.0], **kw)([torch.as_tensor(x0)])
    _same_run(rj, rt)


@pytest.mark.parametrize("direction", ["cg", "sd"])
def test_pca_converges_to_the_leading_eigenvector(pca, direction):
    _, tp, x0 = pca
    r = t_jit(_pca_fg(tp), tp.inner_product, [1.0], max_iters=400,
              alpha0=1.0, direction=direction, line_search="wolfe",
              err_tol=1e-7)([torch.as_tensor(x0)])
    k = int(r.iterations)
    assert 0 < k < 400
    v = tp.ground_truth()
    assert np.linalg.norm(np.abs(v) - np.abs(r.x_opt[0].numpy())) < 1e-5
    assert abs(float(r.x_opt[0] @ r.x_opt[0]) - 1.0) < 1e-12
    assert np.all(np.diff(r.function_values[:k].numpy()) > -1e-12)


def test_convergence_masking_freezes_state(pca):
    """After convergence the loop stops: step sizes and histories past
    the last iteration stay zero, the residual at the stop is below the
    tolerance (JAX _early_exit_loop semantics)."""
    _, tp, x0 = pca
    r = t_jit(_pca_fg(tp), tp.inner_product, [1.0], max_iters=600,
              alpha0=1.0, err_tol=1e-6)([torch.as_tensor(x0)])
    k = int(r.iterations)
    assert k < 600
    assert float(r.step_sizes[k:].abs().max()) == 0.0
    assert float(r.function_values[k:].abs().max()) == 0.0
    assert float(r.residuals[k - 1].max()) < 1e-5


def test_radii_dyn_matches_jax(pca):
    jp, tp, x0 = pca
    kw = dict(max_iters=10, alpha0=1.0, line_search="wolfe")
    rj = j_jit(_pca_fg(jp), jp.inner_product, [1.0], **kw)(
        [jnp.asarray(x0)], radii_dyn=jnp.asarray([2.0]))
    opt = t_jit(_pca_fg(tp), tp.inner_product, [1.0], **kw)
    rt = opt([torch.as_tensor(x0)], radii_dyn=[2.0])
    _same_run(rj, rt)
    assert abs(float(rt.x_opt[0] @ rt.x_opt[0]) - 2.0) < 1e-12
    # the same optimiser at its static radius again
    r1 = opt([torch.as_tensor(x0)])
    assert abs(float(r1.x_opt[0] @ r1.x_opt[0]) - 1.0) < 1e-12


def test_aux_matrix_operand(pca):
    """With aux, f_and_g is called as f_and_g(aux, xs): the operand-passed
    matrix gives the closure's trajectory bit for bit, and JAX's."""
    jp, tp, x0 = pca

    def fg_aux(m, xs):
        return -0.5 * torch.dot(xs[0], m @ xs[0]), [-(m @ xs[0])]

    def jfg_aux(m, xs):
        return -0.5 * xs[0] @ (m @ xs[0]), [-(m @ xs[0])]

    kw = dict(max_iters=10, alpha0=1.0, line_search="wolfe")
    ra = t_jit(fg_aux, tp.inner_product, [1.0], **kw)(
        [torch.as_tensor(x0)], aux=tp.m)
    r0 = t_jit(_pca_fg(tp), tp.inner_product, [1.0], **kw)([torch.as_tensor(x0)])
    assert torch.equal(ra.function_values, r0.function_values)
    assert torch.equal(ra.x_opt[0], r0.x_opt[0])
    rj = j_jit(jfg_aux, jp.inner_product, [1.0], **kw)(
        [jnp.asarray(x0)], aux=jnp.asarray(jp.m))
    _same_run(rj, ra)


def _sh23(npts=48, n_iters=50):
    from spheremanopt_torch.problems.swift_hohenberg import SH23Config as TC
    from spheremanopt_torch.problems.swift_hohenberg import SwiftHohenberg as TS
    from spheremanopt_tpu.problems.swift_hohenberg import SH23Config as JC
    from spheremanopt_tpu.problems.swift_hohenberg import SwiftHohenberg as JS

    cfg = dict(npts=npts, n_iters=n_iters, dt=0.05)
    jp = JS(JC(**cfg))
    return jp, TS(TC(**cfg), device="cpu"), [np.array(jp.generate_ic(seed=42)[0])]


def _shb23():
    from spheremanopt_torch.problems.swift_hohenberg_bounded import (
        SHB23Config as TC, SwiftHohenbergBounded as TS)
    from spheremanopt_tpu.problems.swift_hohenberg_bounded import (
        SHB23Config as JC, SwiftHohenbergBounded as JS)

    cfg = dict(npts=32, n_iters=40, dt=0.1)
    jp = JS(JC(**cfg))
    return jp, TS(TC(**cfg), device="cpu"), [np.array(jp.generate_ic(seed=4)[0])]


def _kdyn():
    from spheremanopt_torch.problems.kinematic_dynamo import (
        KDynConfig as TC, KinematicDynamo as TK)
    from spheremanopt_tpu.problems.kinematic_dynamo import (
        KDynConfig as JC, KinematicDynamo as JK)

    cfg = dict(npts=8, n_iters=20, dt=2e-3, dtype="float64")
    jp = JK(JC(**cfg))
    return jp, TK(TC(**cfg), device="cpu"), [np.array(x) for x in
                                            jp.generate_ic(seed=6)]


PDE_CASES = {
    # (problem maker, alpha0, max_iters, line search, direction)
    "sh23-wolfe-cg": (_sh23, float(np.pi), 8, "wolfe", "cg"),
    "sh23-wolfe-lbfgs": (_sh23, float(np.pi), 8, "wolfe", "lbfgs"),
    "sh23-armijo-cg": (_sh23, float(np.pi), 6, "armijo", "cg"),
    "shb23-wolfe-cg": (_shb23, 1.0, 6, "wolfe", "cg"),
    "kdyn-wolfe-cg": (_kdyn, 5.0, 4, "wolfe", "cg"),
}


@pytest.mark.parametrize("case", sorted(PDE_CASES))
def test_pde_problem_matches_jax(case, one_thread):
    make, alpha0, max_iters, ls, direction = PDE_CASES[case]
    jp, tp, x0 = make()
    kw = dict(max_iters=max_iters, alpha0=alpha0, line_search=ls,
              direction=direction)
    rj = j_jit(jp.objective_and_gradient, jp.inner_product, jp.radii, **kw)(
        [jnp.asarray(x) for x in x0])
    rt = t_jit(tp.objective_and_gradient, tp.inner_product, tp.radii,
               f=tp.objective, **kw)([torch.as_tensor(x) for x in x0])
    assert int(rt.iterations) >= 2
    _same_run(rj, rt)


@pytest.mark.parametrize("direction", ["cg", "sd"])
def test_device_loop_matches_the_host_loop(direction, one_thread):
    """The port's device loop against the port's host loop (f64): the
    same Wolfe decisions, evaluation for evaluation."""
    _, tp, x0 = _sh23(npts=32, n_iters=40)
    x = [torch.as_tensor(x0[0])]
    rh = t_host(x, tp.radii, tp.objective, tp.gradient, tp.inner_product,
                max_iters=6, alpha_k=float(np.pi), line_search="wolfe",
                method=direction, verbose=False,
                f_and_g=tp.objective_and_gradient)
    rd = t_jit(tp.objective_and_gradient, tp.inner_product, tp.radii,
               max_iters=6, alpha0=float(np.pi), line_search="wolfe",
               direction=direction)(x)
    k = rh.iterations
    assert int(rd.iterations) == k
    _close(rd.function_values[:k].numpy(), rh.function_values, J_RTOL, "J")
    _close(rd.step_sizes[:k].numpy(), rh.step_sizes, X_RTOL, "steps")
    _close(rd.x_opt[0].numpy(), rh.x_opt[0].numpy(), X_RTOL, "x")


def test_cli_device_loop_writes_summary(tmp_path, one_thread):
    from spheremanopt_torch.run import main

    out = tmp_path / "run"
    rc = main(["sh23", "--device", "cpu", "--npts", "32", "--n-iters", "20",
               "--max-iters", "4", "--device-loop", "--quiet",
               "--out-dir", str(out)])
    assert rc == 0
    s = json.loads((out / "summary.json").read_text())
    assert s["driver"].startswith("device-resident")
    assert s["iterations"] == 4 and s["J_final"] > 0
    assert len(s["residuals_final"]) == 1 and s["wall_time_total_s"] >= 0
    with pytest.raises(SystemExit, match="lbfgs needs --ls wolfe"):
        main(["sh23", "--device", "cpu", "--npts", "32", "--n-iters", "20",
              "--device-loop", "--direction", "lbfgs", "--ls", "armijo",
              "--quiet", "--out-dir", str(out)])
