"""The port's trust-region Newton (`spheremanopt_torch/optim/rtr.py`)
against the JAX package's `optim/rtr.py`, at f64 on the CPU.

The Hessian-vector product is checked against the analytic sphere
Hessian (PCA) and by the quadratic model's third-order Taylor remainder,
and against JAX's `riemannian_hvp` on SHB23, whose Chebyshev quadrature
weights are not uniform: a product that applied the Riesz map on the
wrong side (H W^-1 v instead of W^-1 H v) fails there. Host RTR
trajectories must match JAX's `optimise_rtr` (iterations, HVP count,
function values rtol 1e-12, step sizes rtol 1e-10 of the larger of the
step and 1e-3 of the largest step) on PCA, SH23 and the two-sphere KDyn.
The CLI substitutes the plain method for the CUDA kernels under
`--direction rtr`, as the JAX CLI substitutes its XLA path for its
Pallas kernels (tests/test_run_rtr_substitute.py).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.manifold import sphere as geom
from spheremanopt_torch.optim.rtr import optimise_rtr as t_rtr
from spheremanopt_torch.optim.rtr import riemannian_hvp as t_hvp
from spheremanopt_torch.problems.pca import PCAProblem as TPCA
from spheremanopt_tpu.optim.rtr import optimise_rtr as j_rtr
from spheremanopt_tpu.optim.rtr import riemannian_hvp as j_hvp
from spheremanopt_tpu.problems.pca import PCAProblem as JPCA
from spheremanopt_tpu.problems.pca import random_spd_matrix

J_RTOL, S_RTOL = 1e-12, 1e-10


@pytest.fixture
def one_thread():
    """Long loops of small products under forward-mode AD: one intra-op
    thread, so several test workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pca():
    m = random_spd_matrix(64, seed=3)
    return JPCA(m), TPCA(m, device="cpu")


def _unit_and_tangent(seed):
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(64))
    x = x / torch.linalg.norm(x)
    v = geom.tangent_project(x, torch.as_tensor(rng.randn(64)), torch.dot)
    return [x], [v]


def test_hvp_matches_analytic_sphere_hessian(pca):
    """J = -x^T M x / 2 on the unit sphere: Hess[v] = -P_x(Mv) + (x^T M x) v."""
    _, tp = pca
    x, v = _unit_and_tangent(0)
    got = t_hvp(x, v, tp.gradient, tp.inner_product)[0]
    mv = tp.m @ v[0]
    want = -(mv - torch.dot(x[0], mv) * x[0]) + torch.dot(x[0], tp.m @ x[0]) * v[0]
    assert float((got - want).abs().max()) <= 1e-13


def test_quadratic_model_taylor_order3(pca):
    """f(R_x(t v)) - [f + t<g,v> + t^2/2 <v, Hess v>] = O(t^3), order
    3.00 +- 0.05."""
    _, tp = pca
    x, v = _unit_and_tangent(5)
    g = geom.tangent_project(x[0], tp.gradient(x)[0], torch.dot)
    hv = t_hvp(x, v, tp.gradient, tp.inner_product)[0]
    f0 = float(tp.objective(x))
    gv, vhv = float(torch.dot(g, v[0])), float(torch.dot(v[0], hv))
    rem = []
    for t in [1e-2 * 0.5 ** k for k in range(8)]:
        ft = float(tp.objective([geom.retract(x[0], t, v[0], 1.0, torch.dot)]))
        rem.append(abs(ft - (f0 + t * gv + 0.5 * t * t * vhv)))
    orders = [np.log2(rem[i] / rem[i + 1]) for i in range(len(rem) - 1)
              if rem[i + 1] > 1e-15]
    assert len(orders) >= 3
    assert abs(np.mean(orders) - 3.0) < 0.05, orders


def test_shb23_hvp_matches_jax(one_thread):
    """Non-uniform quadrature weights: the product must be W^-1 H v, the
    derivative of the Riesz gradient, as JAX's jvp of grad_f gives."""
    from spheremanopt_torch.problems.swift_hohenberg_bounded import (
        SHB23Config as TC, SwiftHohenbergBounded as TS)
    from spheremanopt_tpu.problems.swift_hohenberg_bounded import (
        SHB23Config as JC, SwiftHohenbergBounded as JS)

    cfg = dict(npts=32, n_iters=20, dt=0.1)
    jp, tp = JS(JC(**cfg)), TS(TC(**cfg), device="cpu")
    w = tp._wt.numpy()
    assert w.max() / w.min() > 2.0          # the weights are not uniform
    x = np.array(jp.generate_ic(seed=1)[0])
    v = np.array(jp.generate_ic(seed=2)[0])
    v = v - (np.sum(w * x * v) / np.sum(w * x * x)) * x   # tangent at x
    hj = np.asarray(j_hvp([jnp.asarray(x)], [jnp.asarray(v)], jp.gradient,
                          jp.inner_product)[0])
    ht = t_hvp([torch.as_tensor(x)], [torch.as_tensor(v)], tp.gradient,
               tp.inner_product)[0].numpy()
    assert np.max(np.abs(ht - hj)) <= 1e-10 * np.max(np.abs(hj))


def _same_rtr(rj, rt):
    assert rt.iterations == rj.iterations and rt.converged == rj.converged
    assert rt.hvp_evals == rj.hvp_evals
    assert rt.message == rj.message
    fj, ft = np.asarray(rj.function_values), np.asarray(rt.function_values)
    sj, st = np.asarray(rj.step_sizes), np.asarray(rt.step_sizes)
    assert np.max(np.abs(ft - fj) / np.abs(fj)) <= J_RTOL
    # the last steps of the quadratic tail shrink to ~1e-6 of the first:
    # each step is held relative to the larger of itself and 1e-3 of
    # the largest step
    scale = np.maximum(np.abs(sj), 1e-3 * np.abs(sj).max())
    assert np.max(np.abs(st - sj) / scale) <= S_RTOL


def test_pca_rtr_matches_jax(pca):
    jp, tp = pca
    x0 = np.random.RandomState(7).rand(64)
    kw = dict(err_tol=1e-8, max_iters=100, verbose=False)
    rj = j_rtr([jnp.asarray(x0)], [1.0], jp.objective, jp.gradient,
               jp.inner_product, **kw)
    rt = t_rtr([torch.as_tensor(x0)], [1.0], tp.objective, tp.gradient,
               tp.inner_product, **kw)
    assert rt.converged
    _same_rtr(rj, rt)
    lam = np.linalg.eigvalsh(tp.m.numpy()).max()
    assert np.isclose(rt.function_values[-1], 0.5 * lam, rtol=1e-10)


def _sh23():
    from spheremanopt_torch.problems.swift_hohenberg import SH23Config as TC
    from spheremanopt_torch.problems.swift_hohenberg import SwiftHohenberg as TS
    from spheremanopt_tpu.problems.swift_hohenberg import SH23Config as JC
    from spheremanopt_tpu.problems.swift_hohenberg import SwiftHohenberg as JS

    cfg = dict(npts=32, n_iters=30, dt=0.05)
    jp = JS(JC(**cfg))
    return jp, TS(TC(**cfg), device="cpu"), [np.array(jp.generate_ic(42)[0])], 20


def _kdyn():
    from spheremanopt_torch.problems.kinematic_dynamo import (
        KDynConfig as TC, KinematicDynamo as TK)
    from spheremanopt_tpu.problems.kinematic_dynamo import (
        KDynConfig as JC, KinematicDynamo as JK)

    cfg = dict(npts=8, n_iters=10, dt=2e-3, dtype="float64")
    jp = JK(JC(**cfg))
    return jp, TK(TC(**cfg), device="cpu"), [np.array(x) for x in
                                            jp.generate_ic(seed=0)], 3


@pytest.mark.parametrize("make", [_sh23, _kdyn], ids=["sh23", "kdyn"])
def test_pde_rtr_matches_jax(make, one_thread):
    jp, tp, x0, max_iters = make()
    kw = dict(err_tol=1e-6, max_iters=max_iters, verbose=False)
    rj = j_rtr([jnp.asarray(x) for x in x0], jp.radii, jp.objective,
               jp.gradient, jp.inner_product, **kw)
    rt = t_rtr([torch.as_tensor(x) for x in x0], tp.radii, tp.objective,
               tp.gradient, tp.inner_product, **kw)
    assert rt.iterations >= 2
    _same_rtr(rj, rt)
    for x, r in zip(rt.x_opt, tp.radii):
        assert abs(float(tp.inner_product(x, x)) / r - 1.0) < 1e-10


def _args(argv):
    from spheremanopt_torch.run import build_parser

    return build_parser().parse_args(argv + ["--device", "cpu"])


@pytest.mark.parametrize("problem,sub", [("sh23", "matmul"), ("shb23", "matmul"),
                                         ("kdyn", "plain")])
def test_rtr_cuda_method_substitutes_plain(problem, sub, capsys):
    from spheremanopt_torch.run import make_problem

    p, _, _ = make_problem(_args([problem, "--direction", "rtr", "--method",
                                  "cuda", "--npts", "8" if problem == "kdyn"
                                  else "32", "--n-iters", "5"]))
    assert p.cfg.method == sub and p.cfg.dtype == "float32"
    assert "substituting" in capsys.readouterr().out
    p, _, _ = make_problem(_args([problem, "--method", "cuda", "--npts",
                                  "8" if problem == "kdyn" else "32",
                                  "--n-iters", "5"]))
    assert p.cfg.method == "cuda"          # only rtr substitutes


def test_rtr_cuda_cli_trajectory_matches_explicit_plain(tmp_path, one_thread):
    """`--direction rtr --method cuda` lands the trajectory of the explicit
    plain config: the substitution is that objective."""
    from spheremanopt_torch.run import main

    outs = {}
    for method in ("cuda", "matmul"):
        out = tmp_path / method
        assert main(["sh23", "--device", "cpu", "--direction", "rtr",
                     "--method", method, "--dtype", "float32", "--npts", "32",
                     "--n-iters", "20", "--max-iters", "3", "--quiet",
                     "--out-dir", str(out)]) == 0
        outs[method] = json.loads((out / "summary.json").read_text())
    for key in ("iterations", "J_final", "residuals_final"):
        assert outs["cuda"][key] == outs["matmul"][key]
