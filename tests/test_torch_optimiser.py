"""Host optimisation loop of the PyTorch port against the JAX package's.

Trajectories, not just end points: the same seeded numpy inputs go
through both `optimise_on_multi_sphere` implementations in f64 and every
recorded function value must agree.

  * PCA (dim 64): rel 1e-10 over the whole run, same iteration count.
    The line searches are the same code; only the gemv summation order
    (ulp-level) differs, and a converging run damps it.
  * SH23 at npts=128, n_iters=100, max_iters=6 (Wolfe + CG, alpha0=pi,
    fused f_and_g as `run.py` drives it): rel 1e-9 — 100 nonlinear steps
    per solve amplify ulp differences a little more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.optim.optimiser import (
    optimise_on_multi_sphere as t_optimise,
)
from spheremanopt_torch.problems.pca import PCAProblem as TPCA
from spheremanopt_torch.problems.pca import random_spd_matrix as t_spd
from spheremanopt_torch.problems.swift_hohenberg import SH23Config as TConfig
from spheremanopt_torch.problems.swift_hohenberg import SwiftHohenberg as TSH
from spheremanopt_tpu.optim.optimiser import (
    optimise_on_multi_sphere as j_optimise,
)
from spheremanopt_tpu.problems.pca import PCAProblem as JPCA
from spheremanopt_tpu.problems.pca import random_spd_matrix as j_spd
from spheremanopt_tpu.problems.swift_hohenberg import SH23Config as JConfig
from spheremanopt_tpu.problems.swift_hohenberg import SwiftHohenberg as JSH

DIM = 64


def _pca_x0():
    return np.random.RandomState(7).rand(DIM)


def _assert_same_trajectory(rj, rt, rtol):
    assert rt.iterations == rj.iterations
    np.testing.assert_allclose(rt.function_values, rj.function_values,
                               rtol=rtol, atol=0)
    assert rt.converged == rj.converged


def test_random_spd_matrix_is_the_jax_one():
    np.testing.assert_array_equal(t_spd(DIM, seed=3), j_spd(DIM, seed=3))


@pytest.mark.parametrize("ls", ["wolfe", "armijo"])
@pytest.mark.parametrize("cg", [False, True], ids=["sd", "cg"])
def test_pca_trajectory_matches_jax(ls, cg):
    m = j_spd(DIM, seed=3)
    kw = dict(err_tol=1e-8, max_iters=2000, line_search=ls, cg=cg, verbose=False)
    jp, tp = JPCA(m), TPCA(m, device="cpu")
    rj = j_optimise([jnp.asarray(_pca_x0())], [1.0], jp.objective, jp.gradient,
                    jp.inner_product, **kw)
    rt = t_optimise([torch.as_tensor(_pca_x0())], [1.0], tp.objective,
                    tp.gradient, tp.inner_product, **kw)
    assert rj.iterations > 5
    _assert_same_trajectory(rj, rt, 1e-10)


@pytest.mark.parametrize(
    "ls,cg", [("armijo", False), ("wolfe", True), ("armijo", True)]
)
def test_pca_recovers_leading_eigenvector(ls, cg):
    """Same gates as the JAX package's tests/test_optimiser_pca.py."""
    tp = TPCA(t_spd(DIM, seed=3), device="cpu")
    r = t_optimise([torch.as_tensor(_pca_x0())], [1.0], tp.objective,
                   tp.gradient, tp.inner_product, err_tol=1e-8,
                   max_iters=2000, line_search=ls, cg=cg, verbose=False)
    v, x = tp.ground_truth(), r.x_opt[0].numpy()
    assert np.linalg.norm(np.abs(v) - np.abs(x)) < 1e-4
    lam = np.linalg.eigvalsh(tp.m_np).max()
    assert np.isclose(r.function_values[-1], 0.5 * lam, rtol=1e-6)


@pytest.fixture
def one_thread():
    """Long step loops of small matvecs: with several test workers on one
    host, torch's intra-op threads fight over the cores and a loop that
    takes a second alone takes a minute. One thread is as fast alone and
    does not degrade."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sh23_host_loop_trajectory_matches_jax(one_thread):
    cfg = dict(npts=128, n_iters=100)
    jp, tp = JSH(JConfig(**cfg)), TSH(TConfig(**cfg), device="cpu")
    x0 = np.array(jp.generate_ic(seed=42)[0])
    # the first three iterations; the whole pinned trajectory is held on the
    # card (chip_smoke.py, phase F)
    kw = dict(max_iters=3, alpha_k=float(np.pi), line_search="wolfe", cg=True,
              verbose=False)
    rj = j_optimise([jnp.asarray(x0)], jp.radii, jp.objective, jp.gradient,
                    jp.inner_product, f_and_g=jp.objective_and_gradient, **kw)
    rt = t_optimise([torch.as_tensor(x0)], tp.radii, tp.objective, tp.gradient,
                    tp.inner_product, f_and_g=tp.objective_and_gradient, **kw)
    assert rj.iterations == 3
    _assert_same_trajectory(rj, rt, 1e-9)
    assert abs(float(tp.inner_product(rt.x_opt[0], rt.x_opt[0])) - tp.cfg.e0) < 1e-15


@pytest.mark.parametrize("kw,match", [
    (dict(checkpoint_path="DAL_PROGRESS.npz"), "checkpoint_path"),
])
def test_unported_options_raise(kw, match):
    tp = TPCA(t_spd(8, seed=0), device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        t_optimise([torch.ones(8, dtype=torch.float64)], [1.0], tp.objective,
                   tp.gradient, tp.inner_product, verbose=False, **kw)


def test_log_path_records_each_iteration(tmp_path):
    tp = TPCA(t_spd(16, seed=1), device="cpu")
    log = tmp_path / "optimize_result.txt"
    r = t_optimise([torch.ones(16, dtype=torch.float64)], [1.0], tp.objective,
                   tp.gradient, tp.inner_product, max_iters=4, verbose=False,
                   log_path=str(log))
    assert log.read_text().count("Total iterations") == r.iterations == 4
