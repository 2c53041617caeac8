"""The port's device-resident RTR (`spheremanopt_torch/optim/jit_rtr.py`)
against the port's host RTR (`optim/rtr.py`) and the JAX package's
`jit_optimise_rtr`, at f64 on the CPU (where its steps run eagerly).

Bar, as in tests/test_jit_rtr.py: iterate-for-iterate parity with the
host driver (PCA bit for bit: the same arithmetic in the same order;
SH23 with a rejected trial), zero histories past the last accepted
iterate, the trial and HVP counts, dynamic radii, the aux operand path,
a tight max_trials that still runs the cap pass, and host/device parity
of the rho_max guard on a synthetic cliff.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.optim.jit_rtr import jit_optimise_rtr as t_jrtr
from spheremanopt_torch.optim.rtr import optimise_rtr as t_rtr
from spheremanopt_torch.problems.base import value_and_raw_gradient
from spheremanopt_torch.problems.pca import PCAProblem as TPCA
from spheremanopt_tpu.optim.jit_rtr import jit_optimise_rtr as j_jrtr
from spheremanopt_tpu.problems.pca import PCAProblem as JPCA
from spheremanopt_tpu.problems.pca import random_spd_matrix


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pca():
    m = random_spd_matrix(64, seed=3)
    return JPCA(m), TPCA(m, device="cpu")


@pytest.fixture(scope="module")
def sh23():
    from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    p = SwiftHohenberg(SH23Config(npts=32, n_iters=30, dt=0.05), device="cpu")
    x0 = p.generate_ic(2)      # a seed whose run rejects one trial
    kw = dict(err_tol=1e-6, max_iters=20)
    host = t_rtr(x0, p.radii, p.objective, p.gradient, p.inner_product,
                 verbose=False, **kw)
    dev = t_jrtr(p.objective, p.gradient, p.inner_product, p.radii, **kw)(x0)
    torch.set_num_threads(n)
    return host, dev


def _x0(dim=64, seed=7):
    return [torch.as_tensor(np.random.RandomState(seed).rand(dim))]


def _bitwise(rd, rh):
    k = int(rd.iterations)
    assert k == rh.iterations
    assert bool(rd.converged) == rh.converged
    assert int(rd.hvp_evals) == rh.hvp_evals
    assert np.array_equal(rd.function_values[:k].numpy(), rh.function_values)
    assert np.array_equal(rd.step_sizes[:k].numpy(), rh.step_sizes)
    assert np.array_equal(rd.residuals[:k, 0].numpy(), rh.residuals[0])
    for xd, xh in zip(rd.x_opt, rh.x_opt):
        assert torch.equal(xd, xh)


def test_device_rtr_matches_host_pca_bitwise(pca):
    _, tp = pca
    kw = dict(err_tol=1e-8, max_iters=100)
    rh = t_rtr(_x0(), [1.0], tp.objective, tp.gradient, tp.inner_product,
               verbose=False, **kw)
    rd = t_jrtr(tp.objective, tp.gradient, tp.inner_product, [1.0], **kw)(_x0())
    _bitwise(rd, rh)
    assert int(rd.trials) == rh.iterations + 1


def test_device_rtr_matches_jax_pca(pca):
    jp, tp = pca
    kw = dict(err_tol=1e-8, max_iters=100)
    rj = j_jrtr(jp.objective, jp.gradient, jp.inner_product, [1.0], **kw)(
        [jnp.asarray(_x0()[0].numpy())])
    rd = t_jrtr(tp.objective, tp.gradient, tp.inner_product, [1.0], **kw)(_x0())
    for name in ("iterations", "trials", "hvp_evals", "converged"):
        assert int(getattr(rd, name)) == int(getattr(rj, name)), name
    fj = np.asarray(rj.function_values)
    assert np.max(np.abs(rd.function_values.numpy() - fj)) <= 1e-12 * np.abs(fj).max()


def test_device_rtr_matches_host_sh23(sh23):
    """A PDE problem with a rejected trust-region trial: the accept/reject
    and radius sequences agree with the host's."""
    rh, rd = sh23
    assert "rejected" in rh.message
    _bitwise(rd, rh)
    # trials = accepted + rejected + the final converged-check step
    assert int(rd.trials) == rh.iterations + 1 + int(
        rh.message.split("(")[-1].split()[0])


def test_device_rtr_history_padding_and_counts(sh23):
    _, rd = sh23
    k = int(rd.iterations)
    assert 0 < k < 20 and bool(rd.converged)
    assert int(rd.trials) < 2 * 20 + 64 and int(rd.hvp_evals) > k
    for h in (rd.function_values, rd.residuals, rd.step_sizes):
        assert float(h[k:].abs().max()) == 0.0


def test_device_rtr_radii_dyn(pca):
    """One optimiser serves a sweep of constraint levels: at each radius
    the host run (delta0 / delta_max matched to the [1.0]-derived
    defaults: dmax = 2, d0 = 0.25) iterate for iterate. At r = 0.5 the run
    stops at the pred-below-roundoff floor short of err_tol; both drivers
    agree on that decision too."""
    _, tp = pca
    opt = t_jrtr(tp.objective, tp.gradient, tp.inner_product, [1.0],
                 err_tol=1e-8, max_iters=100)
    for r, conv in ((0.5, False), (2.0, True)):
        rd = opt(_x0(), radii_dyn=[r])
        rh = t_rtr(_x0(), [r], tp.objective, tp.gradient, tp.inner_product,
                   err_tol=1e-8, max_iters=100, delta0=0.25, delta_max=2.0,
                   verbose=False)
        assert bool(rd.converged) == rh.converged == conv, r
        _bitwise(rd, rh)


def test_device_rtr_aux_operand_path(pca):
    _, tp = pca

    def f_aux(m, xs):
        return -0.5 * torch.dot(xs[0], m @ xs[0])

    def g_aux(m, xs):
        return [-(m @ xs[0])]

    kw = dict(err_tol=1e-8, max_iters=100)
    ra = t_jrtr(f_aux, g_aux, tp.inner_product, [1.0], **kw)(_x0(), aux=tp.m)
    r0 = t_jrtr(tp.objective, tp.gradient, tp.inner_product, [1.0], **kw)(_x0())
    assert int(ra.iterations) == int(r0.iterations)
    assert torch.equal(ra.function_values, r0.function_values)


def test_tight_max_trials_still_runs_the_cap_pass(pca):
    _, tp = pca
    mi = 6
    rh = t_rtr(_x0(), [1.0], tp.objective, tp.gradient, tp.inner_product,
               err_tol=1e-6, max_iters=mi, verbose=False)
    assert rh.iterations == mi
    rd = t_jrtr(tp.objective, tp.gradient, tp.inner_product, [1.0],
                err_tol=1e-6, max_iters=mi, max_trials=mi)(_x0())
    assert int(rd.iterations) == mi
    assert int(rd.trials) == mi + 1          # the exempt cap pass ran
    assert bool(rd.converged) == rh.converged
    assert np.array_equal(rd.function_values.numpy(), rh.function_values)


def test_rho_max_model_breakdown_guard_host_device_parity():
    """A smooth sphere objective with a deep narrow well (depth 1e6, width
    ~0.1): with rho_max the drivers reject the cliff trial and stay on the
    smooth branch, host and device alike (tests/test_jit_rtr.py:259)."""
    n = 32
    rng = np.random.RandomState(5)
    M = rng.rand(n, n)
    M = torch.as_tensor(0.1 * (M + M.T))
    c = rng.rand(n)
    c = torch.as_tensor(c / np.linalg.norm(c))

    def f(xs):
        x = xs[0]
        return x @ M @ x - 1e6 * torch.exp(-torch.sum((x - c) ** 2) / 0.01)

    def grad_f(xs):
        return value_and_raw_gradient(f, xs)[1]

    x0 = [torch.as_tensor(rng.rand(n))]
    kw = dict(err_tol=1e-8, max_iters=25, rho_max=100.0)
    rh = t_rtr(x0, [1.0], f, grad_f, torch.dot, verbose=False, **kw)
    rd = t_jrtr(f, grad_f, torch.dot, [1.0], **kw)(x0)
    _bitwise(rd, rh)
    assert rh.function_values[-1] < 1e3, rh.function_values[-1]


def test_cli_rtr_device_loop(tmp_path, one_thread):
    from spheremanopt_torch.run import main

    out = tmp_path / "run"
    assert main(["sh23", "--device", "cpu", "--npts", "32", "--n-iters", "20",
                 "--max-iters", "3", "--direction", "rtr", "--device-loop",
                 "--quiet", "--out-dir", str(out)]) == 0
    s = json.loads((out / "summary.json").read_text())
    assert s["iterations"] >= 1 and s["J_final"] is not None
    assert "converged" in s and s["trust_region_trials"] >= s["iterations"]
    assert s["hvp_evals"] >= 1
