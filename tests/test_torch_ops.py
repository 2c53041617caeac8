"""Building blocks of the PyTorch port against the JAX package: the 1-D
Fourier basis, the Kahan/strided-step helpers, and the framework-free
line searches and Taylor test that the port carries as copies.

Inputs are seeded numpy arrays handed to both. Tolerances: FFT-based
maps rel 1e-14 in f64 (pocketfft vs ducc summation order); the copied
numpy/math modules must give identical results.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.grad import testgrad as t_testgrad
from spheremanopt_torch.ops import fourier as tf
from spheremanopt_torch.optim import linesearch as t_ls
from spheremanopt_torch.solvers import scan_utils as tsu
from spheremanopt_tpu.grad import testgrad as j_testgrad
from spheremanopt_tpu.ops import fourier as jf
from spheremanopt_tpu.optim import linesearch as j_ls
from spheremanopt_tpu.solvers import scan_utils as jsu

BASIS = dict(n=64, length=12.0 * np.pi, pad_factor=2.0)


def _close(t, j, rtol=1e-14):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * np.abs(j).max())


def test_fourier_basis_matches_jax():
    tb, jb = tf.FourierBasis1D(**BASIS), jf.FourierBasis1D(**BASIS)
    assert (tb.n_grid, tb.n_coeff) == (jb.n_grid, jb.n_coeff)
    np.testing.assert_array_equal(tb.grid(), jb.grid())
    np.testing.assert_array_equal(tb.wavenumbers(), jb.wavenumbers())
    np.testing.assert_array_equal(tf.nyquist_mask_rfft(64), jf.nyquist_mask_rfft(64))
    u = np.random.RandomState(0).randn(2, tb.n_grid)   # batched
    c_t, c_j = tb.to_coeff(torch.as_tensor(u)), jb.to_coeff(jnp.asarray(u))
    _close(torch.view_as_real(c_t), np.stack([np.real(c_j), np.imag(c_j)], -1))
    for over in (True, False):
        _close(tb.to_grid(c_t, over), jb.to_grid(c_j, over))
    f_t = tf.filter_coeff_fraction(c_t, 64, 0.5)
    f_j = jf.filter_coeff_fraction(c_j, 64, 0.5)
    _close(torch.view_as_real(f_t), np.stack([np.real(f_j), np.imag(f_j)], -1))


def test_fourier_roundtrip_is_band_limited_projection():
    b = tf.FourierBasis1D(**BASIS)
    u = torch.as_tensor(np.random.RandomState(1).randn(b.n_grid))
    p = b.to_grid(b.to_coeff(u))
    _close(b.to_grid(b.to_coeff(p)), p.numpy())


@pytest.mark.parametrize("n_steps,stride", [(10, 1), (10, 3), (1000, 20), (7, 7)])
def test_strided_steps_matches_jax(n_steps, stride):
    np.testing.assert_array_equal(tsu.strided_steps(n_steps, stride),
                                  jsu.strided_steps(n_steps, stride))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kahan_sum_matches_jax(dtype):
    vals = np.random.RandomState(2).rand(2000).astype(dtype) * 1e-3
    at = tsu.kahan_zero(getattr(torch, dtype))
    aj = jsu.kahan_zero(jnp.dtype(dtype))
    for v in vals:
        at = tsu.kahan_add(at, torch.as_tensor(v))
        aj = jsu.kahan_add(aj, jnp.asarray(v))
    assert float(at[0]) == float(aj[0])
    exact = math.fsum(float(v) for v in vals)
    assert abs(float(at[0]) - exact) <= 2 * np.finfo(dtype).eps * exact


def _phi_pair():
    """A smooth, non-quadratic 1-D function and its central-difference
    slope: exercises the interpolation branches of both searches."""
    def phi(a):
        return (a - 0.7) ** 2 * (1.0 + 0.3 * math.sin(3 * a)) - 0.5

    def derphi(a, h=1e-7):
        return (phi(a + h) - phi(a - h)) / (2 * h)

    return phi, derphi


@pytest.mark.parametrize("alpha0", [0.1, 1.0, 3.0])
def test_line_searches_are_the_jax_ones(alpha0):
    phi, derphi = _phi_pair()
    a_t = t_ls.armijo_search(phi, phi(0.0), derphi(0.0), alpha0=alpha0)
    a_j = j_ls.armijo_search(phi, phi(0.0), derphi(0.0), alpha0=alpha0)
    assert a_t == a_j
    w_t = t_ls.wolfe_search(phi, derphi, phi0=phi(0.0), derphi0=derphi(0.0),
                            amax=alpha0)
    w_j = j_ls.wolfe_search(phi, derphi, phi0=phi(0.0), derphi0=derphi(0.0),
                            amax=alpha0)
    assert w_t.__dict__ == w_j.__dict__


def test_taylor_test_is_the_jax_one():
    m = np.random.RandomState(3).randn(6, 6)
    m = m + m.T

    def f(xs):
        return float(xs[0] @ m @ xs[0] + np.sin(xs[0]).sum())

    def g(xs):
        return [2 * m @ xs[0] + np.cos(xs[0])]

    x0, dx = [np.linspace(0.1, 0.6, 6)], [np.ones(6)]
    rt = t_testgrad.adjoint_gradient_test(x0, dx, f, g, np.dot, verbose=False)
    rj = j_testgrad.adjoint_gradient_test(x0, dx, f, g, np.dot, verbose=False)
    np.testing.assert_array_equal(rt.table(), rj.table())
    assert abs(rt.gamma2 - 2.0) < 0.05
