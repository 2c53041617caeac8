"""Chebyshev basis of the PyTorch port against the JAX package's.

The matrices, weights and boundary rows are the same numpy code in both
packages, so they must be bitwise equal. The `torch.fft` transforms are
held to the JAX `jnp.fft` ones within 1e-12 (f64; FFTs of another
library sum in another order) and to the explicit matrices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.ops import chebyshev as tc
from spheremanopt_tpu.ops import chebyshev as jc

SIZES = [(16, -1.0, 1.0), (33, -20.0, 20.0)]


def _u(n, seed=0, batch=()):
    return np.random.RandomState(seed).randn(*batch, n)


@pytest.mark.parametrize("n,z0,z1", SIZES)
def test_matrices_weights_and_rows_bitwise_equal_jax(n, z0, z1):
    t, j = tc.ChebyshevBasis1D(n, z0, z1), jc.ChebyshevBasis1D(n, z0, z1)
    for name in ("x", "grid", "theta", "synthesis", "analysis", "diff_matrix",
                 "trapezoid_weights", "clenshaw_curtis_weights"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), name)
    for order in (1, 2, 4):
        np.testing.assert_array_equal(t.deriv_matrix(order), j.deriv_matrix(order))
    for side in ("left", "right"):
        for order in range(4):
            np.testing.assert_array_equal(t.boundary_row(side, order),
                                          j.boundary_row(side, order))
    for frac in (0.25, 0.5):
        np.testing.assert_array_equal(t.dealias_mask(frac), j.dealias_mask(frac))


@pytest.mark.parametrize("name", ["dct2_via_rfft", "dct3_via_rfft",
                                  "cheb_to_coeff_fft", "cheb_to_grid_fft"])
@pytest.mark.parametrize("batch", [(), (3,)], ids=["vector", "batched"])
def test_fft_transforms_match_jax(name, batch):
    u = _u(24, seed=1, batch=batch)
    got = getattr(tc, name)(torch.as_tensor(u))
    want = np.asarray(getattr(jc, name)(jnp.asarray(u)))
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_fft_transforms_match_the_matrices_and_invert():
    b = tc.ChebyshevBasis1D(40, -20.0, 20.0)
    u = _u(40, seed=2)
    coeff = tc.cheb_to_coeff_fft(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(coeff, b.analysis @ u, rtol=0, atol=1e-13)
    back = tc.cheb_to_grid_fft(torch.as_tensor(coeff)).numpy()
    np.testing.assert_allclose(back, b.synthesis @ coeff, rtol=0, atol=1e-13)
    np.testing.assert_allclose(back, u, rtol=0, atol=1e-13)


def test_fft_transform_gradient_is_the_transposed_matrix():
    """Autograd through the FFT path gives A^T v, as the matrix path."""
    b = tc.ChebyshevBasis1D(20)
    u = torch.tensor(_u(20, seed=3), requires_grad=True)
    v = torch.as_tensor(_u(20, seed=4))
    g, = torch.autograd.grad(torch.dot(tc.cheb_to_coeff_fft(u), v), u)
    np.testing.assert_allclose(g.numpy(), b.analysis.T @ v.numpy(), rtol=0,
                               atol=1e-13)


def test_f32_transform_stays_f32():
    u = torch.as_tensor(_u(16, seed=5), dtype=torch.float32)
    got = tc.cheb_to_grid_fft(tc.cheb_to_coeff_fft(u))
    assert got.dtype == torch.float32
    assert float((got - u).abs().max()) < 1e-5
