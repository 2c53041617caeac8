"""Chebyshev spectral primitives on the Gauss (roots) grid.

PyTorch port of the JAX package's `ops/chebyshev.py` (which replaces the
reference's scipy.fftpack DCT quartet and Dedalus Chebyshev machinery,
`FWD_Solve_SHB23.py:36-67`):

  * grid <-> coefficient transform matrices (explicit cosine matrices:
    at the N <= 1024 sizes of these problems they fold into the step
    propagators), and a `torch.fft` DCT path for O(N log N) transforms
  * coefficient-space differentiation matrices (standard recurrence)
  * boundary-evaluation rows T_n^(k)(+-1) for tau boundary conditions
  * trapezoid and Clenshaw-Curtis quadrature weights on the nonuniform
    grid (the reference's `weightMatrixDisc`, `FWD_Solve_SHB23.py:69-81`)

The matrices are the JAX package's numpy code, copied (that module
imports `jax.numpy`), so every operator built from them is bitwise the
same in both packages.

Grid convention: ascending physical coordinate, z_j = c + h*x_j with
x_j = -cos(pi (j + 1/2) / N), matching Dedalus's left-to-right ordering.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch


@dataclass(frozen=True)
class ChebyshevBasis1D:
    """N-mode Chebyshev basis on [z0, z1], roots (Gauss) grid."""

    n: int
    z0: float = -1.0
    z1: float = 1.0

    @property
    def half_width(self) -> float:
        return 0.5 * (self.z1 - self.z0)

    @property
    def center(self) -> float:
        return 0.5 * (self.z1 + self.z0)

    @cached_property
    def x(self) -> np.ndarray:
        """Reference-coordinate roots grid, ascending in (-1, 1)."""
        j = np.arange(self.n)
        return -np.cos(np.pi * (j + 0.5) / self.n)

    @cached_property
    def grid(self) -> np.ndarray:
        return self.center + self.half_width * self.x

    @cached_property
    def theta(self) -> np.ndarray:
        return np.arccos(self.x)

    # ------------------------------------------------------------------
    # transform matrices (numpy, exact)
    # ------------------------------------------------------------------

    @cached_property
    def synthesis(self) -> np.ndarray:
        """V[j, n] = T_n(x_j): coefficients -> grid values."""
        nn = np.arange(self.n)
        return np.cos(np.outer(self.theta, nn))

    @cached_property
    def analysis(self) -> np.ndarray:
        """A = V^{-1} via Gauss-Chebyshev discrete orthogonality:
        a_n = (2 - delta_n0)/N * sum_j u_j cos(n theta_j)."""
        nn = np.arange(self.n)
        w = np.full(self.n, 2.0 / self.n)
        w[0] = 1.0 / self.n
        return w[:, None] * np.cos(np.outer(nn, self.theta))

    # ------------------------------------------------------------------
    # operators in coefficient space
    # ------------------------------------------------------------------

    @cached_property
    def diff_matrix(self) -> np.ndarray:
        """D: Chebyshev coefficients of du/dz (includes the 1/half_width
        affine scale). Standard recurrence: c_n a'_n = 2 sum p a_p over
        p > n with p + n odd (c_0 = 2, else 1)."""
        n = self.n
        d = np.zeros((n, n))
        for p in range(1, n):
            for m in range(p - 1, -1, -2):
                d[m, p] = 2.0 * p
        d[0, :] *= 0.5
        return d / self.half_width

    def deriv_matrix(self, order: int) -> np.ndarray:
        out = np.eye(self.n)
        for _ in range(order):
            out = self.diff_matrix @ out
        return out

    def boundary_row(self, side: str, order: int = 0) -> np.ndarray:
        """Row vector evaluating the order-th z-derivative at an endpoint:
        T_n^(k)(+-1) = (+-1)^(n+k) prod_{j<k} (n^2 - j^2)/(2j + 1)."""
        n = np.arange(self.n).astype(float)
        val = np.ones(self.n)
        for j in range(order):
            val *= (n ** 2 - j ** 2) / (2.0 * j + 1.0)
        sgn = 1.0 if side == "right" else (-1.0) ** (n + order)
        return (sgn * val) / self.half_width ** order

    # ------------------------------------------------------------------
    # quadrature / masks
    # ------------------------------------------------------------------

    @cached_property
    def trapezoid_weights(self) -> np.ndarray:
        """Reference `weightMatrixDisc` semantics: half-cell widths."""
        z = self.grid
        w = np.empty(self.n)
        w[0] = 0.5 * (z[1] - z[0])
        w[-1] = 0.5 * (z[-1] - z[-2])
        w[1:-1] = 0.5 * (z[2:] - z[:-2])
        return w

    @cached_property
    def clenshaw_curtis_weights(self) -> np.ndarray:
        """Exact spectral quadrature on the roots grid:
        w = A^T q with q_n = int_-1^1 T_n dx (0 for odd n)."""
        nn = np.arange(self.n)
        q = np.zeros(self.n)
        even = nn[nn % 2 == 0]
        q[even] = 2.0 / (1.0 - even.astype(float) ** 2)
        q[0] = 2.0
        return (self.analysis.T @ q) * self.half_width

    def dealias_mask(self, frac: float = 0.5) -> np.ndarray:
        """Keep-mask zeroing the top (1-frac) coefficients (the
        reference's top-half zeroing, `FWD_Solve_SHB23.py:583-585`)."""
        return (np.arange(self.n) < frac * self.n).astype(float)


# ---------------------------------------------------------------------------
# O(N log N) transforms via torch.fft (differentiable)
# ---------------------------------------------------------------------------


def _phase(n: int, like: torch.Tensor) -> torch.Tensor:
    """exp(-i pi k / (2N)), k = 0..N-1, in the complex dtype of the real
    tensor `like`."""
    k = torch.arange(n, dtype=like.dtype, device=like.device)
    return torch.exp(-1j * np.pi * k / (2 * n))


def dct2_via_rfft(u: torch.Tensor) -> torch.Tensor:
    """DCT-II along the last axis via even extension + rfft phase shift:
    y_k = 2 sum_j u_j cos(pi k (2j+1) / (2N))."""
    n = u.shape[-1]
    ext = torch.cat([u, u.flip(-1)], dim=-1)
    f = torch.fft.rfft(ext, dim=-1)[..., :n]
    return (f * _phase(n, u)).real


def dct3_via_rfft(a: torch.Tensor) -> torch.Tensor:
    """DCT-III along the last axis: d_j = a_0 + 2 sum_{n>0} a_n
    cos(pi n (2j+1)/(2N)), realised as a phase-shifted irfft."""
    n = a.shape[-1]
    spec = a * _phase(n, a)
    full = torch.cat([spec, spec.new_zeros(a.shape[:-1] + (1,))], dim=-1)
    ext = torch.fft.irfft(full, n=2 * n, dim=-1) * (2 * n)
    return ext[..., 1: n + 1]


def cheb_to_coeff_fft(u: torch.Tensor) -> torch.Tensor:
    """Grid (ascending roots grid) -> Chebyshev coefficients; matches
    ChebyshevBasis1D.analysis. The grid reversal bridges the ascending-z
    convention to DCT ordering."""
    n = u.shape[-1]
    coeff = dct2_via_rfft(u.flip(-1)) / n   # theta-ordered samples
    return torch.cat([0.5 * coeff[..., :1], coeff[..., 1:]], dim=-1)


def cheb_to_grid_fft(a: torch.Tensor) -> torch.Tensor:
    """Chebyshev coefficients -> ascending-grid values (inverse of
    cheb_to_coeff_fft): u_j = sum_n a_n cos(n theta_j)."""
    d = dct3_via_rfft(a)
    return (0.5 * (d + a[..., :1])).flip(-1)
