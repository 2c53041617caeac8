"""Real-Fourier spectral primitives: padded transforms, wavenumbers, masks.

PyTorch port of the JAX package's `ops/fourier.py`: the 1-D basis and
the triply periodic 3-D basis of the kinematic dynamo. State
lives in rfft coefficient space and nonlinear terms are evaluated on a
zero-padded (oversampled) grid (`pad_factor = 2` is the Dedalus
`dealias=2` convention of SH23).

Conventions: a basis of `n` points retains rfft modes k = 0..n/2 with the
Nyquist mode zeroed (Dedalus v2 Fourier drops Nyquist). Transforms use
numpy's unscaled forward/backward pair with an explicit 1/m on the
forward, so coefficients are grid-size free and `to_grid(to_coeff(u))`
reproduces the band-limited part of u. Everything is autograd-safe and
dtype-generic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def wavenumbers_rfft(n: int, length: float, dtype=np.float64) -> np.ndarray:
    """Angular wavenumbers k_j = 2*pi*j/L for the rfft layout (j=0..n//2)."""
    return (2.0 * np.pi * np.fft.rfftfreq(n, d=1.0 / n) / length).astype(dtype)


def nyquist_mask_rfft(n: int) -> np.ndarray:
    """Boolean keep-mask zeroing the Nyquist mode (Dedalus drops it)."""
    m = np.ones(n // 2 + 1, dtype=bool)
    if n % 2 == 0:
        m[-1] = False
    return m


@dataclass(frozen=True)
class FourierBasis1D:
    """1D real-Fourier basis of `n` modes on [0, length).

    `n_grid` is the oversampled quadrature grid used for nonlinear
    products (n * pad_factor points).
    """

    n: int
    length: float
    pad_factor: float = 2.0

    @property
    def n_grid(self) -> int:
        return int(round(self.n * self.pad_factor))

    @property
    def n_coeff(self) -> int:
        return self.n // 2 + 1

    def grid(self, oversampled: bool = True) -> np.ndarray:
        m = self.n_grid if oversampled else self.n
        return np.arange(m) * (self.length / m)

    def wavenumbers(self, dtype=np.float64) -> np.ndarray:
        return wavenumbers_rfft(self.n, self.length, dtype)

    def to_coeff(self, u_grid: torch.Tensor) -> torch.Tensor:
        """Oversampled grid -> truncated rfft coefficients (band k <= n/2,
        Nyquist zeroed), normalised so coefficients are grid-size free."""
        m = u_grid.shape[-1]
        c = torch.fft.rfft(u_grid, dim=-1) / m
        c = c[..., : self.n_coeff]
        mask = torch.as_tensor(nyquist_mask_rfft(self.n), device=c.device)
        return torch.where(mask, c, torch.zeros((), dtype=c.dtype, device=c.device))

    def to_grid(self, c: torch.Tensor, oversampled: bool = True) -> torch.Tensor:
        """Coefficients -> (oversampled) grid via zero-padded inverse rfft."""
        m = self.n_grid if oversampled else self.n
        pad = m // 2 + 1 - c.shape[-1]
        cp = torch.cat([c, c.new_zeros(c.shape[:-1] + (pad,))], dim=-1)
        return torch.fft.irfft(cp * m, n=m, dim=-1)


@dataclass(frozen=True)
class FourierBasis3D:
    """Triply periodic real-Fourier basis (kinematic dynamo,
    `FWD_Solve_KDyn.py:213-216`). State layout: coefficients of shape
    (n, n, n//2+1) with rfft over the last axis."""

    n: int
    length: float = 2.0 * np.pi
    pad_factor: float = 1.5

    @property
    def n_grid(self) -> int:
        return int(round(self.n * self.pad_factor))

    @property
    def coeff_shape(self) -> Tuple[int, int, int]:
        return (self.n, self.n, self.n // 2 + 1)

    def wavenumber_grids(self, dtype=np.float64):
        """(kx, ky, kz) numpy arrays broadcastable over the coefficient
        array."""
        kfull = 2.0 * np.pi * np.fft.fftfreq(self.n, d=1.0 / self.n) / self.length
        kr = 2.0 * np.pi * np.fft.rfftfreq(self.n, d=1.0 / self.n) / self.length
        kx = kfull.astype(dtype)[:, None, None]
        ky = kfull.astype(dtype)[None, :, None]
        kz = kr.astype(dtype)[None, None, :]
        return kx, ky, kz

    def keep_mask(self) -> np.ndarray:
        """Mask dropping all Nyquist planes (Dedalus keeps k in (-n/2,
        n/2) exclusive), in integer arithmetic: a float test of
        `abs(fftfreq(n)*n)` rounds at many n (98, 196, ...)."""
        idx = np.arange(self.n)
        k_int = np.where(idx <= self.n // 2, idx, idx - self.n)
        full = 2 * np.abs(k_int) < self.n      # |k| < n/2, exact
        r = nyquist_mask_rfft(self.n)
        return full[:, None, None] & full[None, :, None] & r[None, None, :]

    def to_coeff(self, u_grid: torch.Tensor) -> torch.Tensor:
        """Oversampled grid -> truncated, Nyquist-masked coefficients."""
        m = u_grid.shape[-1]
        c = torch.fft.rfftn(u_grid, dim=(-3, -2, -1)) / (m ** 3)
        c = _truncate_3d(c, self.n)
        keep = torch.as_tensor(self.keep_mask(), device=c.device)
        return torch.where(keep, c, torch.zeros((), dtype=c.dtype, device=c.device))

    def to_grid(self, c: torch.Tensor, oversampled: bool = True) -> torch.Tensor:
        m = self.n_grid if oversampled else self.n
        cp = _pad_3d(c, self.n, m)
        return torch.fft.irfftn(cp * (m ** 3), s=(m, m, m), dim=(-3, -2, -1))


def _truncate_3d(c: torch.Tensor, n: int) -> torch.Tensor:
    """Keep the low |k| block of a full-resolution 3D rfftn array."""
    h = n // 2
    lo = c[..., : h + 1, :, :]
    c1 = torch.cat([lo, c[..., -(n - h - 1):, :, :]], dim=-3) if n - h - 1 > 0 else lo
    lo = c1[..., :, : h + 1, :]
    c2 = torch.cat([lo, c1[..., :, -(n - h - 1):, :]], dim=-2) if n - h - 1 > 0 else lo
    return c2[..., :, :, : n // 2 + 1]


def _pad_3d(c: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """Zero-pad truncated coefficients back to an m^3 rfftn layout."""
    if m == n:
        return c
    h = n // 2
    hi = n - h - 1
    out = c.new_zeros(c.shape[:-3] + (m, m, m // 2 + 1))
    out[..., : h + 1, : h + 1, : n // 2 + 1] = c[..., : h + 1, : h + 1, :]
    if hi > 0:
        out[..., m - hi:, : h + 1, : n // 2 + 1] = c[..., h + 1:, : h + 1, :]
        out[..., : h + 1, m - hi:, : n // 2 + 1] = c[..., : h + 1, h + 1:, :]
        out[..., m - hi:, m - hi:, : n // 2 + 1] = c[..., h + 1:, h + 1:, :]
    return out


def filter_coeff_fraction(c: torch.Tensor, n_basis: int, frac: float = 0.5) -> torch.Tensor:
    """Zero the top (1-frac) fraction of 1D coefficient indices.

    Mirrors the reference's `filter_field` noise smoother
    (`FWD_Solve_SH23.py:28-53`): Dedalus stores n/2 complex Fourier
    coefficients indexed 0..n/2-1 and zeros those with index/(n/2) > frac.
    """
    n_coeff = c.shape[-1]
    idx = np.arange(n_coeff) / float(n_basis // 2)
    keep = torch.as_tensor(idx <= frac, device=c.device)
    return torch.where(keep, c, torch.zeros((), dtype=c.dtype, device=c.device))
