"""PCA on the unit sphere: min J(X) = -(1/2) X^T M X  s.t.  ||X|| = 1.

PyTorch port of the JAX package's `problems/pca.py`: the optimiser
integration test with an analytic ground truth (reference:
`Example_Problems/PCA_example.py`); the minimiser is the leading
eigenvector of the symmetric matrix M, checked against
`numpy.linalg.eigh`.
"""

from __future__ import annotations

import numpy as np
import torch

from spheremanopt_torch.problems.base import RowForms, resolve_device


def random_spd_matrix(dim: int, seed: int = 0, dtype=np.float64) -> np.ndarray:
    """Symmetric matrix with a positive probe quadratic form, exactly the
    reference's `Hessian_Matrix` (`PCA_example.py:14-31`) and the JAX
    package's. Despite the name (kept for parity), a symmetrised Gaussian
    matrix is almost surely indefinite; the optimisation only needs the
    leading eigenvector."""
    rng = np.random.RandomState(seed)
    probe = rng.rand(dim)
    while True:
        m = rng.randn(dim, dim)
        m = 0.5 * (m + m.T)
        if probe @ (m @ probe) > 0:
            return m.astype(dtype)


class PCAProblem:
    """Callable triple (objective, gradient, inner_product) for the
    optimiser, with M on `device` in `dtype`."""

    def __init__(self, m, device="cuda", dtype=torch.float64):
        self.m_np = np.asarray(m)
        self.m = torch.as_tensor(self.m_np, dtype=dtype,
                                 device=resolve_device(device))

    def objective(self, x_list):
        x = x_list[0]
        return -0.5 * torch.dot(x, self.m @ x)

    def gradient(self, x_list):
        # Euclidean gradient of J = -(1/2) x^T M x is -Mx; under the plain
        # dot-product inner product the Riesz representative is itself.
        return [-(self.m @ x_list[0])]

    def inner_product(self, x, y):
        return torch.dot(x, y)

    # -- rows: (R, dim) states, M applied to R columns at once -------------

    def objective_rows(self, x_list):
        x = x_list[0]
        return -0.5 * torch.sum(x * torch.mm(self.m, x.T).T, -1)

    def gradient_rows(self, x_list):
        return [-torch.mm(self.m, x_list[0].T).T]

    def objective_and_gradient_rows(self, x_list):
        mx = torch.mm(self.m, x_list[0].T).T
        return -0.5 * torch.sum(x_list[0] * mx, -1), [-mx]

    def inner_product_rows(self, x, y):
        return torch.sum(x * y, -1)

    def row_forms(self, aux=False):
        """The native forms over rows (`problems.base.row_forms`)."""
        if aux:
            return None
        return RowForms(self.objective_and_gradient_rows, self.objective_rows,
                        self.gradient_rows, self.inner_product_rows)

    def ground_truth(self) -> np.ndarray:
        """Leading eigenvector via LAPACK (`PCA_example.py:123-129`)."""
        vals, vecs = np.linalg.eigh(self.m_np)
        return vecs[:, -1]

    def sd_rate(self) -> float:
        """The reference's printed SD 'theoretical rate' ((k-1)/(k+1))^2
        with kappa = cond(M), reproduced verbatim for parity
        (`PCA_example.py:149-150`). Caveat inherited with it: cond() of
        an (almost surely indefinite) symmetrised Gaussian is
        |lambda|max/|lambda|min, not the eigenvalue-gap ratio the SD
        rate formula assumes; treat it as the reference's diagnostic, not
        a sharp bound."""
        kappa = np.linalg.cond(self.m_np)
        return ((kappa - 1.0) / (kappa + 1.0)) ** 2
