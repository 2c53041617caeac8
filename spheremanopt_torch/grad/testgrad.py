"""Taylor-remainder adjoint gradient verification.

Framework-free copy of the JAX package's `grad/testgrad.py`, the port of
the reference `Adjoint_Gradient_Test` (`TestGrad.py:5-156`),
after Farrell & Cotter (SIAM JSC 2014): for a correct gradient,

  |J(X + eps dX) - J(X)|                      = O(eps)
  |J(X + eps dX) - J(X) - eps <dX, dJ/dX>|    = O(eps^2)

over successive halvings of eps. Returns the fitted convergence orders;
`gamma2 ~ 2` certifies a discrete-adjoint-exact gradient (autodiff of the
discrete forward), while continuous adjoints plateau at discretisation
error. Doubles as the de-facto unit test for every problem's gradient,
mirroring the reference's verification culture (SURVEY.md section 4).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclass
class TaylorTestResult:
    epsilons: np.ndarray
    remainder1: np.ndarray  # |J(X+eps dX) - J(X)|
    remainder2: np.ndarray  # |J(X+eps dX) - J(X) - eps <dX, dJdX>|
    orders1: np.ndarray     # per-halving convergence exponents of remainder1
    orders2: np.ndarray
    gamma1: float           # mean order, expect ~1
    gamma2: float           # mean order, expect ~2 for discrete adjoints
    fwd_time: float = 0.0
    adj_time: float = 0.0

    def table(self) -> np.ndarray:
        """5 x N array in the reference's .npy layout
        (eps, R1, R2, order1, order2) — `TestGrad.py:122-154`."""
        n = len(self.epsilons)
        out = np.zeros((5, n))
        out[0] = self.epsilons
        out[1] = self.remainder1
        out[2] = self.remainder2
        out[3, : n - 1] = self.orders1
        out[4, : n - 1] = self.orders2
        return out


def adjoint_gradient_test(
    x0: Sequence,
    dx0: Sequence,
    fwd_solve: Callable[[List], float],
    adj_solve: Callable[[List], List],
    inner_prod,
    epsilon: float = 1e-4,
    n_tests: int = 5,
    save_path: Optional[str] = None,
    verbose: bool = True,
) -> TaylorTestResult:
    """Run the Taylor-remainder test for (fwd_solve, adj_solve, inner_prod).

    `x0`, `dx0` are lists of state components (the multi-sphere layout);
    `inner_prod` is one shared callable or a per-component list.
    """
    x0 = list(x0)
    dx0 = list(dx0)
    ips = inner_prod if isinstance(inner_prod, (list, tuple)) else [inner_prod] * len(x0)

    t0 = time.time()
    J_ref = float(fwd_solve(x0))
    fwd_time = time.time() - t0

    t0 = time.time()
    dJdX = adj_solve(x0)
    adj_time = time.time() - t0

    w_adj = 0.0
    for dx, g, ip in zip(dx0, dJdX, ips):
        w_adj += float(ip(dx, g))

    eps = epsilon
    epsilons = np.zeros(n_tests)
    r1 = np.zeros(n_tests)
    r2 = np.zeros(n_tests)
    for t in range(n_tests):
        perturbed = [x + eps * dx for x, dx in zip(x0, dx0)]
        J_fd = float(fwd_solve(perturbed))
        epsilons[t] = eps
        r1[t] = abs(J_fd - J_ref)
        r2[t] = abs(J_fd - J_ref - eps * w_adj)
        if verbose:
            print(
                f"eps={eps:.3e}  |J(X+eps dX)-J(X)|={r1[t]:.6e}  "
                f"|.-eps*<dX,dJ>|={r2[t]:.6e}"
            )
        eps *= 0.5

    def fit_orders(rem):
        # A remainder that underflows to exactly 0.0 (f32 rounding on
        # small-eps rows: the perturbation falls below representable
        # change in J) would make log(r_i/0) inf and poison the gamma
        # means for a CORRECT gradient — leave those rows nan and fit
        # the mean over finite entries only.
        orders = np.full(n_tests - 1, np.nan)
        for i in range(n_tests - 1):
            if rem[i] > 0.0 and rem[i + 1] > 0.0:
                orders[i] = np.log(rem[i] / rem[i + 1]) / np.log(
                    epsilons[i] / epsilons[i + 1]
                )
        return orders

    def finite_mean(orders, fallback):
        finite = orders[np.isfinite(orders)]
        # every row underflowed: the remainder is below rounding at all
        # tested eps, which only a correct term achieves — report the
        # expected order rather than nan
        return float(np.mean(finite)) if finite.size else fallback

    orders1 = fit_orders(r1)
    orders2 = fit_orders(r2)
    result = TaylorTestResult(
        epsilons=epsilons,
        remainder1=r1,
        remainder2=r2,
        orders1=orders1,
        orders2=orders2,
        gamma1=finite_mean(orders1, 1.0),
        gamma2=finite_mean(orders2, 2.0),
        fwd_time=fwd_time,
        adj_time=adj_time,
    )
    if verbose:
        print(f"Gamma TAYLOR   = {result.gamma1:.4f} (expect ~1)")
        print(f"Gamma TAYLOR_2 = {result.gamma2:.4f} (expect ~2)")
        print(f"fwd {fwd_time:.3f}s  adj {adj_time:.3f}s")
    if save_path is not None:
        np.save(save_path, result.table())
    return result
