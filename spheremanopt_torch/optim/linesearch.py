"""Armijo backtracking and strong-Wolfe line searches on retracted curves.

The searches minimise phi(a) = f(R_x(a*d)) along the sphere retraction,
following Nocedal & Wright, 'Numerical Optimization' (Algorithms 3.5/3.6
for Wolfe, pp. 56-61 for Armijo with quadratic/cubic interpolation). The
reference (`Sphere_Grad_Descent.py:66-613`) uses the same algorithms via
modified scipy.optimize routines; this is an independent implementation
with identical accept/reject semantics so optimisation trajectories agree.

Framework-free copy of the JAX package's `optim/linesearch.py` (importing
that module would import JAX through the package `__init__`). The
searches run on the host; each phi/derphi evaluation is a complete PDE
solve on the device, so Python-level control flow here costs nothing
relative to the work it schedules.

`wolfe_search` reproduces the reference's gradient-reuse handoff: the
tangent gradient computed for the accepted derphi evaluation is returned
so the outer loop can skip one adjoint solve per iteration
(`Sphere_Grad_Descent.py:336-341,740-741`).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Callable, Optional


class LineSearchWarning(RuntimeWarning):
    pass


# ---------------------------------------------------------------------------
# Interpolation helpers (Nocedal & Wright eq. 3.43/3.57 minimisers)
# ---------------------------------------------------------------------------


def _quad_min(a, fa, dfa, b, fb) -> Optional[float]:
    """Minimiser of the quadratic through (a,fa) with slope dfa and (b,fb)."""
    try:
        db = b - a
        curv = (fb - fa - dfa * db) / (db * db)
        xmin = a - dfa / (2.0 * curv)
    except (ZeroDivisionError, FloatingPointError, OverflowError, ValueError):
        return None
    if not math.isfinite(xmin):
        return None
    return xmin


def _cubic_min(a, fa, dfa, b, fb, c, fc) -> Optional[float]:
    """Minimiser of the cubic through (a,fa),(b,fb),(c,fc), slope dfa at a."""
    try:
        db, dc = b - a, c - a
        denom = (db * dc) ** 2 * (db - dc)
        r1 = fb - fa - dfa * db
        r2 = fc - fa - dfa * dc
        A = (dc * dc * r1 - db * db * r2) / denom
        B = (-(dc ** 3) * r1 + db ** 3 * r2) / denom
        radical = B * B - 3.0 * A * dfa
        if radical < 0.0:
            return None
        xmin = a + (-B + math.sqrt(radical)) / (3.0 * A)
    except (ZeroDivisionError, FloatingPointError, OverflowError, ValueError):
        return None
    if not math.isfinite(xmin):
        return None
    return xmin


# ---------------------------------------------------------------------------
# Armijo backtracking (reference: scalar_search_armijo,
# `Sphere_Grad_Descent.py:138-190`)
# ---------------------------------------------------------------------------


def armijo_search(
    phi: Callable[[float], float],
    phi0: float,
    derphi0: float,
    alpha0: float = 1.0,
    c1: float = 1e-4,
    amin: float = 1e-6,
):
    """Backtrack from alpha0 until phi(a) <= phi0 + c1*a*derphi0.

    Returns (alpha, phi_at_alpha, n_evals); alpha is None on failure.
    Uses a quadratic interpolant for the first backtrack and cubic
    interpolants thereafter, with the reference's step-halving guard.
    """
    n_evals = 0

    def ev(a):
        nonlocal n_evals
        n_evals += 1
        return float(phi(a))

    phi_a0 = ev(alpha0)
    if phi_a0 <= phi0 + c1 * alpha0 * derphi0:
        return alpha0, phi_a0, n_evals

    # Quadratic interpolation for the second trial point.
    alpha1 = -derphi0 * alpha0 * alpha0 / (2.0 * (phi_a0 - phi0 - derphi0 * alpha0))
    if not (math.isfinite(alpha1) and alpha1 > 0.0):
        # an overflowed first trial (phi_a0 = inf from a runaway step)
        # interpolates to +-0.0; evaluating phi(0.0) == phi0 would then
        # "satisfy" the Armijo test with a ZERO step and the outer loop
        # would spin to max_iters making no progress — fail instead
        warnings.warn("Line search interpolated to a non-positive step "
                      "(non-finite first trial)", LineSearchWarning)
        return None, phi_a0, n_evals
    phi_a1 = ev(alpha1)
    if phi_a1 <= phi0 + c1 * alpha1 * derphi0:
        return alpha1, phi_a1, n_evals

    # Cubic interpolation loop.
    while alpha1 > amin:
        factor = alpha0 * alpha0 * alpha1 * alpha1 * (alpha1 - alpha0)
        r0 = phi_a0 - phi0 - derphi0 * alpha0
        r1 = phi_a1 - phi0 - derphi0 * alpha1
        a_coef = (alpha0 * alpha0 * r1 - alpha1 * alpha1 * r0) / factor
        b_coef = (-(alpha0 ** 3) * r1 + alpha1 ** 3 * r0) / factor
        alpha2 = (-b_coef + math.sqrt(abs(b_coef * b_coef - 3.0 * a_coef * derphi0))) / (
            3.0 * a_coef
        )
        phi_a2 = ev(alpha2)
        if phi_a2 <= phi0 + c1 * alpha2 * derphi0:
            return alpha2, phi_a2, n_evals

        # Guard against tiny or insufficient decrease of the trial step.
        if (alpha1 - alpha2) > alpha1 / 2.0 or (1.0 - alpha2 / alpha1) < 0.96:
            alpha2 = alpha1 / 2.0

        alpha0, alpha1 = alpha1, alpha2
        phi_a0, phi_a1 = phi_a1, phi_a2

    return None, phi_a1, n_evals


# ---------------------------------------------------------------------------
# Strong Wolfe (reference: scalar_search_wolfe2 + _zoom,
# `Sphere_Grad_Descent.py:344-613`)
# ---------------------------------------------------------------------------


@dataclass
class WolfeResult:
    alpha: Optional[float]
    phi_star: Optional[float]
    phi0: Optional[float]
    derphi_star: Optional[float]
    n_phi: int = 0
    n_derphi: int = 0


def wolfe_search(
    phi: Callable[[float], float],
    derphi: Callable[[float], float],
    phi0: Optional[float] = None,
    old_phi0: Optional[float] = None,
    derphi0: Optional[float] = None,
    c1: float = 1e-4,
    c2: float = 0.4,
    amax: Optional[float] = None,
    maxiter: int = 10,
) -> WolfeResult:
    """Find alpha satisfying the strong Wolfe conditions.

    Bracketing stage per Nocedal & Wright Algorithm 3.5, zoom per 3.6.
    Note c2=0.4 < 0.5 by default: required for global convergence of
    Fletcher-Reeves-type Riemannian CG (H. Sato & T. Iwai 2015), matching
    the reference default (`Sphere_Grad_Descent.py:198`).
    """
    res = WolfeResult(None, None, phi0, None)

    def ev_phi(a):
        res.n_phi += 1
        return float(phi(a))

    def ev_derphi(a):
        res.n_derphi += 1
        return float(derphi(a))

    if phi0 is None:
        phi0 = ev_phi(0.0)
    if derphi0 is None:
        derphi0 = ev_derphi(0.0)
    res.phi0 = phi0

    # Initial trial step: interpolation from the previous function decrease.
    alpha_prev = 0.0
    if old_phi0 is not None and derphi0 != 0.0:
        alpha_cur = min(1.0, 1.01 * 2.0 * (phi0 - old_phi0) / derphi0)
    else:
        alpha_cur = 1.0
    if alpha_cur < 0.0:
        alpha_cur = 1.0
    if amax is not None:
        alpha_cur = min(alpha_cur, amax)

    phi_cur = ev_phi(alpha_cur)
    phi_prev = phi0
    derphi_prev = derphi0

    def zoom(a_lo, a_hi, phi_lo, phi_hi, derphi_lo):
        """Algorithm 3.6: shrink [a_lo, a_hi] to a Wolfe point."""
        max_zoom = 10
        phi_rec, a_rec = phi0, 0.0
        a_j = None
        for j in range(max_zoom + 1):
            dalpha = a_hi - a_lo
            lo_end, hi_end = (a_hi, a_lo) if dalpha < 0 else (a_lo, a_hi)

            # Cubic first (needs a third point), fall back to quadratic,
            # then bisection when interpolants land too near the ends.
            a_j = None
            if j > 0:
                chk = 0.2 * dalpha
                a_j = _cubic_min(a_lo, phi_lo, derphi_lo, a_hi, phi_hi, a_rec, phi_rec)
                if a_j is not None and (a_j > hi_end - chk or a_j < lo_end + chk):
                    a_j = None
            if a_j is None:
                chk = 0.1 * dalpha
                a_j = _quad_min(a_lo, phi_lo, derphi_lo, a_hi, phi_hi)
                if a_j is None or a_j > hi_end - chk or a_j < lo_end + chk:
                    a_j = a_lo + 0.5 * dalpha

            phi_j = ev_phi(a_j)
            if phi_j > phi0 + c1 * a_j * derphi0 or phi_j >= phi_lo:
                phi_rec, a_rec = phi_hi, a_hi
                a_hi, phi_hi = a_j, phi_j
            else:
                derphi_j = ev_derphi(a_j)
                if abs(derphi_j) <= -c2 * derphi0:
                    return a_j, phi_j, derphi_j
                if derphi_j * (a_hi - a_lo) >= 0:
                    phi_rec, a_rec = phi_hi, a_hi
                    a_hi, phi_hi = a_lo, phi_lo
                else:
                    phi_rec, a_rec = phi_lo, a_lo
                a_lo, phi_lo, derphi_lo = a_j, phi_j, derphi_j
        return None, None, None

    for i in range(maxiter):
        if alpha_cur == 0.0 or (amax is not None and alpha_prev == amax):
            warnings.warn(
                "Line search could not progress (step underflow or amax hit)",
                LineSearchWarning,
            )
            res.alpha, res.phi_star, res.derphi_star = None, phi0, None
            res.phi0 = old_phi0
            return res

        if (phi_cur > phi0 + c1 * alpha_cur * derphi0) or (
            phi_cur >= phi_prev and i > 0
        ):
            a, p, dp = zoom(alpha_prev, alpha_cur, phi_prev, phi_cur, derphi_prev)
            res.alpha, res.phi_star, res.derphi_star = a, p, dp
            return res

        derphi_cur = ev_derphi(alpha_cur)
        if abs(derphi_cur) <= -c2 * derphi0:
            res.alpha, res.phi_star, res.derphi_star = alpha_cur, phi_cur, derphi_cur
            return res

        if derphi_cur >= 0:
            a, p, dp = zoom(alpha_cur, alpha_prev, phi_cur, phi_prev, derphi_cur)
            res.alpha, res.phi_star, res.derphi_star = a, p, dp
            return res

        alpha_next = 2.0 * alpha_cur
        if amax is not None:
            alpha_next = min(alpha_next, amax)
        alpha_prev, alpha_cur = alpha_cur, alpha_next
        phi_prev, derphi_prev = phi_cur, derphi_cur
        phi_cur = ev_phi(alpha_cur)

    warnings.warn("The line search algorithm did not converge", LineSearchWarning)
    res.alpha, res.phi_star, res.derphi_star = alpha_cur, phi_cur, None
    return res
