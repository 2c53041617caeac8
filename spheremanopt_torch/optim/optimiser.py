"""SD/CG optimiser on a product of spherical manifolds.

PyTorch port of the JAX package's `optim/optimiser.py`, the rebuild of
the reference's `Optimise_On_Multi_Sphere`
(`Sphere_Grad_Descent.py:692-838`) with identical algorithmic semantics:

  * normalise X_0 onto the spheres before the first objective evaluation
  * steepest-descent, or conjugate-gradient with the hybrid
    Fletcher-Reeves / Polak-Ribiere rule beta = max(0, min(bFR, bPR))
    (H. Sato, 'Riemannian conjugate gradient methods', 2021)
  * Armijo line search on iteration 0 even when Wolfe is selected
  * Wolfe path reuses the line search's final tangent gradient for the
    next iterate (saves one adjoint solve per iteration)
  * residual recorded from the pre-update tangent gradient
  * failed line search returns early with best-so-far
  * function values recorded negated (problems return -J to maximise)

The geometry (`ManifoldKernels`) is plain tensor code: PyTorch runs
eagerly, so there is nothing to compile. State is a list of 1-D tensors
on the problem's device; scalars cross to the host only for line-search
control flow.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from spheremanopt_torch.manifold import sphere as geom
from spheremanopt_torch.optim import linesearch as ls


@dataclass
class OptimiseResult:
    """Optimisation state record (reference: `result` class,
    `Sphere_Grad_Descent.py:21-59`)."""

    n_components: int
    x_opt: Optional[List[Any]] = None
    iterations: int = 0
    function_evals: int = 0
    gradient_evals: int = 0
    # Hessian-vector products (RTR only; SD/CG never form any)
    hvp_evals: int = 0
    residuals: List[List[float]] = field(default_factory=list)
    step_sizes: List[float] = field(default_factory=list)
    function_values: List[float] = field(default_factory=list)
    converged: bool = False
    message: str = ""
    wall_times: List[float] = field(default_factory=list)

    def __post_init__(self):
        if not self.residuals:
            self.residuals = [[] for _ in range(self.n_components)]

    def __str__(self) -> str:
        k = self.iterations
        err = [r[k - 1] if k > 0 and len(r) >= k else None for r in self.residuals]
        return (
            "Optimise on multi-sphere status\n"
            f"Total iterations     = {self.iterations}\n"
            f"Function evaluations = {self.function_evals}\n"
            f"Gradient evaluations = {self.gradient_evals}\n"
            f"Residual error r_k   = {err}\n"
            f"Step size      a_k   = {self.step_sizes[k-1] if k else None}\n"
            f"J(X_opt)             = {self.function_values[k-1] if k else None}\n"
        )


class ManifoldKernels:
    """Geometry shared by the optimiser loop and the line searches,
    bound to the spheres' radii and inner products (the JAX package's
    jitted `ManifoldKernels`, as plain tensor functions)."""

    def __init__(self, radii: Sequence[float], inner_prod):
        self.radii = tuple(float(r) for r in radii)
        self.ips = geom._as_list(inner_prod, len(self.radii))

    def normalise(self, xs):
        return [geom.normalise_sphere(x, r, ip)
                for x, r, ip in zip(xs, self.radii, self.ips)]

    def retract(self, xs, alpha, ds):
        return [geom.retract(x, alpha, d, r, ip)
                for x, d, r, ip in zip(xs, ds, self.radii, self.ips)]

    def tangent(self, xs, nabs):
        return [geom.tangent_project(x, v, ip)
                for x, v, ip in zip(xs, nabs, self.ips)]

    def slope(self, gs, ds):
        return sum(ip(g, d) for g, d, ip in zip(gs, ds, self.ips))

    def project_transport_slope(self, xs_new, nabs, ds):
        """derphi inner block: tangent gradient at the trial point,
        transport of d, and the slope <g_new, T(d)>
        (ref `Sphere_Grad_Descent.py:305-318`)."""
        gs = self.tangent(xs_new, nabs)
        tds = [geom.transport(x, d, ip) for x, d, ip in zip(xs_new, ds, self.ips)]
        return gs, self.slope(gs, tds)

    def residuals(self, gs):
        return torch.stack([torch.sqrt(ip(g, g)) for g, ip in zip(gs, self.ips)])

    def cg_direction(self, xs, gs, gs_old, ds_old):
        """Hybrid FR/PR direction (ref `Sphere_Grad_Descent.py:750-772`)."""
        beta_fr = 0.0
        beta_pr = 0.0
        tds = []
        for x, g, g_old, d_old, ip in zip(xs, gs, gs_old, ds_old, self.ips):
            gg = ip(g, g)
            gg_old = ip(g_old, g_old)
            beta_fr = beta_fr + gg / gg_old
            tg = geom.transport(x, g_old, ip)
            beta_pr = beta_pr + (gg - ip(g, tg)) / gg_old
            tds.append(geom.transport(x, d_old, ip))
        beta = torch.clamp(torch.minimum(beta_fr, beta_pr), min=0.0)
        return [-g + beta * td for g, td in zip(gs, tds)]


def optimise_on_multi_sphere(
    x0: Sequence[Any],
    radii: Sequence[float],
    f: Callable[[List[Any]], Any],
    grad_f: Callable[[List[Any]], List[Any]],
    inner_prod,
    *,
    err_tol: float = 1e-6,
    max_iters: int = 200,
    alpha_k: float = 1.0,
    line_search: str = "wolfe",
    cg: bool = True,
    callback: Optional[Callable[[int, OptimiseResult], None]] = None,
    verbose: bool = True,
    checkpoint_path: Optional[str] = None,
    log_path: Optional[str] = None,
    wolfe_c1: float = 1e-4,
    wolfe_c2: float = 0.4,
    f_and_g: Optional[Callable[[List[Any]], Any]] = None,
    use_fused_phi: bool = True,
    method: Optional[str] = None,
) -> OptimiseResult:
    """Minimise f(X) subject to <X_i, X_i> = radii[i] for each component.

    Parameters mirror the reference API (`Sphere_Grad_Descent.py:692`):
    `x0` is a list of 1-D tensors; `f` returns a 0-dim tensor J(X);
    `grad_f` returns the list of Riesz representatives of dJ/dX_i under
    `inner_prod`; `inner_prod` is one callable (shared) or a list of
    per-component callables `(x, y) -> 0-dim tensor`.

    Returns an OptimiseResult; `result.function_values` holds -J(X_k)
    (the reference's sign convention for maximisation problems).

    `method` selects the search direction: "sd" or "cg" (the reference's
    hybrid FR/PR conjugate gradient — the default when `cg=True`). When
    given it overrides the legacy `cg` flag.
    """
    n = len(radii)
    if method is None:
        method = "cg" if cg else "sd"
    if method == "lbfgs":
        raise NotImplementedError(
            "method='lbfgs' is not ported yet (ROADMAP Queue 1 item 6)")
    if method not in ("sd", "cg"):
        raise ValueError(f"method must be sd|cg|lbfgs, got {method!r}")
    if checkpoint_path is not None:
        raise NotImplementedError(
            "checkpoint_path is not ported yet (ROADMAP Queue 1 item 9)")
    cg = method == "cg"
    use_wolfe = line_search == "wolfe"
    # The reference caps Wolfe at amax = alpha_0 (`Sphere_Grad_Descent.py`
    # passes alpha_k as amax) — kept for sd/cg parity.
    alpha_max = alpha_k
    K = ManifoldKernels(radii, inner_prod)

    R = OptimiseResult(n_components=n)

    # Normalise onto the spheres, evaluate the starting objective.
    x_k = K.normalise(list(x0))
    R.x_opt = x_k  # valid even if we converge before the first update
    J_k = float(f(x_k))
    J_k_old: Optional[float] = None
    func_evals, grad_evals = 1, 0

    error = np.ones(n)
    derphi_star_grad: Optional[List[Any]] = None
    g_km1: Optional[List[Any]] = None
    d_k: Optional[List[Any]] = None

    while max(error) > err_tol and R.iterations < max_iters:
        t_iter = time.perf_counter()

        # --- gradient (with Wolfe handoff reuse, ref :740-741) ---
        if use_wolfe and R.iterations > 1 and derphi_star_grad is not None:
            g_k = derphi_star_grad
        else:
            nab_J = grad_f(x_k)
            g_k = K.tangent(x_k, nab_J)
            grad_evals += 1

        # --- search direction: SD or hybrid FR/PR CG (ref :750-776) ---
        if R.iterations > 1 and cg and g_km1 is not None and d_k is not None:
            d_k = K.cg_direction(x_k, g_k, g_km1, d_k)
        else:
            d_k = [-g for g in g_k]

        # --- line search (Armijo on iteration 0, ref :780-784) ---
        derphi0 = float(K.slope(g_k, d_k))

        # One-entry (alpha -> gradient) cache: on every ACCEPT path the
        # Wolfe algorithm evaluates derphi(a) right after phi(a) at the
        # same a, so a fused objective-and-gradient in phi makes that
        # derphi a pure lookup: 1 fwd + 1 bwd per accepted trial
        # (`FWD_Solve_SH23.py:499-503,688`). Trials rejected on the
        # sufficient-decrease test paid an unused backward sweep;
        # use_fused_phi=False opts out.
        fused = {}

        def phi(alpha: float) -> float:
            x_new = K.retract(x_k, alpha, d_k)
            if (use_fused_phi and use_wolfe and f_and_g is not None
                    and R.iterations > 0):
                J, nab = f_and_g(x_new)
                fused.clear()
                fused[alpha] = (x_new, nab)
                return float(J)
            return float(f(x_new))

        if R.iterations == 0 or not use_wolfe:
            alpha_k, J_new, n_ev = ls.armijo_search(phi, J_k, derphi0, alpha0=alpha_k)
            func_evals += n_ev
            # Note: J_k_old is only maintained by the Wolfe search (the
            # reference's Armijo path never updates it, ref :781).
            if J_new is not None:
                J_k = J_new
            derphi_star_grad = None
        else:
            store: dict = {}

            def derphi(alpha: float) -> float:
                if alpha in fused:
                    x_new, nab = fused[alpha]
                else:
                    x_new = K.retract(x_k, alpha, d_k)
                    nab = grad_f(x_new)
                g_new, slope = K.project_transport_slope(x_new, nab, d_k)
                store["g"] = g_new
                return float(slope)

            w = ls.wolfe_search(
                phi,
                derphi,
                phi0=J_k,
                old_phi0=J_k_old,
                derphi0=derphi0,
                c1=wolfe_c1,
                c2=wolfe_c2,
                amax=alpha_max,
            )
            alpha_k = w.alpha
            func_evals += w.n_phi
            grad_evals += w.n_derphi
            # Tangent gradient at the accepted point, reused next iter.
            derphi_star_grad = store.get("g") if w.derphi_star is not None else None
            if w.phi_star is not None:
                J_k_old, J_k = w.phi0, w.phi_star

        if alpha_k is None:
            R.message = "Line search failed to find a descent step; terminating."
            if verbose:
                print("\n Couldn't find a descent direction .... Terminating \n")
            break

        if not np.isfinite(float(J_k)):
            # A runaway trial returns a non-finite J that scipy-style
            # Wolfe "accepts" because every NaN comparison is False:
            # treat it as a failed search and keep the best-so-far.
            R.message = ("Line search returned a non-finite objective "
                         "(runaway trial step); terminating with "
                         "best-so-far.")
            if verbose:
                print("\n Non-finite objective in line search .... "
                      "Terminating \n")
            break

        # --- update + residual from pre-update gradient (ref :789-796) ---
        x_k = K.retract(x_k, alpha_k, d_k)
        error = K.residuals(g_k).cpu().numpy()

        R.x_opt = x_k
        R.iterations += 1
        R.function_evals += func_evals
        R.gradient_evals += grad_evals
        func_evals = grad_evals = 0
        for i in range(n):
            R.residuals[i].append(float(error[i]))
        R.step_sizes.append(float(alpha_k))
        R.function_values.append(-1.0 * J_k)
        R.wall_times.append(time.perf_counter() - t_iter)

        g_km1 = g_k

        if callback is not None:
            callback(R.iterations, R)

        if verbose:
            print(R, flush=True)
        if log_path is not None:
            with open(log_path, "a") as log_file:
                log_file.write(str(R) + "\n")

    if max(error) <= err_tol:
        R.converged = True
        R.message = R.message or "Converged: residual below err_tol."
    elif not R.message:
        R.message = "Stopped: max_iters reached."
    return R
