"""SD/CG/L-BFGS optimiser on a product of spherical manifolds.

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

and the JAX package's Riemannian L-BFGS (`method="lbfgs"`, beyond the
reference): curvature pairs transported to each new tangent plane, the
two-loop recursion under the problem's inner product, pairs failing the
curvature condition skipped, a reset to steepest descent when the
direction is not a descent direction, and a 16 x alpha_0 Wolfe envelope.

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

from spheremanopt_torch.io.checkpoint import save_progress
from spheremanopt_torch.manifold import sphere as geom
from spheremanopt_torch.optim import linesearch as ls


def _curv_eps(dtype) -> float:
    """L-BFGS curvature-skip threshold, relative to ||s||*||y||: 1e-10 in
    f64 (classic), widened to ~32 ULP in f32 where 1e-10 sits far below
    the rounding noise of the transported inner products."""
    return max(1e-10, 32.0 * float(torch.finfo(dtype).eps))


@dataclass
class OptimiseResult:
    """Optimisation state record (reference: `result` class,
    `Sphere_Grad_Descent.py:21-59`)."""

    n_components: int
    x_opt: Optional[List[Any]] = None
    iterations: int = 0
    function_evals: int = 0
    gradient_evals: int = 0
    # Hessian-vector products (RTR only; SD/CG/L-BFGS never form any)
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

    def lbfgs_shift(self, xs_new, alpha, ds_old, gs_old, gs_new, S, Y):
        """L-BFGS history maintenance at the new iterate: transport the
        step alpha*d and the old tangent gradient into x_new's tangent
        plane (transport == projection on the sphere, ref
        `Sphere_Grad_Descent.py:625-642`), form the new curvature pair
        (s, y = g_new - T g_old), re-transport every stored pair, and
        return <s,y>, <y,y> and the keep decision of the curvature test."""
        s = self.tangent(xs_new, [alpha * d for d in ds_old])
        tg = self.tangent(xs_new, gs_old)
        y = [gn - t for gn, t in zip(gs_new, tg)]
        sy, yy, ss = self.slope(s, y), self.slope(y, y), self.slope(s, s)
        keep = bool(sy > _curv_eps(sy.dtype)
                    * torch.sqrt(torch.clamp(ss, min=0.0) * torch.clamp(yy, min=0.0))) \
            and bool(yy > 0.0)
        S2 = tuple(self.tangent(xs_new, si) for si in S)
        Y2 = tuple(self.tangent(xs_new, yi) for yi in Y)
        return s, y, sy, yy, keep, S2, Y2

    def lbfgs_direction(self, xs, gs, S, Y, gamma):
        """Two-loop recursion (Nocedal & Wright Alg. 7.4) over the
        product-manifold inner product, with the initial inverse Hessian
        gamma*I; the result is re-projected onto the tangent plane at xs
        (all inputs are tangent, so this only cleans rounding drift).
        Returns the direction and its slope <g, d>."""
        q = list(gs)
        coeffs = []
        for s, y in zip(reversed(S), reversed(Y)):
            rho = 1.0 / self.slope(y, s)
            a = rho * self.slope(s, q)
            q = [qi - a * yi for qi, yi in zip(q, y)]
            coeffs.append((rho, a))
        r = [gamma * qi for qi in q]
        for (s, y), (rho, a) in zip(zip(S, Y), reversed(coeffs)):
            b = rho * self.slope(y, r)
            r = [ri + (a - b) * si for ri, si in zip(r, s)]
        d = self.tangent(xs, [-ri for ri in r])
        return d, self.slope(gs, d)


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
    lbfgs_memory: int = 8,
) -> OptimiseResult:
    """Minimise f(X) subject to <X_i, X_i> = radii[i] for each component.

    Parameters mirror the reference API (`Sphere_Grad_Descent.py:692`):
    `x0` is a list of 1-D tensors; `f` returns a 0-dim tensor J(X);
    `grad_f` returns the list of Riesz representatives of dJ/dX_i under
    `inner_prod`; `inner_prod` is one callable (shared) or a list of
    per-component callables `(x, y) -> 0-dim tensor`.

    Returns an OptimiseResult; `result.function_values` holds -J(X_k)
    (the reference's sign convention for maximisation problems). A state
    of DTensors (`parallel.mesh.shard_fields`) is gathered once, optimised
    whole on every rank, and x_opt comes back with x0's placements
    (`parallel/sharded.py`).

    `method` selects the search direction: "sd" (steepest descent), "cg"
    (the reference's hybrid FR/PR conjugate gradient — the default when
    `cg=True`), or "lbfgs" (Riemannian limited-memory BFGS with the last
    `lbfgs_memory` curvature pairs; pairs failing <s,y> > 0 are skipped).
    When given it overrides the legacy `cg` flag. L-BFGS also runs under
    the Armijo search, which gives no curvature guarantee: more pairs are
    skipped and the direction degrades toward SD, as in the JAX package.
    """
    from spheremanopt_torch.parallel.sharded import Layout

    layout = Layout.of(x0)
    if layout is not None:
        x0 = layout.gather(x0)
    n = len(radii)
    if method is None:
        method = "cg" if cg else "sd"
    if method not in ("sd", "cg", "lbfgs"):
        raise ValueError(f"method must be sd|cg|lbfgs, got {method!r}")
    cg = method == "cg"
    use_wolfe = line_search == "wolfe"
    # The reference caps Wolfe at amax = alpha_0 (`Sphere_Grad_Descent.py`
    # passes alpha_k as amax) — kept for sd/cg parity. Quasi-Newton
    # directions carry their own scale, and the curvature condition can
    # need steps past alpha_0 when gamma underestimates the local Hessian,
    # so lbfgs gets a wider envelope.
    alpha_max = alpha_k * (16.0 if method == "lbfgs" else 1.0)
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
    # L-BFGS state: transported curvature pairs, the initial
    # inverse-Hessian scale, and the (alpha, d, g) of the last accepted
    # step pending pair formation at the next iterate.
    lb_S: tuple = ()
    lb_Y: tuple = ()
    lb_gamma: float = 1.0
    lb_pending = None

    while max(error) > err_tol and R.iterations < max_iters:
        t_iter = time.perf_counter()

        # --- gradient (with Wolfe handoff reuse, ref :740-741) ---
        if use_wolfe and R.iterations > 1 and derphi_star_grad is not None:
            g_k = derphi_star_grad
        else:
            nab_J = grad_f(x_k)
            g_k = K.tangent(x_k, nab_J)
            grad_evals += 1

        # --- L-BFGS history: form the pair for the step just taken ---
        if method == "lbfgs" and lb_pending is not None:
            a_prev, d_prev, g_prev = lb_pending
            s, y, sy, yy, keep, lb_S, lb_Y = K.lbfgs_shift(
                x_k, a_prev, d_prev, g_prev, g_k, lb_S, lb_Y)
            # keep the pair only when <s,y> is positive beyond rounding
            # (on the sphere Wolfe does not guarantee it: y is formed from
            # transported gradients)
            if keep:
                lb_S = (lb_S + (s,))[-lbfgs_memory:]
                lb_Y = (lb_Y + (y,))[-lbfgs_memory:]
                lb_gamma = float(sy) / float(yy)
            lb_pending = None

        # --- search direction: SD, hybrid FR/PR CG (ref :750-776),
        #     or L-BFGS two-loop ---
        derphi0 = None
        if method == "lbfgs" and lb_S:
            d_k, slope = K.lbfgs_direction(x_k, g_k, lb_S, lb_Y, lb_gamma)
            derphi0 = float(slope)
            if not derphi0 < 0.0:
                # not a descent direction (stale/ill-conditioned history):
                # reset to steepest descent, standard L-BFGS safeguard
                lb_S, lb_Y, lb_gamma = (), (), 1.0
                d_k = [-g for g in g_k]
                derphi0 = None
        elif R.iterations > 1 and cg and g_km1 is not None and d_k is not None:
            d_k = K.cg_direction(x_k, g_k, g_km1, d_k)
        else:
            d_k = [-g for g in g_k]

        # --- line search (Armijo on iteration 0, ref :780-784) ---
        if derphi0 is None:
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
        if method == "lbfgs":
            lb_pending = (alpha_k, d_k, g_k)

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

        if checkpoint_path is not None:
            save_progress(checkpoint_path, R)

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
    if layout is not None:
        R.x_opt = layout.shard(R.x_opt)
    return R
