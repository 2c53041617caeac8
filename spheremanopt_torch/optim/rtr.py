"""Riemannian trust-region Newton (RTR) on a product of spheres.

PyTorch port of the JAX package's `optim/rtr.py`: the RTR of Absil,
Baker & Gallivan ('Trust-region methods on Riemannian manifolds', FoCM
2007) with a Steihaug-Toint truncated-CG subproblem solver, on exact
Hessian-vector products. The reference has no second-order optimiser
(its driver is SD/CG + line search, `Sphere_Grad_Descent.py:692-838`).

Geometry. For a sphere component {x : <x,x>_M = r} with a constant metric
<.,.>_M, P_x the tangent projection and nabla f(x) the Riesz gradient the
problems return, the Riemannian Hessian is

    Hess f(x)[v] = P_x( D nabla f(x)[v] ) - (<x, nabla f>_M / <x,x>_M) v

for tangent v: the projected directional derivative of the gradient plus
the sphere's Weingarten (curvature) correction.

Hessian-vector products. The JAX package linearizes `grad_f` once per
outer iteration (`jax.linearize`) and every tCG product is a tangent
sweep. Here each product is forward over reverse: `grad_f` is called on
`torch.autograd.forward_ad` dual tensors (x, v), and the tangent of its
output is D nabla f(x)[v]. The problems' gradients are reverse-mode
autograd (`problems/base.py` `value_and_raw_gradient`, which keeps the
tangents), and the tangent runs through the whole Riesz map (the
quadrature weights, KDyn's Leray projection), so the product is the
derivative of exactly the gradient the optimiser uses. Each product
recomputes the primal forward and backward beside the tangents. The CUDA
kernels' autograd Functions have no forward-mode rule, so RTR runs on a
problem's plain method (the CLI substitutes it, `run.py`).

The tCG stopping rule ||r_j|| <= ||r_0|| min(||r_0||^theta, kappa)
(theta = 1) gives local Q-quadratic convergence.

`build_full_step` builds the fused step (gradient and residuals ->
tCG -> trial point and J) in parts that the host driver here and the
device loop (`optim/jit_rtr.py`) share: the host loop reads the tCG's
stop flag once per product, the device loop replays each part as a CUDA
graph.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from spheremanopt_torch.manifold import sphere as geom
from spheremanopt_torch.optim.optimiser import OptimiseResult


def gradient_jvp(grad_f, xs, vs):
    """(grad_f(xs), D grad_f(xs)[vs]): `grad_f` on dual tensors, forward
    over reverse."""
    with fwAD.dual_level():
        out = grad_f([fwAD.make_dual(x, v) for x, v in zip(xs, vs)])
        parts = [fwAD.unpack_dual(o) for o in out]
        nab = [p.primal.detach() for p in parts]
        dnab = [torch.zeros_like(n) if p.tangent is None else p.tangent.detach()
                for p, n in zip(parts, nab)]
    return nab, dnab


def riemannian_hvp(xs, vs, grad_f, inner_prod):
    """Hessian-vector product Hess f(xs)[vs] on the product of spheres.

    `grad_f` returns the list of Riesz gradients under `inner_prod` and
    must carry forward-mode tangents (plain torch operations and reverse
    autograd do); `vs` must be tangent at `xs`.
    """
    ips = geom._as_list(inner_prod, len(xs))
    nab, dnab = gradient_jvp(grad_f, list(xs), list(vs))
    out = []
    for x, n, dn, v, ip in zip(xs, nab, dnab, vs, ips):
        pdn = dn - (ip(x, dn) / ip(x, x)) * x          # P_x(D nabla[v])
        out.append(pdn - (ip(x, n) / ip(x, x)) * v)    # Weingarten term
    return out


class FullStep:
    """The fused RTR step: gradient/residuals -> Steihaug-Toint tCG ->
    trial point + J, in three parts (`begin`, `cg`, `finish`) over a dict
    of tensors. `radii` are 0-dim tensors in the state's dtype.

    Calling it, `full_step(xs, delta, check_only=False) -> (err, eta_norm,
    pred, hit, n_hvp, x_trial, J_trial)`, runs the parts with the tCG loop
    on the host. `check_only` marks the final pass at the max_iters cap:
    only the residuals are needed, so the tCG is skipped and (a Python
    True) the trial objective is not evaluated (J_trial = +inf, never
    consumed). The device loop passes a tensor flag and pays the trial's
    forward solve, as the JAX device loop does.
    """

    def __init__(self, radii, inner_prod, f: Callable, grad_f: Callable,
                 theta: float, kappa: float, max_cg: int, err_tol: float):
        self.radii = list(radii)
        self.ips = geom._as_list(inner_prod, len(self.radii))
        self.f, self.grad_f = f, grad_f
        self.theta, self.kappa = theta, kappa
        self.max_cg, self.err_tol = int(max_cg), float(err_tol)

    def _slope(self, a, b):
        return sum(ip(x, y) for x, y, ip in zip(a, b, self.ips))

    def _tangent(self, xs, vs):
        return [geom.tangent_project(x, v, ip)
                for x, v, ip in zip(xs, vs, self.ips)]

    def begin(self, xs, check_only=False) -> dict:
        """The gradient, residuals and Weingarten coefficients at xs and
        the tCG's start: min_eta <g,eta> + 0.5 <eta, H eta> s.t.
        ||eta|| <= delta."""
        nab = self.grad_f(list(xs))
        g = self._tangent(xs, nab)
        err = torch.stack([torch.sqrt(ip(gi, gi)) for gi, ip in zip(g, self.ips)])
        coeff = [ip(x, nb) / ip(x, x) for x, nb, ip in zip(xs, nab, self.ips)]
        rr0 = self._slope(g, g)
        norm_r0 = torch.sqrt(rr0)
        # superlinear stopping (theta=1 -> local Q-quadratic)
        stop = norm_r0 * torch.clamp(norm_r0 ** self.theta, max=self.kappa)
        # skip the subproblem when the outer loop is about to declare
        # convergence (the host's predicate), or on the check-only pass
        done = (norm_r0 == 0.0) | (torch.max(err) <= self.err_tol)
        if check_only is not False:    # Python True, or a tensor flag
            done = done | torch.as_tensor(check_only, device=done.device)
        return dict(err=err, coeff=coeff, stop=stop,
                    eta=[torch.zeros_like(gi) for gi in g], r=list(g),
                    p=[-gi for gi in g], rr=rr0, mval=torch.zeros_like(rr0),
                    j=torch.zeros((), dtype=torch.int64, device=rr0.device),
                    done=done, hit=torch.zeros_like(done))

    def more(self, st):
        """Whether the tCG takes another step (a 0-dim bool tensor)."""
        return ~st["done"] & (st["j"] < self.max_cg)

    def cg(self, xs, st, delta) -> dict:
        """One tCG step: one Hessian-vector product."""
        eta, r, p, rr, mval = st["eta"], st["r"], st["p"], st["rr"], st["mval"]
        _, dnab = gradient_jvp(self.grad_f, list(xs), p)
        pdn = self._tangent(xs, dnab)
        hp = [pd - c * v for pd, c, v in zip(pdn, st["coeff"], p)]
        php = self._slope(p, hp)
        pp = self._slope(p, p)
        ep = self._slope(eta, p)
        ee = self._slope(eta, eta)
        pr = self._slope(p, r)
        # step to the trust boundary along p (positive root)
        disc = torch.clamp(ep * ep + pp * (delta * delta - ee), min=0.0)
        tau = (-ep + torch.sqrt(disc)) / pp
        alpha = rr / php
        ee_after = ee + 2.0 * alpha * ep + alpha * alpha * pp
        boundary = (php <= 0.0) | (ee_after >= delta * delta)
        step = torch.where(boundary, tau, alpha)
        eta2 = [e + step * pi for e, pi in zip(eta, p)]
        # model change along p, computed directly (robust to CG
        # orthogonality drift): step*<p,r> + 0.5 step^2 <p,Hp>
        mval2 = mval + step * pr + 0.5 * step * step * php
        r2 = [ri + step * hi for ri, hi in zip(r, hp)]
        rr2 = self._slope(r2, r2)
        small = torch.sqrt(rr2) <= st["stop"]
        beta = rr2 / rr
        p2 = [-r2i + beta * pi for r2i, pi in zip(r2, p)]
        return dict(eta=eta2, r=r2, p=p2, rr=rr2, mval=mval2, j=st["j"] + 1,
                    done=boundary | small, hit=st["hit"] | boundary)

    def finish(self, xs, st, skip_f=False):
        """(err, eta_norm, pred, hit, n_hvp, x_trial, J_trial)."""
        eta = st["eta"]
        eta_norm = torch.sqrt(self._slope(eta, eta))
        xn = [geom.retract(x, 1.0, e, r, ip)
              for x, e, r, ip in zip(xs, eta, self.radii, self.ips)]
        if skip_f:
            J_trial = torch.full((), float("inf"), dtype=eta_norm.dtype,
                                 device=eta_norm.device)
        else:
            J_trial = self.f(xn)
        return st["err"], eta_norm, -st["mval"], st["hit"], st["j"], xn, J_trial

    def __call__(self, xs, delta, check_only=False):
        st = self.begin(xs, check_only)
        while bool(self.more(st)):
            st.update(self.cg(xs, st, delta))
        return self.finish(xs, st, skip_f=check_only is True)


def build_full_step(radii, inner_prod, f: Callable, grad_f: Callable,
                    theta: float, kappa: float, max_cg: int,
                    err_tol: float) -> FullStep:
    """The fused RTR step (see `FullStep`); `radii` floats or 0-dim
    tensors."""
    return FullStep(radii, inner_prod, f, grad_f, theta, kappa, max_cg, err_tol)


def sphere_radii(radii, like):
    """`radii` as 0-dim tensors in `like`'s dtype and device."""
    return [torch.as_tensor(r, dtype=like.dtype, device=like.device)
            for r in radii]


def optimise_rtr(
    x0: Sequence[Any],
    radii: Sequence[float],
    f: Callable[[List[Any]], Any],
    grad_f: Callable[[List[Any]], List[Any]],
    inner_prod,
    *,
    err_tol: float = 1e-6,
    max_iters: int = 200,
    delta0: Optional[float] = None,
    delta_max: Optional[float] = None,
    rho_accept: float = 0.1,
    rho_max: Optional[float] = None,
    theta: float = 1.0,
    kappa: float = 0.1,
    max_cg: int = 50,
    callback: Optional[Callable[[int, OptimiseResult], None]] = None,
    verbose: bool = True,
    checkpoint_path: Optional[str] = None,
    log_path: Optional[str] = None,
) -> OptimiseResult:
    """Minimise f(X) subject to <X_i, X_i> = radii[i] by trust-region
    Newton with truncated-CG subproblems and forward-over-reverse HVPs.

    Same callable-triple contract as `optimise_on_multi_sphere`: `f`
    returns a 0-dim tensor, `grad_f` the Riesz gradients (which must
    carry forward-mode tangents: a problem's plain method), `inner_prod`
    one callable or a per-component list.

    Returns an OptimiseResult (function_values hold -J, residuals from
    the pre-update tangent gradient, step_sizes hold ||eta||_x).
    `hvp_evals` counts Hessian-vector products across all tCG solves.
    """
    if checkpoint_path is not None:
        raise NotImplementedError(
            "checkpoint_path is not ported yet (ROADMAP Queue 1 item 7)")
    n = len(radii)
    sphere_scale = float(np.sqrt(sum(float(r) for r in radii)))
    if delta_max is None:
        delta_max = 2.0 * sphere_scale     # beyond a diameter is meaningless
    if delta0 is None:
        delta0 = delta_max / 8.0
    xs0 = [torch.as_tensor(x) for x in x0]
    rr = sphere_radii(radii, xs0[0])
    ips = geom._as_list(inner_prod, n)
    K = build_full_step(rr, ips, f, grad_f, theta, kappa, int(max_cg),
                        float(err_tol))

    R = OptimiseResult(n_components=n)
    log_file = open(log_path, "a") if log_path else None

    x_k = [geom.normalise_sphere(x, r, ip) for x, r, ip in zip(xs0, rr, ips)]
    R.x_opt = x_k
    J_k = float(f(x_k))
    R.function_evals += 1
    delta = float(delta0)
    delta_min = 1e-10 * float(delta0)
    rejects = 0
    converged = False

    def _step(xs, dlt, check_only=False):
        out = K(xs, torch.as_tensor(dlt, dtype=xs[0].dtype, device=xs[0].device),
                check_only=check_only)
        # one primal gradient, one trial objective and n_hvp products per
        # step; the check-only cap pass spends the gradient alone
        R.gradient_evals += 1
        if not check_only:
            R.function_evals += 1
        R.hvp_evals += int(out[4])
        return out

    t_iter = time.perf_counter()
    out = _step(x_k, delta, R.iterations >= max_iters)
    # the objective dtype's eps, for the pred-below-roundoff stop
    j_eps = float(torch.finfo(out[6].dtype).eps)
    while True:
        err, eta_norm, pred, hit, _n_hvp, x_trial, J_trial = out
        err = err.cpu().numpy()
        if max(err) <= err_tol:
            converged = True
            break
        if R.iterations >= max_iters:
            break
        pred, J_trial, hit = float(pred), float(J_trial), bool(hit)

        if pred <= 0.0 or not np.isfinite(pred):
            # the model predicts no decrease only when g ~ 0 at machine
            # precision (tCG starts along -g): nothing left to do
            R.message = ("tCG predicted no model decrease (gradient at "
                         "roundoff); terminating with best-so-far.")
            break
        if pred < 4.0 * j_eps * (1.0 + abs(J_k)):
            # the predicted decrease sits below the objective's own
            # rounding: rho is noise from here on
            R.message = ("Model decrease below objective roundoff "
                         f"(pred={pred:.2e} < ~eps(J)); iterate at the "
                         "floating-point floor of J. Terminating with "
                         "best-so-far.")
            break
        rho = ((J_k - J_trial) / pred
               if np.isfinite(J_trial) else -np.inf)
        if rho_max is not None and rho > rho_max:
            # model-breakdown guard: an actual decrease orders beyond the
            # quadratic model's prediction means a cliff inside the trust
            # region (KDyn: the CNAB1 CFL-instability region, where the
            # discrete objective is unbounded below); reject and shrink
            rho = -np.inf

        # standard radius update (Absil-Baker-Gallivan Alg. 1)
        if rho < 0.25:
            delta *= 0.25
        elif rho > 0.75 and hit:
            delta = min(2.0 * delta, float(delta_max))

        if rho > rho_accept:
            x_k, J_k = x_trial, J_trial
            R.x_opt = x_k
            R.iterations += 1
            # residual recorded from the PRE-update gradient, matching
            # the reference driver (`Sphere_Grad_Descent.py:796`)
            for i in range(n):
                R.residuals[i].append(float(err[i]))
            R.step_sizes.append(float(eta_norm))
            R.function_values.append(-1.0 * J_k)
            # wall time since the last ACCEPTED iterate (rejected trials
            # accumulate into the accepting iteration)
            R.wall_times.append(time.perf_counter() - t_iter)
            t_iter = time.perf_counter()
            if callback is not None:
                callback(R.iterations, R)
            if verbose:
                print(R, flush=True)
            if log_file is not None:
                log_file.write(str(R) + "\n")
                log_file.flush()
        else:
            rejects += 1
            if delta < delta_min:
                R.message = ("Trust radius collapsed below delta_min "
                             "without an acceptable step; terminating "
                             "with best-so-far.")
                break
        out = _step(x_k, delta, R.iterations >= max_iters)

    if converged:
        R.converged = True
        R.message = R.message or "Converged: residual below err_tol."
    elif not R.message:
        R.message = "Stopped: max_iters reached."
    if rejects:
        R.message += f" ({rejects} rejected trust-region trials)"

    if log_file is not None:
        log_file.close()
    return R
