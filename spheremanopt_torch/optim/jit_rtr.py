"""Device-resident RTR: the trust-region loop with its decisions on the
device, the host reading one flag per step.

PyTorch port of the JAX package's `optim/jit_rtr.py`, which compiles the
outer trust-region loop (the fused step, rho acceptance, radius updates,
early exit) into one `lax.while_loop`. Here the loop runs on the same
machinery as the device SD/CG/L-BFGS driver (`optim/graph_loop.py`):
four steps over device-resident state, each a CUDA graph on the card,
run eagerly on the CPU:

  start   normalise x0 onto the spheres, J there, zero histories
  grad    the gradient, residuals and the tCG's start (`FullStep.begin`);
          flag: the tCG takes a step
  cg      one tCG step, one Hessian-vector product; flag: another step
  decide  the trial point and its J, then the decision ladder; flag: the
          loop goes on

Decision semantics mirror the host driver's (`optimise_rtr`,
`optim/rtr.py`), in order:
  1. residual <= err_tol              -> stop (converged)
  2. accepted iterations == max_iters -> stop
  3. pred <= 0 or non-finite          -> stop (gradient at roundoff)
  4. pred < 4*eps_J*(1+|J|)           -> stop (rho would be noise)
  5. rho = (J - J_trial)/pred; radius shrink/grow; accept if
     rho > rho_accept; a rejected trial that collapsed the radius below
     delta_min -> stop.
Histories are recorded per ACCEPTED iterate, residuals from the
pre-update gradient (Sphere_Grad_Descent.py:796). At the max_iters cap
the final pass computes the gradient and residuals only (no tCG), and
pays the trial's forward solve, as the JAX device loop does.

`optimise.sweep(x0_rows, radii_rows=None, aux=None)` runs R trust-region
optimisations at once over a leading row axis, as `jax.vmap` of the JAX
package's loop: `live` gates every state mutation of a row, a row's tCG
steps only while its own subproblem is open, and the loop runs while any
row is live; `iterations`, `trials` and `converged` are per row.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from spheremanopt_torch.manifold import sphere as geom
from spheremanopt_torch.optim.device_wolfe import freeze, tree_where
from spheremanopt_torch.optim.graph_loop import DeviceOptimiser
from spheremanopt_torch.optim.jit_driver import set_row
from spheremanopt_torch.optim.rtr import build_full_step
from spheremanopt_torch.problems.base import RowForms

_TCG = ("eta", "r", "p", "rr", "mval", "j", "done", "hit", "err", "coeff",
        "stop")


class JitRTRResult(NamedTuple):
    x_opt: List[torch.Tensor]
    function_values: torch.Tensor   # (max_iters,) -J_k (reference convention)
    residuals: torch.Tensor         # (max_iters, n_spheres)
    step_sizes: torch.Tensor        # (max_iters,) ||eta||_x of accepted steps
    iterations: torch.Tensor        # 0-dim int: ACCEPTED iterations
    converged: torch.Tensor         # 0-dim bool: residual <= err_tol
    trials: torch.Tensor            # 0-dim int: full-step evaluations
    hvp_evals: torch.Tensor         # 0-dim int: tCG products in all


def jit_optimise_rtr(
    f: Callable,
    grad_f: Callable,
    inner_prod,
    radii: Sequence[float],
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
    max_trials: Optional[int] = None,
    graphs: bool = None,
    rows: RowForms = None,
) -> Callable:
    """Build `optimise(x0_list, radii_dyn=None, aux=None) -> JitRTRResult`.

    `f(x_list) -> J` and `grad_f(x_list) -> [nab_J]` are the problems'
    callable pair (`grad_f` must carry forward-mode tangents, as in
    `optimise_rtr`); with `aux` they are called as `f(aux, x_list)` /
    `grad_f(aux, x_list)`. `max_trials` bounds the full-step evaluations
    (accepted + rejected); default 2*max_iters + 64: the radius shrinks
    4x per reject and collapses below delta_min after ~17 consecutive
    ones, so the bound is not the binding stop in practice. `graphs` as
    in `jit_optimise_on_multi_sphere`; the returned `DeviceOptimiser`'s
    `last_loop` is the `GraphLoop` of its last call. `rows` gives the
    problem's native callables over rows (`RowForms`: its `f` and `grad`);
    without them (None) a sweep runs its rows one after another on the
    unbatched loop.
    """
    n = len(radii)
    radii_static = tuple(float(r) for r in radii)
    sphere_scale = float(np.sqrt(sum(radii_static)))
    dmax_s = 2.0 * sphere_scale if delta_max is None else float(delta_max)
    d0_s = dmax_s / 8.0 if delta0 is None else float(delta0)
    hi = int(max_trials) if max_trials is not None else 2 * max_iters + 64

    def make_steps(aux_obj, batched=False):
        if batched:
            f0, g0, ips = rows.f, rows.grad, geom._as_list(rows.inner_product, n)
        else:
            f0, g0, ips = f, grad_f, geom._as_list(inner_prod, n)
        if aux_obj is None:
            f_b, g_b = f0, g0
        else:
            f_b = lambda xs: f0(aux_obj, xs)        # noqa: E731
            g_b = lambda xs: g0(aux_obj, xs)   # noqa: E731

        def flag_of(b):
            """The host's word: over rows, whether any row holds `b`."""
            return (b.any() if batched else b).to(torch.int64)

        def full_step(S):
            return build_full_step(S["radii"], ips, f_b, g_b, theta, kappa,
                                   int(max_cg), float(err_tol))

        def tcg_state(S):
            return {k: S["c_" + k] for k in _TCG}

        def start(S):
            xs = [geom.normalise_sphere(x, r, ip)
                  for x, r, ip in zip(S["x0"], S["radii"], ips)]
            J0 = f_b(xs)
            dev, dt, sh = J0.device, J0.dtype, J0.shape
            zi = torch.zeros(sh, dtype=torch.int64, device=dev)
            z = torch.zeros(sh + (max_iters,), dtype=dt, device=dev)
            return dict(xs=xs, J=J0, delta=torch.full(sh, d0_s, dtype=dt,
                                                      device=dev),
                        live=torch.ones(sh, dtype=torch.bool, device=dev),
                        k=zi, conv=torch.zeros(sh, dtype=torch.bool, device=dev),
                        nhvp=zi, t=zi, J_hist=z, s_hist=z,
                        r_hist=torch.zeros(sh + (max_iters, n), dtype=dt, device=dev),
                        flag=torch.ones((), dtype=torch.int64, device=dev))

        def grad(S):
            K = full_step(S)
            st = K.begin(S["xs"], check_only=S["k"] >= max_iters)
            if batched:   # a row that is not live takes no tCG step
                st["done"] = st["done"] | ~S["live"]
            out = {"c_" + k: v for k, v in st.items()}
            out["flag"] = flag_of(K.more(st))
            return out

        def cg(S):
            K = full_step(S)
            st = tcg_state(S)
            if batched:   # only the rows whose subproblem is open step
                st = freeze(K.more(st), dict(st, **K.cg(S["xs"], st, S["delta"])), st)
            else:
                st.update(K.cg(S["xs"], st, S["delta"]))
            out = {"c_" + k: v for k, v in st.items()}
            out["flag"] = flag_of(K.more(st))
            return out

        def decide(S):
            K = full_step(S)
            err, eta_norm, pred, hit, n_hvp, x_trial, J_trial = K.finish(
                S["xs"], tcg_state(S))
            J, delta, live, k = S["J"], S["delta"], S["live"], S["k"]
            at_cap = k >= max_iters
            j_eps = float(torch.finfo(J.dtype).eps)
            nhvp = S["nhvp"] + torch.where(live, n_hvp, 0)

            # host decision ladder, in order (module docstring)
            converged = err.amax(-1) <= err_tol
            pred_bad = (pred <= 0.0) | ~torch.isfinite(pred)
            pred_noise = pred < 4.0 * j_eps * (1.0 + torch.abs(J))
            stop_now = converged | pred_bad | pred_noise

            rho = torch.where(torch.isfinite(J_trial), (J - J_trial) / pred,
                              float("-inf"))
            if rho_max is not None:
                # model-breakdown guard, host parity (optim/rtr.py)
                rho = torch.where(rho > rho_max, float("-inf"), rho)
            # Absil-Baker-Gallivan radius update (host order: before the
            # acceptance test), frozen on a terminating trial
            delta_new = torch.where(
                rho < 0.25, delta * 0.25,
                torch.where((rho > 0.75) & hit,
                            torch.clamp(2.0 * delta, max=dmax_s), delta))
            delta = torch.where(live & ~stop_now & ~at_cap, delta_new, delta)

            accept = live & ~at_cap & (rho > rho_accept) & ~stop_now
            xs = tree_where(accept, list(x_trial), list(S["xs"]))
            # record the accepted iterate at slot k (pre-update residuals,
            # -J per the reference convention)
            J_hist = tree_where(accept, set_row(S["J_hist"], k, -J_trial),
                                S["J_hist"])
            r_hist = tree_where(accept, set_row(S["r_hist"], k, err),
                                S["r_hist"])
            s_hist = tree_where(accept, set_row(S["s_hist"], k, eta_norm),
                                S["s_hist"])
            J = torch.where(accept, J_trial, J)
            k = k + accept.to(k.dtype)

            conv = S["conv"] | (live & converged)
            rejected = live & ~accept & ~stop_now
            collapsed = rejected & (delta < 1e-10 * d0_s)
            active = live & ~(stop_now | collapsed | at_cap)
            t = S["t"] + live.to(S["t"].dtype)
            # the loop's condition for the next pass: the check-only cap
            # pass is exempt from the max_trials bound, so a tight bound
            # that runs out as k reaches the cap still runs the final
            # convergence check the host driver always performs
            more = active & ((t < hi) | (k >= max_iters))
            # over rows a row lives on only while its own loop would
            return dict(xs=xs, J=J, delta=delta, live=more if batched else active,
                        k=k, conv=conv, nhvp=nhvp, t=t, J_hist=J_hist,
                        r_hist=r_hist, s_hist=s_hist, flag=flag_of(more))

        return dict(start=start, grad=grad, cg=cg, decide=decide)

    order = ("start", "grad", "cg", "decide")

    def drive(L):
        go = L.run("start")
        while go:
            more = L.run("grad")
            while more:
                more = L.run("cg")
            go = L.run("decide")

    def result(S):
        return JitRTRResult([x.clone() for x in S["xs"]], S["J_hist"].clone(),
                            S["r_hist"].clone(), S["s_hist"].clone(),
                            S["k"].clone(), S["conv"].clone(), S["t"].clone(),
                            S["nhvp"].clone())

    return DeviceOptimiser(make_steps, order, drive, result, radii_static, graphs,
                           native_rows=rows is not None)
