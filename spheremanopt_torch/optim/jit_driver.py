"""Device-resident optimisation driver: the SD/CG/L-BFGS loop with its
line searches on the device, the host reading one flag per step.

PyTorch port of the JAX package's `optim/jit_driver.py`, which compiles
the whole optimisation (gradient solves, tangent projection, hybrid
FR-PR CG or L-BFGS directions, the line search, retractions, convergence
masking and history recording) into one `lax.while_loop`. Here the same
loop is cut into a few steps over device-resident state
(`optim/graph_loop.py`): on the card each step is a CUDA graph and the
host reads one flag word per replay; on the CPU the steps run eagerly.
Every decision is a tensor operation; the host only chooses which graph
to replay next.

Two line-search modes, as in the JAX package:
  * `line_search="wolfe"` (production parity): strong Wolfe through
    `optim/device_wolfe.py` with the reference's iteration-0
    interpolated Armijo, CG only from the third pass, old-phi0
    interpolated first trials and the gradient-reuse handoff
    (`Sphere_Grad_Descent.py:198-479,740-776`). Graphs: one Armijo
    trial, the iteration-0 commit, one Wolfe trial (retract at the
    state's alpha, f_and_g, tangent, slope, the search's transition) and
    an iteration's commit with the next direction (CG beta, or the L-BFGS
    update and two-loop) and the next search's start.
  * `line_search="armijo"` (default): fixed-shrink backtracking, CG from
    the second pass, the step size carried over from the last accepted
    step. A backtracking trial needs J alone: the JAX package calls
    `f_and_g` there and XLA drops the unused gradient; eager torch cannot
    drop a gradient it has computed, so the optional `f=` (a J-only
    callable) serves those trials.

Deltas from the host driver (`optim/optimiser.py`), as in the JAX
package: a failed line search freezes the iterate (a masked no-op)
instead of returning early; in wolfe mode every iteration-0 Armijo trial
is a fused (phi, derphi) evaluation, so a rejected trial pays an unused
adjoint sweep; the search's interpolants are computed in J's dtype (at
f32 the host's are Python floats).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import torch

from spheremanopt_torch.manifold import sphere as geom
from spheremanopt_torch.manifold.sphere import per_row
from spheremanopt_torch.optim.device_wolfe import (
    _A_DONE,
    _DONE,
    ArmijoState,
    WolfeState,
    armijo_init,
    armijo_step,
    freeze,
    tree_where,
    wolfe_init,
    wolfe_step,
    wolfe_trial,
)
from spheremanopt_torch.optim.graph_loop import DeviceOptimiser
from spheremanopt_torch.optim.optimiser import _curv_eps
from spheremanopt_torch.problems.base import RowForms


class JitOptResult(NamedTuple):
    """A sweep's result carries a leading row axis of R on every field."""
    x_opt: List[torch.Tensor]
    function_values: torch.Tensor   # (max_iters,) -J_k (reference convention)
    residuals: torch.Tensor         # (max_iters, n_spheres)
    step_sizes: torch.Tensor        # (max_iters,)
    iterations: torch.Tensor        # 0-dim int: iterations actually taken


def where_list(c, a, b):
    return tree_where(c, list(a), list(b))


def set_row(hist, it, val):
    """`hist` with row `it` (a 0-dim int tensor) replaced by `val`; with
    a leading row axis, `it` is (R,) and each row's history gets its own
    row."""
    m = torch.arange(hist.shape[it.dim()], device=hist.device) == (
        it.unsqueeze(-1) if it.dim() else it)
    if it.dim() == 0:
        return torch.where(m.view((-1,) + (1,) * (hist.dim() - 1)), val, hist)
    m = m.reshape(m.shape + (1,) * (hist.dim() - 2))
    return torch.where(m, val.unsqueeze(1), hist)


def put_state(prefix, st) -> dict:
    """A search state's fields as state-dict entries; its aux (xs, gs)
    as two lists."""
    d = {}
    for k, v in st._asdict().items():
        if k == "aux":
            d[prefix + "xs"], d[prefix + "gs"] = list(v[0]), list(v[1])
        else:
            d[prefix + k] = v
    return d


def get_state(prefix, cls, S):
    return cls(**{k: ((S[prefix + "xs"], S[prefix + "gs"]) if k == "aux"
                      else S[prefix + k]) for k in cls._fields})


def drop_inputs(T) -> dict:
    return {k: v for k, v in T.items() if k not in ("x0", "radii", "aux")}


def commit_rows(S, T, live):
    """A commit's outputs over rows: each row that was not `live` keeps
    its whole state (a finished row is frozen, as under `jax.vmap`)."""
    T = drop_inputs(T)
    return dict(freeze(live, {k: v for k, v in T.items() if k in S}, S),
                **{k: v for k, v in T.items() if k not in S})


def jit_optimise_on_multi_sphere(
    f_and_g: Callable,
    inner_prod,
    radii: Sequence[float],
    *,
    max_iters: int = 100,
    alpha0: float = 1.0,
    c1: float = 1e-4,
    shrink: float = 0.5,
    grow: float = 2.0,
    max_backtracks: int = 30,
    err_tol: float = 1e-6,
    cg: bool = True,
    line_search: str = "armijo",
    c2: float = 0.4,
    direction: str = None,
    lbfgs_memory: int = 8,
    f: Callable = None,
    graphs: bool = None,
    rows: RowForms = None,
) -> Callable:
    """Build `optimise(x0_list, radii_dyn=None, aux=None) -> JitOptResult`.

    `f_and_g(x_list) -> (J, [nab_J])` (problems provide
    `objective_and_gradient`); `inner_prod` is one callable or a list.
    `direction` selects sd|cg|lbfgs (None = the legacy `cg` flag); lbfgs
    keeps ring buffers of `lbfgs_memory` transported curvature pairs with
    a validity mask and requires line_search="wolfe". `f(x_list) -> J`,
    when given, serves the J-only backtracking trials of armijo mode.

    `radii_dyn` overrides the radii per call; `aux` is passed through as
    `f_and_g(aux, xs)` (and `f(aux, xs)`). `graphs` (default: on for CUDA
    state) selects CUDA-graph replay; `graphs=False` runs the same steps
    eagerly on the card, to hold the graphs against. The returned
    `DeviceOptimiser`'s `last_loop` is the `GraphLoop` of its last call
    (steps run, launches a replay holds).

    `optimise.sweep(x0_rows, radii_rows=None, aux=None)` runs R
    optimisations at once, the batched form of the JAX package's
    `jax.vmap(lambda x, r: optimise([x], radii_dyn=[r]))`: each x0 tensor
    and each field of the result carries a leading row axis of R, and
    `radii_rows` is (R, n_spheres). Every row makes its unbatched run's
    decisions: the loop runs while any row is live, a line search's trials
    step only the rows whose search is still open, and a row that has
    stopped keeps its state (its history is zeros past its last
    iteration). `rows` gives the problem's native callables over rows
    (`RowForms`, from `problems.base.row_forms`); without them (None) the
    sweep runs its rows one after another on the unbatched loop.
    """
    if direction is None:
        direction = "cg" if cg else "sd"
    if direction not in ("sd", "cg", "lbfgs"):
        raise ValueError(f"direction must be sd|cg|lbfgs, got {direction!r}")
    use_lbfgs = direction == "lbfgs"
    if use_lbfgs and line_search != "wolfe":
        raise ValueError("direction='lbfgs' requires line_search='wolfe'")
    if line_search not in ("wolfe", "armijo"):
        raise ValueError(f"line_search must be wolfe|armijo, got {line_search!r}")
    cg = direction == "cg"
    wolfe = line_search == "wolfe"
    mlb = int(lbfgs_memory)
    n = len(radii)
    radii = tuple(float(r) for r in radii)
    amax = alpha0 * (16.0 if use_lbfgs else 1.0)

    def make_steps(aux_obj, batched=False):
        """The loop's steps, bound to one aux operand object; with
        `batched`, over rows (`rows`' callables, per-row masks)."""
        if batched:
            fg0, f0, ips = rows.f_and_g, rows.f, geom._as_list(rows.inner_product, n)
        else:
            fg0, f0, ips = f_and_g, f, geom._as_list(inner_prod, n)
        if aux_obj is None:
            fg, fj = fg0, f0
        else:
            fg = lambda xs: fg0(aux_obj, xs)   # noqa: E731
            fj = None if f0 is None else (lambda xs: f0(aux_obj, xs))  # noqa: E731
        if fj is None:
            fj = lambda xs: fg(xs)[0]   # noqa: E731
        # L-BFGS slots: (mlb, ...) per component, (R, mlb, ...) over rows
        sa = 1 if batched else 0

        def slot(M, j):
            return M[:, j] if batched else M[j]

        def tangent(xs, nabs):
            return [geom.tangent_project(x, v, ip) for x, v, ip in zip(xs, nabs, ips)]

        def slope(gs, ds):
            return sum(ip(g, d) for g, d, ip in zip(gs, ds, ips))

        def residuals(gs):
            return torch.stack([torch.sqrt(ip(g, g)) for g, ip in zip(gs, ips)], -1)

        def retract(xs, alpha, ds, rr):
            return [geom.retract(x, alpha, d, r, ip)
                    for x, d, r, ip in zip(xs, ds, rr, ips)]

        def flag_of(b):
            """The host's word: over rows, whether any row holds `b`."""
            return (b.any() if batched else b).to(torch.int64)

        def all_of(b):
            """The host's word: over rows, whether every row holds `b`."""
            return (b.all() if batched else b).to(torch.int64)

        def cg_direction(xs, gs, gs_old, ds_old):
            beta_fr = 0.0
            beta_pr = 0.0
            tds = []
            for x, g, g_old, d_old, ip in zip(xs, gs, gs_old, ds_old, ips):
                gg = ip(g, g)
                gg_old = ip(g_old, g_old)
                beta_fr = beta_fr + gg / gg_old
                tg = geom.transport(x, g_old, ip)
                beta_pr = beta_pr + (gg - ip(g, tg)) / gg_old
                tds.append(geom.transport(x, d_old, ip))
            beta = torch.clamp(torch.minimum(beta_fr, beta_pr), min=0.0)
            return [-g + per_row(beta, td) * td for g, td in zip(gs, tds)]

        # ---- L-BFGS (direction="lbfgs"): the host driver's transported-pair
        # two-loop with ring buffers of `mlb` slots per component, newest
        # pair last, and a validity mask; invalid slots are exact no-ops
        # (rho = a = 0), so the recursion matches the host's variable-length
        # one to roundoff.

        def lbfgs_two_loop(xs, gs, Sb, Yb, valid, gamma):
            """d = -H.g (Nocedal & Wright Alg. 7.4); returns (d, <g,d>)."""
            q = list(gs)
            coeffs = []
            for j in range(mlb - 1, -1, -1):           # newest -> oldest
                s_j = [slot(Sc, j) for Sc in Sb]
                y_j = [slot(Yc, j) for Yc in Yb]
                v_j = valid[..., j]
                sy_j = slope(y_j, s_j)
                rho = torch.where(v_j, 1.0 / torch.where(v_j, sy_j, 1.0), 0.0)
                a = rho * slope(s_j, q)
                q = [qi - per_row(a, yi) * yi for qi, yi in zip(q, y_j)]
                coeffs.append((j, rho, a))
            r = [per_row(gamma, qi) * qi for qi in q]
            for (j, rho, a) in reversed(coeffs):       # oldest -> newest
                s_j = [slot(Sc, j) for Sc in Sb]
                y_j = [slot(Yc, j) for Yc in Yb]
                b = rho * slope(y_j, r)
                r = [ri + per_row(a - b, si) * si for ri, si in zip(r, s_j)]
            d = tangent(xs, [-ri for ri in r])
            return d, slope(gs, d)

        def lbfgs_update(xs, gs, gs_old, ds_old, alpha_prev, stepped_prev,
                         Sb, Yb, valid, gamma):
            """Pair formation and history transport at the current iterate,
            masked by whether the previous iteration stepped."""
            s_new = tangent(xs, [per_row(alpha_prev, d) * d for d in ds_old])
            tg = tangent(xs, gs_old)
            y_new = [gn - t for gn, t in zip(gs, tg)]
            sy = slope(s_new, y_new)
            yy = slope(y_new, y_new)
            ss = slope(s_new, s_new)
            keep = stepped_prev & (
                sy > _curv_eps(sy.dtype)
                * torch.sqrt(torch.clamp(ss, min=0.0) * torch.clamp(yy, min=0.0))) & (
                yy > 0.0)
            S2, Y2 = [], []
            for x, Sc, Yc, s_c, y_c, ip in zip(xs, Sb, Yb, s_new, y_new, ips):
                def tr(M, _x=x, _ip=ip):
                    return torch.stack([geom.tangent_project(_x, v, _ip)
                                        for v in M.unbind(sa)], sa)
                St = tree_where(stepped_prev, tr(Sc), Sc)
                Yt = tree_where(stepped_prev, tr(Yc), Yc)
                S2.append(tree_where(keep, torch.cat(
                    [St[:, 1:] if batched else St[1:], s_c.unsqueeze(sa)], sa), St))
                Y2.append(tree_where(keep, torch.cat(
                    [Yt[:, 1:] if batched else Yt[1:], y_c.unsqueeze(sa)], sa), Yt))
            valid2 = tree_where(keep, torch.cat([valid[..., 1:],
                                                 torch.ones_like(valid[..., :1])], -1),
                                valid)
            gamma2 = torch.where(keep, sy / torch.where(yy > 0.0, yy, 1.0), gamma)
            return S2, Y2, valid2, gamma2

        def begin(S):
            """Normalise x0 onto the spheres, J and the tangent gradient
            there, zero histories."""
            rr = S["radii"]
            xs = [geom.normalise_sphere(x, r, ip)
                  for x, r, ip in zip(S["x0"], rr, ips)]
            J0, nab0 = fg(xs)
            g0 = tangent(xs, nab0)
            z = torch.zeros(J0.shape + (max_iters,), dtype=J0.dtype, device=J0.device)
            return dict(xs=xs, J=J0, J0=J0, g0=g0, gs=g0,
                        J_hist=z, a_hist=z,
                        r_hist=torch.zeros(J0.shape + (max_iters, n), dtype=J0.dtype,
                                           device=J0.device),
                        it=torch.zeros(J0.shape, dtype=torch.int64, device=J0.device))

        # ---- wolfe mode ----------------------------------------------------

        def w_direction(T):
            """The next search direction and the Wolfe search's start."""
            xs, gs = T["xs"], T["gs"]
            ds_sd = [-g for g in gs]
            out = {}
            if use_lbfgs:
                Sb, Yb, valid, gamma = lbfgs_update(
                    xs, gs, T["gs_old"], T["ds_old"], T["lb_alpha"],
                    T["lb_stepped"], T["lb_S"], T["lb_Y"], T["lb_valid"],
                    T["lb_gamma"])
                d_lb, slope_lb = lbfgs_two_loop(xs, gs, Sb, Yb, valid, gamma)
                # host semantics: the two-loop only with a non-empty history
                # AND a descent result; otherwise steepest descent and (when
                # non-descent with pairs) a history reset
                has_pairs = valid.any(-1)
                ok_dir = has_pairs & (slope_lb < 0)
                reset = has_pairs & ~(slope_lb < 0)
                valid = valid & ~per_row(reset, valid)
                gamma = torch.where(reset, 1.0, gamma)
                ds = where_list(ok_dir, d_lb, ds_sd)
                slope0 = torch.where(ok_dir, slope_lb, slope(gs, ds_sd))
                out.update(lb_S=Sb, lb_Y=Yb, lb_valid=valid, lb_gamma=gamma)
            elif cg:
                ds_cg = cg_direction(xs, gs, T["gs_old"], T["ds_old"])
                # CG only from the third pass (i > 1,
                # `Sphere_Grad_Descent.py:750`), and only if descent
                use_cg = (T["it"] > 1) & (slope(gs, ds_cg) < 0)
                ds = where_list(use_cg, ds_cg, ds_sd)
                slope0 = slope(gs, ds)
            else:
                ds = ds_sd
                slope0 = slope(gs, ds)
            st = wolfe_init(T["J"], slope0, T["J_old"], T["has_old"], (xs, gs),
                            amax=amax)
            out.update(ds=ds, slope0=slope0, **put_state("w_", st))
            return out

        def w_start(S):
            T = begin(S)
            ds0 = [-g for g in T["g0"]]
            slope00 = slope(T["g0"], ds0)
            st = armijo_init(T["J0"], (T["xs"], T["g0"]), alpha0=alpha0)
            flag = torch.zeros((), dtype=torch.int64, device=st.phase.device)
            return dict(T, ds=ds0, slope0=slope00, flag=flag, **put_state("a_", st))

        def w_armijo_trial(S):
            """One trial of the iteration-0 interpolated Armijo search (over
            rows, of the rows whose search is open)."""
            st = get_state("a_", ArmijoState, S)
            xs_t = retract(S["xs"], st.trial, S["ds"], S["radii"])
            J_t, nab_t = fg(xs_t)
            gs_t = tangent(xs_t, nab_t)
            new = armijo_step(st, J_t, (xs_t, gs_t), phi0=S["J0"],
                              derphi0=S["slope0"], c1=c1)
            if batched:
                new = freeze(st.phase < _A_DONE, new, st)
            return dict(flag=all_of(new.phase >= _A_DONE), **put_state("a_", new))

        def w_commit0(S):
            """Iteration 0's commit (the host's pass-2 gradient is the
            accepted trial's), then iteration 1's direction."""
            st = get_state("a_", ArmijoState, S)
            ok0 = st.phase == _A_DONE
            J = torch.where(ok0, st.phi_star, S["J0"])
            res0 = residuals(S["g0"])
            active = ok0 & (res0.amax(-1) > err_tol)
            T = dict(S)
            T.update(
                xs=where_list(ok0, st.aux[0], S["xs"]), J=J,
                J_hist=set_row(S["J_hist"], S["it"], -J),
                r_hist=set_row(S["r_hist"], S["it"], res0),
                a_hist=set_row(S["a_hist"], S["it"],
                               torch.where(ok0, st.a_star, 0.0)),
                gs=where_list(ok0, st.aux[1], S["g0"]),
                gs_old=S["g0"], ds_old=S["ds"], J_old=S["J0"],
                has_old=torch.zeros_like(ok0), active=active,
                it=S["it"] + 1)
            if use_lbfgs:
                def ring(g):
                    shape = (g.shape[:1] + (mlb,) + g.shape[1:] if batched
                             else (mlb,) + g.shape)
                    return torch.zeros(shape, dtype=g.dtype, device=g.device)
                T.update(lb_S=[ring(g) for g in S["g0"]],
                         lb_Y=[ring(g) for g in S["g0"]],
                         lb_valid=torch.zeros(J.shape + (mlb,), dtype=torch.bool,
                                              device=J.device),
                         lb_gamma=torch.ones_like(J), lb_alpha=st.a_star,
                         lb_stepped=ok0)
            T.update(w_direction(T))
            T["flag"] = flag_of(active)
            return drop_inputs(T)

        def w_trial(S):
            """One Wolfe trial: retract at the state's alpha, f_and_g,
            tangent gradient, slope, the search's transition (over rows, of
            the live rows whose search is open)."""
            st = get_state("w_", WolfeState, S)
            a_t = wolfe_trial(st)
            xs_t = retract(S["xs"], a_t, S["ds"], S["radii"])
            J_t, nab_t = fg(xs_t)
            gs_t, slope_t = [], 0.0
            for x_t, nb, d, ip in zip(xs_t, nab_t, S["ds"], ips):
                g_t = geom.tangent_project(x_t, nb, ip)
                gs_t.append(g_t)
                slope_t = slope_t + ip(g_t, geom.transport(x_t, d, ip))
            new = wolfe_step(st, J_t, slope_t, (xs_t, gs_t), phi0=S["J"],
                             derphi0=S["slope0"], c1=c1, c2=c2, amax=amax,
                             a_t=a_t)
            if not batched:
                return dict(flag=flag_of(new.phase >= _DONE), **put_state("w_", new))
            new = freeze(S["active"] & (st.phase < _DONE), new, st)
            return dict(flag=all_of(~S["active"] | (new.phase >= _DONE)),
                        **put_state("w_", new))

        def w_commit(S):
            """An iteration's commit (a masked no-op on a failed search),
            then the next direction and search start."""
            st = get_state("w_", WolfeState, S)
            ok = st.phase == _DONE
            # never commit a non-finite objective (host driver's guard)
            step = S["active"] & ok & torch.isfinite(st.phi_star)
            res = residuals(S["gs"])
            it = S["it"]
            T = dict(S)
            T.update(
                xs=where_list(step, st.aux[0], S["xs"]),
                J_hist=set_row(S["J_hist"], it,
                               -torch.where(step, st.phi_star, S["J"])),
                r_hist=set_row(S["r_hist"], it, res),
                a_hist=set_row(S["a_hist"], it,
                               torch.where(step, st.a_star, 0.0)),
                gs_old=S["gs"], ds_old=S["ds"],
                gs=where_list(step, st.aux[1], S["gs"]),
                J_old=torch.where(step, S["J"], S["J_old"]),
                has_old=S["has_old"] | step,
                J=torch.where(step, st.phi_star, S["J"]),
                active=S["active"] & ok & (res.amax(-1) > err_tol),
                it=it + 1)
            if use_lbfgs:
                T.update(lb_alpha=torch.where(step, st.a_star, S["lb_alpha"]),
                         lb_stepped=step)
            T.update(w_direction(T))
            T = commit_rows(S, T, S["active"]) if batched else drop_inputs(T)
            T["flag"] = flag_of(T["active"])
            return T

        # ---- armijo mode ---------------------------------------------------

        def a_direction(T):
            gs = T["gs"]
            ds_sd = [-g for g in gs]
            if cg:
                ds_cg = cg_direction(T["xs"], gs, T["gs_old"], T["ds_old"])
                # steepest descent on iteration 0 and when the CG direction
                # is not a descent direction
                use_cg = (T["it"] > 0) & (slope(gs, ds_cg) < 0)
                ds = where_list(use_cg, ds_cg, ds_sd)
            else:
                ds = ds_sd
            alpha = torch.clamp(T["alpha_prev"] * grow, max=alpha0 * 1e3)
            out = dict(ds=ds, slope0=slope(gs, ds), b_alpha=alpha, b_a=alpha,
                       b_J=T["J"], b_k=torch.zeros_like(T["it"]))
            if batched:   # over rows: whose backtracking is still open
                out["b_more"] = torch.ones_like(T["active"])
            return out

        def a_start(S):
            T = begin(S)
            J0 = T["J0"]
            T.update(gs_old=T["g0"], ds_old=[-g for g in T["g0"]],
                     alpha_prev=torch.full(J0.shape, alpha0 / 2.0, dtype=J0.dtype,
                                           device=J0.device),
                     active=torch.ones(J0.shape, dtype=torch.bool, device=J0.device))
            T.update(a_direction(T))
            T["flag"] = flag_of(T["active"])
            return T

        def a_trial(S):
            """One backtracking trial: J alone at the state's alpha."""
            alpha = S["b_alpha"]
            J_t = fj(retract(S["xs"], alpha, S["ds"], S["radii"]))
            insufficient = J_t > S["J"] + c1 * alpha * S["slope0"]
            more = insufficient & (S["b_k"] < max_backtracks)
            out = dict(b_a=alpha, b_J=J_t,
                       b_alpha=torch.where(more, alpha * shrink, alpha),
                       b_k=S["b_k"] + more.to(S["b_k"].dtype))
            if not batched:
                return dict(out, flag=flag_of(~more))
            out = freeze(S["active"] & S["b_more"], dict(out, b_more=more), S)
            return dict(out, flag=all_of(~S["active"] | ~out["b_more"]))

        def a_commit(S):
            alpha, J_new = S["b_a"], S["b_J"]
            ok = J_new <= S["J"] + c1 * alpha * S["slope0"]
            step = S["active"] & ok & torch.isfinite(J_new)
            xs = where_list(step, retract(S["xs"], alpha, S["ds"], S["radii"]),
                            S["xs"])
            J = torch.where(step, J_new, S["J"])
            res = residuals(S["gs"])
            it = S["it"]
            # next gradient (only meaningful while active)
            _, nab = fg(xs)
            T = dict(S)
            T.update(
                xs=xs, J=J,
                J_hist=set_row(S["J_hist"], it, -J),
                r_hist=set_row(S["r_hist"], it, res),
                a_hist=set_row(S["a_hist"], it, torch.where(step, alpha, 0.0)),
                gs_old=S["gs"], ds_old=S["ds"],
                gs=where_list(step, tangent(xs, nab), S["gs"]),
                active=S["active"] & ok & (res.amax(-1) > err_tol),
                alpha_prev=torch.where(step, alpha, S["alpha_prev"]),
                it=it + 1)
            T.update(a_direction(T))
            T = commit_rows(S, T, S["active"]) if batched else drop_inputs(T)
            T["flag"] = flag_of(T["active"])
            return T

        if wolfe:
            return dict(start=w_start, arm_trial=w_armijo_trial,
                        commit0=w_commit0, trial=w_trial, commit=w_commit)
        return dict(start=a_start, trial=a_trial, commit=a_commit)

    order = (("start", "arm_trial", "commit0", "trial", "commit") if wolfe
             else ("start", "trial", "commit"))

    def drive(L):
        """The loop on the host: one flag read a step. Over rows, a trial's
        flag says that no live row's search is open, and a commit's that
        some row is still live."""
        if wolfe:
            L.run("start")
            while not L.run("arm_trial"):
                pass
            active = L.run("commit0")
            i = 1
        else:
            active = L.run("start")
            i = 0
        while i < max_iters and active:
            while not L.run("trial"):
                pass
            active = L.run("commit")
            i += 1

    def result(S):
        return JitOptResult([x.clone() for x in S["xs"]], S["J_hist"].clone(),
                            S["r_hist"].clone(), S["a_hist"].clone(),
                            (S["a_hist"] > 0).sum(-1))

    return DeviceOptimiser(make_steps, order, drive, result, radii, graphs,
                           native_rows=rows is not None)
