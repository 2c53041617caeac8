"""Device-resident strong-Wolfe and interpolated-Armijo line searches as
tensor state machines.

PyTorch port of the JAX package's `optim/device_wolfe.py`, there one
`lax.while_loop` each. Here each search is split into a pure state
transition, a function `(state, phi, derphi, aux) -> state` built only
from `torch.where` and arithmetic on 0-dim tensors in phi0's dtype (no
`.item()`, no `float()`, no Python branch on a tensor), and a loop that
runs it. The transition is what `optim/jit_driver.py` captures, with one
fused (phi, derphi) evaluation in front of it, in a CUDA graph; the loop
there reads one flag, the phase, per trial.

The searches mirror the host implementations (`optim/linesearch.py`,
Nocedal & Wright Algorithms 3.5/3.6 as the reference embeds them,
`Sphere_Grad_Descent.py:344-613`) evaluation-for-evaluation: each trial
is one fused (phi, derphi) evaluation at the point the same
bracketing/zoom interpolation rules choose (cubic -> quadratic ->
bisection with the same end-margin guards). Differences, as in the JAX
package: (a) derphi is fused into every phi evaluation; the decisions
are the host's because derphi is consulted at the same alphas; (b) on
bracket-maxiter exhaustion both searches evaluate one further doubled
trial and return it unchecked (host `linesearch.py:264-272`, the `last`
field); (c) a NaN phi/derphi trial fails the search at once (ok=False);
an overflowed +inf trial enters zoom like the host's, whose interpolant
guards bisect back toward the finite a_lo. The maxiter/max_zoom
counters bound the loop either way.

The interpolants are computed in phi0's dtype, as in the JAX package.
At f32 a device search therefore differs from the host search, whose
arithmetic is Python floats, after the first interpolated trial.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

# phases
_BRACKET, _ZOOM, _DONE, _FAIL = 0, 1, 2, 3


def tree_where(cond, a, b):
    """`torch.where(cond, a, b)` over matching (nested) lists and tuples
    of tensors."""
    if isinstance(a, (list, tuple)):
        return type(a)(tree_where(cond, x, y) for x, y in zip(a, b))
    return torch.where(cond, a, b)


def _quad_min(a, fa, dfa, b, fb):
    db = b - a
    curv = (fb - fa - dfa * db) / (db * db)
    xmin = a - dfa / (2.0 * curv)
    return xmin, torch.isfinite(xmin)


def _cubic_min(a, fa, dfa, b, fb, c, fc):
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1 = fb - fa - dfa * db
    r2 = fc - fa - dfa * dc
    A = (dc * dc * r1 - db * db * r2) / denom
    B = (-(dc ** 3) * r1 + db ** 3 * r2) / denom
    rad = B * B - 3.0 * A * dfa
    xmin = a + (-B + torch.sqrt(torch.abs(rad))) / (3.0 * A)
    return xmin, (rad >= 0.0) & torch.isfinite(xmin)


class WolfeState(NamedTuple):
    phase: torch.Tensor
    last: torch.Tensor        # bracket maxiter exhausted: accept the next
    #                           (already-doubled) trial unchecked, like the
    #                           host's post-loop return (linesearch.py:272)
    i: torch.Tensor           # bracket iteration counter
    j: torch.Tensor           # zoom iteration counter
    alpha_prev: torch.Tensor
    phi_prev: torch.Tensor
    derphi_prev: torch.Tensor
    alpha_cur: torch.Tensor   # next bracket trial
    a_lo: torch.Tensor
    phi_lo: torch.Tensor
    derphi_lo: torch.Tensor
    a_hi: torch.Tensor
    phi_hi: torch.Tensor
    a_rec: torch.Tensor
    phi_rec: torch.Tensor
    a_star: torch.Tensor
    phi_star: torch.Tensor
    aux: Any                  # tensors from the accepted evaluation


def _as(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def wolfe_init(phi0, derphi0, old_phi0, has_old_phi0, aux0, *,
               amax: float = 1.0) -> WolfeState:
    """The search's state before its first trial. phi0, derphi0 and
    old_phi0 are 0-dim tensors of one dtype (old_phi0 is read only where
    the 0-dim bool `has_old_phi0` holds)."""
    has_old = torch.as_tensor(has_old_phi0, device=phi0.device)
    # initial trial: interpolate from the previous objective decrease
    # (host lines 183-192)
    nz = derphi0 != 0.0
    a1 = torch.where(
        has_old & nz,
        torch.clamp(1.01 * 2.0 * (phi0 - old_phi0)
                    / torch.where(nz, derphi0, 1.0), max=1.0),
        1.0)
    a1 = torch.where(a1 < 0.0, 1.0, a1)
    a1 = torch.clamp(a1, max=amax)
    z = torch.zeros_like(phi0)
    zi = torch.zeros((), dtype=torch.int64, device=phi0.device)
    return WolfeState(
        phase=zi + _BRACKET, last=torch.zeros((), dtype=torch.bool,
                                              device=phi0.device),
        i=zi, j=zi,
        alpha_prev=z, phi_prev=phi0, derphi_prev=derphi0, alpha_cur=a1,
        a_lo=z, phi_lo=phi0, derphi_lo=derphi0,
        a_hi=z, phi_hi=phi0, a_rec=z, phi_rec=phi0,
        a_star=z, phi_star=phi0, aux=aux0)


def _zoom_trial(st: WolfeState):
    """Host zoom lines 204-219: cubic (j>0) -> quadratic -> bisection with
    the same signed end-margin guards."""
    dalpha = st.a_hi - st.a_lo
    neg = dalpha < 0
    lo_end = torch.where(neg, st.a_hi, st.a_lo)
    hi_end = torch.where(neg, st.a_lo, st.a_hi)

    cj, c_ok = _cubic_min(st.a_lo, st.phi_lo, st.derphi_lo,
                          st.a_hi, st.phi_hi, st.a_rec, st.phi_rec)
    chk_c = 0.2 * dalpha
    c_ok = c_ok & (st.j > 0) & (cj <= hi_end - chk_c) & (cj >= lo_end + chk_c)

    qj, q_ok = _quad_min(st.a_lo, st.phi_lo, st.derphi_lo, st.a_hi, st.phi_hi)
    chk_q = 0.1 * dalpha
    q_ok = q_ok & (qj <= hi_end - chk_q) & (qj >= lo_end + chk_q)

    bis = st.a_lo + 0.5 * dalpha
    return torch.where(c_ok, cj, torch.where(q_ok, qj, bis))


def wolfe_trial(st: WolfeState):
    """The alpha of the state's next trial."""
    return torch.where(st.phase == _BRACKET, st.alpha_cur, _zoom_trial(st))


def wolfe_step(st: WolfeState, phi_t, derphi_t, aux_t, *, phi0, derphi0,
               c1: float = 1e-4, c2: float = 0.4, amax: float = 1.0,
               maxiter: int = 10, max_zoom: int = 10, a_t=None) -> WolfeState:
    """The state after one trial at `wolfe_trial(st)` (`a_t`, when the
    caller has it) that returned (phi_t, derphi_t, aux_t). A state whose
    phase is _DONE or _FAIL is not stepped again."""
    if a_t is None:
        a_t = wolfe_trial(st)
    phi_t, derphi_t = _as(phi_t, phi0), _as(derphi_t, phi0)
    in_br = st.phase == _BRACKET
    finite = torch.isfinite(phi_t) & torch.isfinite(derphi_t)
    # Fail fast ONLY on NaN (a poisoned PDE state never recovers, and NaN
    # comparisons are all-false); an overflowed +inf trial takes the
    # host's transitions (to_zoom1, then bisection toward a_lo).
    nan_t = torch.isnan(phi_t) | torch.isnan(derphi_t)
    # maxiter-exhausted final trial: accept unchecked, like the host's
    # post-loop return of the freshly doubled evaluation (:264-272)
    in_last = in_br & st.last

    # ---- bracket transition (host lines 237-269) ----
    br_fail = (st.alpha_cur == 0.0) | (st.alpha_prev == amax) | nan_t
    to_zoom1 = (phi_t > phi0 + c1 * a_t * derphi0) | (
        (phi_t >= st.phi_prev) & (st.i > 0))
    br_done = torch.abs(derphi_t) <= -c2 * derphi0
    to_zoom2 = derphi_t >= 0.0
    br_maxed = st.i + 1 >= maxiter   # exhausted: one final doubled trial

    alpha_next = torch.clamp(2.0 * a_t, max=amax)

    # zoom entry (lo, hi) for the two cases
    z1 = (st.alpha_prev, st.phi_prev, st.derphi_prev, a_t, phi_t)
    z2 = (a_t, phi_t, derphi_t, st.alpha_prev, st.phi_prev)
    za_lo, zphi_lo, zderphi_lo, za_hi, zphi_hi = (
        torch.where(to_zoom1, z1[k], z2[k]) for k in range(5))

    # Acceptance requires a FINITE trial everywhere: a would-be accept of
    # a non-finite trial is a terminal failure (ok=False), matching the
    # host driver's non-finite-objective early return.
    done_or_fail = torch.where(finite, _DONE, _FAIL)
    br_phase = torch.where(
        in_last, done_or_fail,
        torch.where(
            br_fail, _FAIL,
            torch.where(to_zoom1, _ZOOM,
                        torch.where(br_done, done_or_fail,
                                    torch.where(to_zoom2, _ZOOM, _BRACKET)))))
    br_accept = torch.where(in_last, finite,
                            (~br_fail) & (~to_zoom1) & br_done & finite)
    last_next = in_br & (~in_last) & (~br_fail) & (~to_zoom1) & (
        ~br_done) & (~to_zoom2) & br_maxed

    # ---- zoom transition (host zoom lines 221-234) ----
    zm_hi_move = (phi_t > phi0 + c1 * a_t * derphi0) | (phi_t >= st.phi_lo)
    zm_done = (~zm_hi_move) & (torch.abs(derphi_t) <= -c2 * derphi0)
    zm_flip = derphi_t * (st.a_hi - st.a_lo) >= 0.0
    zm_fail = (st.j + 1 > max_zoom) | nan_t

    n_a_lo = torch.where(zm_hi_move, st.a_lo, a_t)
    n_phi_lo = torch.where(zm_hi_move, st.phi_lo, phi_t)
    n_derphi_lo = torch.where(zm_hi_move, st.derphi_lo, derphi_t)
    n_a_hi = torch.where(zm_hi_move, a_t,
                         torch.where(zm_flip, st.a_lo, st.a_hi))
    n_phi_hi = torch.where(zm_hi_move, phi_t,
                           torch.where(zm_flip, st.phi_lo, st.phi_hi))
    rec_hi = zm_hi_move | zm_flip
    n_a_rec = torch.where(rec_hi, st.a_hi, st.a_lo)
    n_phi_rec = torch.where(rec_hi, st.phi_hi, st.phi_lo)

    zm_phase = torch.where(zm_done, done_or_fail,
                           torch.where(zm_fail, _FAIL, _ZOOM))

    # ---- merge ----
    phase = torch.where(in_br, br_phase, zm_phase)
    accepted = torch.where(in_br, br_accept, zm_done & finite)
    return WolfeState(
        phase=phase,
        last=last_next,
        i=st.i + in_br.to(st.i.dtype),
        j=(st.j + 1) * (~in_br).to(st.j.dtype),
        alpha_prev=torch.where(in_br, a_t, st.alpha_prev),
        phi_prev=torch.where(in_br, phi_t, st.phi_prev),
        derphi_prev=torch.where(in_br, derphi_t, st.derphi_prev),
        alpha_cur=torch.where(in_br, alpha_next, st.alpha_cur),
        a_lo=torch.where(in_br, za_lo, n_a_lo),
        phi_lo=torch.where(in_br, zphi_lo, n_phi_lo),
        derphi_lo=torch.where(in_br, zderphi_lo, n_derphi_lo),
        a_hi=torch.where(in_br, za_hi, n_a_hi),
        phi_hi=torch.where(in_br, zphi_hi, n_phi_hi),
        a_rec=torch.where(in_br, 0.0, n_a_rec),
        phi_rec=torch.where(in_br, phi0, n_phi_rec),
        a_star=torch.where(accepted, a_t, st.a_star),
        phi_star=torch.where(accepted, phi_t, st.phi_star),
        aux=tree_where(accepted, aux_t, st.aux),
    )


def device_wolfe(eval_fn: Callable, phi0, derphi0, aux0, old_phi0,
                 has_old_phi0, *, c1: float = 1e-4, c2: float = 0.4,
                 amax: float = 1.0, maxiter: int = 10, max_zoom: int = 10):
    """Run the strong-Wolfe search: `wolfe_step` in a loop that reads the
    phase once a trial.

    eval_fn(alpha) -> (phi, derphi, aux); the aux (tensors, e.g. the
    retracted iterate and its tangent gradient) of the ACCEPTED
    evaluation is returned, the reference's gradient-reuse handoff
    (`Sphere_Grad_Descent.py:336-341`). Returns (alpha_star, phi_star,
    aux_star, ok) with ok a 0-dim bool tensor.
    """
    phi0 = torch.as_tensor(phi0)
    if not phi0.is_floating_point():
        phi0 = phi0.double()
    derphi0, old_phi0 = _as(derphi0, phi0), _as(old_phi0, phi0)
    st = wolfe_init(phi0, derphi0, old_phi0, has_old_phi0, aux0, amax=amax)
    kw = dict(phi0=phi0, derphi0=derphi0, c1=c1, c2=c2, amax=amax,
              maxiter=maxiter, max_zoom=max_zoom)
    while int(st.phase) < _DONE:
        phi_t, derphi_t, aux_t = eval_fn(wolfe_trial(st))
        st = wolfe_step(st, phi_t, derphi_t, aux_t, **kw)
    return st.a_star, st.phi_star, st.aux, st.phase == _DONE


# ---------------------------------------------------------------------------
# Interpolated Armijo (host `armijo_search` / scipy scalar_search_armijo)
# ---------------------------------------------------------------------------

_A_FIRST, _A_QUAD, _A_CUBIC, _A_DONE, _A_FAIL = 0, 1, 2, 3, 4


class ArmijoState(NamedTuple):
    phase: torch.Tensor
    trial: torch.Tensor    # next alpha to evaluate
    a0: torch.Tensor       # previous-previous point
    phi_a0: torch.Tensor
    a1: torch.Tensor       # previous point
    phi_a1: torch.Tensor
    a_star: torch.Tensor
    phi_star: torch.Tensor
    aux: Any


def armijo_init(phi0, aux0, *, alpha0: float = 1.0) -> ArmijoState:
    """The backtracking search's state before its first trial."""
    a = torch.full((), alpha0, dtype=phi0.dtype, device=phi0.device)
    return ArmijoState(
        phase=torch.full((), _A_FIRST, dtype=torch.int64, device=phi0.device),
        trial=a, a0=a, phi_a0=phi0, a1=a, phi_a1=phi0,
        a_star=torch.zeros_like(phi0), phi_star=phi0, aux=aux0)


def armijo_step(st: ArmijoState, phi_t, aux_t, *, phi0, derphi0,
                c1: float = 1e-4, amin: float = 1e-6) -> ArmijoState:
    """The state after one trial at `st.trial` that returned (phi_t,
    aux_t); includes the scipy step-halving guard quirk (the guard
    relabels the NEXT bracket point alpha2 -> alpha1/2 while keeping phi
    evaluated at the original alpha2; `optim/linesearch.py:124-128`)."""
    a_t = st.trial
    phi_t = _as(phi_t, phi0)
    # a finite objective is required for acceptance (phi = -inf would
    # otherwise "satisfy" the Armijo test)
    accept = (phi_t <= phi0 + c1 * a_t * derphi0) & torch.isfinite(phi_t)

    def cubic_next(a0, phi_a0, a1, phi_a1):
        factor = a0 * a0 * a1 * a1 * (a1 - a0)
        r0 = phi_a0 - phi0 - derphi0 * a0
        r1 = phi_a1 - phi0 - derphi0 * a1
        a_coef = (a0 * a0 * r1 - a1 * a1 * r0) / factor
        b_coef = (-(a0 ** 3) * r1 + a1 ** 3 * r0) / factor
        return (-b_coef + torch.sqrt(torch.abs(b_coef * b_coef
                                               - 3.0 * a_coef * derphi0))) / (
            3.0 * a_coef)

    # FIRST reject -> quadratic trial from (alpha0, phi_t)
    quad = -derphi0 * a_t * a_t / (2.0 * (phi_t - phi0 - derphi0 * a_t))
    # QUAD reject -> cubic from (a0=alpha0, phi_a0) and (a_t, phi_t)
    cub_q = cubic_next(st.a0, st.phi_a0, a_t, phi_t)
    # CUBIC reject -> shift with the scipy guard, then the next cubic
    guard = ((st.a1 - a_t) > st.a1 / 2.0) | ((1.0 - a_t / st.a1) < 0.96)
    alpha2 = torch.where(guard, st.a1 / 2.0, a_t)
    cub_c = cubic_next(st.a1, st.phi_a1, alpha2, phi_t)

    is_first = st.phase == _A_FIRST
    is_quad = st.phase == _A_QUAD
    n_a0 = torch.where(is_first, a_t, torch.where(is_quad, st.a0, st.a1))
    n_phi_a0 = torch.where(is_first, phi_t,
                           torch.where(is_quad, st.phi_a0, st.phi_a1))
    n_a1 = torch.where(is_first | is_quad, a_t, alpha2)
    n_trial = torch.where(is_first, quad, torch.where(is_quad, cub_q, cub_c))

    # failure tests are NaN-closed (~(x > y)), so a non-finite phi or
    # interpolant ends the search instead of cycling on NaN comparisons
    underflow = (~is_first) & ~(n_a1 > amin)
    bad_trial = ~(n_trial > 0.0) | ~torch.isfinite(n_trial)
    phase = torch.where(
        accept, _A_DONE,
        torch.where(underflow | bad_trial, _A_FAIL,
                    torch.where(is_first, _A_QUAD, _A_CUBIC)))
    return ArmijoState(
        phase=phase, trial=n_trial,
        a0=n_a0, phi_a0=n_phi_a0, a1=n_a1, phi_a1=phi_t,
        a_star=torch.where(accept, a_t, st.a_star),
        phi_star=torch.where(accept, phi_t, st.phi_star),
        aux=tree_where(accept, aux_t, st.aux))


def device_armijo(eval_fn: Callable, phi0, derphi0, aux0, *,
                  alpha0: float = 1.0, c1: float = 1e-4, amin: float = 1e-6):
    """Backtracking with quadratic-then-cubic interpolation, mirroring the
    host `armijo_search` evaluation-for-evaluation: `armijo_step` in a
    loop that reads the phase once a trial. eval_fn as in
    `device_wolfe`; returns (alpha, phi, aux, ok)."""
    phi0 = torch.as_tensor(phi0)
    if not phi0.is_floating_point():
        phi0 = phi0.double()
    derphi0 = _as(derphi0, phi0)
    st = armijo_init(phi0, aux0, alpha0=alpha0)
    while int(st.phase) < _A_DONE:
        phi_t, _derphi_t, aux_t = eval_fn(st.trial)
        st = armijo_step(st, phi_t, aux_t, phi0=phi0, derphi0=derphi0,
                         c1=c1, amin=amin)
    return st.a_star, st.phi_star, st.aux, st.phase == _A_DONE
