"""The port's device line searches (`spheremanopt_torch/optim/device_wolfe.py`)
against the JAX package's (`optim/device_wolfe.py`), at f64 on scalar
objectives: every accepted alpha and phi, and every failure, must agree
(abs 1e-12), as the JAX searches agree with the host ones
(tests/test_device_wolfe.py)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.optim import device_wolfe as tdw
from spheremanopt_tpu.optim import device_wolfe as jdw

# (phi, derphi, old_phi0, amax) for xp in (jnp, torch): first-trial
# accept, zoom via cubic/quad/bisection, derphi >= 0 flip, amax-capped
# failure (tests/test_device_wolfe.py:25-40)
SCALAR_CASES = [
    (lambda a, xp: (a - 2.0) ** 2, lambda a, xp: 2 * (a - 2.0), None, 10.0),
    (lambda a, xp: (a - 2.0) ** 2, lambda a, xp: 2 * (a - 2.0), 4.5, 10.0),
    (lambda a, xp: a ** 4 - 3 * a ** 2 + 0.5 * a,
     lambda a, xp: 4 * a ** 3 - 6 * a + 0.5, None, 8.0),
    (lambda a, xp: -a / (a * a + 1.0),
     lambda a, xp: (a * a - 1.0) / (a * a + 1.0) ** 2, -0.3, 50.0),
    (lambda a, xp: -a, lambda a, xp: -1.0 + 0 * a, None, 2.0),
    (lambda a, xp: (a - 0.01) ** 2 - 1e-4, lambda a, xp: 2 * (a - 0.01), None, 3.0),
    (lambda a, xp: xp.exp(-a) + 0.05 * a,
     lambda a, xp: -xp.exp(-a) + 0.05, 1.2, 20.0),
]
TOL = 1e-12


def _t(v):
    return torch.tensor(v, dtype=torch.float64)


def _jax_wolfe(f, df, phi0, derphi0, old, amax):
    def ev(a):
        return f(a, jnp), df(a, jnp), (a,)

    return jax.jit(lambda: jdw.device_wolfe(
        ev, phi0, derphi0, (jnp.asarray(0.0),), old if old is not None else 0.0,
        old is not None, c1=1e-4, c2=0.4, amax=amax))()


def _torch_wolfe(f, df, phi0, derphi0, old, amax):
    def ev(a):
        return f(a, torch), df(a, torch), (a,)

    return tdw.device_wolfe(ev, _t(phi0), derphi0, (_t(0.0),),
                            old if old is not None else 0.0, old is not None,
                            c1=1e-4, c2=0.4, amax=amax)


def _same(j, t):
    a_j, p_j, _, ok_j = j
    a_t, p_t, _, ok_t = t
    assert bool(ok_t) == bool(ok_j)
    if bool(ok_j):
        assert abs(float(a_t) - float(a_j)) < TOL, (float(a_t), float(a_j))
        assert abs(float(p_t) - float(p_j)) < TOL, (float(p_t), float(p_j))


@pytest.mark.parametrize("case", range(len(SCALAR_CASES)))
def test_device_wolfe_matches_jax_scalar(case):
    f, df, old, amax = SCALAR_CASES[case]
    phi0, derphi0 = float(f(0.0, np)), float(df(0.0, np))
    _same(_jax_wolfe(f, df, phi0, derphi0, old, amax),
          _torch_wolfe(f, df, phi0, derphi0, old, amax))


@pytest.mark.parametrize("alpha0", [0.3, 1.0, 3.0, 40.0])
def test_device_armijo_matches_jax_scalar(alpha0):
    f = lambda a: (a - 0.17) ** 2      # noqa: E731
    df = lambda a: 2 * (a - 0.17)      # noqa: E731
    phi0, derphi0 = f(0.0), df(0.0)
    j = jax.jit(lambda: jdw.device_armijo(
        lambda a: (f(a), df(a), (a,)), phi0, derphi0, (jnp.asarray(0.0),),
        alpha0=alpha0, c1=1e-4))()
    t = tdw.device_armijo(lambda a: (f(a), df(a), (a,)), _t(phi0), derphi0,
                          (_t(0.0),), alpha0=alpha0, c1=1e-4)
    assert bool(j[3]) and bool(t[3])
    _same(j, t)


def test_device_wolfe_maxiter_exhaustion_matches_jax():
    """Bracket maxiter exhaustion: one further doubled trial, returned
    unchecked (host linesearch.py:264-272)."""
    f = lambda a, xp: -a                # noqa: E731  never satisfies curvature
    df = lambda a, xp: -1.0 + 0 * a     # noqa: E731
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = _jax_wolfe(f, df, 0.0, -1.0, None, 1e7)
    t = _torch_wolfe(f, df, 0.0, -1.0, None, 1e7)
    assert bool(t[3])
    _same(j, t)
    assert float(t[0]) == 1024.0   # 1, 2, ..., 2^9 bracketed, then 2^10


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_device_wolfe_nonfinite_trial_fails_not_hangs(bad):
    def ev(a):
        phi = torch.where(a > 0.5, _t(bad), -a)
        return phi, -1.0 + 0 * a, (a,)

    _, _, _, ok = tdw.device_wolfe(ev, _t(0.0), -1.0, (_t(0.0),), 0.0, False,
                                   c1=1e-4, c2=0.4, amax=100.0)
    assert not bool(ok)


def test_device_wolfe_recovers_from_inf_overflow_like_jax():
    """An overflowed (+inf) bracket trial enters zoom and bisects back
    into the finite region: the same point as JAX's search."""
    f = lambda a, xp: xp.where(a > 1.6, xp.inf, (a - 2.0) ** 2)        # noqa: E731
    df = lambda a, xp: xp.where(a > 1.6, xp.inf, 2.0 * (a - 2.0))     # noqa: E731
    j = _jax_wolfe(f, df, 4.0, -4.0, None, 50.0)
    t = _torch_wolfe(f, df, 4.0, -4.0, None, 50.0)
    assert bool(t[3])
    _same(j, t)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_device_armijo_nonfinite_trial_fails_not_hangs(bad):
    def ev(a):
        return torch.where(a > 1e-12, _t(bad), _t(0.0)), _t(0.0), (a,)

    _, _, _, ok = tdw.device_armijo(ev, _t(0.0), -1.0, (_t(0.0),), alpha0=1.0)
    assert not bool(ok)


def test_transition_is_pure_tensor_code():
    """One Wolfe transition and one Armijo transition run under a tensor
    mode that refuses host reads (`.item()`, `float()`, a Python branch on
    a tensor): the transitions read nothing back, so a CUDA graph can hold
    them."""
    from torch.overrides import TorchFunctionMode

    class NoHostReads(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.Tensor.item, torch.Tensor.__bool__,
                        torch.Tensor.__float__, torch.Tensor.__int__,
                        torch.Tensor.tolist):
                raise AssertionError(f"host read {func}")
            return func(*args, **(kwargs or {}))

    phi0, derphi0 = _t(1.0), _t(-2.0)
    st = tdw.wolfe_init(phi0, derphi0, _t(0.5), torch.tensor(True), (_t(0.0),),
                        amax=3.0)
    ast = tdw.armijo_init(phi0, (_t(0.0),), alpha0=1.0)
    with NoHostReads():
        for _ in range(3):
            a = tdw.wolfe_trial(st)
            st = tdw.wolfe_step(st, (a - 1.0) ** 2, 2 * (a - 1.0), (a,),
                                phi0=phi0, derphi0=derphi0, amax=3.0)
            ast = tdw.armijo_step(ast, 2.0 + ast.trial, (ast.trial,),
                                  phi0=phi0, derphi0=derphi0)
    assert st.phase.dtype == torch.int64 and st.a_star.dtype == torch.float64
