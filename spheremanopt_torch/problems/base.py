"""Problem helpers shared by the port's problems (PyTorch port of
the JAX package's `problems/base.py`).

A problem exposes the callable triple the optimiser and gradient test
consume — `objective(xs) -> 0-dim tensor -J`, `gradient(xs) -> [tensor]`
(Riesz representatives), `inner_product(x, y)` — over lists of 1-D
tensors, together with the sphere radii and IC generation:

    p = SwiftHohenberg(cfg, device="cuda")
    x0 = p.generate_ic(seed=42)
    res = optimise_on_multi_sphere(x0, p.radii, p.objective, p.gradient,
                                   p.inner_product, ...)
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.autograd.forward_ad as fwAD

# config dtype names -> torch dtypes
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a GPU raises
    (a problem never drops to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r}: no CUDA GPU found (pass device='cpu' "
            "to run on the CPU)")
    return device


def check_choice(field: str, value, allowed) -> None:
    """Loud validation for string config switches: an unrecognised value
    must not silently select a fallback compute path."""
    if value not in allowed:
        raise ValueError(
            f"{field} must be one of {sorted(allowed)!r}, got {value!r}")


class SegmentAdvance:
    """n-step solver advances for PDE-state restart (the JAX package's
    `SegmentAdvance`, there a cached jitted scan per segment length).

    Problems expose `initial_state(x_list) -> dict[str, tensor]` and
    `advance_state(state, n_steps) -> state` built on this helper — the
    analogue of the reference's Dedalus `IVP_FWD.load_state` restart
    path (`FWD_Solve_SH23.py:459-460`). A plain loop under no_grad, so
    advance(s, a + b) == advance(advance(s, a), b) exactly.
    """

    def __init__(self, step_fn: Callable):
        self._step = step_fn

    def __call__(self, state: dict, n_steps: int):
        with torch.no_grad():
            for _ in range(int(n_steps)):
                state = self._step(state)
        return state


def riesz_gradient(objective: Callable, weights) -> Callable:
    """Gradient of `objective` as Riesz representatives under weighted
    inner products IP_i(x, y) = sum(w_i * x * y).

    Autograd returns covectors g with dJ[v] = sum(g * v); the optimiser's
    geometry needs the representative r with IP(r, v) = dJ[v], i.e.
    r = g / w. `weights` is one scalar (or tensor) per state component.
    """

    def gradient(x_list):
        raw = value_and_raw_gradient(objective, x_list)[1]
        return [g / w for g, w in zip(raw, weights)]

    return gradient


def _leaf(x):
    """`x` as a fresh autograd leaf; a forward-mode (dual) tensor keeps its
    tangent."""
    primal, tangent = fwAD.unpack_dual(x)
    if tangent is None:
        return x.detach().requires_grad_(True)
    return fwAD.make_dual(primal.detach(), tangent).requires_grad_(True)


def value_and_raw_gradient(objective: Callable, x_list):
    """(objective(xs), [d objective / d x_i]) from one forward+backward:
    reverse-mode autograd of the discrete forward (the discrete
    adjoint). Inputs that carry forward-mode tangents
    (`torch.autograd.forward_ad` dual tensors) keep them, so the
    gradient's tangent is the Hessian-vector product: forward over
    reverse, as `optim/rtr.py` uses it."""
    xs = [_leaf(x) for x in x_list]
    with torch.enable_grad():
        J = objective(xs)
        grads = torch.autograd.grad(J, xs)
    return J.detach(), list(grads)
