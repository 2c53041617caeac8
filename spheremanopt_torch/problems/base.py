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

Rows. A sweep runs R independent optimisations at once, each state
tensor with a leading row axis (R, ...). `row_forms(problem)` gives the
callables it needs (`RowForms`): the problem's native batched forms where
it has them (`problem.row_forms()`), else None, and the sweep then runs
its rows one after another on the unbatched loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

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


class MeshForms:
    """`problem.on_mesh(mesh)`: the problem's state forms over DTensor
    state sharded on `mesh`, its operators replicated on every rank
    (`parallel.sharded.ShardedProblem`). An adapter: each evaluation
    gathers the state and runs the whole solve on every rank, so it
    splits neither memory nor work."""

    def on_mesh(self, mesh):
        from spheremanopt_torch.parallel.sharded import ShardedProblem

        return ShardedProblem(self, mesh)


def to_f64(x_list):
    """A state list in float64 (df64 mode: an f32 state for the f64 twin
    problem; f32 values are exact in f64)."""
    return [torch.as_tensor(x).to(torch.float64) for x in x_list]


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
    reverse, as `optim/rtr.py` uses it.

    An objective of rows returns J of shape (R,): the rows are
    independent, so the gradient of J.sum() is each row's gradient."""
    xs = [_leaf(x) for x in x_list]
    with torch.enable_grad():
        J = objective(xs)
        grads = torch.autograd.grad(
            J, xs, grad_outputs=None if J.dim() == 0 else torch.ones_like(J))
    return J.detach(), list(grads)


# ---------------------------------------------------------------------------
# rows: R independent points with a leading row axis
# ---------------------------------------------------------------------------


class RowForms(NamedTuple):
    """A problem's callables over rows. `f_and_g(xs) -> (J (R,), [g (R,
    ...)])`, `f` (J only) and `grad` (gradient only; None where a driver
    does not need it) take `(aux, xs)` when the problem's loop has an aux
    operand; `inner_product` is one per-row callable `(x, y) -> (R,)` or
    a list of them, one per sphere."""
    f_and_g: Callable
    f: Optional[Callable]
    grad: Optional[Callable]
    inner_product: object


def row_forms(problem, aux: bool = False) -> Optional[RowForms]:
    """The native row forms of `problem` (`problem.row_forms(aux)`, with
    `aux` the forms that take the loop's aux operand), or None where the
    problem or its configuration has none."""
    native = getattr(problem, "row_forms", None)
    return None if native is None else native(aux)
