"""Sharded state with the operators replicated: the counterpart of the
JAX package's GSPMD runs (`tests/test_sharded_optimise.py`), where a
problem's state arrives as arrays sharded over a mesh and the operators
are replicated.

This is an adapter, not a partitioned solve. The state is a list of
DTensors (`parallel.mesh.shard_fields`, one `Shard(dim)` placement per
mesh axis); every rank holds the problem's operators whole, as plain
tensors, gathers the state (an all-gather per component, exact) and runs
the one-process solve on it. No memory and no work is split: P ranks do
P times the work of one, and each holds the whole state and trajectory.
What it buys is the interface (DTensor state in, DTensor gradients and
x_opt out, with the state's placements) and bitwise agreement with the
one-process run at any rank count: no contraction or reduction over a
sharded axis runs as partial sums, whose order would depend on the rank
count, and DTensor's own FFT (which gathers the field anyway) never runs.

  * `problem.on_mesh(mesh)` (`ShardedProblem`) evaluates the objective,
    gradient, fused and aux forms on DTensor state and returns the
    gradients with the state's placements.
  * the optimisation loops (`optim.optimiser.optimise_on_multi_sphere`,
    the device loops of `optim.graph_loop.DeviceOptimiser`) gather a
    DTensor x0 once, run unchanged on every rank, and return x_opt with
    x0's placements.

The solve that divides its work over the ranks is KDyn's
`transform="distributed"` (`parallel/fft.py`), whose state is its ranks'
local shards.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, distribute_tensor


class Layout:
    """The mesh and placements of a list of DTensors."""

    def __init__(self, xs: Sequence[DTensor]):
        if not all(isinstance(x, DTensor) for x in xs):
            raise TypeError("Layout: every state component must be a DTensor "
                            "(or none of them)")
        self.mesh = xs[0].device_mesh
        if any(x.device_mesh != self.mesh for x in xs):
            raise ValueError("Layout: the state's components lie on different meshes")
        self.placements = [tuple(x.placements) for x in xs]

    @staticmethod
    def of(xs) -> Optional["Layout"]:
        """The layout of `xs`, or None for plain tensors."""
        return Layout(list(xs)) if any(isinstance(x, DTensor) for x in xs) else None

    @staticmethod
    def gather(xs) -> List[torch.Tensor]:
        """Full tensors of DTensors (an all-gather each)."""
        return [x.full_tensor() for x in xs]

    def shard(self, fulls) -> List[DTensor]:
        """DTensors of full tensors that every rank holds (each keeps its
        slice; nothing is sent)."""
        return [distribute_tensor(t, self.mesh, pl, src_data_rank=None)
                for t, pl in zip(fulls, self.placements)]


class ShardedProblem:
    """`problem.on_mesh(mesh)`: the problem's `objective`, `gradient`,
    `objective_and_gradient`, `objective_and_gradient_aux` and
    `inner_product` over DTensor state on `mesh` (the state gathered for
    each evaluation, gradients returned with the state's placements);
    plain tensors pass straight through, and every other attribute is
    the problem's own."""

    def __init__(self, problem, mesh):
        self.problem, self.mesh = problem, mesh

    def __getattr__(self, name):
        return getattr(self.problem, name)

    def _call(self, fn: Callable, xs, *lead):
        """(layout or None, fn(*lead, xs) on the gathered state)."""
        layout = Layout.of(xs)
        if layout is None:
            return None, fn(*lead, xs)
        if layout.mesh != self.mesh:
            raise ValueError("on_mesh: the state lies on another mesh")
        return layout, fn(*lead, layout.gather(xs))

    def _fused(self, fn: Callable, xs, *lead):
        layout, (J, g) = self._call(fn, xs, *lead)
        return J, (g if layout is None else layout.shard(g))

    def objective(self, xs):
        return self._call(self.problem.objective, xs)[1]

    def gradient(self, xs):
        layout, g = self._call(self.problem.gradient, xs)
        return g if layout is None else layout.shard(g)

    def objective_and_gradient(self, xs):
        return self._fused(self.problem.objective_and_gradient, xs)

    def inner_product(self, x, y):
        if isinstance(x, DTensor):
            x, y = x.full_tensor(), y.full_tensor()
        return self.problem.inner_product(x, y)

    @property
    def objective_and_gradient_aux(self):
        fg, ops = self.problem.objective_and_gradient_aux
        if fg is None:
            return None, None
        return (lambda o, xs: self._fused(fg, xs, o)), ops
