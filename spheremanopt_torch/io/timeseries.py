"""Scalar time series, state snapshots and the optimiser's per-iteration
archivers.

Port of the JAX package's `io/timeseries.py`. It replaces the reference's
Dedalus file handlers ('scalar_data' KE series, 'CheckPoints' state
snapshots, `FWD_Solve_SH23.py:478-483`) and the per-iteration copies made
by `File_Manips` (`:731-746`) with npz recorders:

  * `save_scalar_series`  named 1-D series and a time axis ('scalar_data')
  * `save_snapshots`      named fields and grids ('CheckPoints')
  * `LightArchiver`       what the iteration already produced (histories,
                          the iterate), no extra solve
  * `FusedArchiver`       full diagnostics from the optimisation's own
                          solves, no extra solve
  * `IterationArchiver`   full diagnostics from a re-run of the forward
                          solve (problems without a fused form)

Payloads may be tensors on the card; they are copied to the host when
they are written (`FusedArchiver`: on its writer thread), never before.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable, Dict

import numpy as np

from spheremanopt_torch.io.checkpoint import to_numpy


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_scalar_series(path: str, sim_time, **series) -> str:
    path = _npz(path)
    np.savez(path, sim_time=to_numpy(sim_time),
             **{k: to_numpy(v) for k, v in series.items()})
    return path


def load_scalar_series(path: str) -> Dict[str, np.ndarray]:
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_snapshots(path: str, grids: Dict[str, np.ndarray],
                   fields: Dict[str, np.ndarray]) -> str:
    path = _npz(path)
    payload = {f"grid_{k}": to_numpy(v) for k, v in grids.items()}
    payload.update({f"field_{k}": to_numpy(v) for k, v in fields.items()})
    np.savez(path, **payload)
    return path


def load_snapshots(path: str):
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    grids, fields = {}, {}
    with np.load(path) as data:
        for k in data.files:
            if k.startswith("grid_"):
                grids[k[5:]] = data[k]
            elif k.startswith("field_"):
                fields[k[6:]] = data[k]
    return grids, fields


def _write_diag(path: str, diag: dict) -> None:
    np.savez(path, **{key: to_numpy(val) for key, val in diag.items()})


class LightArchiver:
    """Optimiser callback: per iteration, archive only what the iteration
    already produced (J history, residuals, step sizes, wall times and,
    optionally, the current iterate) to `<prefix>_iter_<k>.npz`. No extra
    solve: the reference's `File_Manips` copies files that are already
    written (`FWD_Solve_SH23.py:731-746`). The CLI's default archive mode
    (`--archive-every N`)."""

    def __init__(self, prefix: str, out_dir: str = ".",
                 save_iterate: bool = True):
        self.prefix = prefix
        self.out_dir = out_dir
        self.save_iterate = save_iterate
        os.makedirs(out_dir, exist_ok=True)
        self.paths = []

    def __call__(self, k: int, result) -> None:
        payload = {
            "iteration": np.asarray(k),
            "function_values": np.asarray(result.function_values),
            "residuals": np.asarray(
                [r[: len(result.step_sizes)] for r in result.residuals]),
            "step_sizes": np.asarray(result.step_sizes),
            "wall_times": np.asarray(result.wall_times),
            "function_evals": np.asarray(result.function_evals),
            "gradient_evals": np.asarray(result.gradient_evals),
        }
        if self.save_iterate and result.x_opt is not None:
            for i, x in enumerate(result.x_opt):
                payload[f"x_opt_{i}"] = to_numpy(x)
        path = os.path.join(self.out_dir, f"{self.prefix}_iter_{k}.npz")
        np.savez(path, **payload)
        self.paths.append(path)


class FusedArchiver:
    """Optimiser callback that archives full diagnostics per iteration at
    no extra solve. Its `f`, `grad_f` and `f_and_g` stand in for the
    problem's in the optimiser: they call the problem's fused
    `objective_and_diagnostics` / `objective_gradient_and_diagnostics`,
    whose one solve gives J (and the gradient, bitwise the plain forms')
    and the diagnostics payload, cached by the exact J. When the
    optimiser accepts an iterate and calls back, the accepted J (bitwise
    the trial's) looks its payload up and it is written. On `method=cuda`
    every forward of the run is then the series kernel, and no plain
    forward runs beside it.

    The reference's scalar_data / CheckPoints handlers ride the same
    Dedalus forward as the cost (`FWD_Solve_SH23.py:478-483,731-746`);
    `IterationArchiver` re-runs the forward instead, for problems without
    a fused form (KDyn's `method="cuda"`).

        arch = FusedArchiver("diag", problem, out_dir)
        optimise_on_multi_sphere(x0, radii, arch.f, arch.grad_f,
                                 problem.inner_product,
                                 f_and_g=arch.f_and_g, callback=arch)
        arch.flush()
    """

    def __init__(self, prefix: str, problem, out_dir: str = ".",
                 keep: int = 8, async_writes: bool = True):
        if not getattr(problem, "has_fused_diagnostics", False):
            raise ValueError(
                "problem config has no fused-diagnostics objective; use "
                "IterationArchiver (re-runs diagnostics) instead")
        self.prefix = prefix
        self.problem = problem
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.paths = []
        self.fallback_recomputes = 0   # cache misses (should stay 0)
        self._keep = keep
        self._cache: "OrderedDict[float, dict]" = OrderedDict()
        # async_writes takes the device-to-host copies and the npz writes
        # off the optimisation's path: one writer thread, FIFO; `flush()`
        # (the CLI calls it) before reading `paths`
        self._pool = None
        self._pending: list = []
        if async_writes:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=1)

    def _store(self, J: float, diag: dict) -> None:
        # Latest wins: a same-J store from another trial overwrites, and
        # the accepted trial is the last evaluation at its J before the
        # callback (the line searches return on accept). A key evicted by
        # more than `keep` later trials costs a counted recompute
        # (`fallback_recomputes`), never a wrong payload. The payload
        # holds the trial's own tensors: the host loop allocates every
        # solve's outputs afresh, and nothing writes them later.
        self._cache[J] = diag
        self._cache.move_to_end(J)
        while len(self._cache) > self._keep:
            self._cache.popitem(last=False)

    def f(self, xs):
        J, diag = self.problem.objective_and_diagnostics(xs)
        J = float(J)
        self._store(J, diag)
        return J

    def f_and_g(self, xs):
        J, g, diag = self.problem.objective_gradient_and_diagnostics(xs)
        self._store(float(J), diag)
        return J, g

    def grad_f(self, xs):
        return self.f_and_g(xs)[1]

    def __call__(self, k: int, result) -> None:
        # function_values holds -J of the accepted iterate (the negation is
        # exact, so the key matches bitwise)
        J = -float(result.function_values[-1])
        diag = self._cache.get(J)
        if diag is None:
            # resumed mid-run, or a driver that bypassed f / f_and_g
            self.fallback_recomputes += 1
            diag = self.problem.diagnostics(result.x_opt)
        path = os.path.join(self.out_dir, f"{self.prefix}_iter_{k}.npz")
        if self._pool is not None:
            # `paths` lists only files that have landed: the append runs in
            # the writer's task after the write, and a failed write (flush
            # re-raises it) leaves no path behind
            self._pending.append(
                self._pool.submit(self._write_and_record, path, dict(diag)))
        else:
            _write_diag(path, diag)
            self.paths.append(path)

    def _write_and_record(self, path: str, diag: dict) -> None:
        _write_diag(path, diag)
        self.paths.append(path)

    def flush(self) -> None:
        """Wait for the pending writes, re-raising the first failure.
        Idempotent."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()


class IterationArchiver:
    """Optimiser callback: per iteration, evaluate `diagnostics(x_opt)` (a
    dict of arrays and scalars) and write `<prefix>_iter_<k>.npz`.

    `diagnostics` re-runs the forward solve, so at `--archive-every 1`
    it adds a solve an iteration; `LightArchiver` and `FusedArchiver`
    add none."""

    def __init__(self, prefix: str, diagnostics: Callable, out_dir: str = "."):
        self.prefix = prefix
        self.diagnostics = diagnostics
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.paths = []

    def __call__(self, k: int, result) -> None:
        diag = self.diagnostics(result.x_opt)
        path = os.path.join(self.out_dir, f"{self.prefix}_iter_{k}.npz")
        _write_diag(path, diag)
        self.paths.append(path)
