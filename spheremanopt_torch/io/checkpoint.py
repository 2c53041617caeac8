"""Optimiser progress checkpoint/resume, and the PDE solver state.

Port of the JAX package's `io/checkpoint.py`: the reference's rank-0 h5py
`DAL_PROGRESS.h5` rewrite (`Sphere_Grad_Descent.py:821-829`) and its
sketched resume (`FWD_Solve_SH23.py:787-800`) as a portable .npz and a
`load_progress` that rebuilds an `OptimiseResult` to warm-start from
`x_opt`. The keys, dtypes and the atomic `os.replace` are the JAX
package's, so either package resumes from the other's files. Tensors
(on any device) are saved as numpy arrays in their own dtype; loads
return numpy arrays.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def to_numpy(v) -> np.ndarray:
    """A tensor on any device, or anything numpy takes, as a numpy array."""
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _atomic_savez(path: str, payload: dict) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path if path.endswith(".npz") else path + ".npz")


def save_progress(path: str, result) -> None:
    """Atomically write the optimiser state to `path` (.npz)."""
    payload = {
        "n_components": result.n_components,
        "iterations": result.iterations,
        "function_evals": result.function_evals,
        "gradient_evals": result.gradient_evals,
        "step_sizes": np.asarray(result.step_sizes, dtype=np.float64),
        "function_values": np.asarray(result.function_values, dtype=np.float64),
        "wall_times": np.asarray(result.wall_times, dtype=np.float64),
        "converged": result.converged,
    }
    for i, r in enumerate(result.residuals):
        payload[f"residual_{i}"] = np.asarray(r, dtype=np.float64)
    if result.x_opt is not None:
        payload["n_x"] = len(result.x_opt)
        for i, x in enumerate(result.x_opt):
            payload[f"x_opt_{i}"] = to_numpy(x)
    _atomic_savez(path, payload)


def save_pde_state(path: str, state: dict, step: int, meta: Optional[dict] = None) -> None:
    """Atomically save a mid-trajectory PDE solver state: a dict of real
    arrays (the problems keep complex fields as stacked re/im planes) and
    the step it was taken at (the reference restarts long forward solves
    with Dedalus `IVP_FWD.load_state`, `FWD_Solve_SH23.py:459-460`)."""
    payload = {f"state_{k}": to_numpy(v) for k, v in state.items()}
    payload["pde_step"] = np.asarray(int(step))
    for k, v in (meta or {}).items():
        payload[f"meta_{k}"] = np.asarray(v)
    _atomic_savez(path, payload)


def load_pde_state(path: str):
    """(state dict of numpy arrays, step, meta) saved by save_pde_state."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    state, meta, step = {}, {}, 0
    with np.load(path) as data:
        for k in data.files:
            if k.startswith("state_"):
                state[k[6:]] = data[k]
            elif k == "pde_step":
                step = int(data[k])
            elif k.startswith("meta_"):
                meta[k[5:]] = data[k]
    return state, step, meta


def load_progress_any(path: str):
    """Optimiser progress from the .npz or from a reference-format
    `DAL_PROGRESS.h5` (every `vars(R)` item as a dataset,
    `Sphere_Grad_Descent.py:821-826`), so `--resume` can continue a
    reference study."""
    if path.endswith(".h5") or _is_hdf5(path):
        return _load_progress_h5(path)
    return load_progress(path)


def _is_hdf5(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(8) == b"\x89HDF\r\n\x1a\n"
    except OSError:
        return False


def _load_progress_h5(path: str):
    from spheremanopt_torch.io.h5compat import load_dal_progress_h5
    from spheremanopt_torch.optim.optimiser import OptimiseResult

    data = load_dal_progress_h5(path)
    if "X_opt" in data:
        x_opt = [np.asarray(x) for x in np.atleast_2d(np.asarray(data["X_opt"]))]
    else:  # ragged components: one X_opt_{i} dataset each
        idx = sorted(int(k[6:]) for k in data if k.startswith("X_opt_"))
        x_opt = [np.asarray(data[f"X_opt_{i}"]) for i in idx]
    n = int(data.get("N", len(x_opt)))
    R = OptimiseResult(n_components=n)
    R.x_opt = x_opt
    R.iterations = int(data.get("Iterations", 0))
    R.function_evals = int(data.get("Function_Evals", 0))
    R.gradient_evals = int(data.get("Gradient_Evals", 0))
    res = np.atleast_2d(np.asarray(data.get("Residual", np.zeros((n, 0)))))
    R.residuals = [list(np.asarray(r, dtype=np.float64)) for r in res]
    R.step_sizes = list(np.atleast_1d(np.asarray(
        data.get("Step_Size", []), dtype=np.float64)))
    R.function_values = list(np.atleast_1d(np.asarray(
        data.get("Function_Value", []), dtype=np.float64)))
    R.wall_times = []
    R.converged = False
    return R


def load_progress(path: str):
    """A progress checkpoint back into the port's OptimiseResult (x_opt as
    numpy arrays)."""
    from spheremanopt_torch.optim.optimiser import OptimiseResult

    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    with np.load(path) as data:
        n = int(data["n_components"])
        R = OptimiseResult(n_components=n)
        R.iterations = int(data["iterations"])
        R.function_evals = int(data["function_evals"])
        R.gradient_evals = int(data["gradient_evals"])
        R.step_sizes = list(data["step_sizes"])
        R.function_values = list(data["function_values"])
        R.wall_times = list(data["wall_times"])
        R.converged = bool(data["converged"])
        R.residuals = [list(data[f"residual_{i}"]) for i in range(n)]
        if "n_x" in data:
            R.x_opt = [data[f"x_opt_{i}"] for i in range(int(data["n_x"]))]
    return R
