"""HDF5 exports in the reference ecosystem's file formats.

Port of the JAX package's `io/h5compat.py`. The native artifacts are npz
(io/timeseries, io/checkpoint); a reference user's post-processing reads
three h5 layouts, which these writers reproduce name for name:

  * `DAL_PROGRESS.h5`: the optimiser state dump
    (`Sphere_Grad_Descent.py:823-826` writes every field of its result
    class: N, X_opt, Iterations, Function_Evals, Gradient_Evals,
    Residual, Step_Size, Function_Value; restart scripts read
    `Residual`, `Function_Value`, `X_opt[0]`,
    `FWD_Solve_SH23.py:789-794`).
  * `scalar_data_s1.h5`: the Dedalus scalar-series layout,
    `scales/sim_time` + `tasks/<name>` of shape (T, 1)
    (`FWD_Solve_SH23.py:478-483`; plot scripts read
    `file['tasks/Kinetic energy'][:,0]`, `plot_figure_SH23_FULL.py:38-42`).
  * `CheckPoints_s1.h5`: the Dedalus snapshot layout, `scales/<axis>` +
    `tasks/<name>` with a leading write dimension.

h5py is optional: it is imported when an h5 function is called, which
raises ImportError without it. Exports run once at a run's end
(`run.py --h5`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from spheremanopt_torch.io.checkpoint import to_numpy

# reference analysis-task names per problem (`add_task(..., name=...)`):
# SH23 FWD_Solve_SH23.py:470, SHB23 FWD_Solve_SHB23.py:470(-style),
# KDyn FWD_Solve_KDyn.py:613, mixing FWD_Solve_Poiseuille.py:707-708
# (note the reference's literal double space in "Kinetic  energy")
TASK_NAMES: Dict[str, Dict[str, str]] = {
    "sh23": {"kinetic_energy": "Kinetic energy"},
    "shb23": {"kinetic_energy": "Kinetic energy"},
    "kdyn": {"magnetic_energy": "Magnetic energy"},
    "mixing": {"kinetic_energy": "Kinetic  energy",
               "buoyancy_energy": "Buoyancy energy"},
}


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "h5 export needs the optional h5py dependency "
            "(pip install h5py)") from e
    return h5py


def save_dal_progress_h5(path: str, result) -> str:
    """Write an OptimiseResult as the reference's DAL_PROGRESS.h5.

    Dataset names match `vars(R)` of `Sphere_Grad_Descent.py`'s result
    class exactly; history datasets are truncated to the iterations
    actually run (the reference's lists grow per iteration)."""
    h5py = _h5py()
    if not path.endswith(".h5"):
        path = path + ".h5"
    k = int(result.iterations)
    xs = [to_numpy(x) for x in result.x_opt]
    with h5py.File(path, "w") as f:
        f.create_dataset("N", data=result.n_components)
        f.create_dataset("Iterations", data=k)
        f.create_dataset("Function_Evals", data=int(result.function_evals))
        f.create_dataset("Gradient_Evals", data=int(result.gradient_evals))
        f.create_dataset("Residual",
                         data=np.asarray([np.asarray(r)[:k]
                                          for r in result.residuals]))
        f.create_dataset("Step_Size",
                         data=np.asarray(result.step_sizes)[:k])
        f.create_dataset("Function_Value",
                         data=np.asarray(result.function_values)[:k])
        if len({x.shape for x in xs}) <= 1:
            # homogeneous components stack exactly as the reference's
            # `create_dataset('X_opt', data=R.X_opt)` list write does
            f.create_dataset("X_opt", data=np.stack(xs) if xs else
                             np.zeros(0))
        else:  # ragged components: one dataset each (the reference's
            # writer would fail here; its try/except swallows the file)
            for i, x in enumerate(xs):
                f.create_dataset(f"X_opt_{i}", data=x)
    return path


def load_dal_progress_h5(path: str) -> Dict[str, np.ndarray]:
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f.keys()}


def save_scalar_series_h5(path: str, sim_time, tasks: Dict[str, np.ndarray]
                          ) -> str:
    """Dedalus scalar_data layout: scales/sim_time + tasks/<name> with
    shape (T, 1) (plot scripts index `[:, 0]`)."""
    h5py = _h5py()
    if not path.endswith(".h5"):
        path = path + ".h5"
    t = to_numpy(sim_time)
    with h5py.File(path, "w") as f:
        f.create_dataset("scales/sim_time", data=t)
        for name, arr in tasks.items():
            a = to_numpy(arr)
            if a.ndim == 1:
                a = a[:, None]
            f.create_dataset(f"tasks/{name}", data=a)
    return path


def save_checkpoints_h5(path: str, grids: Dict[str, np.ndarray],
                        fields: Dict[str, np.ndarray]) -> str:
    """Dedalus CheckPoints layout: scales/<axis> + tasks/<name> with a
    leading write dimension (one snapshot per write)."""
    h5py = _h5py()
    if not path.endswith(".h5"):
        path = path + ".h5"
    with h5py.File(path, "w") as f:
        for name, g in grids.items():
            f.create_dataset(f"scales/{name}", data=to_numpy(g))
        for name, a in fields.items():
            a = to_numpy(a)
            f.create_dataset(f"tasks/{name}", data=a[None])
    return path


def export_run_h5(out_dir: str, problem_name: str, result,
                  diagnostics: Dict[str, np.ndarray]) -> Dict[str, str]:
    """One-call export of a finished run into the three reference h5
    artifacts inside `out_dir`. Returns {kind: path}."""
    import os

    names = TASK_NAMES.get(problem_name, {})
    t = to_numpy(diagnostics.get("sim_time", []))
    tasks, grids, fields = {}, {}, {}
    for key, val in diagnostics.items():
        a = to_numpy(val)
        if key == "sim_time":
            continue
        if a.ndim == 1 and t.size and a.shape[0] == t.shape[0]:
            tasks[names.get(key, key)] = a
        elif key.endswith("_grid"):
            grids[key] = a
        elif a.ndim >= 1 and a.size > 1:
            fields[key] = a
    out = {"dal": save_dal_progress_h5(
        os.path.join(out_dir, "DAL_PROGRESS.h5"), result)}
    if tasks:
        out["scalar"] = save_scalar_series_h5(
            os.path.join(out_dir, "scalar_data_s1.h5"), t, tasks)
    if fields:
        out["checkpoints"] = save_checkpoints_h5(
            os.path.join(out_dir, "CheckPoints_s1.h5"), grids, fields)
    return out
