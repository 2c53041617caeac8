"""Dedalus-layout HDF5 exports that the reference's own plot scripts read
unmodified.

Port of the JAX package's `io/dedalus_export.py`. `io/h5compat.py`
reproduces the reference's three artifact files; this module writes
`scalar_data_iter_0.h5` / `CheckPoints_iter_0.h5` with the dataset
paths, shapes and extra scalar dims that the reference's
`plot_figure_*.py` readers index:

  * SH23:   `scales/sim_time`, `tasks/Kinetic energy` (T,1);
            `scales/x/1.5`, `tasks/u` (2,mgx), `tasks/u_hat` (2,kxn)
            complex (plot_figure_SH23_FULL.py:38-42,106-121)
  * SHB23:  `tasks/Kinetic energy`; `scales/z/1.5`, `tasks/u`
            (plot_figure_SHB23.py:31-42,110-116)
  * KDyn:   `tasks/Magnetic energy` (T,1,1,1); `scales/{x,y,z}/1.5`,
            `tasks/{A,B,C}` + `tasks/{u,v,w}-velocity` (2,m,m,m)
            (plot_figure_KDyn.py:31-35,95-100; the driving velocity is
            stationary, so both writes carry the same field, as the
            reference's own CheckPoints would)
  * mixing: `tasks/Kinetic  energy` / `Buoyancy energy` (T,1,1) (the
            reference's literal double space); `scales/{x,z}/1.5`,
            `scales/kx`, `scales/Tz`, `tasks/b`, `tasks/vorticity`
            (2,mgx,mgz), and the four spectra tasks
            `kx/Tz Kinetic  energy` / `Buoyancy energy`
            (plot_figure_Poiseuille.py:34-44,193-198; task definitions
            FWD_Solve_Poiseuille.py:698-708)

The time axis of every CheckPoints task is [initial, final]: the
reference plot mains read `times = [0, -1]`. All assembly is f64 numpy on
the host through the problems' exact operator matrices.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from spheremanopt_torch.io.checkpoint import to_numpy
from spheremanopt_torch.io.h5compat import _h5py
from spheremanopt_torch.ops.fourier import nyquist_mask_rfft


# ---------------------------------------------------------------------
# numpy mirrors of the problems' transforms (exact f64 operators)
# ---------------------------------------------------------------------


def _mix_to_coeff_np(p, g: np.ndarray) -> np.ndarray:
    c = np.einsum("kj,jz->kz", p._Fx64, np.asarray(g, np.float64))
    c = np.einsum("nz,kz->kn", p._Az64, c)
    return c * p._xmask[:, None]


def _mix_to_grid_np(p, c: np.ndarray) -> np.ndarray:
    g = np.einsum("zn,kn->kz", p._Vz64, np.asarray(c, np.complex128))
    return np.real(np.einsum("jk,kz->jz", p._Bx64, g))


def _mix_kx_task(p, g2d: np.ndarray) -> np.ndarray:
    """`inv_Vol*integ(g, 'z')` in the x-coeff layout (kxn,) complex —
    the reference's kx spectra tasks (FWD_Solve_Poiseuille.py:699-700)."""
    dx = p.cfg.lx / p.mgx
    e_x = np.einsum("xz,xz->x", p._w64, np.asarray(g2d, np.float64)) / dx
    return p._Fx64 @ e_x


def _mix_tz_task(p, g2d: np.ndarray) -> np.ndarray:
    """`inv_Vol*integ(g, 'x')` in the z-coeff (Chebyshev Tz) layout
    (nz,) — the reference's Tz spectra tasks (:702-703)."""
    dx = p.cfg.lx / p.mgx
    vol = p.cfg.lx * 2.0
    e_z = np.sum(np.asarray(g2d, np.float64), axis=0) * dx / vol
    return p._Az64 @ e_z


def _sh23_u_hat_np(p, u_grid: np.ndarray) -> np.ndarray:
    """Oversampled-grid u -> truncated rfft coefficients, mirroring
    `FourierBasis1D.to_coeff` (rfft/m, band k <= n/2, Nyquist zeroed)."""
    u = np.asarray(u_grid, np.float64)
    m = u.shape[-1]
    c = np.fft.rfft(u) / m
    c = c[: p.cfg.npts // 2 + 1]
    return c * nyquist_mask_rfft(p.cfg.npts)


# ---------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------


def _write(path: str, scales: Dict[str, np.ndarray],
           tasks: Dict[str, np.ndarray]) -> str:
    h5py = _h5py()
    with h5py.File(path, "w") as f:
        for name, arr in scales.items():
            f.create_dataset(f"scales/{name}", data=to_numpy(arr))
        for name, arr in tasks.items():
            f.create_dataset(f"tasks/{name}", data=to_numpy(arr))
    return path


def export_dedalus_h5(out_dir: str, problem_name: str, problem, result,
                      diagnostics: Dict[str, np.ndarray]) -> Dict[str, str]:
    """Write `scalar_data_iter_0.h5` + `CheckPoints_iter_0.h5` into
    `out_dir` in the reference's exact Dedalus layouts (see module
    docstring). Returns {kind: path}."""
    import os

    if problem_name not in ("sh23", "shb23", "kdyn", "mixing"):
        # problems without Dedalus-layout counterparts (pca) — before
        # touching the diagnostics dict, which they may not populate
        return {}
    d = {k: to_numpy(v) for k, v in diagnostics.items()}
    t = d["sim_time"]
    xs = [to_numpy(x).astype(np.float64) for x in result.x_opt]

    if problem_name == "sh23":
        scalar_tasks = {"Kinetic energy": d["kinetic_energy"][:, None]}
        u_hat = np.stack([_sh23_u_hat_np(problem, d["u_initial"]),
                          d["u_hat_final"]])
        ck_scales = {"x/1.5": d["x_grid"]}
        ck_tasks = {"u": np.stack([d["u_initial"], d["u_final"]]),
                    "u_hat": u_hat}
    elif problem_name == "shb23":
        scalar_tasks = {"Kinetic energy": d["kinetic_energy"][:, None]}
        ck_scales = {"z/1.5": d["z_grid"]}
        ck_tasks = {"u": np.stack([d["u_initial"], d["u_final"]])}
    elif problem_name == "kdyn":
        scalar_tasks = {
            "Magnetic energy": d["magnetic_energy"][:, None, None, None]}
        m = d["B_final"].shape[-1]
        g = np.arange(m) * problem.cfg.length / m
        ck_scales = {"x/1.5": g, "y/1.5": g, "z/1.5": g}
        b0, u0 = xs[0], xs[1]
        ck_tasks = {}
        for i, name in enumerate("ABC"):
            ck_tasks[name] = np.stack([b0[i], d["B_final"][i]])
        for i, name in enumerate(("u-velocity", "v-velocity",
                                  "w-velocity")):
            ck_tasks[name] = np.stack([u0[i], u0[i]])
    elif problem_name == "mixing":
        p = problem
        scalar_tasks = {
            "Kinetic  energy": d["kinetic_energy"][:, None, None],
            "Buoyancy energy": d["buoyancy_energy"][:, None, None]}
        rho0_g = _mix_to_grid_np(p, p._rho0_c64)
        u0_c = _mix_to_coeff_np(p, xs[0][0])
        w0_c = _mix_to_coeff_np(p, xs[0][1])
        vort0 = _mix_to_grid_np(
            p, (1j * p._kx)[:, None] * w0_c
            - np.einsum("mn,kn->km", p._Dz_np.astype(np.float64), u0_c))
        uw2 = [xs[0][0] ** 2 + xs[0][1] ** 2,
               d["u_final"] ** 2 + d["w_final"] ** 2]
        bb = [rho0_g ** 2, d["rho_final"] ** 2]
        ck_scales = {"x/1.5": d["x_grid"], "z/1.5": d["z_grid"],
                     "kx": np.asarray(p._kx),
                     "Tz": np.arange(p.cfg.nz)}
        ck_tasks = {
            "b": np.stack([rho0_g, d["rho_final"]]),
            "vorticity": np.stack([vort0, d["vorticity_final"]]),
            "kx Kinetic  energy": np.stack(
                [_mix_kx_task(p, g) for g in uw2])[:, :, None],
            "kx Buoyancy energy": np.stack(
                [_mix_kx_task(p, g) for g in bb])[:, :, None],
            "Tz Kinetic  energy": np.stack(
                [_mix_tz_task(p, g) for g in uw2])[:, None, :],
            "Tz Buoyancy energy": np.stack(
                [_mix_tz_task(p, g) for g in bb])[:, None, :],
        }
    else:
        return {}

    out = {
        "scalar_iter": _write(
            os.path.join(out_dir, "scalar_data_iter_0.h5"),
            {"sim_time": t}, scalar_tasks),
        "checkpoints_iter": _write(
            os.path.join(out_dir, "CheckPoints_iter_0.h5"),
            ck_scales, ck_tasks),
    }
    return out
