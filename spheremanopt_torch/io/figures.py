"""Result figures: energy time series, field snapshots, spectra.

Port of the JAX package's `io/figures.py`, the counterpart of the
reference's per-problem plot scripts (`plot_figure_SH23_FULL.py`,
`plot_figure_SHB23.py`, `plot_figure_KDyn.py`,
`plot_figure_Poiseuille.py`): reads the diagnostics dicts of each
problem's `.diagnostics()` (or the npz archives of `io.timeseries`) and
renders the same panels. matplotlib is optional and imported when a
figure is drawn (Agg backend, headless).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from spheremanopt_torch.io.checkpoint import to_numpy


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_energy_series(diag: Dict, save_path: str, keys=None, logy=True) -> str:
    """KE/ME time-series panel (e.g. `plot_figure_SH23_FULL.py:42-76`)."""
    plt = _plt()
    keys = keys or [k for k in diag if k.endswith("energy")]
    fig, ax = plt.subplots(figsize=(7, 5))
    t = to_numpy(diag["sim_time"])
    for k in keys:
        y = to_numpy(diag[k])
        (ax.semilogy if logy else ax.plot)(t, y, linewidth=2, label=k)
    ax.set_xlabel("t")
    ax.legend()
    ax.grid(alpha=0.4)
    fig.tight_layout()
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


def plot_profile(diag: Dict, field_key: str, grid_key: str, save_path: str) -> str:
    """1D state snapshot (initial vs final when both present)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 5))
    x = to_numpy(diag[grid_key])
    ax.plot(x, to_numpy(diag[field_key]), linewidth=2, label=field_key)
    other = field_key.replace("final", "initial")
    if other != field_key and other in diag:
        ax.plot(x, to_numpy(diag[other]), "--", linewidth=1.5, label=other)
    ax.set_xlabel(grid_key)
    ax.legend()
    ax.grid(alpha=0.4)
    fig.tight_layout()
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


def plot_field2d(diag: Dict, field_key: str, save_path: str,
                 x_key: str = "x_grid", z_key: str = "z_grid") -> str:
    """2D pcolormesh snapshot (vorticity/density panels of
    `plot_figure_Poiseuille.py`)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4))
    f = to_numpy(diag[field_key])
    x, z = to_numpy(diag[x_key]), to_numpy(diag[z_key])
    pc = ax.pcolormesh(x, z, f.T, shading="auto", cmap="RdBu_r")
    fig.colorbar(pc, ax=ax)
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_title(field_key)
    fig.tight_layout()
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


def plot_spectrum(coeffs: np.ndarray, save_path: str, label: str = "|u_k|") -> str:
    """Coefficient-magnitude spectrum (`plot_figure_SH23_FULL.py:137-166`)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7, 5))
    mag = np.abs(to_numpy(coeffs)).ravel()
    ax.semilogy(np.arange(len(mag)), np.maximum(mag, 1e-300), linewidth=1.5)
    ax.set_xlabel("mode index")
    ax.set_ylabel(label)
    ax.grid(alpha=0.4)
    fig.tight_layout()
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


# ---------------------------------------------------------------------------
# Per-problem figure assemblies (reference plot-script parity, SURVEY.md
# component #22): each reproduces the panel layout of the corresponding
# reference script from the problem's diagnostics()/state APIs.
# ---------------------------------------------------------------------------


def _three_slice_panel(v: np.ndarray, title: str, save_path: str,
                       cmap: str = "PuOr", levels: int = 30) -> str:
    """`plot_figure_KDyn.py::Plot_UB_pair` (:118-168) layout: 221 = first
    component on a y-z slice, 222 = second component on an x-z slice,
    212 = second component on an x-y slice."""
    plt = _plt()
    m = v.shape[-1]
    s = m // 2
    ax_idx = np.arange(m)
    fig = plt.figure(figsize=(8, 6))
    fig.suptitle(title)
    ax1 = plt.subplot(221)
    cs = ax1.contourf(ax_idx, ax_idx, v[0][s, :, :].T, cmap=cmap, levels=levels)
    fig.colorbar(cs, ax=ax1)
    ax1.set_xlabel("y"); ax1.set_ylabel("z")
    ax2 = plt.subplot(222)
    cs = ax2.contourf(ax_idx, ax_idx, v[1][:, s, :].T, cmap=cmap, levels=levels)
    fig.colorbar(cs, ax=ax2)
    ax2.set_xlabel("x"); ax2.set_ylabel("z")
    ax3 = plt.subplot(212)
    cs = ax3.contourf(ax_idx, ax_idx, v[1][:, :, s], cmap=cmap, levels=levels)
    fig.colorbar(cs, ax=ax3)
    ax3.set_xlabel("x"); ax3.set_ylabel("y")
    fig.tight_layout(pad=1, w_pad=1.5)
    fig.savefig(save_path, dpi=200)
    plt.close(fig)
    return save_path


def figures_kdyn(problem, x_list, out_dir: str) -> list:
    """`plot_figure_KDyn.py` parity: ME-series 1x2 panel (log10 + linear,
    `Plot_KinematicB_scalar_data` :8-64) and three-slice contour panels
    of B at t=0 / t=T and of the stirring field U (`Plot_UB_pair`)."""
    import os

    plt = _plt()
    diag = problem.diagnostics(x_list)
    paths = []

    t = to_numpy(diag["sim_time"])
    me = to_numpy(diag["magnetic_energy"])
    fig, a = plt.subplots(1, 2, figsize=(8, 6))
    a[0].plot(t, np.log10(np.maximum(me, 1e-300)), "-",
              label=r"$\log_{10}\langle B^2\rangle$")
    a[1].plot(t, me, "-.", label=r"$\langle B^2\rangle$")
    for ax in a:
        ax.set_xlabel("t"); ax.legend(); ax.grid(alpha=0.4)
    fig.tight_layout(pad=1, w_pad=1.5)
    p = os.path.join(out_dir, "kdyn_ME_series.pdf")
    fig.savefig(p, dpi=200); plt.close(fig); paths.append(p)

    b0 = to_numpy(x_list[0])
    bT = to_numpy(diag["B_final"])
    uf = to_numpy(x_list[1])
    paths.append(_three_slice_panel(
        b0, "B field, t=0", os.path.join(out_dir, "kdyn_B_t0.pdf")))
    paths.append(_three_slice_panel(
        bT, f"B field, t=T", os.path.join(out_dir, "kdyn_B_tT.pdf")))
    paths.append(_three_slice_panel(
        uf, "U field", os.path.join(out_dir, "kdyn_U.pdf"), levels=10))
    return paths


def figures_mixing(problem, x_list, out_dir: str) -> list:
    """`plot_figure_Poiseuille.py` parity: scalar-series 1x2 semilogy
    panel (`Plot_scalar_data` :10-74), vorticity/density 2x1 contour
    snapshot (`Plot_U_and_B` :116-158, same RdBu colormap and value
    clips), and kx / Tz spectra panels (`Plot_Spectra` :160-256)."""
    import os

    plt = _plt()
    diag = problem.diagnostics(x_list)
    paths = []

    t = to_numpy(diag["sim_time"])
    fig, a = plt.subplots(1, 2, figsize=(8, 6))
    a[0].semilogy(t, to_numpy(diag["kinetic_energy"]),
                  label=r"$\langle u^2 + w^2\rangle$")
    a[1].semilogy(t, to_numpy(diag["buoyancy_energy"]),
                  label=r"$\langle b^2\rangle$")
    for ax in a:
        ax.set_xlabel("t"); ax.legend(); ax.grid(alpha=0.4)
    fig.tight_layout(pad=1, w_pad=1.5)
    p = os.path.join(out_dir, "mixing_scalar_series.pdf")
    fig.savefig(p, dpi=200); plt.close(fig); paths.append(p)

    X = to_numpy(diag["x_grid"]); Z = to_numpy(diag["z_grid"])
    fig, ax = plt.subplots(2, 1, figsize=(8, 6))
    cs = ax[0].contourf(X, Z, to_numpy(diag["vorticity_final"]).T,
                        vmin=-2.0, vmax=2.0, cmap="RdBu", levels=30)
    fig.colorbar(cs, ax=ax[0]); ax[0].set_title(r"$\Omega(T)$")
    cs = ax[1].contourf(X, Z, to_numpy(diag["rho_final"]).T,
                        vmin=-0.5, vmax=0.5, cmap="RdBu", levels=30)
    fig.colorbar(cs, ax=ax[1]); ax[1].set_title(r"$\rho(T)$")
    for axi in ax:
        axi.set_xlabel("x"); axi.set_ylabel("z")
    fig.tight_layout(pad=1, w_pad=1.5)
    p = os.path.join(out_dir, "mixing_fields_T.pdf")
    fig.savefig(p, dpi=200); plt.close(fig); paths.append(p)

    # spectra at t=T from the real grids (host numpy transforms)
    state = problem.advance_state(problem.initial_state(x_list),
                                  problem.cfg.n_iters)
    f = problem.state_fields(state)
    Az = problem._Az64
    mgx = problem.mgx

    def coeffs(g):
        c = np.fft.rfft(to_numpy(g).astype(np.float64), axis=0) / mgx
        return np.einsum("nz,kz->kn", Az, c)

    cu, cw, cb = coeffs(f["u"]), coeffs(f["w"]), coeffs(f["rho"])
    ke_kx = (np.abs(cu) ** 2 + np.abs(cw) ** 2).sum(axis=1)
    be_kx = (np.abs(cb) ** 2).sum(axis=1)
    ke_tz = (np.abs(cu) ** 2 + np.abs(cw) ** 2).sum(axis=0)
    be_tz = (np.abs(cb) ** 2).sum(axis=0)
    for name, (e1, e2), xlab in (
        ("kx", (ke_kx[: problem.kxn], be_kx[: problem.kxn]), r"$k_x$"),
        ("Tz", (ke_tz, be_tz), r"$T_z$"),
    ):
        fig, a = plt.subplots(1, 2, figsize=(8, 6))
        a[0].semilogy(np.maximum(e1, 1e-300), "b.",
                      label=r"$\langle u^2+w^2\rangle$")
        a[1].semilogy(np.maximum(e2, 1e-300), "k.",
                      label=r"$\langle b^2\rangle$")
        for ax in a:
            ax.set_xlabel(xlab); ax.legend(); ax.grid(alpha=0.4)
        fig.tight_layout(pad=1, w_pad=1.5)
        p = os.path.join(out_dir, f"mixing_spectra_{name}.pdf")
        fig.savefig(p, dpi=200); plt.close(fig); paths.append(p)
    return paths


def figures_sh23(problem, x_list, out_dir: str) -> list:
    """`plot_figure_SH23_FULL.py` parity: energy-series 1x2 panel
    (`Plot_KinematicB_scalar_data` :8-64), u(x) initial/final profile
    pair (`Plot_UB_pair`), and the |u_k| spectrum panel."""
    import os

    plt = _plt()
    diag = problem.diagnostics(x_list)
    paths = []

    t = to_numpy(diag["sim_time"])
    ke = to_numpy(diag["kinetic_energy"])
    fig, a = plt.subplots(1, 2, figsize=(8, 6))
    a[0].plot(t, np.log10(np.maximum(ke, 1e-300)), "-",
              label=r"$\log_{10}\langle u^2\rangle$")
    a[1].plot(t, ke, "-.", label=r"$\langle u^2\rangle$")
    for ax in a:
        ax.set_xlabel("t"); ax.legend(); ax.grid(alpha=0.4)
    fig.tight_layout(pad=1, w_pad=1.5)
    p = os.path.join(out_dir, "sh23_energy_series.pdf")
    fig.savefig(p, dpi=200); plt.close(fig); paths.append(p)

    paths.append(plot_profile(diag, "u_final", "x_grid",
                              os.path.join(out_dir, "sh23_profiles.pdf")))
    paths.append(plot_spectrum(diag["u_hat_final"],
                               os.path.join(out_dir, "sh23_spectrum.pdf"),
                               label=r"$|\hat u_k(T)|$"))
    return paths


def figures_shb23(problem, x_list, out_dir: str) -> list:
    """`plot_figure_SHB23.py` parity: energy series, u(z) initial/final
    profiles, and the Chebyshev |u_n| spectrum (`Plot_KE` :135-176)."""
    import os

    plt = _plt()
    diag = problem.diagnostics(x_list)
    paths = [plot_energy_series(
        diag, os.path.join(out_dir, "shb23_energy_series.pdf"))]
    paths.append(plot_profile(diag, "u_final", "z_grid",
                              os.path.join(out_dir, "shb23_profiles.pdf")))
    # Chebyshev spectrum of the final state (host-side transform)
    A = to_numpy(problem.basis.analysis).astype(np.float64)
    cT = A @ to_numpy(diag["u_final"]).astype(np.float64)
    paths.append(plot_spectrum(cT, os.path.join(out_dir, "shb23_spectrum.pdf"),
                               label=r"$|\hat u_{T_n}(T)|$"))
    return paths


PROBLEM_FIGURES = {
    "sh23": figures_sh23,
    "shb23": figures_shb23,
    "kdyn": figures_kdyn,
    "mixing": figures_mixing,
}
