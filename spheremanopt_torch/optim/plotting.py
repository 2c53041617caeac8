"""Convergence plot: J(X_k) and each sphere's residual history on two
axes.

Port of the JAX package's `optim/plotting.py` (the reference's
`plot_optimisation`, `Sphere_Grad_Descent.py:840-882`), on an
OptimiseResult or raw residual / function-value lists. matplotlib is
optional and imported when a plot is drawn (Agg backend, headless)."""

from __future__ import annotations

from typing import Optional, Sequence


def plot_optimisation(
    residuals,
    function_values: Optional[Sequence[float]] = None,
    save_path: str = "optimisation_convergence.pdf",
    show: bool = False,
):
    """residuals: list of per-sphere residual histories (or an
    OptimiseResult, from which both series are taken)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    import numpy as np

    if hasattr(residuals, "residuals"):  # OptimiseResult
        function_values = residuals.function_values
        residuals = residuals.residuals
    if function_values is None:
        # raw-list call with no J series: plot residuals alone rather
        # than crashing on len(None)
        function_values = []

    fig, ax1 = plt.subplots(figsize=(8, 6))
    ax2 = ax1.twinx()

    x = np.arange(len(function_values))
    ax1.plot(x, function_values, color="tab:red", linewidth=3, linestyle=":")
    ax1.set_xlabel(r"Iteration $k$", fontsize=18)
    ax1.set_ylabel(r"$J_k(X_k)$", color="tab:red", fontsize=18)
    ax1.tick_params(axis="y", labelcolor="tab:red")

    styles = ["-", "-.", "--", ":"]
    for i, r in enumerate(residuals):
        ax2.semilogy(
            np.arange(len(r)), r, linewidth=2,
            linestyle=styles[i % len(styles)], color="tab:blue",
            label=rf"$r_k$ sphere {i}",
        )
    ax2.set_ylabel(r"$r_k$", color="tab:blue", fontsize=18)
    ax2.tick_params(axis="y", labelcolor="tab:blue")
    ax2.legend(fontsize=12)

    ax1.grid(True, alpha=0.4)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=200)
    if show:  # pragma: no cover
        plt.show()
    plt.close(fig)
    return save_path
