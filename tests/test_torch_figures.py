"""The port's figures (`spheremanopt_torch/io/figures.py`,
`optim/plotting.py`): every problem's assembly renders its panel set
(the JAX package's count) from small-config diagnostics, and the
convergence plot takes an OptimiseResult, the device loop's record or
raw lists."""

import os
import types

import numpy as np
import pytest
import torch

pytest.importorskip("matplotlib")

from spheremanopt_torch.io.figures import PROBLEM_FIGURES, plot_field2d  # noqa: E402
from spheremanopt_torch.optim.plotting import plot_optimisation  # noqa: E402

EXPECTED_PANELS = {"sh23": 3, "shb23": 3, "kdyn": 4, "mixing": 4}


def _make(name):
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo
    from spheremanopt_torch.problems.optimal_mixing import MixingConfig, OptimalMixing
    from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg
    from spheremanopt_torch.problems.swift_hohenberg_bounded import (
        SHB23Config, SwiftHohenbergBounded)

    return {
        "sh23": lambda: SwiftHohenberg(SH23Config(npts=48, n_iters=20), device="cpu"),
        "shb23": lambda: SwiftHohenbergBounded(SHB23Config(npts=48, n_iters=20),
                                               device="cpu"),
        "kdyn": lambda: KinematicDynamo(KDynConfig(npts=8, n_iters=10, dt=1e-3),
                                        device="cpu"),
        "mixing": lambda: OptimalMixing(MixingConfig(nx=16, nz=16, n_iters=10,
                                                     prep_steps=2), device="cpu"),
    }[name]()


@pytest.mark.parametrize("name", sorted(PROBLEM_FIGURES))
def test_problem_figures_render(tmp_path, name):
    p = _make(name)
    paths = PROBLEM_FIGURES[name](p, p.generate_ic(seed=7), str(tmp_path))
    assert len(paths) == EXPECTED_PANELS[name]
    for pth in paths:
        assert os.path.exists(pth) and os.path.getsize(pth) > 1000, pth


def test_convergence_plot_inputs(tmp_path):
    from spheremanopt_torch.optim.optimiser import OptimiseResult

    R = OptimiseResult(n_components=2)
    R.function_values = [0.1, 0.2, 0.3]
    R.residuals = [[1.0, 0.5, 0.1], [2.0, 0.4, 0.2]]
    rec = types.SimpleNamespace(function_values=np.array([0.1, 0.2]),
                                residuals=[np.array([1.0, 0.1])])
    for i, (res, fv) in enumerate(((R, None), (rec, None), ([[1.0, 0.5]], None),
                                   ([[1.0, 0.5]], [0.2, 0.3]))):
        path = plot_optimisation(res, fv, save_path=str(tmp_path / f"c{i}.pdf"))
        assert os.path.getsize(path) > 1000
    grid = {"f": torch.ones(4, 3), "x_grid": np.arange(4.0), "z_grid": np.arange(3.0)}
    assert os.path.getsize(plot_field2d(grid, "f", str(tmp_path / "f.pdf"))) > 1000
