"""The port's h5 exports (`spheremanopt_torch/io/h5compat.py`,
`io/dedalus_export.py`) against the JAX package's.

For SH23, SHB23, KDyn and mixing at one x0 (f64), both packages' exports
of their own diagnostics hold the same datasets (names, including the
reference's double space in mixing's "Kinetic  energy", and shapes) with
values within 1e-12; `--resume` reads a reference-format
`DAL_PROGRESS.h5`, flat vectors and ragged components included.
"""

import types

import numpy as np
import pytest
import torch

h5py = pytest.importorskip("h5py")

from spheremanopt_torch import run  # noqa: E402
from spheremanopt_torch.io import dedalus_export as tde  # noqa: E402
from spheremanopt_torch.io import h5compat as th5  # noqa: E402
from spheremanopt_tpu.io import dedalus_export as jde  # noqa: E402
from spheremanopt_tpu.io import h5compat as jh5  # noqa: E402

from test_torch_regrid import _pair  # noqa: E402


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _record(xs, n_iters=3):
    return types.SimpleNamespace(
        iterations=n_iters, x_opt=xs, n_components=len(xs), function_evals=5,
        gradient_evals=4, residuals=[np.linspace(1, 0.1, n_iters)] * len(xs),
        step_sizes=np.full(n_iters, 0.5), function_values=np.linspace(0, 1, n_iters))


@pytest.mark.parametrize("name", ["sh23", "shb23", "kdyn", "mixing"])
def test_exports_match_jax(tmp_path, name):
    jp, tp = _pair(name, True)
    x = [np.array(v, np.float64) for v in jp.generate_ic(seed=3)]
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir(), tdir.mkdir()
    rj = _record([v.copy() for v in x])
    rt = _record([torch.as_tensor(v) for v in x])
    jd, td = jp.diagnostics(x), tp.diagnostics(rt.x_opt)
    jpaths = jh5.export_run_h5(str(jdir), name, rj, jd)
    jpaths.update(jde.export_dedalus_h5(str(jdir), name, jp, rj, jd))
    tpaths = th5.export_run_h5(str(tdir), name, rt, td)
    tpaths.update(tde.export_dedalus_h5(str(tdir), name, tp, rt, td))
    assert sorted(jpaths) == sorted(tpaths)
    assert {"dal", "scalar", "scalar_iter", "checkpoints_iter"} <= set(tpaths)
    for kind in jpaths:
        a, b = _datasets(jpaths[kind]), _datasets(tpaths[kind])
        assert sorted(a) == sorted(b), (kind, sorted(a), sorted(b))
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.shape == y.shape, (kind, k)
            if x.size:
                scale = max(np.abs(x).max(), 1e-300)
                assert np.abs(y - x).max() <= 1e-12 * scale, (kind, k)
    if name == "mixing":
        assert "tasks/Kinetic  energy" in _datasets(tpaths["scalar"])


def test_h5_needs_h5py(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        th5.save_dal_progress_h5("never.h5", _record([np.ones(3)]))


def _write_reference(path, xs, flat=True):
    """A `DAL_PROGRESS.h5` as the reference writes it (`vars(R)`, X_opt the
    flat `Field_to_Vec` vectors, stacked; or one dataset per component
    when they are ragged)."""
    with h5py.File(path, "w") as f:
        f["N"], f["Iterations"] = len(xs), 4
        f["Function_Evals"], f["Gradient_Evals"] = 9, 6
        f["Residual"] = np.full((len(xs), 4), 0.1)
        f["Step_Size"] = np.full(4, 0.5)
        f["Function_Value"] = np.linspace(0.1, 0.4, 4)
        vs = [np.asarray(x).ravel() if flat else np.asarray(x) for x in xs]
        if len({v.shape for v in vs}) == 1:
            f["X_opt"] = np.stack(vs)
        else:
            for i, v in enumerate(vs):
                f[f"X_opt_{i}"] = v


@pytest.mark.parametrize("name", ["sh23", "kdyn"])
def test_resume_from_reference_dal_progress(tmp_path, name):
    """`run.main --resume DAL_PROGRESS.h5`: the flat vectors shaped to the
    problem's layout; x0 is the file's state, bitwise."""
    jp, tp = _pair(name, True)
    x = [np.array(v, np.float64) for v in jp.generate_ic(seed=5)]
    path = str(tmp_path / "DAL_PROGRESS.h5")
    _write_reference(path, x)
    args = (["sh23", "--npts", "32"] if name == "sh23"
            else ["kdyn", "--npts", "8", "--dt", "1e-3"])
    out = {}
    assert run.main(args + ["--n-iters", "2" if name == "kdyn" else "4",
                            "--device", "cpu", "--max-iters", "1", "--quiet",
                            "--out-dir", str(tmp_path / "o"), "--resume", path],
                    out=out) == 0
    for a, b in zip(out["x0"], x):
        assert torch.equal(a, torch.as_tensor(b))


def test_resume_ragged_components(tmp_path):
    """Ragged components (one dataset each) load in order, and a resume
    at another KDyn resolution (`--regrid`) lands on both spheres."""
    from spheremanopt_torch.io.checkpoint import load_progress_any

    xs = [np.arange(3 * 6 ** 3, dtype=np.float64), np.ones((3, 4, 4, 4))]
    path = str(tmp_path / "DAL_PROGRESS.h5")
    _write_reference(path, xs, flat=False)
    R = load_progress_any(path)
    assert R.iterations == 4 and [x.shape for x in R.x_opt] == [(648,), (3, 4, 4, 4)]
    assert np.array_equal(R.x_opt[0], xs[0]) and np.array_equal(R.x_opt[1], xs[1])
    # a port-written ragged file reads back the same way
    th5.save_dal_progress_h5(str(tmp_path / "own.h5"), _record(xs, 4))
    R2 = load_progress_any(str(tmp_path / "own.h5"))
    assert all(np.array_equal(a, b) for a, b in zip(R2.x_opt, xs))
    jp, tp = _pair("kdyn", True)
    x = [np.array(v, np.float64) for v in jp.generate_ic(seed=5)]
    src = [np.array(_pair("kdyn", False)[0].generate_ic(seed=5)[i]) for i in range(2)]
    _write_reference(path, [src[0], src[1][:, ::2, ::2, ::2]], flat=False)
    out = {}
    assert run.main(["kdyn", "--npts", "8", "--dt", "1e-3", "--n-iters", "2",
                     "--device", "cpu", "--max-iters", "1", "--quiet", "--out-dir",
                     str(tmp_path / "o"), "--resume", path, "--regrid"], out=out) == 0
    p = out["problem"]
    assert [tuple(v.shape) for v in out["x0"]] == [v.shape for v in x]
    for v, r in zip(out["x0"], p.radii):
        assert abs(float(p.inner_product(v, v)) / r - 1.0) <= 1e-12
