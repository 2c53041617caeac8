"""Progress checkpoints and PDE states of the port (`spheremanopt_torch/
io/checkpoint.py`) against the JAX package's `io/checkpoint.py`.

The files are interchangeable: the keys, dtypes and layout are the JAX
package's, so each package loads the other's `DAL_PROGRESS.npz` and PDE
state with every field equal (arrays bitwise, in their own dtype). The
host loop and host RTR write the checkpoint after every iteration (after
the callback, as in JAX), and checkpointing changes no value the
optimiser computes.
"""

import numpy as np
import pytest
import torch

from spheremanopt_torch.io import checkpoint as tck
from spheremanopt_torch.optim.optimiser import OptimiseResult
from spheremanopt_torch.optim.optimiser import optimise_on_multi_sphere as t_opt
from spheremanopt_torch.optim.rtr import optimise_rtr as t_rtr
from spheremanopt_torch.problems.pca import PCAProblem as TPCA
from spheremanopt_torch.problems.pca import random_spd_matrix
from spheremanopt_tpu.io import checkpoint as jck


def _result(dtype, n=2):
    rng = np.random.RandomState(0)
    R = OptimiseResult(n_components=n)
    R.x_opt = [torch.as_tensor(rng.randn(3, 4).astype(dtype)) for _ in range(n)]
    R.iterations, R.function_evals, R.gradient_evals = 3, 7, 5
    R.step_sizes = [0.5, 0.25, 0.125]
    R.function_values = [1.0, 1.5, 1.75]
    R.wall_times = [0.1, 0.2, 0.3]
    R.residuals = [[0.3, 0.2, 0.1 * (i + 1)] for i in range(n)]
    R.converged = True
    return R


def _same_fields(a, b):
    for k in ("n_components", "iterations", "function_evals", "gradient_evals",
              "converged"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("step_sizes", "function_values", "wall_times"):
        assert np.array_equal(np.asarray(getattr(a, k)), np.asarray(getattr(b, k))), k
    for ra, rb in zip(a.residuals, b.residuals):
        assert np.array_equal(np.asarray(ra), np.asarray(rb))
    assert len(a.x_opt) == len(b.x_opt)
    for xa, xb in zip(a.x_opt, b.x_opt):
        xa, xb = tck.to_numpy(xa), tck.to_numpy(xb)
        assert xa.dtype == xb.dtype and np.array_equal(xa, xb)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_progress_round_trip(tmp_path, dtype):
    R = _result(dtype)
    path = str(tmp_path / "DAL_PROGRESS.npz")
    tck.save_progress(path, R)
    back = tck.load_progress(path)
    assert isinstance(back, OptimiseResult)
    assert all(isinstance(x, np.ndarray) for x in back.x_opt)
    _same_fields(R, back)
    assert not (tmp_path / "DAL_PROGRESS.npz.tmp.npz").exists()   # atomic
    # no extension: the .npz is appended on save and found on load
    tck.save_progress(str(tmp_path / "p"), R)
    _same_fields(R, tck.load_progress(str(tmp_path / "p")))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_progress_files_interchange_with_jax(tmp_path, writer):
    """A JAX `save_progress` file read by the port's `load_progress`, and
    the port's read by JAX's: every field equal, the same npz keys."""
    R = _result(np.float32)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    Rj = _result(np.float32)
    Rj.x_opt = [x.numpy() for x in Rj.x_opt]
    jck.save_progress(jpath, Rj)
    tck.save_progress(tpath, R)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    if writer == "jax":
        _same_fields(R, tck.load_progress(jpath))
    else:
        _same_fields(R, jck.load_progress(tpath))


def test_pde_state_round_trip_and_interchange(tmp_path):
    rng = np.random.RandomState(1)
    state = {"b": torch.as_tensor(rng.randn(2, 4, 4, 3)),
             "u": torch.as_tensor(rng.randn(3, 6, 6, 6).astype(np.float32))}
    path = str(tmp_path / "state.npz")
    tck.save_pde_state(path, state, 17, meta={"problem": "kdyn"})
    for load in (tck.load_pde_state, jck.load_pde_state):
        s, step, meta = load(path)
        assert step == 17 and str(meta["problem"]) == "kdyn"
        for k, v in state.items():
            assert s[k].dtype == v.numpy().dtype and np.array_equal(s[k], v.numpy())
    jpath = str(tmp_path / "jstate")
    jck.save_pde_state(jpath, {k: v.numpy() for k, v in state.items()}, 3)
    s, step, _ = tck.load_pde_state(jpath)
    assert step == 3 and all(np.array_equal(s[k], state[k].numpy()) for k in state)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_progress_any_reads_h5(tmp_path, writer):
    """`load_progress_any` on a reference-format `DAL_PROGRESS.h5` (by its
    extension or its magic bytes), written by either package's shim."""
    pytest.importorskip("h5py")
    from spheremanopt_torch.io.h5compat import save_dal_progress_h5 as t_save
    from spheremanopt_tpu.io.h5compat import save_dal_progress_h5 as j_save

    R = _result(np.float64)
    path = str(tmp_path / "DAL_PROGRESS.h5")
    if writer == "jax":
        Rj = _result(np.float64)
        Rj.x_opt = [x.numpy() for x in Rj.x_opt]
        j_save(path, Rj)
    else:
        t_save(path, R)
    for p in (path, str(tmp_path / "renamed")):
        if p != path:
            (tmp_path / "renamed").write_bytes((tmp_path / "DAL_PROGRESS.h5").read_bytes())
        back = tck.load_progress_any(p)
        assert back.iterations == 3 and back.n_components == 2
        for a, b in zip(back.x_opt, R.x_opt):
            assert np.array_equal(a, b.numpy())
        assert np.array_equal(back.function_values, R.function_values)
        assert np.array_equal(np.asarray(back.residuals), np.asarray(R.residuals))
    # an npz goes to load_progress
    tck.save_progress(str(tmp_path / "x.npz"), R)
    _same_fields(R, tck.load_progress_any(str(tmp_path / "x.npz")))


@pytest.mark.parametrize("driver", ["host", "rtr"])
def test_checkpoint_written_after_every_iteration(tmp_path, driver):
    """The host loop and host RTR write `checkpoint_path` after the
    callback of every iteration (so the callback of iteration k sees k - 1
    in the file), and the run's values are bitwise those of a run without
    a checkpoint."""
    p = TPCA(random_spd_matrix(16, seed=2), device="cpu")
    x0 = [torch.as_tensor(np.random.RandomState(3).rand(16))]
    path = str(tmp_path / "DAL_PROGRESS.npz")
    seen = []

    def callback(k, result):
        seen.append(tck.load_progress(path).iterations if k > 1 else 0)

    run = t_opt if driver == "host" else t_rtr
    kw = dict(max_iters=5, verbose=False)
    if driver == "host":
        kw["alpha_k"] = 1.0
    r = run(x0, [1.0], p.objective, p.gradient, p.inner_product,
            checkpoint_path=path, callback=callback, **kw)
    plain = run(x0, [1.0], p.objective, p.gradient, p.inner_product, **kw)
    assert r.iterations == 5 and seen == [0, 1, 2, 3, 4]
    back = tck.load_progress(path)
    assert back.iterations == r.iterations == plain.iterations
    assert back.function_values == r.function_values == plain.function_values
    assert r.step_sizes == plain.step_sizes and r.residuals == plain.residuals
    assert np.array_equal(back.x_opt[0], r.x_opt[0].numpy())
    assert torch.equal(r.x_opt[0], plain.x_opt[0])
