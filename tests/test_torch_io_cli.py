"""The port's command line with its I/O (`spheremanopt_torch/run.py`):
`run.main` in-process on the CPU at small sizes.

A host-loop run writes `summary.json`, `optimize_result.txt`,
`DAL_PROGRESS.npz` (after every iteration) and `convergence.pdf`;
`--resume` starts from the checkpoint's x_opt bitwise (the port's or the
JAX package's file); `--archive-full` alone archives every iteration, from
the run's own solves where the problem has a fused form and by a re-run
of `diagnostics` where it has none (KDyn `cuda`, df64, RTR);
`--solve-steps` restarts bitwise from `--state-in` and, from a state the
JAX package saved mid-way, matches JAX's uninterrupted advance within
1e-13; `--h5` writes the reference's files on the host and device loops;
`--regrid` continues a coarse study on a finer grid on the sphere. A
missing matplotlib costs one line naming the files; `--h5` without h5py
fails.
"""

import json
import os

import numpy as np
import pytest
import torch

from spheremanopt_torch import run
from spheremanopt_torch.io.checkpoint import load_pde_state, load_progress

SH = ["sh23", "--device", "cpu", "--npts", "32", "--n-iters", "20", "--quiet"]
SIZES = {"sh23": ["--npts", "32", "--n-iters", "20"],
         "shb23": ["--npts", "32", "--n-iters", "20"],
         "kdyn": ["--npts", "8", "--n-iters", "10", "--dt", "1e-3"],
         "mixing": ["--nx", "16", "--nz", "16", "--n-iters", "10"]}


@pytest.fixture
def one_thread():
    """Step loops of small products: one intra-op thread, so several test
    workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _main(argv, **kw):
    out = {}
    assert run.main(argv, out=out, **kw) == 0
    return out


def test_host_run_writes_its_outputs(tmp_path, one_thread):
    pytest.importorskip("matplotlib")
    d = tmp_path / "o"
    out = _main(SH + ["--max-iters", "3", "--out-dir", str(d)])
    summary = json.loads((d / "summary.json").read_text())
    assert summary["iterations"] == 3 and "archive" not in summary
    assert summary["optimise_wall_s"] > 0
    for f in ("DAL_PROGRESS.npz", "convergence.pdf", "optimize_result.txt",
              "sh23_energy_series.pdf", "sh23_profiles.pdf", "sh23_spectrum.pdf"):
        assert (d / f).exists(), f
    ck = load_progress(str(d / "DAL_PROGRESS.npz"))
    r = out["result"]
    assert ck.iterations == 3 and ck.function_values == r.function_values
    assert np.array_equal(ck.x_opt[0], r.x_opt[0].numpy())
    assert out["archiver"] is None


def test_resume_flow(tmp_path, capsys, one_thread):
    d = tmp_path / "o"
    first = _main(SH + ["--max-iters", "3", "--out-dir", str(d)])
    ck = load_progress(str(d / "DAL_PROGRESS.npz"))
    capsys.readouterr()
    second = _main(SH + ["--max-iters", "2", "--out-dir", str(tmp_path / "r"),
                         "--resume", str(d / "DAL_PROGRESS.npz")])
    assert "[resume] warm-starting from iteration 3" in capsys.readouterr().out
    assert torch.equal(second["x0"][0], torch.as_tensor(ck.x_opt[0]))
    fv = second["result"].function_values
    assert second["result"].iterations == 2
    assert min(fv) >= first["result"].function_values[-1] - 1e-14


def test_resume_from_a_jax_checkpoint(tmp_path, one_thread):
    """A `DAL_PROGRESS.npz` that the JAX package's optimiser wrote resumes
    the port's run at its x_opt, bitwise."""
    import jax.numpy as jnp

    from spheremanopt_tpu.optim.optimiser import optimise_on_multi_sphere
    from spheremanopt_tpu.problems.swift_hohenberg import SH23Config, SwiftHohenberg

    jp = SwiftHohenberg(SH23Config(npts=32, n_iters=20))
    path = str(tmp_path / "DAL_PROGRESS.npz")
    r = optimise_on_multi_sphere(jp.generate_ic(seed=4), jp.radii, jp.objective,
                                 jp.gradient, jp.inner_product, max_iters=2,
                                 alpha_k=float(np.pi), verbose=False,
                                 checkpoint_path=path)
    out = _main(SH + ["--max-iters", "1", "--out-dir", str(tmp_path / "o"),
                      "--resume", path])
    assert torch.equal(out["x0"][0], torch.as_tensor(np.array(r.x_opt[0])))
    assert isinstance(r.x_opt[0], jnp.ndarray)


@pytest.mark.parametrize("case,kind", [
    (["sh23", "--archive-full"], "FusedArchiver"),
    (["kdyn", "--archive-full", "--method", "cuda", "--dtype", "float32"],
     "IterationArchiver"),
    (["mixing", "--archive-full", "--precision", "df64", "--dtype", "float32"],
     "IterationArchiver"),
    (["sh23", "--archive-full", "--direction", "rtr"], "IterationArchiver"),
    (["shb23", "--archive-every", "2"], "LightArchiver"),
    (["sh23", "--archive-full", "--no-archive"], None),
])
def test_archive_flags(tmp_path, case, kind, one_thread):
    """`--archive-full` alone archives every iteration; the archiver is the
    JAX CLI's choice for the path; `--archive-every 2` every other;
    `--no-archive` none."""
    d = tmp_path / "o"
    name = case[0]
    out = _main([name, "--device", "cpu", "--quiet", "--max-iters", "2",
                 "--out-dir", str(d)] + SIZES[name] + case[1:])
    arch, res = out["archiver"], out["result"]
    summary = json.loads((d / "summary.json").read_text())
    if kind is None:
        assert arch is None and not list(d.glob("*_iter_*.npz"))
        return
    assert type(arch).__name__ == kind == summary["archive"]["kind"]
    every = 2 if "--archive-every" in case else 1
    want = [k for k in range(1, res.iterations + 1) if k % every == 0]
    prefix = "progress" if kind == "LightArchiver" else "diag"
    assert sorted(os.path.basename(p) for p in arch.paths) == sorted(
        f"{prefix}_iter_{k}.npz" for k in want)
    assert summary["archive"]["files"] == len(want)
    if kind == "FusedArchiver":
        assert arch.fallback_recomputes == 0
        with np.load(arch.paths[-1]) as a:
            assert np.array_equal(a["u_initial"], res.x_opt[0].numpy())


@pytest.mark.parametrize("name", ["sh23", "shb23", "kdyn", "mixing"])
def test_solve_steps_restart(tmp_path, name, capsys, one_thread):
    """4 steps, then `--state-in` for 3 more, bitwise one run of 7; and 3
    steps from the JAX package's state after 4 within 1e-13 of JAX's
    uninterrupted 7."""
    from spheremanopt_tpu.io.checkpoint import save_pde_state as j_save

    base = [name, "--device", "cpu", "--quiet", "--out-dir", str(tmp_path)] + SIZES[name]
    a, b, c = (str(tmp_path / f"{s}.npz") for s in "abc")
    _main(base + ["--solve-steps", "4", "--state-out", a])
    _main(base + ["--solve-steps", "3", "--state-in", a, "--state-out", b])
    out = _main(base + ["--solve-steps", "7", "--state-out", c])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [(ln["from_step"], ln["to_step"]) for ln in lines] == [(0, 4), (4, 7), (0, 7)]
    assert lines[1]["field_norms"] == lines[2]["field_norms"]
    sb, nb, _ = load_pde_state(b)
    sc, nc, meta = load_pde_state(c)
    assert nb == nc == 7 and str(meta["problem"]) == name
    assert all(np.array_equal(sb[k], sc[k]) for k in sc)

    # from the JAX package's mid state, against its uninterrupted advance
    jp = _jax_problem(name)
    s0 = jp.initial_state(jp.generate_ic(seed=2))
    mid = str(tmp_path / "jmid.npz")
    j_save(mid, {k: np.asarray(v) for k, v in jp.advance_state(s0, 4).items()}, 4)
    full = jp.advance_state(s0, 7)
    _main(base + ["--solve-steps", "3", "--state-in", mid, "--state-out", b])
    sb, nb, _ = load_pde_state(b)
    assert nb == 7
    for k, v in full.items():
        v = np.asarray(v)
        assert np.abs(sb[k] - v).max() <= 1e-13 * np.abs(v).max(), k
    assert out["x0"] is not None and "result" not in out


def _jax_problem(name):
    from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig, KinematicDynamo
    from spheremanopt_tpu.problems.optimal_mixing import MixingConfig, OptimalMixing
    from spheremanopt_tpu.problems.swift_hohenberg import SH23Config, SwiftHohenberg
    from spheremanopt_tpu.problems.swift_hohenberg_bounded import (
        SHB23Config, SwiftHohenbergBounded)

    return {"sh23": lambda: SwiftHohenberg(SH23Config(npts=32, n_iters=20)),
            "shb23": lambda: SwiftHohenbergBounded(SHB23Config(npts=32, n_iters=20)),
            "kdyn": lambda: KinematicDynamo(KDynConfig(npts=8, n_iters=10, dt=1e-3)),
            "mixing": lambda: OptimalMixing(MixingConfig(nx=16, nz=16, n_iters=10)),
            }[name]()


@pytest.mark.parametrize("loop", ["host", "device"])
def test_h5_exports(tmp_path, loop, one_thread):
    pytest.importorskip("h5py")
    d = tmp_path / "o"
    extra = ["--device-loop"] if loop == "device" else []
    out = _main(SH + ["--max-iters", "2", "--out-dir", str(d), "--h5"] + extra)
    for f in ("DAL_PROGRESS.h5", "scalar_data_s1.h5", "CheckPoints_s1.h5",
              "scalar_data_iter_0.h5", "CheckPoints_iter_0.h5"):
        assert (d / f).exists(), f
    assert set(out["outputs"]["h5"]) == {"dal", "scalar", "checkpoints",
                                         "scalar_iter", "checkpoints_iter"}
    import h5py

    with h5py.File(d / "DAL_PROGRESS.h5", "r") as f:
        k = int(f["Iterations"][()])
        assert k == 2 and f["Function_Value"].shape == (k,)
        assert np.array_equal(f["X_opt"][0], out["result"].x_opt[0].numpy())


def test_regrid_continues_a_coarse_study(tmp_path, capsys, one_thread):
    coarse = tmp_path / "c"
    _main(SH + ["--max-iters", "2", "--out-dir", str(coarse)])
    out = _main(["sh23", "--device", "cpu", "--npts", "48", "--n-iters", "20",
                 "--quiet", "--max-iters", "1", "--out-dir", str(tmp_path / "f"),
                 "--resume", str(coarse / "DAL_PROGRESS.npz"), "--regrid"])
    assert "[resume] regridded [(64,)] -> [(96,)]" in capsys.readouterr().out
    p, x0 = out["problem"], out["x0"]
    assert tuple(x0[0].shape) == (96,)
    assert abs(float(p.inner_product(x0[0], x0[0])) / p.radii[0] - 1.0) <= 1e-12
    with pytest.raises(SystemExit, match="--regrid requires --resume"):
        run.main(SH + ["--regrid", "--out-dir", str(tmp_path / "x")])


def test_missing_optional_packages(tmp_path, capsys, monkeypatch, one_thread):
    """Without matplotlib: one line names the files not written, and the run
    ends normally. `--h5` without h5py: ImportError, before the run."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda n, *a: None if n == "matplotlib" else real(n, *a))
    d = tmp_path / "o"
    _main(SH + ["--max-iters", "1", "--out-dir", str(d)])
    said = [ln for ln in capsys.readouterr().out.splitlines() if "not written" in ln]
    assert said == ["[sh23] not written: convergence.pdf, the sh23 figures "
                    "(matplotlib is not installed)"]
    assert not (d / "convergence.pdf").exists() and (d / "summary.json").exists()
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        run.main(SH + ["--max-iters", "1", "--h5", "--out-dir", str(tmp_path / "h")])
    assert not (tmp_path / "h").exists()
