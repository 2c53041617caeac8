"""The port's archivers and series recorders (`spheremanopt_torch/io/
timeseries.py`) against the JAX package's `io/timeseries.py`.

`FusedArchiver` archives the full diagnostics of every accepted iterate
at no extra solve: its `f`, `grad_f` and `f_and_g` are the problems'
fused forms, whose payloads are cached by the exact J, so a run calls
`diagnostics` never and misses the cache never. A miss costs a counted
recompute; a failed write is re-raised by `flush`. Its archives, and
those of `LightArchiver` and `IterationArchiver`, match the JAX
archivers' for the same x0 (SH23 `matmul`, f64, rtol 1e-12), key for
key. The card test (`requires_cuda`, `python -m pytest --noconftest -m
requires_cuda tests/test_torch_timeseries.py`; the card's machine has no
JAX, so this module imports it inside the tests that need it) shows that
on `method=cuda` the archiver adds no kernel launch: every forward is the
series kernel.
"""

import os

import numpy as np
import pytest
import torch

from spheremanopt_torch.io import timeseries as tts
from spheremanopt_torch.optim.optimiser import optimise_on_multi_sphere as t_opt

SMALL = dict(npts=32, n_iters=30)
KW = dict(max_iters=3, alpha_k=float(np.pi), line_search="wolfe", cg=True,
          verbose=False)


@pytest.fixture
def one_thread():
    """Step loops of small products: one intra-op thread, so several test
    workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sh23(**cfg):
    from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg

    return SwiftHohenberg(SH23Config(**{**SMALL, **cfg}), device="cpu")


def _problems():
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo
    from spheremanopt_torch.problems.optimal_mixing import MixingConfig, OptimalMixing
    from spheremanopt_torch.problems.swift_hohenberg_bounded import (
        SHB23Config, SwiftHohenbergBounded)

    return {
        "sh23-matmul": lambda: _sh23(method="matmul"),
        "sh23-fft": lambda: _sh23(method="fft"),
        "sh23-cuda-plain": lambda: _sh23(method="cuda", dtype="float32"),
        "shb23": lambda: SwiftHohenbergBounded(SHB23Config(npts=32, n_iters=20),
                                               device="cpu"),
        "kdyn": lambda: KinematicDynamo(KDynConfig(npts=8, n_iters=10, dt=1e-3),
                                        device="cpu"),
        "mixing": lambda: OptimalMixing(MixingConfig(nx=16, nz=16, n_iters=10,
                                                     prep_steps=2), device="cpu"),
    }


def _run(p, arch=None, **kw):
    x0 = p.generate_ic(seed=3)
    if arch is None:
        return t_opt(x0, p.radii, p.objective, p.gradient, p.inner_product,
                     f_and_g=p.objective_and_gradient, **{**KW, **kw})
    return t_opt(x0, p.radii, arch.f, arch.grad_f, p.inner_product,
                 f_and_g=arch.f_and_g, callback=arch, **{**KW, **kw})


@pytest.mark.parametrize("name", list(_problems()))
def test_fused_archiver_runs_with_no_extra_solve(tmp_path, name, one_thread):
    """No `diagnostics` call and no cache miss; one archive per iteration,
    listed once its write has landed; the run's values bitwise a run
    without the archiver (the fused forms give the plain J and
    gradient)."""
    p = _problems()[name]()
    calls = []
    diagnostics = p.diagnostics
    p.diagnostics = lambda xs: calls.append(1) or diagnostics(xs)
    arch = tts.FusedArchiver("diag", p, str(tmp_path))
    r = _run(p, arch, max_iters=2)
    arch.flush()
    plain = _run(p, max_iters=2)
    assert calls == [] and arch.fallback_recomputes == 0
    assert r.function_values == plain.function_values
    assert r.step_sizes == plain.step_sizes
    assert [os.path.basename(q) for q in arch.paths] == [
        f"diag_iter_{k}.npz" for k in range(1, r.iterations + 1)]
    with np.load(arch.paths[-1]) as d:
        series = [k for k in d.files if k.endswith("energy")]
        assert series and all(np.all(np.isfinite(d[k])) for k in series)
        assert np.array_equal(d["sim_time"].shape, d[series[0]].shape)


def test_cache_miss_is_a_counted_recompute(tmp_path):
    """An accepted J that is not in the cache (here: a resumed result)
    costs one `diagnostics` re-run, counted, and the archive is still
    written."""
    p = _sh23(method="matmul")
    arch = tts.FusedArchiver("diag", p, str(tmp_path), async_writes=False)
    r = _run(p, max_iters=1)
    arch(1, r)
    assert arch.fallback_recomputes == 1 and len(arch.paths) == 1
    with np.load(arch.paths[0]) as d:
        assert np.allclose(d["kinetic_energy"],
                           p.diagnostics(r.x_opt)["kinetic_energy"].numpy(),
                           rtol=0, atol=0)
    arch.f(r.x_opt)     # now cached under J(x_opt)
    r.function_values[-1] = -float(p.objective(r.x_opt))
    arch(2, r)
    assert arch.fallback_recomputes == 1 and len(arch.paths) == 2


def test_flush_reraises_a_failed_write(tmp_path, monkeypatch):
    p = _sh23(method="matmul")
    arch = tts.FusedArchiver("diag", p, str(tmp_path))

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tts.np, "savez", fail)
    r = _run(p, arch, max_iters=1)
    with pytest.raises(OSError, match="disk full"):
        arch.flush()
    assert arch.paths == [] and r.iterations == 1
    arch.flush()    # idempotent once drained


def test_fused_archiver_refuses_a_problem_without_fused_forms():
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    p = KinematicDynamo(KDynConfig(npts=8, n_iters=4, method="cuda", dtype="float32"),
                        device="cpu")
    assert not p.has_fused_diagnostics
    with pytest.raises(ValueError, match="IterationArchiver"):
        tts.FusedArchiver("diag", p)


def _jax_pair():
    import jax.numpy as jnp

    from spheremanopt_tpu.problems.swift_hohenberg import SH23Config, SwiftHohenberg

    jp = SwiftHohenberg(SH23Config(method="matmul", **SMALL))
    x0 = np.array(jp.generate_ic(seed=3)[0])
    return jp, [jnp.asarray(x0)], _sh23(method="matmul"), [torch.as_tensor(x0)]


def _same_archives(jpaths, tpaths, rtol=1e-12):
    assert [os.path.basename(q) for q in jpaths] == [os.path.basename(q) for q in tpaths]
    for a, b in zip(jpaths, tpaths):
        with np.load(a) as ja, np.load(b) as tb:
            assert sorted(ja.files) == sorted(tb.files), (ja.files, tb.files)
            for k in ja.files:
                x, y = ja[k], tb[k]
                assert x.shape == y.shape, k
                np.testing.assert_allclose(y, x, rtol=rtol, atol=rtol * np.abs(x).max(),
                                           err_msg=f"{os.path.basename(a)}:{k}")


@pytest.mark.parametrize("kind", ["fused", "light", "iteration"])
def test_archives_match_jax(tmp_path, kind, one_thread):
    """The same x0 through each package's archiver on SH23 `matmul` f64:
    the same files, keys and shapes, values rtol 1e-12."""
    from spheremanopt_tpu.io import timeseries as jts
    from spheremanopt_tpu.optim.optimiser import optimise_on_multi_sphere as j_opt

    jp, jx, tp, tx = _jax_pair()
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    if kind == "fused":
        ja, ta = jts.FusedArchiver("diag", jp, jd), tts.FusedArchiver("diag", tp, td)
        jf, jg, jfg = ja.f, jp.gradient, ja.f_and_g
        tf, tg, tfg = ta.f, ta.grad_f, ta.f_and_g
    else:
        if kind == "light":
            ja, ta = jts.LightArchiver("progress", jd), tts.LightArchiver("progress", td)
        else:
            ja = jts.IterationArchiver("diag", jp.diagnostics, jd)
            ta = tts.IterationArchiver("diag", tp.diagnostics, td)
        jf, jg, jfg = jp.objective, jp.gradient, jp.objective_and_gradient
        tf, tg, tfg = tp.objective, tp.gradient, tp.objective_and_gradient
    rj = j_opt(jx, jp.radii, jf, jg, jp.inner_product, f_and_g=jfg, callback=ja, **KW)
    rt = t_opt(tx, tp.radii, tf, tg, tp.inner_product, f_and_g=tfg, callback=ta, **KW)
    for a in (ja, ta):
        if hasattr(a, "flush"):
            a.flush()
    assert rj.iterations == rt.iterations == 3
    if kind == "light":
        # wall times are the runs' own; the rest must agree
        for q in ja.paths:
            with np.load(q) as d:
                np.savez(q, **{k: d[k] for k in d.files if k != "wall_times"})
        for q in ta.paths:
            with np.load(q) as d:
                assert d["wall_times"].shape == (int(d["iteration"]),)
                np.savez(q, **{k: d[k] for k in d.files if k != "wall_times"})
    _same_archives(ja.paths, ta.paths)


def test_series_and_snapshots_round_trip_and_interchange(tmp_path):
    from spheremanopt_tpu.io import timeseries as jts

    t = np.linspace(0, 1, 5)
    ke = torch.linspace(0, 2, 5, dtype=torch.float64)
    p = tts.save_scalar_series(str(tmp_path / "s"), t, kinetic_energy=ke)
    for load in (tts.load_scalar_series, jts.load_scalar_series):
        d = load(p)
        assert np.array_equal(d["sim_time"], t) and np.array_equal(d["kinetic_energy"], ke.numpy())
    grids = {"x": np.arange(4.0)}
    fields = {"u": torch.ones(2, 4)}
    q = tts.save_snapshots(str(tmp_path / "c.npz"), grids, fields)
    for load in (tts.load_snapshots, jts.load_snapshots):
        g, f = load(q)
        assert np.array_equal(g["x"], grids["x"]) and np.array_equal(f["u"], np.ones((2, 4)))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
def test_fused_archiver_on_the_kernels_adds_no_launch(tmp_path):
    """SH23 f32 `method=cuda` through `run.main`: with `--archive-full` the
    run launches the series forward as often as the plain run launches the
    plain forward, the plain forward never, the reverse as often; its J
    history is bitwise the plain run's and no archive was recomputed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from spheremanopt_torch import run
    from spheremanopt_torch.ops.cuda import fused_two_matrix as fk

    base = ["sh23", "--device", "cuda", "--dtype", "float32", "--method", "cuda",
            "--npts", "64", "--n-iters", "200", "--max-iters", "4", "--quiet"]
    counts, outs = [], []
    for extra in ([], ["--archive-full"]):
        out = {}
        fk.reset_launches()
        assert run.main(base + ["--out-dir", str(tmp_path / str(len(extra)))] + extra,
                        out=out) == 0
        torch.cuda.synchronize()
        counts.append(dict(fk.LAUNCHES))
        outs.append(out)
    plain, arch = counts
    assert plain["fused_fwd_shared_grid"] > 0 and plain["fused_fwd_shared_grid_ser"] == 0
    assert arch["fused_fwd_shared_grid"] == 0
    assert arch["fused_fwd_shared_grid_ser"] == plain["fused_fwd_shared_grid"]
    assert arch["fused_bwd_shared"] == plain["fused_bwd_shared"]
    assert outs[1]["archiver"].fallback_recomputes == 0
    assert outs[1]["result"].function_values == outs[0]["result"].function_values
