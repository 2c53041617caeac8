"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its chip smoke test has no CPU path."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "spheremanopt_torch"

_BLOCK_JAX = "import sys; sys.modules['jax'] = None; "


def _python(code, cwd=ROOT, timeout=120):
    # one intra-op thread: the test workers share the host's cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_without_jax():
    code = _BLOCK_JAX + (
        "import spheremanopt_torch, spheremanopt_torch.run, "
        "spheremanopt_torch.convert, spheremanopt_torch.problems.pca, "
        "spheremanopt_torch.serve; "
        "from spheremanopt_torch.problems.swift_hohenberg import SwiftHohenberg, SH23Config; "
        "from spheremanopt_torch.ops.cuda import build, fused_two_matrix; "
        "from spheremanopt_torch.ops import chebyshev; "
        "from spheremanopt_torch.problems.swift_hohenberg_bounded import "
        "SwiftHohenbergBounded, SHB23Config; "
        "p = SwiftHohenberg(SH23Config(npts=16, n_iters=3, method='cuda', dtype='float32'), device='cpu'); "
        "p.objective_and_gradient(p.generate_ic()); "
        "p.objective_gradient_and_diagnostics(p.generate_ic()); "
        "q = SwiftHohenbergBounded(SHB23Config(npts=16, n_iters=3, method='cuda', dtype='float32'), device='cpu'); "
        "q.objective_gradient_and_diagnostics(q.generate_ic()); "
        "chebyshev.cheb_to_coeff_fft(q.generate_ic()[0]); "
        "from spheremanopt_torch.utils import opcache; "
        "from spheremanopt_torch.problems.optimal_mixing import OptimalMixing, MixingConfig; "
        "m = OptimalMixing(MixingConfig(nx=8, nz=8, n_iters=2, prep_steps=2), device='cpu'); "
        "m.objective_and_gradient(m.generate_ic()); "
        "assert not any(m.startswith(('jax', 'spheremanopt_tpu')) "
        "for m, v in sys.modules.items() if v is not None), 'JAX imported'; "
        "print('isolated')")
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert "isolated" in r.stdout


def test_server_answers_optimise_and_sweep_without_jax():
    """The port's server (`spheremanopt_torch.serve`) and the sweeps over
    rows it runs, with JAX blocked."""
    code = _BLOCK_JAX + (
        "from spheremanopt_torch.serve import OptimisationService; "
        "s = OptimisationService(device='cpu'); "
        "cfg = dict(npts=16, n_iters=4); drv = dict(max_iters=2, line_search='wolfe'); "
        "a = s.handle(dict(cmd='optimise', problem='sh23', config=cfg, driver=drv)); "
        "b = s.handle(dict(cmd='sweep', problem='sh23', config=cfg, driver=drv, "
        "seeds=[1, 2], e0=[0.05, 0.1])); "
        "assert a['ok'] and b['ok'] and len(b['points']) == 2, (a, b); "
        "assert not any(m.startswith(('jax', 'spheremanopt_tpu')) "
        "for m, v in sys.modules.items() if v is not None), 'JAX imported'; "
        "print('isolated')")
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert "isolated" in r.stdout


def test_profiling_doctor_and_sharding_run_without_jax():
    """utils/profiling.py, utils/doctor.py, parallel/mesh.py,
    parallel/fft.py and parallel/sharded.py, with JAX blocked: a one-rank
    gloo group, KDyn's distributed transform against the matmul one, and
    a DTensor state through `on_mesh`."""
    code = _BLOCK_JAX + (
        "import torch; "
        "from spheremanopt_torch.utils import profiling, doctor; "
        "from spheremanopt_torch.parallel import mesh, fft, sharded; "
        "assert profiling.bound_ms(*profiling.sh23_cost_model(16, 4))[0] > 0; "
        "assert doctor._gpu_probe_ok({'ok': True, 'out': 'cuda|H|1|1|16384.0'}); "
        "mesh.init_distributed('cpu'); m = mesh.make_mesh(); "
        "from spheremanopt_torch.problems.kinematic_dynamo import KinematicDynamo, "
        "KDynConfig; "
        "cfg = dict(npts=8, n_iters=2, dt=1e-3); "
        "pm = KinematicDynamo(KDynConfig(**cfg), device='cpu'); "
        "pd = KinematicDynamo(KDynConfig(transform='distributed', **cfg), device='cpu'); "
        "x = pm.generate_ic(); "
        "a = float(pm.objective(x)); b = float(pd.objective(pd.shard_state(x))); "
        "assert abs(a - b) < 1e-12 * abs(a), (a, b); "
        "xs = mesh.shard_fields(m, x, 1); "
        "J, g = pm.on_mesh(m).objective_and_gradient(xs); "
        "assert float(J) == a and type(g[0]).__name__ == 'DTensor'; "
        "assert not any(m.startswith(('jax', 'spheremanopt_tpu')) "
        "for m, v in sys.modules.items() if v is not None), 'JAX imported'; "
        "print('isolated')")
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert "isolated" in r.stdout


def test_kdyn_rest_and_df64_run_without_jax():
    """The continuous adjoint, the nested and offload remat modes, the Rm
    route and the df64 modes of KDyn and mixing, with JAX blocked."""
    code = _BLOCK_JAX + (
        "import torch; "
        "from spheremanopt_torch.solvers.scan_utils import nested_checkpoint_scan, "
        "offload_checkpoint; "
        "from spheremanopt_torch.problems.kinematic_dynamo import KinematicDynamo, "
        "KDynConfig; "
        "from spheremanopt_torch.problems.optimal_mixing import OptimalMixing, "
        "MixingConfig; "
        "kw = dict(npts=8, n_iters=4, dt=1e-3); "
        "x = KinematicDynamo(KDynConfig(**kw), device='cpu').generate_ic(); "
        "d = KinematicDynamo(KDynConfig(adjoint='continuous', **kw), "
        "device='cpu').adjoint_diagnostics(x); "
        "assert d['max_flux_G'].max() == 0.0; "
        "[KinematicDynamo(KDynConfig(remat=r, **kw), device='cpu')"
        ".objective_and_gradient(x) for r in ('nested', 'offload')]; "
        "p = KinematicDynamo(KDynConfig(**kw), device='cpu'); "
        "fg, make_ops = p.objective_and_gradient_rm; fg(make_ops(2.0), x); "
        "q = KinematicDynamo(KDynConfig(dtype='float32', solve_precision='df64', "
        "**kw), device='cpu'); "
        "x32 = [a.float() for a in x]; assert isinstance(q.objective_f64(x32), float); "
        "assert q.gradient(x32)[0].dtype == torch.float32; "
        "m = OptimalMixing(MixingConfig(nx=8, nz=8, n_iters=2, prep_steps=2, "
        "dtype='float32', solve_precision='df64'), device='cpu'); "
        "J, g = m.objective_and_gradient(m.generate_ic()); "
        "assert isinstance(J, float) and g[0].dtype == torch.float32; "
        "assert not any(m.startswith(('jax', 'spheremanopt_tpu')) "
        "for m, v in sys.modules.items() if v is not None), 'JAX imported'; "
        "print('isolated')")
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert "isolated" in r.stdout


def test_io_and_resume_run_without_jax(tmp_path):
    """The I/O modules, regrid and the plotting module import with JAX
    blocked, and `run.main` archives (`--archive-full`), checkpoints and
    resumes on the CPU."""
    out = str(tmp_path)
    code = _BLOCK_JAX + (
        "import spheremanopt_torch.io.checkpoint, spheremanopt_torch.io.timeseries, "
        "spheremanopt_torch.io.h5compat, spheremanopt_torch.io.dedalus_export, "
        "spheremanopt_torch.io.figures, spheremanopt_torch.io.native_io, "
        "spheremanopt_torch.utils.regrid, spheremanopt_torch.optim.plotting; "
        "from spheremanopt_torch import run; "
        "base = ['sh23', '--device', 'cpu', '--npts', '16', '--n-iters', '4', "
        f"'--quiet', '--max-iters', '2', '--out-dir', {out!r}]; "
        "o = {}; assert run.main(base + ['--archive-full'], out=o) == 0; "
        "assert type(o['archiver']).__name__ == 'FusedArchiver' and o['archiver'].paths; "
        f"assert run.main(base + ['--resume', {out!r} + '/DAL_PROGRESS.npz']) == 0; "
        "assert not any(m.startswith(('jax', 'spheremanopt_tpu')) "
        "for m, v in sys.modules.items() if v is not None), 'JAX imported'; "
        "print('isolated')")
    r = _python(code)
    assert r.returncode == 0, r.stderr
    assert "isolated" in r.stdout and "[resume] warm-starting from iteration" in r.stdout


@pytest.mark.parametrize("pattern", ["import jax", "from jax", "spheremanopt_tpu"])
def test_no_package_file_names_jax(pattern):
    files = (sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu"))
             + sorted(PKG.rglob("*.cpp")))
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files if pattern in f.read_text()]
    assert not offenders, f"{pattern!r} in {offenders}"


def test_chip_smoke_imports_no_jax_and_refuses_without_cuda():
    """chip_smoke.py on a machine without CUDA: no JAX needed to import
    it, a non-zero exit, and no result line."""
    code = _BLOCK_JAX + (
        "import runpy; sys.argv = ['chip_smoke.py']; "
        "runpy.run_path('chip_smoke.py', run_name='__main__')")
    r = _python(code)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied out of the repository, the script cannot run the port."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=""), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


# every examples/torch_*.py at a tiny config on the CPU: (argv, environment)
EXAMPLES = {
    "sh23_batch_sweep": (["2"], {"SMO_SWEEP_TINY": "1"}),
    "mixing_e0_sweep": (["2"], {"SMO_SWEEP_TINY": "1"}),
    "sh23_critical_seed": (["--npts", "48", "--t-final", "10", "--bisections", "1",
                            "--max-iters", "10"], {}),
    "kdyn_critical_rm": (["--npts", "8", "--steps", "50", "--iters", "2",
                          "--bisections", "1"], {}),
    "lbfgs_vs_cg": (["kdyn", "--npts", "8", "--steps", "10", "--max-iters", "2"], {}),
    "rtr_newton_vs_cg": (["--npts", "16", "--n-iters", "10", "--max-iters", "2"], {}),
    "regrid_warmstart": (["--fine", "32", "--coarse", "16", "--n-steps", "10",
                          "--max-iters", "3"], {}),
    "mixing_regrid_continuation": (["--small", "--n-steps", "10", "--coarse-iters", "1",
                                    "--fine-iters", "1", "--out", "{tmp}/c.json"], {}),
    "mixing512_df64_study": (["--small", "--n-iters", "10", "--max-iters", "1",
                              "--out", "{tmp}/s.npz"], {}),
    "kdyn_sharded_optimisation": (["--npts", "8", "--steps", "5", "--iters", "2"], {}),
    "mixing_sharded_optimisation": (["--nx", "16", "--nz", "8", "--steps", "5",
                                     "--iters", "2"], {}),
}


def test_every_torch_example_is_listed():
    assert sorted(p.stem[len("torch_"):] for p in (ROOT / "examples").glob("torch_*.py")) \
        == sorted(EXAMPLES)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_without_jax(name, tmp_path):
    """The example at a tiny config on `--device cpu` with JAX blocked:
    it finishes, imports neither JAX nor the JAX package, and (the eleven
    that print one) ends its output with a JSON object."""
    argv, env = EXAMPLES[name]
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv] + ["--device", "cpu"]
    code = _BLOCK_JAX + (
        "import runpy; "
        f"sys.argv = ['torch_{name}.py'] + {argv!r}; "
        f"runpy.run_path('examples/torch_{name}.py', run_name='__main__'); "
        "assert not any(m.startswith(('jax', 'spheremanopt_tpu')) "
        "for m, v in sys.modules.items() if v is not None), 'JAX imported'; "
        "print('isolated')")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                                SMO_OP_CACHE=str(tmp_path / "op_cache"), **env))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "isolated"
    if name not in ("sh23_batch_sweep", "mixing_e0_sweep"):   # PR 14's print tables
        import json

        assert isinstance(json.loads(lines[-2]), dict)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_refuses_cuda_without_a_gpu(name):
    """`--device cuda` (the default) without a GPU exits non-zero with the
    "no CUDA GPU" message, and never falls back to the CPU."""
    import torch

    from torch_dist_cases import load_example

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    argv, _ = EXAMPLES[name]
    with pytest.raises(SystemExit) as e:
        load_example(name).main([a for a in argv if "{tmp}" not in a and a != "--out"] + ["--device", "cuda"])
    assert isinstance(e.value.code, str) and "no CUDA GPU" in e.value.code
