"""Sharded state with the operators replicated: the counterparts of
`tests/test_sharded_optimise.py` for the port (`parallel/sharded.py`,
`problem.on_mesh`, DTensor state in the host and device loops), and the
sharded command line (`torchrun ... kdyn --shards 2`).

The port's side runs in local gloo worlds of 3 and 4 processes (one each
per module; the cases are in `torch_dist_cases.py`). Each case holds the
sharded run against the one-process run at the JAX test's tolerance
(rtol 1e-9 histories, 1e-12 J, 1e-8 / 1e-9 gradients, bitwise for the
two df64 cases), checks that x_opt and the gradients keep x0's
placements, and holds the one-process port against the JAX package's
result from the same numpy x0 (computed here on the CPU).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from torch_dist_cases import LocalWorld

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def op_cache(tmp_path_factory):
    """Mixing's operator cache in a temporary directory, for this process
    and the workers (spawned after it is set)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMO_OP_CACHE", str(tmp_path_factory.mktemp("op_cache")))
        yield


@pytest.fixture(scope="module")
def world4(tmp_path_factory, op_cache):
    with LocalWorld(4, str(tmp_path_factory.mktemp("world4"))) as w:
        yield w


@pytest.fixture(scope="module")
def world3(tmp_path_factory, op_cache):
    with LocalWorld(3, str(tmp_path_factory.mktemp("world3"))) as w:
        yield w


@pytest.fixture(scope="module")
def kdyn_jax():
    """The JAX package's KDyn at the port tests' size (npts 8: the
    oversampled grid mg = 12 divides 2, 3 and 4 ranks) and its x0."""
    from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    p = KinematicDynamo(KDynConfig(npts=8, n_iters=5, dt=1e-3, dtype="float64",
                                   remat=True))
    return p, [np.asarray(x) for x in p.generate_ic(seed=3)]


def _jax_loop(p, x0, aux=None, **kw):
    import jax

    from spheremanopt_tpu.optim.jit_driver import jit_optimise_on_multi_sphere

    if aux is None:
        opt = jit_optimise_on_multi_sphere(p.objective_and_gradient, p.inner_product,
                                           p.radii, **kw)
        r = opt([jax.numpy.asarray(x) for x in x0])
    else:
        fg, ops = aux
        opt = jit_optimise_on_multi_sphere(fg, p.inner_product, p.radii, **kw)
        r = opt([jax.numpy.asarray(x) for x in x0], None, ops)
    k = int(r.iterations)
    return dict(J=np.asarray(r.function_values)[:k], a=np.asarray(r.step_sizes)[:k], k=k)


def _same_history(a, b, rtol=1e-9):
    assert a["k"] == b["k"], (a["k"], b["k"])
    np.testing.assert_allclose(a["J"], b["J"], rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(a["a"], b["a"], rtol=rtol, atol=1e-12)


def _pair_checks(out, rtol=1e-9):
    """A loop run one-process and sharded (`cases._run_pair`)."""
    r1, x1, rP, xP, kept = out[:5]
    assert kept
    _same_history(rP, r1, rtol)
    for a, b in zip(xP, x1):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-10)
    return r1, rP


def test_sharded_trajectory_matches_single_device(world4, kdyn_jax):
    jp, x0 = kdyn_jax
    out = world4.run(cases.kdyn_loop, x0, "cg")
    r1, rP = _pair_checks(out[0])
    assert rP["J"][-1] > rP["J"][0]
    ips, radii = out[0][5:]
    np.testing.assert_allclose(ips, radii, rtol=1e-10)
    _same_history(r1, _jax_loop(jp, x0, max_iters=10, alpha0=0.5, cg=True,
                                err_tol=1e-12))


def test_sharded_lbfgs_trajectory_matches_single_device(world4, kdyn_jax):
    jp, x0 = kdyn_jax
    out = world4.run(cases.kdyn_loop, x0, "lbfgs")[0]
    r1, rP = _pair_checks(out)
    assert rP["J"][-1] > rP["J"][0]
    _same_history(r1, _jax_loop(jp, x0, max_iters=6, alpha0=10.0, line_search="wolfe",
                                direction="lbfgs", err_tol=1e-12))


def test_sharded_host_loop_matches_single_device(world4, kdyn_jax):
    """The host loop takes DTensor state too (Wolfe + CG, 3 iterations)."""
    _, x0 = kdyn_jax
    f1, fP, kept = world4.run(cases.kdyn_host_loop, x0)[0]
    assert kept and len(f1) == 3
    np.testing.assert_allclose(fP, f1, rtol=1e-9, atol=1e-12)


def test_sharded_gradient_matches_single_device(world4, kdyn_jax):
    jp, x0 = kdyn_jax
    J1, g1, JP, gP, kept = world4.run(cases.kdyn_gradient, x0)[0]
    assert kept
    np.testing.assert_allclose(JP, J1, rtol=1e-12)
    for a, b in zip(gP, g1):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12)
    Jj, gj = jp.objective_and_gradient(x0)
    np.testing.assert_allclose(J1, float(Jj), rtol=1e-12)
    for a, b in zip(g1, gj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-12)


@pytest.fixture(scope="module")
def mixing_jax(op_cache):
    from spheremanopt_tpu.problems.optimal_mixing import MixingConfig, OptimalMixing

    p = OptimalMixing(MixingConfig(nx=32, nz=16, n_iters=20, prep_steps=5, s=1))
    return p, [np.asarray(p.generate_ic(seed=3)[0])]


def test_sharded_mixing_trajectory_matches_single_device(world4, mixing_jax):
    jp, x0 = mixing_jax
    out = world4.run(cases.mixing_loop, x0)[0]
    r1, rP = _pair_checks(out)
    assert rP["a"][0] > 0
    ip, radii = out[5:]
    np.testing.assert_allclose(ip, radii[0], rtol=1e-10)
    _same_history(r1, _jax_loop(jp, x0, aux=jp.objective_and_gradient_aux, max_iters=5,
                                alpha0=10.0, cg=True, line_search="wolfe"))


def test_sharded_mixing_gradient_other_mesh_shapes(world3, world4, op_cache):
    """nx 20 (mgx 30), nz 16 (mgz 24): a 3-rank mesh over x (10-wide
    shards) and over the Chebyshev z axis, and a 4-rank mesh over x
    (uneven shards of 8, 8, 8, 6) and over z."""
    from spheremanopt_tpu.problems.optimal_mixing import MixingConfig, OptimalMixing

    cfg = dict(nx=20, nz=16, n_iters=10, prep_steps=3, s=1)
    jp = OptimalMixing(MixingConfig(**cfg))
    x0 = [np.asarray(jp.generate_ic(seed=7)[0])]
    fg, ops = jp.objective_and_gradient_aux
    Jj, gj = fg(ops, x0)
    for w, shapes in ((world3, {1: (2, 10, 24), 2: (2, 30, 8)}),
                      (world4, {1: (2, 8, 24), 2: (2, 30, 6)})):
        J1, g1, runs = w.run(cases.mixing_gradient_dims, x0, cfg, (1, 2))[0]
        np.testing.assert_allclose(J1, float(Jj), rtol=1e-12)
        np.testing.assert_allclose(g1, np.asarray(gj[0]), rtol=1e-8, atol=1e-12)
        for d, JP, gP, kept, local in runs:
            assert kept and local == shapes[d], (w.n, d, local)
            np.testing.assert_allclose(JP, J1, rtol=1e-12, err_msg=f"{w.n} ranks, dim {d}")
            np.testing.assert_allclose(gP, g1, rtol=1e-8, atol=1e-12,
                                       err_msg=f"{w.n} ranks, dim {d}")


def test_sharded_mixing_df64_bitwise(world4, op_cache):
    """df64 (the f32 problem's f64 solves) under sharding: J and the
    gradient bitwise the one-process values. The port's df64 is the f64
    solve, so the one-process values are held against the JAX package's
    f64 problem at the same x0 (the gradient cast to f32)."""
    from spheremanopt_tpu.problems.optimal_mixing import MixingConfig, OptimalMixing

    cfg = dict(nx=32, nz=16, n_iters=20, prep_steps=5, s=1)
    x0 = [np.asarray(OptimalMixing(MixingConfig(dtype="float32", **cfg))
                     .generate_ic(seed=3)[0])]
    J1, g1, JP, gP, kept = world4.run(cases.mixing_df64, x0)[0]
    assert kept
    assert JP == J1
    np.testing.assert_array_equal(gP, g1)
    fg, ops = OptimalMixing(MixingConfig(**cfg)).objective_and_gradient_aux
    Jj, gj = fg(ops, [x0[0].astype(np.float64)])
    np.testing.assert_allclose(J1, float(Jj), rtol=1e-6)
    np.testing.assert_allclose(g1, np.asarray(gj[0], np.float32), rtol=1e-6, atol=1e-7)


def test_sharded_kdyn_df64_bitwise(world4):
    from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    cfg = dict(npts=8, n_iters=10, dt=1e-3)
    x0 = [np.asarray(a) for a in
          KinematicDynamo(KDynConfig(dtype="float32", **cfg)).generate_ic(seed=3)]
    ops, J1, g1, JP, gP, kept = world4.run(cases.kdyn_df64, x0)[0]
    assert ops == {} and kept
    assert JP == J1
    for a, b in zip(gP, g1):
        np.testing.assert_array_equal(a, b)
    Jj, gj = KinematicDynamo(KDynConfig(dtype="float64", **cfg)).objective_and_gradient(
        [a.astype(np.float64) for a in x0])
    np.testing.assert_allclose(J1, float(Jj), rtol=1e-6)
    for a, b in zip(g1, gj):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=1e-6, atol=1e-6)


def _kdyn_nested(world, mesh_shape, npts):
    from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    jm = KinematicDynamo(KDynConfig(npts=npts, n_iters=9, dt=1e-3, dtype="float64",
                                    transform="matmul", remat=True))
    x0 = [np.asarray(x) for x in jm.generate_ic(seed=5)]
    Jm, gm, Jd, gd, same = world.run(cases.kdyn_nested_distributed, x0, npts,
                                     mesh_shape)[0]
    assert same
    np.testing.assert_allclose(Jd, Jm, rtol=1e-12)
    for a, b in zip(gd, gm):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
    Jj, gj = jm.objective_and_gradient(x0)
    np.testing.assert_allclose(Jm, float(Jj), rtol=1e-12)
    for a, b in zip(gm, gj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-12)


def test_nested_remat_composes_with_distributed_sharded_step(world4):
    """remat="nested" with the slab over 4 ranks (npts 16: mg 24)."""
    _kdyn_nested(world4, (), 16)


def test_sharded_shb23_gradient_matches_single_device(world4):
    from spheremanopt_tpu.problems.swift_hohenberg_bounded import (
        SHB23Config, SwiftHohenbergBounded)

    jp = SwiftHohenbergBounded(SHB23Config(npts=64, n_iters=40, dt=0.01))
    x0 = [np.asarray(jp.generate_ic(seed=4)[0])]
    J1, g1, JP, gP, kept = world4.run(cases.shb23_gradient, x0)[0]
    assert kept
    np.testing.assert_allclose(JP, J1, rtol=1e-12)
    np.testing.assert_allclose(gP, g1, rtol=1e-8, atol=1e-12)
    Jj, gj = jp.objective_and_gradient(x0)
    np.testing.assert_allclose(J1, float(Jj), rtol=1e-12)
    np.testing.assert_allclose(g1, np.asarray(gj[0]), rtol=1e-8, atol=1e-12)


def test_sharded_shb23_device_loop_trajectory(world4):
    from spheremanopt_tpu.problems.swift_hohenberg_bounded import (
        SHB23Config, SwiftHohenbergBounded)

    jp = SwiftHohenbergBounded(SHB23Config(npts=64, n_iters=40, dt=0.01))
    x0 = [np.asarray(jp.generate_ic(seed=4)[0])]
    r1, _ = _pair_checks(world4.run(cases.shb23_loop, x0)[0])
    _same_history(r1, _jax_loop(jp, x0, max_iters=6, alpha0=1.0, line_search="wolfe",
                                cg=True))


def test_nested_remat_composes_with_2d_pencil(world4):
    """remat="nested" with the 2 x 2 pencil (npts 16)."""
    _kdyn_nested(world4, (2, 2), 16)


def test_sharded_2d_pencil_device_loop_trajectory(world4, kdyn_jax):
    """The device loop on the 2 x 2 pencil transform reproduces the
    one-process matmul trajectory (JAX's test: rtol 1e-11)."""
    jp, x0 = kdyn_jax
    r1, r2, x2 = world4.run(cases.pencil_loop, x0)[0]
    _same_history(r2, r1, rtol=1e-11)
    _same_history(r1, _jax_loop(jp, x0, max_iters=6, alpha0=1.0, line_search="wolfe",
                                cg=True))


def test_kdyn_distributed_3_ranks(world3, kdyn_jax):
    """The slab over an odd world (3 ranks; mg 12 -> 4-wide slabs)."""
    _, x0 = kdyn_jax
    Jm, Jd, gm, gd, _ = world3.run(cases.kdyn_distributed, x0, 8, (), True)[0]
    np.testing.assert_allclose(Jd, Jm, rtol=1e-12)
    for a, b in zip(gd, gm):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


@pytest.fixture
def one_thread():
    """One intra-op thread for the in-process run: the test workers share
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_shards_two_ranks(tmp_path, one_thread):
    """`torchrun --nproc-per-node 2 -m spheremanopt_torch.run kdyn --device
    cpu --shards 2` writes summary.json once, with the J history of the
    one-process run at rtol 1e-9; --shards not equal to the world size
    exits non-zero with a message."""
    from spheremanopt_torch import run as cli

    common = ["kdyn", "--device", "cpu", "--npts", "16", "--n-iters", "5",
              "--max-iters", "2", "--quiet"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    d = tmp_path / "sharded"
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "2", "-m", "spheremanopt_torch.run",
                        *common, "--shards", "2", "--out-dir", str(d)],
                       capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    summaries = [ln for ln in r.stdout.splitlines() if ln.startswith('{"problem"')]
    assert len(summaries) == 1, r.stdout[-2000:]
    got = json.loads((d / "summary.json").read_text())
    assert got["config"]["transform"] == "distributed" and got["config"]["n_shards"] == 2
    out = {}
    assert cli.main(common + ["--out-dir", str(tmp_path / "one")], out=out) == 0
    one = json.loads((tmp_path / "one" / "summary.json").read_text())
    assert len(got["function_values"]) == len(one["function_values"]) == 2
    np.testing.assert_allclose(got["function_values"], one["function_values"], rtol=1e-9)
    # without torchrun: a one-rank group, which --shards 2 refuses
    import torch.distributed as dist

    try:
        with pytest.raises(SystemExit, match="--nproc-per-node 2"):
            cli.main(common + ["--shards", "2", "--out-dir", str(tmp_path / "bad")])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_comm_debug_counts(world4, kdyn_jax, mixing_jax):
    """CommDebugMode of one fwd+grad of each sharded problem: the sharded
    state is gathered (an all-gather per component) and nothing else; the
    distributed KDyn transform runs all_to_all transposes and all-reduces
    and gathers nothing. The counts are printed for the records."""
    from spheremanopt_tpu.problems.swift_hohenberg_bounded import (
        SHB23Config, SwiftHohenbergBounded)

    _, xk = kdyn_jax
    _, xm = mixing_jax
    xs = [np.asarray(SwiftHohenbergBounded(SHB23Config(npts=64, n_iters=40, dt=0.01))
                     .generate_ic(seed=4)[0])]
    counts = world4.run(cases.comm_counts, xk, xs, xm, 8)[0]
    print(json.dumps(counts))
    ag = "all_gather_into_tensor"
    assert counts["kdyn_matmul_sharded"] == {ag: 2}
    assert counts["shb23_sharded"] == {ag: 1}
    assert counts["mixing_sharded_x"] == {ag: 1}
    dist_ops = counts["kdyn_distributed"]
    assert ag not in dist_ops and dist_ops.get("all_to_all_single", 0) > 0


def test_sharded_loops_gather_once(world4, kdyn_jax):
    """The host and device loops take DTensor x0 by gathering it once (an
    all-gather per component, here 2) and run the one-process loop; x_opt
    comes back with x0's placements and nothing else is communicated."""
    _, xk = kdyn_jax
    counts = world4.run(cases.loop_comm_counts, xk)[0]
    print(json.dumps(counts))
    for name, (comm, iters, kept) in counts.items():
        assert comm == {"all_gather_into_tensor": 2}, (name, comm)
        assert iters > 0 and kept, (name, iters, kept)

