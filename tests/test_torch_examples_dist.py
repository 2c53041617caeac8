"""The port's two sharded example studies on 2 gloo ranks, on the CPU in
f64: `examples/torch_kdyn_sharded_optimisation.py` (the distributed
transform, slab and pencil) and `examples/torch_mixing_sharded_optimisation.py`
(the state a DTensor through the gathering adapter).

Each runs in a local world of 2 processes (`LocalWorld`,
`torch_dist_cases.example_case`) from the x0 pinned in
`baselines/examples_port_ref.npz`, and is held against the JAX study
there (rel 1e-6 per value and step, the f64 trajectory rule) and against
the port's own one-process run of the same loop with the matmul
transform / the unsharded state (rel 1e-9: PERF.md section 2's limit for
the distributed loop; the counterpart of `tests/test_aux_io_cli.py`'s
`test_mixing_sharded_example`).
"""

import numpy as np
import pytest
import torch

from torch_dist_cases import LocalWorld, example_case

REF = np.load(__import__("pathlib").Path(__file__).resolve().parents[1]
              / "baselines" / "examples_port_ref.npz")
RTOL_PIN = 1e-6
RTOL_LOOP = 1e-9

KDYN_ARGS = ["--device", "cpu", "--npts", "8", "--steps", "20", "--iters", "3"]
MIX_ARGS = ["--device", "cpu", "--nx", "32", "--nz", "16", "--steps", "20", "--iters", "3",
            "--s", "0"]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMO_OP_CACHE", str(tmp_path_factory.mktemp("op_cache")))
        with LocalWorld(2, str(tmp_path_factory.mktemp("world2"))) as w:
            yield w


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def one_process_loop(p, fg, x0, max_iters, alpha0, aux=None):
    from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere

    opt = jit_optimise_on_multi_sphere(fg, p.inner_product, p.radii, max_iters=max_iters,
                                       alpha0=alpha0, cg=True, err_tol=1e-12,
                                       line_search="wolfe")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = opt([torch.as_tensor(x) for x in x0], aux=aux)
    finally:
        torch.set_num_threads(n)
    k = int(r.iterations)
    return (r.function_values[:k].numpy(), r.step_sizes[:k].numpy(),
            [x.numpy() for x in r.x_opt])


@pytest.fixture(scope="module")
def kdyn_reference():
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    p = KinematicDynamo(KDynConfig(npts=8, n_iters=20, dt=1e-3, dtype="float64"),
                        device="cpu")
    return one_process_loop(p, p.objective_and_gradient,
                            [REF["ks_x0_b"], REF["ks_x0_u"]], 3, 100.0)


@pytest.fixture(scope="module")
def mixing_reference(world2):
    from spheremanopt_torch.problems.optimal_mixing import MixingConfig, OptimalMixing

    p = OptimalMixing(MixingConfig(nx=32, nz=16, n_iters=20, prep_steps=5, s=0,
                                   dtype="float64"), device="cpu")
    fg, ops = p.objective_and_gradient_aux
    return one_process_loop(p, fg, [REF["ms_x0"]], 3, 10.0, aux=ops)


@pytest.fixture(scope="module")
def kdyn_runs(world2):
    x0 = [REF["ks_x0_b"], REF["ks_x0_u"]]
    return {shape: world2.run(example_case, "kdyn_sharded_optimisation",
                              KDYN_ARGS + (["--mesh-shape", shape] if shape else []), x0)
            for shape in ("", "2,1", "1,2")}


@pytest.mark.parametrize("shape", ["", "2,1", "1,2"], ids=["slab", "pencil21", "pencil12"])
def test_kdyn_sharded_against_jax_pin(kdyn_runs, shape):
    (ret, line, _), (ret1, line1, _) = kdyn_runs[shape]
    assert line == ret and line1 is None   # rank 0 prints the JSON line
    assert ret["ranks"] == 2 and ret["transform"] == "distributed"
    assert ret["memory_and_work_split"] and not ret["torchrun"]
    assert ret["local_shape"] == ([3, 6, 12, 12] if shape in ("", "2,1") else [3, 12, 6, 12])
    assert ret["iterations"] == len(REF["ks_hist"])
    assert rel(ret["J_trajectory"], REF["ks_hist"]) <= RTOL_PIN
    assert rel(ret["step_sizes"], REF["ks_steps"]) <= RTOL_PIN
    assert ret1["J_trajectory"] == ret["J_trajectory"]


@pytest.mark.parametrize("shape", ["", "2,1", "1,2"], ids=["slab", "pencil21", "pencil12"])
def test_kdyn_sharded_against_one_process_matmul(kdyn_runs, kdyn_reference, shape):
    (ret, _, x_opt), _ = kdyn_runs[shape]
    fv, steps, x_ref = kdyn_reference
    assert rel(ret["J_trajectory"], fv) <= RTOL_LOOP
    assert rel(ret["step_sizes"], steps) <= RTOL_LOOP
    for a, b in zip(x_opt, x_ref):
        assert np.max(np.abs(a - b)) <= RTOL_LOOP * np.max(np.abs(b))


@pytest.fixture(scope="module")
def mixing_runs(world2):
    return world2.run(example_case, "mixing_sharded_optimisation", MIX_ARGS, [REF["ms_x0"]])


def test_mixing_sharded_against_jax_pin(mixing_runs):
    (ret, line, _), (ret1, line1, _) = mixing_runs
    assert line == ret and line1 is None
    assert ret["ranks"] == 2 and not ret["memory_and_work_split"]
    assert ret["final_placements"] == ["S(1)"] and ret["local_shape"] == [2, 24, 24]
    assert ret["iterations"] == len(REF["ms_hist"])
    assert rel(ret["J_trajectory"], REF["ms_hist"]) <= RTOL_PIN
    assert rel(ret["step_sizes"], REF["ms_steps"]) <= RTOL_PIN
    assert ret1["J_trajectory"] == ret["J_trajectory"]


def test_mixing_sharded_against_one_process(mixing_runs, mixing_reference):
    """The adapter gathers the state: every rank computes the one-process
    values (held here at the loop's 1e-9)."""
    (ret, _, x_opt), _ = mixing_runs
    fv, steps, x_ref = mixing_reference
    assert rel(ret["J_trajectory"], fv) <= RTOL_LOOP
    assert rel(ret["step_sizes"], steps) <= RTOL_LOOP
    assert np.max(np.abs(x_opt[0] - x_ref[0])) <= RTOL_LOOP * np.max(np.abs(x_ref[0]))
