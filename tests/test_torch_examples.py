"""The port's example studies (`examples/torch_*.py`) against the JAX
package's, on the CPU in f64.

`baselines/examples_port_ref.npz` (`baselines/make_examples_port_ref.py`)
holds each JAX study at a small configuration with its x0; each port
example runs here in-process from that x0 through its `main` and is held
to it: bisection decisions and probe abscissae equal, E_c and rm_c to
1e-12, every J value of every run within rel 1e-6 per value and step (the
f64 trajectory rule, PERF.md section 2), iteration, f, g and HVP counts
equal, the regrid of JAX's coarse optimum to JAX's warm state to 1e-12
(the example's own coarse optimum and warm state to 1e-6, as the
trajectory that ends there), the port's generators from JAX's noise to
JAX's x0 to 1e-12. The last line of each
example's output must be the JSON object its `main` returns. The two
sharded examples are in `test_torch_examples_dist.py`.
"""

import contextlib
import io
import json
import pathlib

import numpy as np
import pytest
import torch

from torch_dist_cases import load_example

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = np.load(ROOT / "baselines" / "examples_port_ref.npz")
RTOL = 1e-6       # f64 trajectories, per value and step
EXACT = 1e-12     # bisection results, the regridded state


def run_example(name, argv, **kw):
    """`main(argv, **kw)` of the example with one intra-op thread (long
    loops of small ops: see `one_thread` in test_torch_sh23.py); its
    return value and the JSON object of its last output line."""
    buf = io.StringIO()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(buf):
            ret = load_example(name).main(["--device", "cpu"] + argv, **kw)
    finally:
        torch.set_num_threads(n)
    return ret, json.loads(buf.getvalue().strip().splitlines()[-1])


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want) / np.abs(want)) if want.size else 0.0
    assert err <= rtol, f"worst rel {err:.3e} > {rtol:g}: {got} vs {want}"


def unpad(row):
    return row[~np.isnan(row)]


@pytest.fixture(scope="module")
def op_cache(tmp_path_factory):
    """Mixing's operator cache in a temporary directory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMO_OP_CACHE", str(tmp_path_factory.mktemp("op_cache")))
        yield


# -- critical seed energy (SH23, bisection on E0) --------------------------


@pytest.fixture(scope="module")
def seed():
    return run_example("sh23_critical_seed", [
        "--npts", "48", "--t-final", "10", "--bisections", "3", "--max-iters", "20"],
        x0=[REF["seed_x0"]])


def test_critical_seed_decisions_and_abscissae(seed):
    ret, line = seed
    assert line == ret
    probes = ret["ends"] + ret["bisections"]
    assert [h["triggered"] for h in ret["bisections"]] == REF["seed_triggered"].tolist()
    assert [h["E0"] for h in probes] == REF["seed_e0"].tolist()
    assert ret["bracket"] == REF["seed_bracket"].tolist()


def test_critical_seed_energy(seed):
    ret, _ = seed
    assert abs(ret["critical_seed_energy"] - float(REF["seed_ec"])) <= EXACT * float(REF["seed_ec"])
    assert ret["captures"] == 0   # the CPU runs the steps eagerly


def test_critical_seed_j_values(seed):
    ret, _ = seed
    probes = ret["ends"] + ret["bisections"]
    assert [h["iterations"] for h in probes] == REF["seed_iters"].tolist()
    close([h["J_opt"] for h in probes], REF["seed_j"])
    for h, row in zip(probes, REF["seed_hist"]):
        close(h["J_history"], unpad(row))
    close(ret["j_tiny"], REF["seed_j_tiny"])
    close(ret["threshold"], REF["seed_threshold"])


# -- critical Rm (KDyn, bisection in log2 Rm over one loop) ----------------


@pytest.fixture(scope="module")
def rm():
    return run_example("kdyn_critical_rm", [
        "--npts", "8", "--steps", "50", "--iters", "3", "--bisections", "2"],
        x0=[REF["rm_x0_b"], REF["rm_x0_u"]])


def test_critical_rm_decisions_and_abscissae(rm):
    ret, line = rm
    assert line == ret
    assert [h["growth"] for h in ret["probes"]] == REF["rm_growth"].tolist()
    assert [h["rm"] for h in ret["probes"]] == REF["rm_rm"].tolist()
    assert ret["eager"] and ret["captures"] == 0


def test_critical_rm_value(rm):
    ret, _ = rm
    assert abs(ret["rm_c"] - float(REF["rm_rm_c"])) <= EXACT * float(REF["rm_rm_c"])
    close(ret["bracket"], REF["rm_bracket"], EXACT)


def test_critical_rm_j_values(rm):
    ret, _ = rm
    assert [h["iterations"] for h in ret["probes"]] == REF["rm_iters"].tolist()
    close([h["J_opt"] for h in ret["probes"]], REF["rm_j"])
    for h, row in zip(ret["probes"], REF["rm_hist"]):
        close(h["J_history"], unpad(row))


# -- L-BFGS against CG ------------------------------------------------------


LBFGS_ARGS = {"sh23": ["--npts", "48", "--steps", "50", "--max-iters", "20"],
              "kdyn": ["--npts", "8", "--steps", "20", "--max-iters", "3"]}


@pytest.fixture(scope="module")
def lbfgs():
    out = {}
    for name, argv in LBFGS_ARGS.items():
        x0 = [REF[f"lb_{name}_x{i}"] for i in range(2 if name == "kdyn" else 1)]
        out[name] = run_example("lbfgs_vs_cg", [name] + argv, x0=x0)
    return out


@pytest.mark.parametrize("problem", sorted(LBFGS_ARGS))
@pytest.mark.parametrize("direction", ["cg", "lbfgs"])
def test_lbfgs_vs_cg(lbfgs, problem, direction):
    ret, line = lbfgs[problem]
    assert line == ret and ret["dtype"] == "float64"
    run = ret[direction]
    assert run["iterations"] == int(REF[f"lb_{problem}_{direction}_iters"])
    close(run["J_history"], REF[f"lb_{problem}_{direction}_hist"])
    close(run["J_final"], REF[f"lb_{problem}_{direction}_hist"][-1])


# -- RTR against CG (host loops) -------------------------------------------


@pytest.fixture(scope="module")
def rtr():
    return run_example("rtr_newton_vs_cg", [
        "--npts", "32", "--n-iters", "50", "--max-iters", "10"], x0=[REF["rtr_x0"]])


@pytest.mark.parametrize("driver", ["cg", "rtr"])
def test_rtr_newton_vs_cg_ledger(rtr, driver):
    ret, line = rtr
    assert line == ret
    run = ret[driver]
    assert (run["iterations"], run["function_evals"], run["gradient_evals"],
            run["hvp_evals"], run["converged"]) == tuple(
        v.item() for v in (REF[f"rtr_{driver}_{k}"] for k in
                           ("iters", "f", "g", "hvp", "converged")))


@pytest.mark.parametrize("driver", ["cg", "rtr"])
def test_rtr_newton_vs_cg_histories(rtr, driver):
    ret, _ = rtr
    close(ret[driver]["J_history"], REF[f"rtr_{driver}_hist"])
    close(ret[driver]["residuals"], REF[f"rtr_{driver}_res"])
    if driver == "rtr":
        close(ret[driver]["residual_tail"], REF["rtr_rtr_res"][-4:])


# -- regrid warm start (SH23 coarse -> fine on the device loop) -------------


@pytest.fixture(scope="module")
def warm():
    out = {}
    ret = run_example("regrid_warmstart", [
        "--fine", "64", "--coarse", "32", "--n-steps", "50", "--max-iters", "20"],
        x0={"fine": [REF["ws_x0_fine"]], "coarse": [REF["ws_x0_coarse"]]}, out=out)
    return ret, out


@pytest.mark.parametrize("study", ["cold", "coarse", "warm"])
def test_regrid_warmstart_histories(warm, study):
    (ret, line), _ = warm
    assert line == ret
    want = REF[f"ws_hist_{study}"]
    assert ret[study]["iters"] == len(want)
    close(ret[study]["J_history"], want)
    if study != "coarse":
        assert ret[study]["iters_to_target"] == int(REF[f"ws_to_target_{study}"])


def test_regrid_warmstart_state(warm):
    """The coarse optimum ends a 20-iteration f64 trajectory, so it and
    its regridded state carry that trajectory's roundoff (RTOL)."""
    _, out = warm
    for key in ("x_coarse", "x_warm"):
        want = REF[f"ws_{key}"]
        assert np.max(np.abs(out[key][0] - want)) <= RTOL * np.max(np.abs(want))


def test_regrid_of_the_pinned_coarse_optimum():
    """`regrid_state` of JAX's coarse optimum is JAX's warm state."""
    from spheremanopt_torch.utils.regrid import regrid_state

    got = regrid_state(_sh23(64, n_iters=2, e0=0.0725), [REF["ws_x_coarse"]])[0]
    want = REF["ws_x_warm"]
    assert np.max(np.abs(got - want)) <= EXACT * np.max(np.abs(want))


# -- the mixing studies (host loop, f64 solves) -----------------------------


@pytest.fixture(scope="module")
def continuation(op_cache, tmp_path_factory):
    d = tmp_path_factory.mktemp("continuation")
    return run_example("mixing_regrid_continuation", [
        "--small", "--n-steps", "100", "--coarse-iters", "3", "--fine-iters", "2",
        "--out", str(d / "c.json")], x0=[REF["mc_x0"]]), d


def test_mixing_regrid_continuation(continuation):
    (ret, line), d = continuation
    assert line == ret == json.loads((d / "c.json").read_text())
    assert ret["cold_fine_reference"] is None
    c, f = ret["coarse"], ret["warm_fine"]
    assert [c["iters"], f["iters"]] == REF["mc_iters"].tolist()
    assert [c["function_evals"], f["function_evals"]] == REF["mc_f"].tolist()
    assert [c["gradient_evals"], f["gradient_evals"]] == REF["mc_g"].tolist()
    close([-v for v in c["mixnorm"]], REF["mc_fv_coarse"])
    close([-v for v in f["mixnorm"]], REF["mc_fv_fine"])
    close(f["J_start"], REF["mc_j_start"])


@pytest.fixture(scope="module")
def study512(op_cache, tmp_path_factory):
    d = tmp_path_factory.mktemp("study512")
    return run_example("mixing512_df64_study", [
        "--small", "--n-iters", "60", "--max-iters", "3", "--out", str(d / "s.npz")],
        x0=[REF["m5_x0"]]), d


def test_mixing512_df64_study(study512):
    (ret, line), d = study512
    assert line == ret
    assert (ret["iterations"], ret["function_evals"], ret["gradient_evals"]) == (
        int(REF["m5_iters"]), int(REF["m5_f"]), int(REF["m5_g"]))
    close(ret["function_values"], REF["m5_fv"])
    close(ret["step_sizes"], REF["m5_steps"])
    saved = np.load(d / "s.npz")
    assert np.array_equal(saved["function_values"], np.asarray(ret["function_values"]))


# -- the port's generators from JAX's noise give JAX's x0 -------------------


def _sh23(npts, **kw):
    from spheremanopt_torch.problems.swift_hohenberg import SH23Config, SwiftHohenberg

    return SwiftHohenberg(SH23Config(npts=npts, **kw), device="cpu")


def _kdyn(npts):
    from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    return KinematicDynamo(KDynConfig(npts=npts, n_iters=2), device="cpu")


def _mixing(nx, nz, **kw):
    from spheremanopt_torch.problems.optimal_mixing import MixingConfig, OptimalMixing

    return OptimalMixing(MixingConfig(nx=nx, nz=nz, n_iters=2, **kw), device="cpu")


NOISE_CASES = {
    "seed": lambda: (_sh23(48, n_iters=2).generate_ic(e0=1.0, noise=REF["seed_noise"]),
                     [REF["seed_x0"]]),
    "rm": lambda: (_kdyn(8).generate_ic(noise=(REF["rm_noise_b"], REF["rm_noise_u"])),
                   [REF["rm_x0_b"], REF["rm_x0_u"]]),
    "lbfgs_kdyn": lambda: (_kdyn(8).generate_ic(noise=tuple(REF["lb_kdyn_noise"])),
                           [REF["lb_kdyn_x0"], REF["lb_kdyn_x1"]]),
    "lbfgs_sh23": lambda: (_sh23(48, n_iters=2).generate_ic(noise=REF["lb_sh23_noise"]),
                           [REF["lb_sh23_x0"]]),
    "rtr": lambda: (_sh23(32, n_iters=2).generate_ic(noise=REF["rtr_noise"]),
                    [REF["rtr_x0"]]),
    "warm_fine": lambda: (_sh23(64, n_iters=2).generate_ic(noise=REF["ws_noise_fine"]),
                          [REF["ws_x0_fine"]]),
    "warm_coarse": lambda: (_sh23(32, n_iters=2).generate_ic(noise=REF["ws_noise_coarse"]),
                            [REF["ws_x0_coarse"]]),
    "continuation": lambda: (_mixing(64, 32).generate_ic(noise=REF["mc_noise"]),
                             [REF["mc_x0"]]),
    "mixing_sharded": lambda: (_mixing(32, 16, prep_steps=5, s=0).generate_ic(
        noise=REF["ms_noise"]), [REF["ms_x0"]]),
}


@pytest.mark.parametrize("case", sorted(NOISE_CASES))
def test_generators_reproduce_the_pinned_x0(case, op_cache):
    got, want = NOISE_CASES[case]()
    for g, w in zip(got, want):
        g = g.numpy()
        assert np.max(np.abs(g - w)) <= EXACT * np.max(np.abs(w))
