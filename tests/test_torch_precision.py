"""df64 (solve_precision="df64") of the port's KDyn and mixing: an f32
problem whose solves and reverse sweeps run in float64, against the JAX
package's exact f64 run live on the CPU at small sizes (KDyn 8^3 modes,
20 steps; mixing 32 x 16 modes, 30 steps, as the JAX package's df64
tests), on the same numpy inputs (the JAX package's f32 initial
condition). Tolerances:

  * `objective_f64` against JAX's f64 J rel 1e-12;
  * the gradient equal to the port's f64-config gradient cast to f32,
    and within rel 1e-6 of JAX's f64 gradient (f32 output rounding);
  * the JAX df64 tests' structure: the fused form's J is
    `objective_f64`'s and its gradient `gradient`'s; the f32 `objective`
    is that J rounded to f32; the aux form's J within 2e-7 of it; the
    device loop's values within 2e-6 of the host loop's (J at f64);
    Taylor orders above 1.7.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch import run as cli
from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
from spheremanopt_torch.optim.optimiser import optimise_on_multi_sphere
from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig as TKConfig
from spheremanopt_torch.problems.kinematic_dynamo import KinematicDynamo as TKDyn
from spheremanopt_torch.problems.optimal_mixing import MixingConfig as TMConfig
from spheremanopt_torch.problems.optimal_mixing import OptimalMixing as TMixing
from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig as JKConfig
from spheremanopt_tpu.problems.kinematic_dynamo import KinematicDynamo as JKDyn
from spheremanopt_tpu.problems.optimal_mixing import MixingConfig as JMConfig
from spheremanopt_tpu.problems.optimal_mixing import OptimalMixing as JMixing

KW_K = dict(npts=8, n_iters=20, dt=1e-3, rm=1.0)
KW_M = dict(nx=32, nz=16, n_iters=30, dt=5e-3, prep_steps=10)
DF = dict(dtype="float32", solve_precision="df64")


@pytest.fixture(scope="module", autouse=True)
def op_cache(tmp_path_factory):
    """Both packages' mixing operator caches in a directory of this
    module's own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMO_OP_CACHE", str(tmp_path_factory.mktemp("op_cache")))
        yield


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_g(g, g64):
    num = sum(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b)) ** 2
              for a, b in zip(g, g64))
    den = sum(np.linalg.norm(np.asarray(b)) ** 2 for b in g64)
    return float((num / den) ** 0.5)


def _tk(**kw):
    return TKDyn(TKConfig(**{**KW_K, **kw}), device="cpu")


def _tm(**kw):
    return TMixing(TMConfig(**{**KW_M, **kw}), device="cpu")


@pytest.fixture(scope="module")
def kdyn_truth():
    """(x32, {cost: (J64, g64)}) of the JAX package's f64 problem at the
    exact f32 point."""
    p64 = JKDyn(JKConfig(dtype="float64", **KW_K))
    x32 = [np.asarray(a).astype(np.float32) for a in p64.generate_ic(seed=3)]
    out = {}
    for cost in ("Final", "Integrated"):
        p = JKDyn(JKConfig(dtype="float64", cost=cost, **KW_K))
        xe = [jnp.asarray(a.astype(np.float64)) for a in x32]
        out[cost] = (float(p.objective(xe)), [np.asarray(v) for v in p.gradient(xe)])
    return x32, out


@pytest.fixture(scope="module")
def mix_truth():
    out = {}
    x32 = None
    for s in (1, 0):
        p64 = JMixing(JMConfig(dtype="float64", s=s, **KW_M))
        if x32 is None:
            x32 = np.asarray(p64.generate_ic(seed=3)[0]).astype(np.float32)
        xe = [jnp.asarray(x32.astype(np.float64))]
        out[s] = (float(p64.objective(xe)), [np.asarray(p64.gradient(xe)[0])])
    return x32, out


def _xs(x32):
    return [torch.as_tensor(a) for a in x32]


# ---------------------------------------------------------------------------
# KDyn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("df_adjoint", [False, True])
@pytest.mark.parametrize("cost", ["Final", "Integrated"])
def test_kdyn_df64_matches_jax_f64(cost, df_adjoint, kdyn_truth, one_thread):
    x32, truth = kdyn_truth
    J64, g64 = truth[cost]
    p = _tk(cost=cost, df_adjoint=df_adjoint, **DF)
    x = _xs(x32)
    J = p.objective_f64(x)
    g = p.gradient(x)
    assert isinstance(J, float) and abs(J - J64) / abs(J64) < 1e-12
    assert all(a.dtype == torch.float32 for a in g)
    g_port64 = _tk(cost=cost).gradient([a.double() for a in x])
    assert all(torch.equal(a, b.float()) for a, b in zip(g, g_port64))
    assert _rel_g(g, g64) < 1e-6


def test_kdyn_df64_fused_aux_and_objective_forms(kdyn_truth):
    x = _xs(kdyn_truth[0])
    p = _tk(**DF)
    J1 = p.objective_f64(x)
    g1 = p.gradient(x)
    J2, g2 = p.objective_and_gradient(x)
    assert isinstance(J2, float) and J2 == J1
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    Jf = p.objective(x)
    assert Jf.dtype == torch.float32 and Jf.dim() == 0
    assert float(np.float32(J2)) == float(Jf)
    fg, ops = p.objective_and_gradient_aux
    assert ops == {}
    J3, g3 = fg(ops, x)
    assert J3.dtype == torch.float32 and J3.dim() == 0
    assert abs(float(J3) - J2) <= 2e-7 * abs(J2)
    assert all(torch.equal(a, b) for a, b in zip(g3, g2))
    assert torch.equal(p.objective_ops(ops, x), Jf)
    assert all(torch.equal(a, b) for a, b in zip(p.gradient_ops(ops, x), g2))
    # native configs keep the no-operand contract
    assert _tk(dtype="float32").objective_and_gradient_aux == (None, None)
    with pytest.raises(RuntimeError, match="df64"):
        _tk(dtype="float32").objective_f64(x)


def test_kdyn_df64_device_loop_matches_host_loop(kdyn_truth, one_thread):
    """The device loop on the aux form (an f32 J beside the f32 search
    state) against the host loop comparing J at f64."""
    x = _xs(kdyn_truth[0])
    p = _tk(**DF)
    fg, ops = p.objective_and_gradient_aux
    rd = jit_optimise_on_multi_sphere(fg, p.inner_product, p.radii, max_iters=3,
                                      alpha0=10.0, cg=True, line_search="wolfe")(x, aux=ops)
    rh = optimise_on_multi_sphere(x, p.radii, p.objective_f64, p.gradient,
                                  p.inner_product, max_iters=3, alpha_k=10.0,
                                  line_search="wolfe", cg=True,
                                  f_and_g=p.objective_and_gradient, verbose=False)
    k = int(rd.iterations)
    assert rd.function_values.dtype == torch.float32
    assert k == rh.iterations == 3
    np.testing.assert_allclose(rd.function_values[:k].double().numpy(),
                               np.asarray(rh.function_values), rtol=2e-6)


def test_kdyn_df64_taylor_second_order(kdyn_truth):
    """Taylor remainders of the df64 gradient against J at f64, along a
    solenoidal direction (the gradient is Leray-projected)."""
    x32 = kdyn_truth[0]
    p = _tk(**DF)
    x = _xs(x32)
    J0 = p.objective_f64(x)
    g = p.gradient(x)
    d = [a.numpy() for a in p.generate_ic(seed=11)]
    w = 1.0 / p.mg ** 3
    slope = sum(float(np.sum(gi.double().numpy() * di.astype(np.float64))) * w
                for gi, di in zip(g, d))
    rems = []
    for eps in (1e-1, 5e-2, 2.5e-2):
        J1 = p.objective_f64([torch.as_tensor(a + eps * v) for a, v in zip(x32, d)])
        rems.append(abs(J1 - J0 - eps * slope))
    orders = [np.log(rems[i] / rems[i + 1]) / np.log(2.0) for i in range(2)]
    assert all(o > 1.7 for o in orders), (rems, orders)


def test_kdyn_df64_config_validation():
    for kw in (dict(adjoint="continuous"), dict(transform="fft"),
               dict(method="cuda"), dict(remat="nested"), dict(remat="offload")):
        with pytest.raises(ValueError, match="df64"):
            _tk(**DF, **kw)
    for remat in (True, "step", False):
        assert _tk(remat=remat, **DF)._df is not None
    # under dtype=float64 df64 is a no-op (f64 is exact)
    p = _tk(dtype="float64", solve_precision="df64")
    assert p._df is None
    with pytest.raises(ValueError, match="solve_precision"):
        _tk(dtype="float32", solve_precision="compensated")


# ---------------------------------------------------------------------------
# mixing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,df_adjoint", [(1, False), (1, True), (0, False)])
def test_mixing_df64_matches_jax_f64(s, df_adjoint, mix_truth, one_thread):
    x32, truth = mix_truth
    J64, g64 = truth[s]
    p = _tm(s=s, df_adjoint=df_adjoint, **DF)
    x = [torch.as_tensor(x32)]
    J = p.objective_f64(x)
    g = p.gradient(x)
    assert isinstance(J, float) and abs(J - J64) / abs(J64) < 1e-12
    assert g[0].dtype == torch.float32 and g[0].shape == x32.shape
    assert torch.equal(g[0], _tm(s=s).gradient([x[0].double()])[0].float())
    assert _rel_g(g, g64) < 1e-6


def test_mixing_df64_fused_aux_and_objective_forms(mix_truth, one_thread):
    x = [torch.as_tensor(mix_truth[0])]
    p = _tm(**DF)
    J1, g1 = p.objective_f64(x), p.gradient(x)
    J2, g2 = p.objective_and_gradient(x)
    assert isinstance(J2, float) and J2 == J1 and torch.equal(g1[0], g2[0])
    assert float(np.float32(J2)) == float(p.objective(x))
    fn, ops = p.objective_and_gradient_aux
    assert ops["S"].dtype == torch.complex128     # the f64 twin's stacks
    J3, g3 = fn(ops, x)
    assert J3.dtype == torch.float32 and abs(float(J3) - J2) <= 2e-7 * abs(J2)
    assert torch.equal(g3[0], g2[0])
    assert torch.equal(p.objective_ops(ops, x), p.objective(x))
    assert torch.equal(p.gradient_ops(ops, x)[0], g2[0])
    # the other paths stay on the f32 solve
    Jd, diag = p.objective_and_diagnostics(x)
    assert Jd.dtype == torch.float32 and diag["kinetic_energy"].dtype == torch.float32
    assert p.generate_ic(seed=1)[0].dtype == torch.float32
    with pytest.raises(RuntimeError, match="df64"):
        _tm(dtype="float32").objective_f64(x)


def test_mixing_df64_device_loop_matches_host_loop(mix_truth, one_thread):
    x = [torch.as_tensor(mix_truth[0])]
    p = _tm(**DF)
    fg, ops = p.objective_and_gradient_aux
    rd = jit_optimise_on_multi_sphere(fg, p.inner_product, p.radii, max_iters=3,
                                      alpha0=10.0, cg=True, line_search="wolfe")(x, aux=ops)
    rh = optimise_on_multi_sphere(x, p.radii, p.objective_f64, p.gradient,
                                  p.inner_product, max_iters=3, alpha_k=10.0,
                                  line_search="wolfe", cg=True,
                                  f_and_g=p.objective_and_gradient, verbose=False)
    k = int(rd.iterations)
    assert k == rh.iterations >= 1
    np.testing.assert_allclose(rd.function_values[:k].double().numpy(),
                               np.asarray(rh.function_values), rtol=2e-6)


def test_mixing_df64_taylor_second_order(mix_truth, one_thread):
    x32 = mix_truth[0]
    p = _tm(**DF)
    x = [torch.as_tensor(x32)]
    J0 = p.objective_f64(x)
    g = p.gradient(x)[0]
    d = np.random.default_rng(7).standard_normal(x32.shape).astype(np.float32)
    d /= np.linalg.norm(d)
    slope = float(p.inner_product(g, torch.as_tensor(d)))
    rems = []
    for eps in (1e-1, 5e-2, 2.5e-2):
        J1 = p.objective_f64([torch.as_tensor(x32 + eps * d)])
        rems.append(abs(J1 - J0 - eps * slope))
    orders = [np.log(rems[i] / rems[i + 1]) / np.log(2.0) for i in range(2)]
    assert all(o > 1.7 for o in orders), (rems, orders)


def test_mixing_df64_config_validation():
    with pytest.raises(ValueError, match="df64"):
        _tm(adjoint="continuous", **DF)
    assert _tm(dtype="float64", solve_precision="df64")._df is None
    with pytest.raises(ValueError, match="solve_precision"):
        _tm(dtype="float32", solve_precision="compensated")


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

SMALL_CLI = {"kdyn": ["--npts", "8", "--n-iters", "12"],
             "mixing": ["--nx", "16", "--nz", "8", "--n-iters", "8"]}


@pytest.mark.parametrize("problem", ["kdyn", "mixing"])
def test_cli_precision_flag_selects_df64(problem):
    args = cli.build_parser().parse_args(
        [problem, "--device", "cpu", "--dtype", "float32", "--precision", "df64",
         "--df-adjoint", *SMALL_CLI[problem]])
    p, _x0, _ = cli.make_problem(args)
    assert p.cfg.solve_precision == "df64" and p.cfg.df_adjoint
    assert cli.df64(p) and callable(p.objective_f64)
    if problem == "kdyn":
        assert p.cfg.method == "plain"
    # on the CPU the default dtype is f64, where df64 is a no-op (as JAX)
    args = cli.build_parser().parse_args(
        [problem, "--device", "cpu", "--precision", "df64", *SMALL_CLI[problem]])
    assert not cli.df64(cli.make_problem(args)[0])


@pytest.mark.parametrize("extra", [[], ["--device-loop"], ["--test-grad"]])
@pytest.mark.parametrize("problem", ["kdyn", "mixing"])
def test_cli_df64_runs(problem, extra, tmp_path, capsys, one_thread):
    argv = [problem, "--device", "cpu", "--dtype", "float32", "--precision", "df64",
            "--max-iters", "2", "--out-dir", str(tmp_path), *SMALL_CLI[problem], *extra]
    if extra == ["--test-grad"]:
        argv += ["--test-grad-eps", "1e-2" if problem == "kdyn" else "3e-2"]
    else:
        argv += ["--quiet"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    if extra == ["--test-grad"]:
        assert "gradient test PASSED" in out
        return
    s = json.loads(out.strip().splitlines()[-1])
    assert s["iterations"] >= 1 and np.isfinite(s["J_final"])
    if not extra:
        assert s["config"]["solve_precision"] == "df64"


def test_cli_precision_refusals_and_rtr_notice(tmp_path, capsys):
    base = ["--device", "cpu", "--out-dir", str(tmp_path), "--quiet"]
    with pytest.raises(SystemExit, match="--dtype float64"):
        cli.main(["kdyn", "--precision", "compensated", *base])
    with pytest.raises(SystemExit, match="--dtype float64"):
        cli.main(["sh23", "--precision", "df64", *base])
    with pytest.raises(SystemExit, match="requires --precision df64"):
        cli.main(["kdyn", "--df-adjoint", *base])
    with pytest.raises(SystemExit, match="no df64 mode"):
        cli.main(["shb23", "--df-adjoint", "--precision", "df64", *base])
    # RTR drops df64 with the JAX CLI's notice
    args = cli.build_parser().parse_args(
        ["mixing", "--direction", "rtr", "--precision", "df64", "--df-adjoint",
         "--dtype", "float32", *base, *SMALL_CLI["mixing"]])
    p, _, _ = cli.make_problem(args)
    assert "substituting the standard-precision objective" in capsys.readouterr().out
    assert not cli.df64(p) and args.precision is None and not args.df_adjoint
