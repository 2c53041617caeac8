"""Kinematic-dynamo (KDyn) problem of the PyTorch port against the JAX package.

The same inputs (the JAX package's `generate_ic`, or seeded numpy) go
through both `KinematicDynamo` classes at a small size: 8^3 modes on
the 12^3 grid, 10 CNAB1 steps at dt = 1e-3. Tolerances:
  * the constants and the per-axis DFT matrices bitwise (the same numpy
    expressions in the same dtype order in both packages);
  * f64 transforms rel 1e-12, J rel 1e-12 and both Riesz gradients rel
    1e-10: the same operations, with the einsum sums taken in another
    order;
  * the f64 trajectory of a 3-iteration two-sphere host loop rel 1e-9;
  * Taylor remainder order gamma2 within 0.05 of 2.
The pinned file `baselines/kdyn_port_ref.npz` is checked against
`baselines/kdyn24_truth.npz`; its values are reproduced at the full
width on the card (`chip_smoke.py`), not here.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.convert import (
    kdyn_operators,
    operators_to_torch,
    state_to_numpy,
    state_to_torch,
)
from spheremanopt_torch.grad.testgrad import adjoint_gradient_test
from spheremanopt_torch.ops.cuda import kdyn_step as kd
from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig as TConfig
from spheremanopt_torch.problems.kinematic_dynamo import KinematicDynamo as TKDyn
from spheremanopt_tpu.ops.pallas.kdyn_step import make_consts as j_make_consts
from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig as JConfig
from spheremanopt_tpu.problems.kinematic_dynamo import KinematicDynamo as JKDyn

SMALL = dict(npts=8, n_iters=10, dt=1e-3)
BASELINES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "baselines")
_JAX = {}


def _j(**kw):
    """JAX problem, one per configuration (its jitted functions are reused)."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX:
        _JAX[key] = JKDyn(JConfig(**{**SMALL, **kw}))
    return _JAX[key]


def _t(**kw):
    return TKDyn(TConfig(**{**SMALL, **kw}), device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def x():
    """[B0, U] on the two spheres, f64 numpy: the JAX package's seed-3 draw."""
    return [np.asarray(a) for a in _j().generate_ic(seed=3)]


def _jx(x):
    return [jnp.asarray(a) for a in x]


@pytest.fixture
def one_thread():
    """Long step loops of small products: with several test workers on one
    host, torch's intra-op threads fight over the cores. One thread is as
    fast alone and does not degrade."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_constants_and_dft_matrices_bitwise_equal_jax(dtype):
    jp, tp = _j(dtype=dtype), _t(dtype=dtype)
    oj, ot = kdyn_operators(jp), kdyn_operators(tp)
    assert set(oj) == set(ot) == {"Ff", "Fz", "Bf", "Bz", "k", "inv_k2", "lhs_inv",
                                  "rhs_fac", "keep", "pw"}
    for k in oj:
        assert oj[k].dtype == ot[k].dtype, k
        np.testing.assert_array_equal(ot[k], oj[k], k)
    assert tp.mg == jp.mg == 12 and tp.radii == jp.radii == [1.0, 1.0]
    # the f32 pack the kernels read, as the JAX Pallas path forms it
    cj, ct = j_make_consts(jp), kd.make_consts(tp)
    assert set(cj) == set(ct)
    for k in cj:
        assert ct[k].dtype == np.float32
        np.testing.assert_array_equal(ct[k], cj[k], k)
    tens = operators_to_torch(ot, "cpu")
    for k in ot:
        np.testing.assert_array_equal(tens[k].numpy(), ot[k])
        assert torch.equal(getattr(tp, f"_{k}t"), tens[k])


@pytest.mark.parametrize("transform", ["matmul", "fft"])
def test_transforms_match_jax(transform, x):
    jp, tp = _j(transform=transform), _t(transform=transform)
    g = np.random.RandomState(0).randn(3, 12, 12, 12)
    c_j = np.asarray(jp.to_coeff(jnp.asarray(g)))
    c_t = tp.to_coeff(torch.as_tensor(g))
    assert c_t.shape == (3, 8, 8, 5) and c_t.dtype == torch.complex128
    assert _rel(c_t.numpy(), c_j) < 1e-12
    assert _rel(tp.to_grid(c_t), jp.to_grid(jnp.asarray(c_j))) < 1e-12
    # a band-limited field survives the round trip
    bl = tp.to_grid(tp.to_coeff(torch.tensor(x[1])))
    assert _rel(tp.to_grid(tp.to_coeff(bl)), bl) < 1e-12
    # the two transforms agree with each other
    assert _rel(c_t.numpy(), _t().to_coeff(torch.as_tensor(g)).numpy()) < 1e-12


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("cost", ["Final", "Integrated"])
def test_objective_and_projected_gradients_match_jax_f64(cost, remat, x):
    jp, tp = _j(cost=cost), _t(cost=cost, remat=remat)
    J_j, g_j = jp.objective_and_gradient(_jx(x))
    xt = state_to_torch(x, "cpu")
    J_t, g_t = tp.objective_and_gradient(xt)
    assert J_t.dim() == 0 and J_t.dtype == torch.float64 and float(J_t) < 0
    assert abs(float(J_t) - float(J_j)) / abs(float(J_j)) < 1e-12
    for a, b in zip(g_t, g_j):
        assert a.shape == (3, 12, 12, 12) and _rel(a, b) < 1e-10
    assert abs(float(tp.objective(xt)) - float(J_j)) <= 1e-12 * abs(float(J_j))
    for a, b in zip(tp.gradient(xt), g_j):
        assert _rel(a, b) < 1e-10
    # the projected gradients are divergence-free
    for g in g_t:
        div = torch.sum(tp._kt * tp.to_coeff(g), dim=0).abs().max()
        assert float(div) < 1e-10 * float(g.abs().max())


@pytest.mark.parametrize("transform", ["matmul", "fft"])
def test_unprojected_gradients_match_jax(transform, x):
    kw = dict(project_gradients=False, transform=transform)
    J_j, g_j = _j(**kw).objective_and_gradient(_jx(x))
    J_t, g_t = _t(**kw).objective_and_gradient(state_to_torch(x, "cpu"))
    assert abs(float(J_t) - float(J_j)) / abs(float(J_j)) < 1e-12
    for a, b in zip(g_t, g_j):
        assert _rel(a, b) < 1e-10


def test_remat_and_store_all_give_the_same_values(x):
    xt = state_to_torch(x, "cpu")
    J_r, g_r = _t(remat=True).objective_and_gradient(xt)
    J_s, g_s = _t(remat=False).objective_and_gradient(xt)
    assert torch.equal(J_r, J_s)
    for a, b in zip(g_r, g_s):
        assert _rel(a, b) < 1e-13


def test_inner_product_matches_jax(x):
    jp, tp = _j(), _t()
    xt = state_to_torch(x, "cpu")
    ij = float(jp.inner_product(jnp.asarray(x[0]), jnp.asarray(x[1])))
    assert abs(float(tp.inner_product(xt[0], xt[1])) - ij) <= 1e-14 * np.mean(
        np.abs(x[0] * x[1])) * 3
    assert tp.inner_products == tp.inner_product
    for a, r in zip(xt, tp.radii):
        assert abs(float(tp.inner_product(a, a)) / r - 1.0) < 1e-12
    back = state_to_numpy(xt)
    for a, b in zip(x, back):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cost", ["Final", "Integrated"])
def test_fused_diagnostics_match_jax(cost, x):
    jp, tp = _j(cost=cost), _t(cost=cost)
    xt = state_to_torch(x, "cpu")
    J_j, d_j = jp.objective_and_diagnostics(_jx(x))
    J_t, d_t = tp.objective_and_diagnostics(xt)
    assert tp.has_fused_diagnostics
    assert d_t.keys() == d_j.keys()
    assert d_t["magnetic_energy"].shape == (SMALL["n_iters"] + 1,)
    assert _rel(d_t["magnetic_energy"], d_j["magnetic_energy"]) < 1e-12
    assert _rel(d_t["B_final"], d_j["B_final"]) < 1e-12
    # |k . b| is roundoff of a divergence-free field: both sit at its floor
    assert float(d_t["max_div_B"]) < 1e-12 and float(d_j["max_div_B"]) < 1e-12
    np.testing.assert_array_equal(d_t["sim_time"], d_j["sim_time"])
    # J and the gradients bitwise the plain objective's
    J, g = tp.objective_and_gradient(xt)
    J_gd, g_gd, d_gd = tp.objective_gradient_and_diagnostics(xt)
    assert torch.equal(J_t, J) and torch.equal(J_gd, J)
    assert torch.equal(J_t, tp.objective(xt))
    assert all(torch.equal(a, b) for a, b in zip(g_gd, g))
    assert torch.equal(d_gd["magnetic_energy"], d_t["magnetic_energy"])
    assert not d_gd["magnetic_energy"].requires_grad


def test_rerun_diagnostics_match_jax(x):
    jp, tp = _j(), _t()
    d_j, d_t = jp.diagnostics(_jx(x)), tp.diagnostics(state_to_torch(x, "cpu"))
    assert d_t.keys() == d_j.keys()
    assert _rel(d_t["magnetic_energy"], d_j["magnetic_energy"]) < 1e-12
    assert _rel(d_t["B_final"], d_j["B_final"]) < 1e-12
    assert float(d_t["max_div_B"]) < 1e-12
    # the series is the one the fused call captures
    fused = tp.objective_and_diagnostics(state_to_torch(x, "cpu"))[1]
    assert torch.equal(d_t["magnetic_energy"], fused["magnetic_energy"])


def test_initial_state_and_advance_state_match_jax(x):
    jp, tp = _j(), _t()
    s0_j, s0_t = jp.initial_state(_jx(x)), tp.initial_state(state_to_torch(x, "cpu"))
    assert s0_t.keys() == s0_j.keys()
    assert s0_t["b"].shape == (2, 3, 8, 8, 5) and s0_t["u"].shape == (3, 12, 12, 12)
    for k in s0_j:
        assert _rel(s0_t[k], s0_j[k]) < 1e-12, k
    whole = tp.advance_state(s0_t, 10)
    parts = tp.advance_state(tp.advance_state(s0_t, 4), 6)
    assert torch.equal(whole["b"], parts["b"])
    f_j, f_t = jp.state_fields(jp.advance_state(s0_j, 10)), tp.state_fields(whole)
    assert f_t.keys() == f_j.keys()
    for k in f_j:
        assert _rel(f_t[k], f_j[k]) < 1e-12, k
    # a full-length advance lands on the solver's final field
    assert _rel(f_t["b_grid"], tp.diagnostics(state_to_torch(x, "cpu"))["B_final"]) < 1e-12


def _div_and_band(tp, f):
    c = tp.to_coeff(f)
    div = float(torch.sum(tp._kt * c, dim=0).abs().max())
    off_band = float((tp.to_grid(c) - f).abs().max())
    return div, off_band


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_generate_ic_from_jax_noise_matches_jax(dtype):
    jp, tp = _j(dtype=dtype), _t(dtype=dtype)
    key_b, key_u = jax.random.split(jax.random.PRNGKey(42))
    noise = [np.asarray(jax.random.normal(k, (12,) * 3, jnp.dtype(dtype)))
             for k in (key_b, key_u)]
    x_j = [np.asarray(a) for a in jp.generate_ic(seed=42)]
    x_t = tp.generate_ic(seed=42, noise=noise)
    tol, eps = (1e-11, 1e-13) if dtype == "float64" else (2e-4, 1e-5)
    for a, b, r in zip(x_t, x_j, tp.radii):
        assert a.dtype == tp.dtype and a.shape == (3, 12, 12, 12)
        assert _rel(a, b) < tol
        assert abs(float(tp.inner_product(a, a)) / r - 1.0) < eps
    again = tp.generate_ic(seed=7, noise=noise)
    assert all(torch.equal(a, b) for a, b in zip(x_t, again))
    with pytest.raises(ValueError, match="noise"):
        tp.generate_ic(noise=noise[:1])


@pytest.mark.parametrize("u_noise", [True, False])
def test_generate_ic_on_both_spheres_solenoidal_and_band_limited(u_noise):
    tp = _t(m0=2.0, e0=0.5)
    b, u = tp.generate_ic(seed=1, u_noise=u_noise)
    assert abs(float(tp.inner_product(b, b)) - 2.0) < 1e-13
    assert abs(float(tp.inner_product(u, u)) - 0.5) < 1e-13
    for f in (b, u):
        div, off_band = _div_and_band(tp, f)
        assert div < 1e-12 and off_band < 1e-12
    again = tp.generate_ic(seed=1, u_noise=u_noise)
    assert torch.equal(b, again[0]) and torch.equal(u, again[1])
    other = tp.generate_ic(seed=2, u_noise=u_noise)
    assert not torch.equal(b, other[0])
    if not u_noise:
        assert _rel(u, _j(m0=2.0, e0=0.5).generate_ic(seed=1, u_noise=False)[1]) < 1e-12


@pytest.mark.parametrize("cost", ["Final", "Integrated"])
def test_taylor_remainder_is_second_order(cost):
    tp = _t(cost=cost, n_iters=20)
    r = adjoint_gradient_test(tp.generate_ic(seed=4), tp.generate_ic(seed=5),
                              tp.objective, tp.gradient, tp.inner_product,
                              epsilon=1e-4, verbose=False)
    assert abs(r.gamma2 - 2.0) < 0.05


def test_two_sphere_host_loop_trajectory_matches_jax(x, one_thread):
    """Three iterations of the CLI's optimiser loop (Wolfe + hybrid CG,
    alpha0 = 100) from the same x0 on both spheres: function values and
    both final iterates rel 1e-9."""
    from spheremanopt_torch.optim.optimiser import optimise_on_multi_sphere as t_opt
    from spheremanopt_tpu.optim.optimiser import optimise_on_multi_sphere as j_opt

    jp, tp = _j(), _t()
    kw = dict(max_iters=3, alpha_k=100.0, line_search="wolfe", cg=True,
              verbose=False)
    rj = j_opt(_jx(x), jp.radii, jp.objective, jp.gradient, jp.inner_product,
               f_and_g=jp.objective_and_gradient, **kw)
    rt = t_opt(state_to_torch(x, "cpu"), tp.radii, tp.objective, tp.gradient,
               tp.inner_product, f_and_g=tp.objective_and_gradient, **kw)
    assert rt.iterations == rj.iterations == 3
    assert _rel(rt.function_values, rj.function_values) < 1e-9
    for a, b, r in zip(rt.x_opt, rj.x_opt, tp.radii):
        assert _rel(a, b) < 1e-9
        assert abs(float(tp.inner_product(a, a)) / r - 1.0) < 1e-12
    assert len(rt.residuals) == 2 and all(len(r) == 3 for r in rt.residuals)


def test_cuda_method_config_errors():
    with pytest.raises(ValueError, match="float32"):
        _t(method="cuda", dtype="float64")
    with pytest.raises(ValueError, match="matmul"):
        _t(method="cuda", dtype="float32", transform="fft")
    with pytest.raises(ValueError, match="method"):
        _t(method="pallas")
    with pytest.raises(ValueError, match="remat"):
        _t(remat="sqrt")
    with pytest.raises(ValueError, match="cost"):
        _t(cost="Mean")


def test_cuda_method_has_no_fused_diagnostics(x):
    tp = _t(method="cuda", dtype="float32")
    xt = state_to_torch(x, "cpu", torch.float32)
    assert not tp.has_fused_diagnostics
    with pytest.raises(ValueError, match="fused diagnostics unavailable"):
        tp.objective_and_diagnostics(xt)
    with pytest.raises(ValueError, match="fused diagnostics unavailable"):
        tp.objective_gradient_and_diagnostics(xt)
    # the re-running form stays available, as in the JAX package
    assert tp.diagnostics(xt)["magnetic_energy"].shape == (11,)


def test_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TKDyn(TConfig(**SMALL))


def test_converters_take_the_device_explicitly(x):
    with pytest.raises(TypeError):
        state_to_torch(x)
    with pytest.raises(TypeError):
        operators_to_torch(kdyn_operators(_t()))
    xt = state_to_torch(x, "cpu", torch.float32)
    assert all(a.dtype == torch.float32 and a.shape == (3, 12, 12, 12) for a in xt)


# ---------------------------------------------------------------------------
# pinned reference data (full width)
# ---------------------------------------------------------------------------


def test_pinned_reference_is_consistent():
    ref = np.load(os.path.join(BASELINES, "kdyn_port_ref.npz"))
    truth = np.load(os.path.join(BASELINES, "kdyn24_truth.npz"))
    np.testing.assert_array_equal(ref["b0"], truth["b0"])
    np.testing.assert_array_equal(ref["u0"], truth["u0"])
    assert ref["b0"].dtype == np.float32 and ref["b0"].shape == (3, 36, 36, 36)
    assert int(ref["iters200_f64"]) == len(ref["fv200_f64"]) == 10
    assert np.all(np.diff(ref["fv200_f64"]) > 0)
    for cost in ("Final", "Integrated"):
        assert float(ref[f"J200_{cost}"]) < 0
        assert ref[f"gb200_{cost}"].shape == ref[f"gu200_{cost}"].shape == (3, 36, 36, 36)
    assert float(ref["fv0_f32_full"]) > -float(ref["J0_f32_full"]) > 0
    assert int(ref["iters_f32_full"]) == len(ref["fv_f32_full"]) == 10
    assert float(ref["fv_f32_full"][0]) == float(ref["fv0_f32_full"])
    assert np.all(np.diff(ref["fv_f32_full"]) > 0)
    # f32 follows the f64 trajectory of the same workload to a fraction of a percent
    assert int(ref["iters_f64_full"]) == len(ref["fv_f64_full"]) == 10
    assert np.max(np.abs(ref["fv_f32_full"] / ref["fv_f64_full"] - 1.0)) < 5e-3
    # the f32 problem's J(x0) at full depth is the f64 truth's, to f32 accuracy
    assert abs(float(ref["J0_f32_full"]) - float(truth["J"])) < 1e-3 * abs(float(truth["J"]))


def test_port_reproduces_pinned_f64_at_full_width_and_a_cut_depth(one_thread):
    """J(x0) in f64 at the full 24^3 width: 20 steps here (the pinned
    200-step values are reproduced on the card), against the JAX package
    on the same pinned x0."""
    ref = np.load(os.path.join(BASELINES, "kdyn_port_ref.npz"))
    x0 = [ref["b0"].astype(np.float64), ref["u0"].astype(np.float64)]
    jp = JKDyn(JConfig(n_iters=20))
    tp = TKDyn(TConfig(n_iters=20), device="cpu")
    J_j = float(jp.objective(_jx(x0)))
    J_t = float(tp.objective(state_to_torch(x0, "cpu")))
    assert abs(J_t - J_j) < 1e-12 * abs(J_j)
    for a, r in zip(state_to_torch(x0, "cpu"), tp.radii):
        assert abs(float(tp.inner_product(a, a)) / r - 1.0) < 1e-6


# ---------------------------------------------------------------------------
# command line (run.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cost", ["Final", "Integrated"])
def test_cli_kdyn_optimise_on_cpu(cost, tmp_path, capsys, one_thread):
    from spheremanopt_torch import run

    base = ["kdyn", "--device", "cpu", "--npts", "8", "--n-iters", "20",
            "--quiet", "--out-dir", str(tmp_path)]
    assert run.main(base + ["--max-iters", "3", "--cost", cost]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # at this toy depth the Integrated line search stalls at alpha0 = 100
    assert summary["problem"] == "kdyn"
    assert summary["iterations"] == 3 if cost == "Final" else summary["iterations"] >= 1
    assert summary["config"]["cost"] == cost
    assert summary["config"]["method"] == "plain"
    assert summary["config"]["dtype"] == "float64"
    assert len(summary["residuals_final"]) == 2 and summary["J_final"] > 0
    assert os.path.exists(tmp_path / "summary.json")


def test_cli_kdyn_taylor_and_method_cuda_on_cpu(tmp_path, capsys):
    from spheremanopt_torch import run

    base = ["kdyn", "--device", "cpu", "--npts", "8", "--n-iters", "20",
            "--quiet", "--out-dir", str(tmp_path)]
    assert run.main(base + ["--test-grad"]) == 0
    assert "gradient test PASSED" in capsys.readouterr().out
    # --method cuda on the CPU runs the kernels' plain versions in f32
    kd.reset_launches()
    assert run.main(base + ["--max-iters", "2", "--method", "cuda"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["config"]["dtype"] == "float32"
    assert summary["config"]["method"] == "cuda" and summary["iterations"] == 2
    assert not any(kd.LAUNCHES.values())
    with pytest.raises(SystemExit):
        run.main(base + ["--method", "matmul"])
    # the TPU's pass-count modes stay refused (df64 and --adjoint
    # continuous run: tests/test_torch_precision.py, test_torch_kdyn_continuous.py)
    with pytest.raises(SystemExit, match="--dtype float64"):
        run.main(base + ["--precision", "high"])
