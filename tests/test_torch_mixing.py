"""Optimal mixing of the PyTorch port against the JAX package.

The same inputs (the pinned JAX seed-0 draw, or seeded numpy) go through
both `OptimalMixing` classes at small sizes (nx = 32, nz = 16 or 24,
n_iters <= 40), in f64 on the CPU. Tolerances:
  * the tau solve stacks S, MN, SA and the prep-dt stack bitwise (the
    same numpy code in both packages);
  * the parity-blocked solve against the dense stack, f64 roundoff;
  * transforms and the diagnostics' series rel 1e-12, J rel 1e-12 and
    the Riesz gradient rel 1e-10, for s = 0, 1 and both adjoints (the
    same operations, summed in another order);
  * Taylor remainder order gamma2 within 0.05 of 2;
  * the wall residuals of the forward and the continuous-adjoint solves
    at roundoff (1e-10), as tests/test_bc_residuals.py holds JAX's;
  * the host loop, the device loop and trust-region Newton against the
    pinned JAX trajectories (`baselines/mixing_port_ref.npz`) rel 1e-9,
    with equal counts; the workload's settings run to their end against
    the live JAX host loop (the same last iteration and reason, rel 1e-9).
The full-width values are held on the card (`chip_smoke.py` phases Y, Z).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch import run as cli
from spheremanopt_torch.convert import mixing_operators
from spheremanopt_torch.grad.testgrad import adjoint_gradient_test
from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
from spheremanopt_torch.optim.jit_rtr import jit_optimise_rtr
from spheremanopt_torch.optim.optimiser import optimise_on_multi_sphere
from spheremanopt_torch.optim.rtr import optimise_rtr
from spheremanopt_torch.problems.optimal_mixing import MixingConfig as TConfig
from spheremanopt_torch.problems.optimal_mixing import OptimalMixing as TMixing
from spheremanopt_tpu.optim.optimiser import optimise_on_multi_sphere as j_optimise
from spheremanopt_tpu.problems.optimal_mixing import MixingConfig as JConfig
from spheremanopt_tpu.problems.optimal_mixing import OptimalMixing as JMixing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the pinned file's config (tests/test_rtr_pde.py's size)
PIN = dict(nx=32, nz=16, n_iters=40, dt=1e-2, prep_steps=10)
_JAX, _TORCH = {}, {}


@pytest.fixture(scope="module", autouse=True)
def op_cache(tmp_path_factory):
    """Both packages' operator caches in a directory of this module's own:
    the JAX package's default lies outside the checkout, the port's inside
    it (build/op_cache)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMO_OP_CACHE", str(tmp_path_factory.mktemp("op_cache")))
        yield


@pytest.fixture(scope="module")
def ref():
    return np.load(os.path.join(ROOT, "baselines", "mixing_port_ref.npz"))


@pytest.fixture
def one_thread():
    """Long step loops of small products: with several test workers on one
    host, torch's intra-op threads fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _JAX:
        _JAX[key] = JMixing(JConfig(**{**PIN, **kw}))
    return _JAX[key]


def _t(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _TORCH:
        _TORCH[key] = TMixing(TConfig(**{**PIN, **kw}), device="cpu")
    return _TORCH[key]


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return np.abs(a - b).max() / np.abs(b).max()


def _x0(ref):
    return [torch.as_tensor(ref["x0"])]


@pytest.mark.parametrize("adjoint", ["discrete", "continuous"])
def test_stacks_bitwise_equal_jax(adjoint):
    jp, tp = _j(adjoint=adjoint), _t(adjoint=adjoint)
    oj, ot = mixing_operators(jp), mixing_operators(tp)
    want = {"S", "MN"} | ({"SA"} if adjoint == "continuous" else set())
    assert set(oj) == set(ot) == want
    for k in oj:
        assert ot[k].dtype == oj[k].dtype == np.complex128, k
        np.testing.assert_array_equal(ot[k], oj[k], k)
    # the prep-dt stack of generate_ic
    kw = dict(dt=jp.cfg.prep_dt, build_mixnorm=False)
    sj, mj = jp._build_operators(**kw)
    st, mt = tp._build_operators(**kw)
    assert mj is None and mt is None
    np.testing.assert_array_equal(st, sj)
    # the port's device stacks are the parity blocks of those
    assert tp._ops["S"].shape == (tp.kxn, 2, 24, 24)
    assert tp._ops["MN"].shape == (tp.kxn, 16, 16)


def test_operators_argument_replaces_the_assembly():
    jp = _j(adjoint="continuous")
    tp = TMixing(TConfig(**PIN, adjoint="continuous"), device="cpu",
                 operators=mixing_operators(jp))
    for k in ("S", "MN", "SA"):
        assert torch.equal(tp._ops[k], _t(adjoint="continuous")._ops[k])


def test_parity_blocked_solve_matches_full():
    """The parity-blocked product equals the dense stack's to roundoff."""
    tp = _t()
    nz, kxn = tp.cfg.nz, tp.kxn
    rng = np.random.RandomState(1)
    rhs = rng.randn(kxn, 2, 3, nz)
    out = tp._solve(tp._ops["S"], torch.as_tensor(rhs)).numpy()
    rc = (rhs[:, 0] + 1j * rhs[:, 1]).reshape(kxn, 3 * nz)
    full = np.einsum("kij,kj->ki", tp._S_np, rc).reshape(kxn, 3, nz)
    np.testing.assert_allclose(out[:, 0] + 1j * out[:, 1], full, rtol=1e-12,
                               atol=1e-13 * np.abs(full).max())
    # the dense stack takes the same path without the family permutation
    dense = tp._put(tp._S_np)
    out2 = tp._solve(dense, torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(out2, out, rtol=0, atol=1e-13 * np.abs(out).max())
    # the JAX package's blocked solve on the same rhs
    jp = _j()
    jout = np.asarray(jp._solve(jp._ops["S"], jnp.asarray(rc)))
    assert _rel(full.reshape(kxn, -1), jout) < 1e-12


def test_transforms_match_jax():
    jp, tp = _j(nz=24), _t(nz=24)
    g = np.random.RandomState(0).randn(3, tp.mgx, tp.mgz)
    c_j = np.asarray(jp.to_coeff(jnp.asarray(g)))
    c_t = tp.to_coeff(torch.as_tensor(g))
    assert c_t.shape == (3, tp.kxn, 24) and c_t.dtype == torch.complex128
    assert _rel(c_t.numpy(), c_j) < 1e-12
    assert _rel(tp.to_grid(c_t).numpy(), jp.to_grid(jnp.asarray(c_j))) < 1e-12


def test_step_matches_jax():
    jp, tp = _j(nz=24), _t(nz=24)
    rng = np.random.RandomState(2)
    u, w, r = (jp.to_coeff(jnp.asarray(0.1 * rng.randn(tp.mgx, tp.mgz)))
               for _ in range(3))
    outj = jp._step(jp._ops, u, w, r)
    x = torch.stack([torch.as_tensor(np.stack([np.real(c), np.imag(c)], 1))
                     for c in (u, w, r)], 2)
    outt = tp._step(tp._ops, x)
    for i, cj in enumerate(outj):
        assert _rel(outt[:, 0, i] + 1j * outt[:, 1, i], cj) < 1e-12


@pytest.mark.parametrize("s", [0, 1])
@pytest.mark.parametrize("adjoint", ["discrete", "continuous"])
def test_objective_and_gradient_match_pinned_jax(s, adjoint, ref, one_thread):
    tp = _t(s=s, adjoint=adjoint)
    J, g = tp.objective_and_gradient(_x0(ref))
    assert J.dtype == g[0].dtype == torch.float64
    assert g[0].shape == (2, tp.mgx, tp.mgz)
    assert _rel(float(J), ref[f"J_s{s}_{adjoint}"]) < 1e-12
    assert _rel(g[0].numpy(), ref[f"g_s{s}_{adjoint}"]) < 1e-10
    assert torch.equal(tp.objective(_x0(ref)), J)
    assert torch.equal(tp.gradient(_x0(ref))[0], g[0])


def test_objective_and_gradient_match_live_jax(one_thread):
    """A config the pinned file does not hold (nz = 24, s = 0, no remat)."""
    kw = dict(nz=24, n_iters=20, s=0, prep_steps=5)
    jp, tp = _j(**kw), _t(remat=False, **kw)
    x = jp.generate_ic(seed=3)
    J_j, g_j = jp.objective_and_gradient(x)
    J_t, g_t = tp.objective_and_gradient([torch.as_tensor(np.asarray(x[0]))])
    assert _rel(float(J_t), float(J_j)) < 1e-12
    assert _rel(g_t[0].numpy(), g_j[0]) < 1e-10
    assert _rel(float(tp.inner_product(g_t[0], g_t[0])),
                float(jp.inner_product(g_j[0], g_j[0]))) < 1e-10


@pytest.mark.parametrize("s", [0, 1])
def test_taylor_orders(s, ref, one_thread):
    tp = _t(s=s)
    dx = tp.generate_ic(seed=5)
    r = adjoint_gradient_test(_x0(ref), dx, tp.objective, tp.gradient,
                              tp.inner_product, epsilon=1e-3, verbose=False)
    assert abs(r.gamma1 - 1.0) < 0.05, r.gamma1
    assert abs(r.gamma2 - 2.0) < 0.05, r.gamma2


def test_generate_ic_from_the_jax_draw(ref):
    tp = _t()
    x = tp.generate_ic(noise=ref["noise"])
    assert x[0].shape == (2, tp.mgx, tp.mgz) and x[0].dtype == torch.float64
    assert _rel(x[0].numpy(), ref["x0"]) < 1e-12
    assert abs(float(tp.inner_product(x[0], x[0])) - tp.cfg.e0) < 1e-14
    with pytest.raises(ValueError, match="noise must have shape"):
        tp.generate_ic(noise=np.zeros((4, 4)))
    # the torch draw: another sample, on the same sphere
    y = tp.generate_ic(seed=0)
    assert abs(float(tp.inner_product(y[0], y[0])) - tp.cfg.e0) < 1e-14


def test_forward_bc_residuals_at_roundoff(ref, one_thread):
    tp = _t(n_iters=25)
    d = tp.diagnostics(_x0(ref))
    bc = d["bc_residuals"]
    assert bc.shape == (26, 2, 3) and bool(torch.isfinite(bc).all())
    assert float(bc[1:].max()) < 1e-10   # index 0 is the dealiased IC


def test_adjoint_bc_residuals_at_roundoff(ref, one_thread):
    tp = _t(adjoint="continuous", n_iters=20)
    bc = tp.adjoint_bc_residuals(_x0(ref))
    assert bc.shape == (20, 2, 3) and bool(torch.isfinite(bc).all())
    assert float(bc.max()) < 1e-10
    # the monitored sweep returns the gradient of the plain one
    g, _ = tp._gradient_continuous_impl(tp._ops, _x0(ref), with_bc=True)
    assert torch.equal(g[0], tp.gradient(_x0(ref))[0])
    with pytest.raises(ValueError, match="continuous"):
        _t(n_iters=20).adjoint_bc_residuals(_x0(ref))


@pytest.mark.parametrize("s", [0, 1])
def test_diagnostics_match_objective_and_jax(s, ref, one_thread):
    kw = dict(s=s, n_iters=20)
    jp, tp = _j(**kw), _t(**kw)
    x = _x0(ref)
    J, d = tp.objective_and_diagnostics(x)
    assert torch.equal(J, tp.objective(x))
    Jg, g, dg = tp.objective_gradient_and_diagnostics(x)
    J2, g2 = tp.objective_and_gradient(x)
    assert torch.equal(Jg, J) and torch.equal(J2, J) and torch.equal(g[0], g2[0])
    assert tp.has_fused_diagnostics
    Jj, dj = jp.objective_and_diagnostics([jnp.asarray(ref["x0"])])
    assert _rel(float(J), float(Jj)) < 1e-12
    for k in ("kinetic_energy", "buoyancy_energy", "rho_final",
              "vorticity_final", "u_final", "w_final"):
        assert d[k].shape == np.asarray(dj[k]).shape, k
        assert _rel(d[k].numpy(), dj[k]) < 1e-12, k
        assert torch.equal(d[k], dg[k]), k
    np.testing.assert_array_equal(d["sim_time"], dj["sim_time"])
    np.testing.assert_array_equal(d["z_grid"], dj["z_grid"])
    assert np.asarray(dj["bc_residuals"]).shape == tuple(d["bc_residuals"].shape)


def test_state_restart_segments_equal_one_run(ref):
    tp = _t(n_iters=12)
    s0 = tp.initial_state(_x0(ref))
    assert set(s0) == {"u", "w", "r"} and s0["u"].shape == (2, tp.kxn, 16)
    one = tp.advance_state(s0, 12)
    seg = tp.advance_state(tp.advance_state(tp.advance_state(s0, 5), 4), 3)
    for k in one:
        assert torch.equal(one[k], seg[k])
    u, w, r = tp.final_fields(_x0(ref))
    np.testing.assert_array_equal(u, (one["u"][0] + 1j * one["u"][1]).numpy())
    np.testing.assert_array_equal(r, (one["r"][0] + 1j * one["r"][1]).numpy())
    f = tp.state_fields(one)
    assert f["rho"].shape == (tp.mgx, tp.mgz)
    # the JAX package's final state
    uj, wj, rj = _j(n_iters=12).final_fields([jnp.asarray(ref["x0"])])
    assert _rel(u, uj) < 1e-12 and _rel(w, wj) < 1e-12 and _rel(r, rj) < 1e-12


def test_f32_keeps_complex64_through_a_step(ref, one_thread):
    tp = _t(dtype="float32")
    assert tp._ops["S"].dtype == tp._ops["MN"].dtype == torch.complex64
    x = tp._initial(torch.as_tensor(ref["x0"], dtype=torch.float32))
    assert x.dtype == torch.float32
    rhs = tp._a0 * x - tp._nonlinear(x)
    assert rhs.dtype == torch.float32
    out = tp._step(tp._ops, x)
    assert out.dtype == torch.float32 and out.shape == x.shape
    r = rhs.reshape(tp.kxn, 2, -1).index_select(2, tp._perm)
    c = torch.complex(r[:, 0], r[:, 1])
    assert c.dtype == torch.complex64 and (tp._ops["S"] @ c.view(tp.kxn, 2, -1, 1)).dtype \
        == torch.complex64
    J, g = tp.objective_and_gradient([torch.as_tensor(ref["x0"], dtype=torch.float32)])
    assert J.dtype == g[0].dtype == torch.float32
    assert _rel(float(J), ref["J_s1_discrete"]) < 1e-4
    # the inner product sums in f64 and returns f32
    ip = tp.inner_product(g[0], g[0])
    assert ip.dtype == torch.float32
    exact = float(torch.sum(tp._w.double() * g[0].double() * g[0].double()))
    assert float(ip) == np.float32(exact)


def _pinned(fv, steps, pfv, psteps):
    fv, steps = np.asarray(fv, np.float64), np.asarray(steps, np.float64)
    assert fv.shape == pfv.shape
    assert np.max(np.abs(fv - pfv) / np.abs(pfv)) < 1e-9
    assert np.max(np.abs(steps - psteps) / np.abs(psteps)) < 1e-9


def test_host_loop_matches_pinned_jax(ref, one_thread):
    tp = _t()
    r = optimise_on_multi_sphere(
        _x0(ref), tp.radii, tp.objective, tp.gradient, tp.inner_product,
        max_iters=3, alpha_k=100.0, line_search="wolfe", cg=True,
        verbose=False, f_and_g=tp.objective_and_gradient)
    assert r.iterations == int(ref["iters_host"])
    assert r.function_evals == int(ref["fevals_host"])
    assert r.gradient_evals == int(ref["gevals_host"])
    _pinned(r.function_values, r.step_sizes, ref["fv_host"], ref["steps_host"])


def test_device_loop_with_aux_matches_pinned_jax(ref, one_thread):
    tp = _t()
    fg, ops = tp.objective_and_gradient_aux
    assert ops is tp._ops
    r = jit_optimise_on_multi_sphere(
        fg, tp.inner_product, tp.radii, max_iters=3, alpha0=100.0, cg=True,
        line_search="wolfe")(_x0(ref), aux=ops)
    k = int(r.iterations)
    assert k == int(ref["iters_dev"])
    _pinned(r.function_values[:k], r.step_sizes[:k], ref["fv_dev"], ref["steps_dev"])


@pytest.mark.parametrize("n_iters, err_tol, message", [
    (30, 1e-6, "Line search failed"),   # the first CG search finds no step
    (40, 1e-3, "Converged"),            # the residual falls below err_tol
])
def test_loops_end_where_jax_ends(n_iters, err_tol, message, ref, one_thread):
    """`bench.py`'s mixing_workload settings (Wolfe + CG, alpha0 = 100,
    max_iters 200; its err_tol is 1e-6) run to their end: the port's host
    and device loops stop at the JAX host loop's iteration, for its
    reason."""
    kw = dict(max_iters=200, err_tol=err_tol)
    jp, tp = _j(n_iters=n_iters), _t(n_iters=n_iters)
    rj = j_optimise([jnp.asarray(ref["x0"])], jp.radii, jp.objective, jp.gradient,
                    jp.inner_product, alpha_k=100.0, line_search="wolfe", cg=True,
                    verbose=False, f_and_g=jp.objective_and_gradient, **kw)
    assert rj.message.startswith(message) and rj.iterations < kw["max_iters"]
    rt = optimise_on_multi_sphere(
        _x0(ref), tp.radii, tp.objective, tp.gradient, tp.inner_product,
        alpha_k=100.0, line_search="wolfe", cg=True, verbose=False,
        f_and_g=tp.objective_and_gradient, **kw)
    assert (rt.message, rt.iterations, rt.function_evals, rt.gradient_evals,
            rt.converged) == (rj.message, rj.iterations, rj.function_evals,
                              rj.gradient_evals, rj.converged)
    _pinned(rt.function_values, rt.step_sizes, np.asarray(rj.function_values),
            np.asarray(rj.step_sizes))
    fg, ops = tp.objective_and_gradient_aux
    rd = jit_optimise_on_multi_sphere(fg, tp.inner_product, tp.radii, alpha0=100.0,
                                      cg=True, line_search="wolfe", **kw)(
        _x0(ref), aux=ops)
    k = int(rd.iterations)
    assert k == rj.iterations
    _pinned(rd.function_values[:k], rd.step_sizes[:k], np.asarray(rj.function_values),
            np.asarray(rj.step_sizes))
    assert (float(rd.residuals[k - 1].max()) <= err_tol) == rj.converged


def test_rtr_host_and_device_match_pinned_jax(ref, one_thread):
    tp = _t()
    kw = dict(err_tol=1e-6, max_iters=3, max_cg=50)
    r = optimise_rtr(_x0(ref), tp.radii, tp.objective, tp.gradient,
                     tp.inner_product, verbose=False, **kw)
    assert r.iterations == int(ref["iters_rtr"])
    assert r.hvp_evals == int(ref["hvp_rtr"])
    _pinned(r.function_values, r.step_sizes, ref["fv_rtr"], ref["steps_rtr"])
    d = jit_optimise_rtr(tp.objective_ops, tp.gradient_ops, tp.inner_product,
                         tp.radii, **kw)(_x0(ref), aux=tp._ops)
    k = int(d.iterations)
    assert (k, int(d.trials), int(d.hvp_evals)) == (
        int(ref["iters_jrtr"]), int(ref["trials_jrtr"]), int(ref["hvp_jrtr"]))
    _pinned(d.function_values[:k], d.step_sizes[:k], ref["fv_jrtr"], ref["steps_jrtr"])


def test_continuous_mode_fused_callables_serve_continuous_gradient(ref, one_thread):
    tp = _t(adjoint="continuous", n_iters=10)
    x = _x0(ref)
    fg, ops = tp.objective_and_gradient_aux
    J, g = fg(ops, x)
    assert torch.equal(J, tp.objective(x))
    assert torch.equal(g[0], tp.gradient(x)[0])
    Jd, gd, _ = tp.objective_gradient_and_diagnostics(x)
    assert torch.equal(Jd, J) and torch.equal(gd[0], g[0])


@pytest.mark.parametrize("extra", [[], ["--device-loop"], ["--direction", "rtr"],
                                   ["--direction", "rtr", "--device-loop"]])
def test_cli_mixing_on_cpu(extra, tmp_path, one_thread):
    out = str(tmp_path)
    rc = cli.main(["mixing", "--device", "cpu", "--nx", "16", "--nz", "16",
                   "--n-iters", "8", "--max-iters", "2", "--quiet",
                   "--out-dir", out, *extra])
    assert rc == 0
    s = json.load(open(os.path.join(out, "summary.json")))
    assert s["problem"] == "mixing" and s["iterations"] >= 1
    assert np.isfinite(s["J_final"]) and s["J_final"] < 0   # -mix-norm
    if not extra:
        assert s["config"]["dtype"] == "float64" and s["config"]["s"] == 1


def test_cli_mixing_refusals():
    with pytest.raises(SystemExit, match="--dtype float64"):
        cli.main(["mixing", "--device", "cpu", "--precision", "compensated"])
    with pytest.raises(SystemExit, match="mixing takes plain"):
        cli.main(["mixing", "--device", "cpu", "--method", "cuda"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA GPU"):
            cli.main(["mixing", "--nx", "16", "--nz", "16"])
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            TMixing(TConfig(nx=16, nz=16, n_iters=2))
    with pytest.raises(ValueError, match="adjoint"):
        TMixing(TConfig(nx=16, nz=16, adjoint="df"), device="cpu")
