"""KDyn's continuous adjoint, its remat modes and its Rm-operand route in
the port, against the JAX package run live on the CPU at small sizes (8^3
or 12^3 modes, 12-40 steps, f64), on the same numpy inputs (the JAX
package's `generate_ic` draws). Tolerances are the JAX tests':

  * continuous gradient rel 1e-12; its invariant series below 1e-10 of
    max|k| max|G| and the mean flux exactly 0;
  * remat="nested" against store-all: J rel 1e-13, gradients rel 1e-10;
    remat="offload" against "step": J rel 1e-13, gradients rel 1e-12;
  * the Rm route at cfg.rm bitwise the bound problem, at another Rm rel
    1e-12 against a problem built there; the device loop over two Rm
    values rel 1e-12 per value.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.convert import state_to_torch
from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig as TConfig
from spheremanopt_torch.problems.kinematic_dynamo import KinematicDynamo as TKDyn
from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig as JConfig
from spheremanopt_tpu.problems.kinematic_dynamo import KinematicDynamo as JKDyn

BASELINES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "baselines")
SMALL = dict(npts=8, n_iters=15, dt=1e-3)
_JAX = {}


def _j(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _JAX:
        _JAX[key] = JKDyn(JConfig(**{**SMALL, **kw}))
    return _JAX[key]


def _t(**kw):
    return TKDyn(TConfig(**{**SMALL, **kw}), device="cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def x8():
    return [np.asarray(a) for a in _j().generate_ic(seed=4)]


@pytest.fixture(scope="module")
def x12():
    return [np.asarray(a) for a in _j(npts=12).generate_ic(seed=42)]


@pytest.fixture
def one_thread():
    """Long step loops of small products: one intra-op thread each (test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# continuous adjoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cost", ["Final", "Integrated"])
def test_continuous_gradient_and_invariants_match_jax(cost, x12, one_thread):
    kw = dict(npts=12, n_iters=25, cost=cost, adjoint="continuous")
    jd = _j(**kw).adjoint_diagnostics([jnp.asarray(a) for a in x12])
    tp = _t(**kw)
    td = tp.adjoint_diagnostics(state_to_torch(x12, "cpu"))
    n = tp.cfg.n_iters
    for k in ("max_div_G", "max_div_nu", "max_flux_G", "adj_sim_time"):
        assert isinstance(td[k], np.ndarray) and td[k].shape == (n,), k
    np.testing.assert_array_equal(td["adj_sim_time"], jd["adj_sim_time"])
    for a, b in zip(td["gradient"], jd["gradient"]):
        assert a.shape == (3, 18, 18, 18) and _rel(a, b) < 1e-12
    scale = float(tp._kt.abs().max()) * float(tp.to_coeff(td["gradient"][0]).abs().max())
    assert td["max_div_G"].max() < 1e-10 * scale
    assert td["max_div_nu"].max() < 1e-10 * scale
    assert td["max_flux_G"].max() == 0.0 == jd["max_flux_G"].max()
    # the gradient path returns the sweep's gradient bitwise
    for a, b in zip(tp.gradient(state_to_torch(x12, "cpu")), td["gradient"]):
        assert torch.equal(a, b)


def test_continuous_mode_objective_and_gradient_dispatch(x8):
    """J from `objective`, the gradient from the continuous sweep, in the
    fused and diagnostics forms too (JAX `tests/test_kdyn.py:330`)."""
    tp, jp = _t(adjoint="continuous"), _j(adjoint="continuous")
    xt = state_to_torch(x8, "cpu")
    g_ref = tp.gradient(xt)
    g_disc = _t().gradient(xt)
    assert not torch.allclose(g_ref[1], g_disc[1])
    J_f, g_f = tp.objective_and_gradient(xt)
    assert torch.equal(J_f, tp.objective(xt))
    for a, b in zip(g_f, g_ref):
        assert torch.equal(a, b)
    J_d, g_d, diag = tp.objective_gradient_and_diagnostics(xt)
    assert torch.equal(J_d, J_f) and diag["magnetic_energy"].shape == (16,)
    for a, b in zip(g_d, g_ref):
        assert torch.equal(a, b)
    J_j, g_j = jp.objective_and_gradient([jnp.asarray(a) for a in x8])
    assert abs(float(J_f) / float(J_j) - 1) < 1e-12
    for a, b in zip(g_f, g_j):
        assert _rel(a, b) < 1e-12


def test_continuous_mode_under_cuda_method_on_cpu(x8):
    """adjoint='continuous' with method='cuda': J from the forward kernel's
    plain version (on a CPU tensor), the f32 continuous sweep beside it."""
    tp = _t(adjoint="continuous", method="cuda", dtype="float32")
    xt = state_to_torch(x8, "cpu", torch.float32)
    J, g = tp.objective_and_gradient(xt)
    J64, g64 = _t(adjoint="continuous").objective_and_gradient(state_to_torch(x8, "cpu"))
    assert J.dtype == torch.float32 and abs(float(J) / float(J64) - 1) < 1e-5
    for a, b in zip(g, g64):
        assert a.dtype == torch.float32 and _rel(a, b) < 1e-4


def test_adjoint_diagnostics_requires_continuous(x8):
    with pytest.raises(ValueError, match="continuous"):
        _t().adjoint_diagnostics(state_to_torch(x8, "cpu"))


def test_pinned_continuous_reference_is_consistent():
    """The chip check compares like with like: the pinned x0 is
    kdyn24_truth's, and the pinned values have the stated shapes."""
    ext = np.load(os.path.join(BASELINES, "kdyn_ext_port_ref.npz"))
    truth = np.load(os.path.join(BASELINES, "kdyn24_truth.npz"))
    np.testing.assert_array_equal(ext["b0"], truth["b0"])
    np.testing.assert_array_equal(ext["u0"], truth["u0"])
    for cost in ("Final", "Integrated"):
        for k in ("gcb", "gcu"):
            a = ext[f"{k}_{cost}"]
            assert a.dtype == np.complex128 and a.shape == (3, 24, 24, 13)
            assert np.isfinite(a).all() and np.abs(a).max() > 0
        for k in ("div_g", "div_nu", "flux_g"):
            assert ext[f"{k}_{cost}"].shape == (200,)
        assert ext[f"flux_g_{cost}"].max() == 0.0
        assert ext[f"div_g_{cost}"].max() < 1e-10 * np.abs(ext[f"gcb_{cost}"]).max() * 12
    assert os.path.getsize(os.path.join(BASELINES, "kdyn_ext_port_ref.npz")) < 5e6


# ---------------------------------------------------------------------------
# remat modes
# ---------------------------------------------------------------------------


def test_nested_remat_matches_storeall_and_jax(x12, one_thread):
    kw = dict(npts=12, n_iters=37, cost="Integrated")
    xt = state_to_torch(x12, "cpu")
    Ja, ga = _t(remat=False, **kw).objective_and_gradient(xt)
    Jb, gb = _t(remat="nested", **kw).objective_and_gradient(xt)
    Jj, gj = _j(remat="nested", **kw).objective_and_gradient(
        [jnp.asarray(a) for a in x12])
    assert abs(float(Jb) / float(Ja) - 1) < 1e-13
    assert abs(float(Jb) / float(Jj) - 1) < 1e-13
    for a, b, c in zip(gb, ga, gj):
        assert _rel(a, b) < 1e-10 and _rel(a, c) < 1e-10


@pytest.mark.parametrize("cost", ["Final", "Integrated"])
def test_offload_remat_matches_step_remat(cost, x12, one_thread):
    kw = dict(npts=12, n_iters=40, cost=cost)
    xt = state_to_torch(x12, "cpu")
    Ja, ga = _t(remat="step", **kw).objective_and_gradient(xt)
    Jb, gb = _t(remat="offload", **kw).objective_and_gradient(xt)
    Jj, gj = _j(remat="offload", **kw).objective_and_gradient(
        [jnp.asarray(a) for a in x12])
    assert abs(float(Jb) / float(Ja) - 1) < 1e-13
    assert abs(float(Jb) / float(Jj) - 1) < 1e-13
    for a, b, c in zip(gb, ga, gj):
        assert _rel(a, b) < 1e-12 and _rel(a, c) < 1e-12


@pytest.mark.parametrize("cost", ["Final", "Integrated"])
@pytest.mark.parametrize("remat", ["nested", "offload", "step"])
def test_aux_objective_op_identical_across_modes(cost, remat):
    """The fused-diagnostics solve gives the objective's J bitwise under
    every remat mode, its series covers all n_iters + 1 energies, and its
    gradient is the plain one (JAX `tests/test_kdyn.py:303`)."""
    kw = dict(n_iters=23, cost=cost, remat=remat)
    jp, tp = _j(**kw), _t(**kw)
    x0 = [np.asarray(a) for a in jp.generate_ic(seed=7)]
    xt = state_to_torch(x0, "cpu")
    J_plain = tp.objective(xt)
    J_aux, diag = tp.objective_and_diagnostics(xt)
    assert torch.equal(J_aux, J_plain)
    assert diag["magnetic_energy"].shape == (24,)
    if cost == "Final":
        assert abs(float(diag["magnetic_energy"][-1]) / -float(J_plain) - 1) < 1e-13
    J_j, dj = jp.objective_and_diagnostics([jnp.asarray(a) for a in x0])
    assert abs(float(J_aux) / float(J_j) - 1) < 1e-12
    assert _rel(diag["magnetic_energy"], dj["magnetic_energy"]) < 1e-12
    Jg, g_aux, _ = tp.objective_gradient_and_diagnostics(xt)
    assert torch.equal(Jg, J_plain)
    for a, b in zip(g_aux, tp.gradient(xt)):
        assert _rel(a, b) < 1e-11


def test_nested_remat_of_the_cuda_method_is_unused(x8):
    """The cuda objective is a closed kernel (its plain versions on the
    CPU): remat does not apply, as the JAX Pallas objective bypasses it."""
    xt = state_to_torch(x8, "cpu", torch.float32)
    Ja, ga = _t(method="cuda", dtype="float32").objective_and_gradient(xt)
    Jb, gb = _t(method="cuda", dtype="float32",
                remat="nested").objective_and_gradient(xt)
    assert torch.equal(Ja, Jb) and all(torch.equal(a, b) for a, b in zip(ga, gb))


# ---------------------------------------------------------------------------
# Rm as an operand
# ---------------------------------------------------------------------------


def test_rm_route_matches_bound_problem_and_jax(x8):
    tp = _t(n_iters=12, rm=1.0)
    fg, make_ops = tp.objective_and_gradient_rm
    xt = state_to_torch(x8, "cpu")
    J_ref, g_ref = tp.objective_and_gradient(xt)
    J_aux, g_aux = fg(make_ops(1.0), xt)
    assert torch.equal(J_aux, J_ref)
    assert all(torch.equal(a, b) for a, b in zip(g_aux, g_ref))
    J3_ref, g3_ref = _t(n_iters=12, rm=3.0).objective_and_gradient(xt)
    J3, g3 = fg(make_ops(3.0), xt)
    assert abs(float(J3) / float(J3_ref) - 1) < 1e-12 and float(J3) != float(J_aux)
    for a, b in zip(g3, g3_ref):
        assert _rel(a, b) < 1e-12
    jfg, jmake = _j(n_iters=12, rm=1.0).objective_and_gradient_rm
    J3j, g3j = jfg(jmake(3.0), [jnp.asarray(a) for a in x8])
    assert abs(float(J3) / float(J3j) - 1) < 1e-12
    for a, b in zip(g3, g3j):
        assert _rel(a, b) < 1e-10


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_make_ops_bit_equal_to_the_constructor_and_jax(dtype):
    tp, jp = _t(dtype=dtype), _j(dtype=dtype)
    ops = tp.objective_and_gradient_rm[1](tp.cfg.rm)
    jops = jp.objective_and_gradient_rm[1](jp.cfg.rm)
    for k, own in (("lhs_inv", tp._lhs_invt), ("rhs_fac", tp._rhs_fact)):
        assert ops[k].dtype == own.dtype == getattr(torch, dtype)
        assert torch.equal(ops[k], own)
        np.testing.assert_array_equal(ops[k].numpy(), jops[k])
    ops4 = tp.objective_and_gradient_rm[1](4.0)
    assert torch.equal(ops4["lhs_inv"], _t(dtype=dtype, rm=4.0)._lhs_invt)


def test_device_loop_serves_multiple_rm_from_one_optimiser(one_thread):
    """One device-loop object serves every Rm through its aux operand
    (JAX `tests/test_jit_driver.py:187`): for each Rm, its trajectory
    matches a loop on a problem built at that Rm, and JAX's."""
    from spheremanopt_torch.optim.jit_driver import jit_optimise_on_multi_sphere
    from spheremanopt_tpu.optim.jit_driver import \
        jit_optimise_on_multi_sphere as j_loop

    cfg = dict(npts=8, n_iters=20, dt=2e-3)
    tp = _t(rm=1.0, **cfg)
    fg, make_ops = tp.objective_and_gradient_rm
    kw = dict(max_iters=4, alpha0=5.0, cg=True, line_search="wolfe", err_tol=1e-12)
    opt = jit_optimise_on_multi_sphere(fg, tp.inner_product, [1.0, 1.0], **kw)
    x0 = [np.asarray(a) for a in _j(**cfg).generate_ic(seed=6)]
    xt = state_to_torch(x0, "cpu")
    jp = _j(rm=1.0, **cfg)
    jfg, jmake = jp.objective_and_gradient_rm
    jopt = j_loop(jfg, jp.inner_product, [1.0, 1.0], **kw)
    ends = {}
    for rm in (1.0, 4.0):
        r = opt(xt, aux=make_ops(rm))
        q = _t(rm=rm, **cfg)
        rq = jit_optimise_on_multi_sphere(q.objective_and_gradient, q.inner_product,
                                          [1.0, 1.0], **kw)(xt)
        rj = jopt([jnp.asarray(a) for a in x0], aux=jmake(rm))
        assert int(r.iterations) == int(rq.iterations) == int(rj.iterations) == 4
        assert _rel(r.function_values, rq.function_values) < 1e-12
        assert _rel(r.step_sizes, rq.step_sizes) < 1e-10
        assert _rel(r.function_values, np.asarray(rj.function_values)) < 1e-12
        ends[rm] = float(r.function_values[-1])
    assert ends[1.0] != ends[4.0]


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [["--adjoint", "continuous"],
                                   ["--remat", "nested"], ["--remat", "offload"],
                                   ["--remat", "none"]])
def test_cli_kdyn_continuous_and_remat_on_cpu(extra, tmp_path, capsys):
    from spheremanopt_torch import run

    assert run.main(["kdyn", "--device", "cpu", "--npts", "8", "--n-iters", "12",
                     "--max-iters", "2", "--quiet", "--out-dir", str(tmp_path),
                     *extra]) == 0
    s = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert s["iterations"] >= 1 and s["J_final"] > 0
    cfg = s["config"]
    if extra[0] == "--adjoint":
        assert cfg["adjoint"] == "continuous"
    else:
        assert cfg["remat"] == {"none": False}.get(extra[1], extra[1])
