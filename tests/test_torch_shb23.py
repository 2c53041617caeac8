"""SHB23 problem of the PyTorch port against the JAX package.

Seeded numpy inputs go through both `SwiftHohenbergBounded` classes at
a small size (npts <= 128, n_iters <= 60). Tolerances:
  * the operators A_lin, A_nl and the weights bitwise (the same numpy
    code in both packages);
  * f64 J rel 1e-12 and Riesz gradient rel 1e-10, both adjoints — the
    same operations, matvecs summed in another order;
  * method="cuda" on the CPU (the kernels' plain versions, f32) vs the
    JAX Pallas kernel in interpret mode: J rel 1e-5, gradient rel 1e-4;
  * a 3-iteration f64 host-loop trajectory rel 1e-9.
The pinned file `baselines/shb23_port_ref.npz` is checked against what
the JAX package computes now at the full config: x0 and J/grad at x0
(the whole trajectories are not re-run here).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.convert import shb23_operators, state_to_torch
from spheremanopt_torch.grad.testgrad import adjoint_gradient_test
from spheremanopt_torch.ops.cuda import fused_two_matrix as fk
from spheremanopt_torch.problems.pca import PCAProblem
from spheremanopt_torch.problems.swift_hohenberg import SwiftHohenberg
from spheremanopt_torch.problems.swift_hohenberg_bounded import (
    SHB23Config as TConfig,
)
from spheremanopt_torch.problems.swift_hohenberg_bounded import (
    SwiftHohenbergBounded as TSHB,
)
from spheremanopt_tpu.problems.swift_hohenberg_bounded import (
    SHB23Config as JConfig,
)
from spheremanopt_tpu.problems.swift_hohenberg_bounded import (
    SwiftHohenbergBounded as JSHB,
)

SMALL = dict(npts=64, n_iters=40)
REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "baselines", "shb23_port_ref.npz")


def _t(**kw):
    return TSHB(TConfig(**{**SMALL, **kw}), device="cpu")


def _j(**kw):
    return JSHB(JConfig(**{**SMALL, **kw}))


def _x(p, seed=3):
    """Seeded numpy state on the problem's sphere."""
    x = np.random.RandomState(seed).randn(p.cfg.npts)
    return x * np.sqrt(p.cfg.m0 / np.sum(np.asarray(p._w) * x * x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("adjoint", ["discrete", "continuous"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_operators_bitwise_equal_jax(adjoint, dtype):
    oj = shb23_operators(_j(adjoint=adjoint, dtype=dtype))
    tp = _t(adjoint=adjoint, dtype=dtype)
    ot = shb23_operators(tp)
    assert oj.keys() == ot.keys()
    for k in oj:
        assert oj[k].dtype == ot[k].dtype
        np.testing.assert_array_equal(ot[k], oj[k], k)
    assert tp._Alt.dtype == tp.dtype and tp.radii == [tp.cfg.m0]
    assert tp._resid < 1e-8


@pytest.mark.parametrize("adjoint", ["discrete", "continuous"])
def test_objective_and_gradient_match_jax_f64(adjoint):
    jp, tp = _j(adjoint=adjoint), _t(adjoint=adjoint)
    x = _x(jp)
    J_j, g_j = jp.objective_and_gradient([jnp.asarray(x)])
    J_t, g_t = tp.objective_and_gradient(state_to_torch([x], "cpu"))
    assert J_t.dim() == 0 and J_t.dtype == torch.float64 and float(J_t) < 0
    assert abs(float(J_t) - float(J_j)) / abs(float(J_j)) < 1e-12
    assert _rel(g_t[0], g_j[0]) < 1e-10
    assert abs(float(tp.objective(state_to_torch([x], "cpu"))) - float(J_j)) \
        <= 1e-12 * abs(float(J_j))
    assert _rel(tp.gradient(state_to_torch([x], "cpu"))[0], g_j[0]) < 1e-10
    y = _x(jp, seed=4)
    ij = float(jp.inner_product(jnp.asarray(x), jnp.asarray(y)))
    it = float(tp.inner_product(*state_to_torch([x, y], "cpu")))
    assert abs(it - ij) <= 1e-15 * abs(ij) + 1e-18


def test_taylor_test_order_two():
    p = _t()
    x0 = p.generate_ic(seed=42)
    dx = p.generate_ic(seed=9, m0=1.0)
    r = adjoint_gradient_test(x0, dx, p.objective, p.gradient, p.inner_product,
                              epsilon=1e-4, verbose=False)
    assert abs(r.gamma2 - 2.0) < 0.05


def test_cuda_method_on_cpu_matches_jax_pallas_interpret():
    """method="cuda" on CPU tensors runs the plain sweeps (no launch) and
    lands within f32 accuracy of the JAX kernel in interpret mode."""
    cfg = dict(npts=96, n_iters=40, dtype="float32")
    jp, tp = _j(method="pallas", **cfg), _t(method="cuda", **cfg)
    x = _x(jp).astype(np.float32)
    J_j, g_j = jp.objective_and_gradient([jnp.asarray(x)])
    fk.reset_launches()
    J_t, g_t = tp.objective_and_gradient(state_to_torch([x], "cpu"))
    J0 = tp.objective(state_to_torch([x], "cpu"))
    assert not any(fk.LAUNCHES.values())
    assert J_t.dtype == torch.float32 and float(J0) == float(J_t)
    assert abs(float(J_t) - float(J_j)) / abs(float(J_j)) < 1e-5
    assert _rel(g_t[0], g_j[0]) < 1e-4


def test_cuda_method_needs_float32():
    with pytest.raises(ValueError, match="float32"):
        _t(method="cuda", dtype="float64")
    with pytest.raises(ValueError, match="method"):
        _t(method="fft")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_generate_ic_from_jax_noise_matches_jax(dtype):
    jp, tp = _j(dtype=dtype), _t(dtype=dtype)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(42), (64,),
                                         jnp.dtype(dtype)))
    x_j = np.asarray(jp.generate_ic(seed=42)[0])
    x_t = tp.generate_ic(seed=42, noise=noise)[0]
    assert x_t.dtype == tp.dtype
    assert _rel(x_t, x_j) < (1e-12 if dtype == "float64" else 1e-5)
    assert abs(float(tp.inner_product(x_t, x_t)) / tp.cfg.m0 - 1.0) < (
        1e-14 if dtype == "float64" else 1e-6)
    a, b = tp.generate_ic(seed=1)[0], tp.generate_ic(seed=1)[0]
    assert torch.equal(a, b) and not torch.equal(a, tp.generate_ic(seed=2)[0])


def test_host_loop_trajectory_matches_jax():
    """Three iterations of the CLI's optimiser loop (Wolfe + CG, alpha0 = 1) from
    the same x0: function values rel 1e-9, final iterate rel 1e-9."""
    from spheremanopt_torch.optim.optimiser import optimise_on_multi_sphere as t_opt
    from spheremanopt_tpu.optim.optimiser import optimise_on_multi_sphere as j_opt

    cfg = dict(n_iters=60, dt=0.05)
    jp, tp = _j(**cfg), _t(**cfg)
    x = _x(jp)
    kw = dict(err_tol=1e-5, max_iters=3, alpha_k=1.0, line_search="wolfe",
              cg=True, verbose=False)
    rj = j_opt([jnp.asarray(x)], jp.radii, jp.objective, jp.gradient,
               jp.inner_product, f_and_g=jp.objective_and_gradient, **kw)
    rt = t_opt(state_to_torch([x], "cpu"), tp.radii, tp.objective, tp.gradient,
               tp.inner_product, f_and_g=tp.objective_and_gradient, **kw)
    assert rt.iterations == rj.iterations == 3
    assert _rel(rt.function_values, rj.function_values) < 1e-9
    assert _rel(rt.x_opt[0], rj.x_opt[0]) < 1e-9


@pytest.mark.parametrize("make", [
    lambda: TSHB(TConfig(**SMALL)),
    lambda: SwiftHohenberg(),
    lambda: PCAProblem(np.eye(3)),
], ids=["shb23", "sh23", "pca"])
def test_problems_default_to_cuda_and_never_fall_back(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make()


# ---------------------------------------------------------------------------
# pinned reference data (full config)
# ---------------------------------------------------------------------------

_PIN_RTOL = {"float64": 1e-14, "float32": 1e-6}


@pytest.fixture(scope="module")
def ref():
    return np.load(REF)


@pytest.fixture
def one_thread():
    """Long step loops of small matvecs: with several test workers on one
    host, torch's intra-op threads fight over the cores and a loop that
    takes a second alone takes a minute. One thread is as fast alone and
    does not degrade."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pinned_inputs_match_jax_now(ref, one_thread):
    for dtype, tag in (("float64", "f64"), ("float32", "f32")):
        p = JSHB(JConfig(dtype=dtype))
        noise = jax.random.normal(jax.random.PRNGKey(42), (512,), jnp.dtype(dtype))
        np.testing.assert_array_equal(ref[f"noise_{tag}"], np.asarray(noise))
        # rel 1e-14 / 1e-6, not bitwise: XLA's CPU vector width may
        # reorder sums on another host
        assert _rel(p.generate_ic(seed=42)[0], ref[f"x0_{tag}"]) < _PIN_RTOL[dtype]
    for key in ("f64_matmul", "f32_matmul", "f32_pallas"):
        assert int(ref[f"iters_{key}"]) == len(ref[f"fv_{key}"]) >= 5


@pytest.mark.parametrize("dtype,method", [("float64", "matmul"),
                                          ("float32", "pallas")])
def test_pinned_objective_and_gradient_match_jax_now(ref, dtype, method):
    """J/grad at x0, exactly as the JAX package gives them now (one
    fwd+grad at the full config; pallas in interpret mode)."""
    tag = "f" + dtype[-2:]
    p = JSHB(JConfig(dtype=dtype, method=method))
    J, g = p.objective_and_gradient([jnp.asarray(ref[f"x0_{tag}"])])
    assert _rel(J, ref[f"J_{tag}"]) < _PIN_RTOL[dtype]
    assert _rel(g[0], ref[f"g_{tag}"]) < 100 * _PIN_RTOL[dtype]


def test_port_reproduces_pinned_f64_at_full_config(ref, one_thread):
    p = TSHB(TConfig(), device="cpu")
    x0 = p.generate_ic(noise=ref["noise_f64"])
    assert _rel(x0[0], ref["x0_f64"]) < 1e-12
    J, g = p.objective_and_gradient(state_to_torch([ref["x0_f64"]], "cpu"))
    assert abs(float(J) - float(ref["J_f64"])) / abs(float(ref["J_f64"])) < 1e-12
    assert _rel(g[0], ref["g_f64"]) < 1e-10


# ---------------------------------------------------------------------------
# command line (run.py)
# ---------------------------------------------------------------------------


def test_cli_shb23_optimise_and_taylor_on_cpu(tmp_path, capsys):
    from spheremanopt_torch import run

    base = ["shb23", "--device", "cpu", "--npts", "48", "--n-iters", "40",
            "--quiet", "--out-dir", str(tmp_path)]
    assert run.main(base + ["--max-iters", "2", "--diag-stride", "3",
                            "--dt", "0.05"]) == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["iterations"] == 2
    cfg = summary["config"]
    assert (cfg["method"], cfg["dtype"], cfg["dt"], cfg["diag_stride"]) == (
        "matmul", "float64", 0.05, 3)
    assert run.main(base + ["--test-grad"]) == 0
    assert "gradient test PASSED" in capsys.readouterr().out
    assert run.main(base + ["--max-iters", "1", "--method", "cuda",
                            "--adjoint", "continuous"]) == 0
    cfg = json.loads((tmp_path / "summary.json").read_text())["config"]
    assert (cfg["method"], cfg["dtype"], cfg["adjoint"]) == (
        "cuda", "float32", "continuous")


def test_cli_shb23_defaults_mirror_the_jax_cli():
    from spheremanopt_torch import run

    args = run.build_parser().parse_args(["shb23", "--device", "cpu", "--npts", "32"])
    p, x0, defaults = run.make_problem(args)
    assert defaults == dict(alpha=1.0, max_iters=50, err_tol=1e-5)
    assert (p.cfg.method, p.cfg.dtype, p.cfg.adjoint) == ("matmul", "float64",
                                                          "discrete")
    assert abs(float(p.inner_product(x0[0], x0[0])) - p.cfg.m0) < 1e-15
    bad = run.build_parser().parse_args(["shb23", "--device", "cpu",
                                         "--method", "fft"])
    with pytest.raises(SystemExit, match="fft"):
        run.make_problem(bad)
    sh = run.build_parser().parse_args(["sh23", "--device", "cpu", "--npts", "32",
                                        "--adjoint", "continuous"])
    assert run.make_problem(sh)[0].cfg.adjoint == "continuous"
