"""SH23 problem of the PyTorch port against the JAX package.

Seeded numpy inputs go through both `SwiftHohenberg` classes at a small
size (npts=64, n_iters=40). Tolerances in f64:
  * J rel 1e-12 and Riesz gradient rel 1e-10 for "matmul" and "fft" —
    the same operations in another summation order (matvec, FFT), whose
    ulp differences the gradient's reverse sweep amplifies a little;
  * the continuous-adjoint gradient rel 1e-12 (the same FFT recursion);
  * generate_ic from JAX's noise rel 1e-12 (100 FFT prep steps);
  * the step operators bitwise (the same numpy code).
The pinned files `baselines/sh23_port_ref.npz` and
`baselines/sh23_ext_port_ref.npz` are checked against what the JAX
package computes now at the full config: x0, J/grad and the continuous
gradient at x0 (the whole trajectories are not re-run here).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.convert import (
    operators_to_torch,
    sh23_operators,
    state_to_numpy,
    state_to_torch,
)
from spheremanopt_torch.grad.testgrad import adjoint_gradient_test
from spheremanopt_torch.ops.cuda import fused_two_matrix as fk
from spheremanopt_torch.problems.swift_hohenberg import SH23Config as TConfig
from spheremanopt_torch.problems.swift_hohenberg import SwiftHohenberg as TSH
from spheremanopt_tpu.problems.swift_hohenberg import SH23Config as JConfig
from spheremanopt_tpu.problems.swift_hohenberg import SwiftHohenberg as JSH

# anchored on this file, as in tests/test_baseline_parity.py
BASELINES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "baselines")
sys.path.insert(0, BASELINES)
from sh23_numpy import SH23Numpy, generate_ic_like  # noqa: E402

SMALL = dict(npts=64, n_iters=40)
REF = os.path.join(BASELINES, "sh23_port_ref.npz")


def _x(mg, seed=3):
    return np.random.RandomState(seed).randn(mg) * 0.3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("method", ["matmul", "fft"])
def test_objective_and_gradient_match_numpy_baseline(method):
    """Independent of JAX: the hand-rolled numpy forward and reverse
    sweep of `baselines/sh23_numpy.py` (rel 1e-12 / 1e-10 in f64)."""
    npy = SH23Numpy(npts=64, dt=0.05, n_iters=80)
    tp = TSH(TConfig(npts=64, n_iters=80, method=method), device="cpu")
    u0 = generate_ic_like(npts=64, seed=42, e0=0.0725)
    J, g = tp.objective_and_gradient(state_to_torch([u0], "cpu"))
    assert abs(float(J) - npy.forward(u0)) / abs(npy.forward(u0)) < 1e-12
    assert _rel(g[0], npy.gradient(u0)) < 1e-10


@pytest.mark.parametrize("method", ["matmul", "fft"])
def test_objective_and_gradient_match_jax_f64(method):
    jp = JSH(JConfig(method=method, **SMALL))
    tp = TSH(TConfig(method=method, **SMALL), device="cpu")
    x = _x(jp.basis.n_grid)
    J_j = float(jp.objective([jnp.asarray(x)]))
    g_j = np.asarray(jp.gradient([jnp.asarray(x)])[0])
    J_t = tp.objective(state_to_torch([x], "cpu"))
    g_t = tp.gradient(state_to_torch([x], "cpu"))[0]
    assert J_t.dim() == 0 and J_t.dtype == torch.float64 and float(J_t) < 0
    assert abs(float(J_t) - J_j) / abs(J_j) < 1e-12
    assert _rel(g_t, g_j) < 1e-10
    Jf_j, gf_j = jp.objective_and_gradient([jnp.asarray(x)])
    Jf_t, gf_t = tp.objective_and_gradient(state_to_torch([x], "cpu"))
    assert abs(float(Jf_t) - float(Jf_j)) / abs(float(Jf_j)) < 1e-12
    assert _rel(gf_t[0], gf_j[0]) < 1e-10


def test_inner_product_and_radii_match_jax():
    jp, tp = JSH(JConfig(**SMALL)), TSH(TConfig(**SMALL), device="cpu")
    x, y = _x(128, 1), _x(128, 2)
    assert tp.radii == jp.radii
    ij = float(jp.inner_product(jnp.asarray(x), jnp.asarray(y)))
    it = float(tp.inner_product(*state_to_torch([x, y], "cpu")))
    assert abs(it - ij) <= 1e-14 * np.mean(np.abs(x * y))


def test_taylor_test_order_two():
    p = TSH(TConfig(**SMALL), device="cpu")
    x0 = p.generate_ic(seed=42)
    dx = p.generate_ic(seed=9, e0=1.0)
    r = adjoint_gradient_test(x0, dx, p.objective, p.gradient, p.inner_product,
                              epsilon=1e-4, verbose=False)
    assert abs(r.gamma2 - 2.0) < 0.05


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_generate_ic_from_jax_noise_matches_jax(dtype):
    jp = JSH(JConfig(dtype=dtype, **SMALL))
    tp = TSH(TConfig(dtype=dtype, **SMALL), device="cpu")
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(42), (128,), jnp.dtype(dtype)))
    x_j = np.asarray(jp.generate_ic(seed=42)[0])
    x_t = tp.generate_ic(seed=42, noise=noise)[0]
    assert x_t.dtype == tp.dtype
    assert _rel(x_t, x_j) < (1e-12 if dtype == "float64" else 1e-5)
    assert abs(float(tp.inner_product(x_t, x_t)) / tp.cfg.e0 - 1.0) < (
        1e-14 if dtype == "float64" else 1e-6)


def test_generate_ic_own_noise_is_seeded():
    p = TSH(TConfig(**SMALL), device="cpu")
    a, b, c = (p.generate_ic(seed=s)[0] for s in (42, 42, 43))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_step_operators_bitwise_and_convert_roundtrip(dtype):
    jp = JSH(JConfig(dtype=dtype, **SMALL))
    tp = TSH(TConfig(dtype=dtype, **SMALL), device="cpu")
    oj, ot = sh23_operators(jp), sh23_operators(tp)
    assert oj.keys() == ot.keys()
    for k in oj:
        assert oj[k].dtype == ot[k].dtype
        np.testing.assert_array_equal(ot[k], oj[k])
    tens = operators_to_torch(oj, "cpu")
    for k in oj:
        np.testing.assert_array_equal(tens[k].numpy(), oj[k])
    assert operators_to_torch(oj, "cpu", dtype=torch.float32)["M"].dtype == torch.float32
    xs = [_x(128), _x(7)]
    back = state_to_numpy(state_to_torch(xs, "cpu"))
    for a, b in zip(xs, back):
        np.testing.assert_array_equal(a, b)


def test_cuda_method_on_cpu_runs_the_plain_version():
    """method="cuda" on CPU tensors: the plain sweeps, no kernel launch,
    and the f32 matmul path's numbers to f32 accuracy (rel 1e-5)."""
    cfg = dict(dtype="float32", **SMALL)
    pk = TSH(TConfig(method="cuda", **cfg), device="cpu")
    pm = TSH(TConfig(method="matmul", **cfg), device="cpu")
    x = state_to_torch([_x(128)], "cpu", dtype=torch.float32)
    fk.reset_launches()
    Jk, gk = pk.objective_and_gradient(x)
    g2 = pk.gradient(x)
    J0 = pk.objective(x)
    Jm, gm = pm.objective_and_gradient(x)
    assert not any(fk.LAUNCHES.values())
    assert float(J0) == float(Jk)
    assert torch.equal(gk[0], g2[0])
    assert abs(float(Jk) - float(Jm)) / abs(float(Jm)) < 1e-5
    assert _rel(gk[0], gm[0]) < 1e-5


def test_cuda_method_needs_float32():
    with pytest.raises(ValueError, match="float32"):
        TSH(TConfig(method="cuda", dtype="float64", **SMALL), device="cpu")


@pytest.mark.parametrize("method", ["matmul", "fft"])
def test_continuous_gradient_matches_jax_f64(method):
    cfg = dict(adjoint="continuous", method=method, **SMALL)
    jp, tp = JSH(JConfig(**cfg)), TSH(TConfig(**cfg), device="cpu")
    x = _x(jp.basis.n_grid)
    g_j = np.asarray(jp.gradient([jnp.asarray(x)])[0])
    g_t = tp.gradient(state_to_torch([x], "cpu"))[0]
    assert g_t.dtype == torch.float64
    assert _rel(g_t, g_j) < 1e-12


def test_continuous_mode_objective_and_gradient_dispatch():
    """Port of the JAX package's test of the same name: under
    adjoint='continuous', `objective_and_gradient` and the fused
    diagnostics form serve the continuous gradient (= `gradient()`), not
    the discrete one, so a Wolfe search never mixes the two. method="cuda"
    takes the same plain path (no kernel launch)."""
    p = TSH(TConfig(npts=64, n_iters=30, dt=0.05, adjoint="continuous"),
            device="cpu")
    x0 = p.generate_ic(seed=4)
    g_ref = p.gradient(x0)[0]
    g_disc = p._gradient(list(x0))[0]
    assert not torch.allclose(g_ref, g_disc)
    J_f, g_f = p.objective_and_gradient(x0)
    assert float(J_f) == float(p.objective(x0))
    assert torch.equal(g_f[0], g_ref)
    _, g_fd, _ = p.objective_gradient_and_diagnostics(x0)
    assert torch.equal(g_fd[0], g_ref)
    cfg = dict(npts=64, n_iters=30, dtype="float32", adjoint="continuous")
    x32 = [x0[0].float()]
    fk.reset_launches()
    g_k = TSH(TConfig(method="cuda", **cfg), device="cpu").objective_and_gradient(x32)[1]
    assert not any(fk.LAUNCHES.values())
    assert torch.equal(g_k[0], TSH(TConfig(method="fft", **cfg),
                                   device="cpu").gradient(x32)[0])


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


def test_pinned_inputs_match_jax_now(ref):
    for dtype, tag in (("float64", "f64"), ("float32", "f32")):
        p = JSH(JConfig(dtype=dtype))
        noise = jax.random.normal(jax.random.PRNGKey(42), (512,), jnp.dtype(dtype))
        np.testing.assert_array_equal(ref[f"noise_{tag}"], np.asarray(noise))
        # rel 1e-14 / 1e-6, not bitwise: XLA's CPU vector width may
        # reorder sums on another host
        assert _rel(p.generate_ic(seed=42)[0], ref[f"x0_{tag}"]) < _PIN_RTOL[dtype]
    assert int(ref["iters_f64_matmul"]) == len(ref["fv_f64_matmul"]) == 7


@pytest.mark.parametrize("dtype,method", [("float64", "matmul"),
                                          ("float32", "pallas")])
def test_pinned_objective_and_gradient_match_jax_now(ref, dtype, method):
    """J/grad at x0, exactly as the JAX package gives them now (one
    fwd+grad at the full config; pallas in interpret mode)."""
    tag = "f" + dtype[-2:]
    p = JSH(JConfig(dtype=dtype, method=method))
    J, g = p.objective_and_gradient([jnp.asarray(ref[f"x0_{tag}"])])
    assert _rel(J, ref[f"J_{tag}"]) < _PIN_RTOL[dtype]
    assert _rel(g[0], ref[f"g_{tag}"]) < 100 * _PIN_RTOL[dtype]


def test_pinned_continuous_gradient_matches_jax_now_and_the_port():
    """gc_f64 of baselines/sh23_ext_port_ref.npz at x0_f64 (full config)."""
    ext = np.load(os.path.join(BASELINES, "sh23_ext_port_ref.npz"))
    x0 = np.load(REF)["x0_f64"]
    g_j = JSH(JConfig(adjoint="continuous")).gradient([jnp.asarray(x0)])[0]
    g_t = TSH(TConfig(adjoint="continuous"), device="cpu").gradient(
        state_to_torch([x0], "cpu"))[0]
    assert _rel(g_j, ext["gc_f64"]) < 1e-12
    assert _rel(g_t, ext["gc_f64"]) < 1e-12
    assert int(ext["iters_f64_lbfgs"]) == len(ext["fv_f64_lbfgs"]) \
        == len(ext["steps_f64_lbfgs"])


def test_port_reproduces_pinned_f64_at_full_config(ref, one_thread):
    p = TSH(TConfig(), device="cpu")
    x0 = p.generate_ic(noise=ref["noise_f64"])
    assert _rel(x0[0], ref["x0_f64"]) < 1e-12
    J, g = p.objective_and_gradient(state_to_torch([ref["x0_f64"]], "cpu"))
    assert abs(float(J) - float(ref["J_f64"])) / abs(float(ref["J_f64"])) < 1e-12
    assert _rel(g[0], ref["g_f64"]) < 1e-10


# ---------------------------------------------------------------------------
# command line (run.py)
# ---------------------------------------------------------------------------


def test_cli_sh23_optimise_and_taylor_on_cpu(tmp_path, capsys):
    import json

    from spheremanopt_torch import run

    base = ["sh23", "--device", "cpu", "--npts", "32", "--n-iters", "20",
            "--quiet", "--out-dir", str(tmp_path)]
    assert run.main(base + ["--max-iters", "3"]) == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["iterations"] == 3 and summary["config"]["method"] == "matmul"
    assert summary["config"]["dtype"] == "float64"
    assert (tmp_path / "optimize_result.txt").exists()
    assert run.main(base + ["--test-grad"]) == 0
    assert "gradient test PASSED" in capsys.readouterr().out


def test_cli_pca_converges_on_cpu(tmp_path):
    import json

    from spheremanopt_torch import run

    assert run.main(["pca", "--device", "cpu", "--dim", "20", "--quiet",
                     "--out-dir", str(tmp_path)]) == 0
    assert json.loads((tmp_path / "summary.json").read_text())["converged"]


def test_cli_defaults_mirror_the_jax_cli():
    from spheremanopt_torch import run

    args = run.build_parser().parse_args(["sh23", "--device", "cpu", "--npts", "32"])
    p, x0, defaults = run.make_problem(args)
    assert defaults == dict(alpha=np.pi, max_iters=200)
    assert p.cfg.method == "matmul" and p.cfg.dtype == "float64"
    assert abs(float(p.inner_product(x0[0], x0[0])) - p.cfg.e0) < 1e-15
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    pinned = [np.linspace(-1, 1, 64)]
    _, x1, _ = run.make_problem(args, x0=pinned)
    np.testing.assert_array_equal(x1[0].numpy(), pinned[0])


def test_cli_cuda_device_never_falls_back_to_cpu(monkeypatch, tmp_path):
    from spheremanopt_torch import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA GPU"):
        run.main(["sh23", "--out-dir", str(tmp_path)])
