"""Fused diagnostics and PDE-state restart of the PyTorch port against the
JAX package, for SH23 (`matmul`, `fft`, `cuda`) and SHB23 (`matmul`,
`cuda`), with diag_stride 1, 3 and 7 (7 does not divide the 30 steps).

  * energies, u_final and sim_time match JAX's fused diagnostics: f64
    rel 1e-12; `cuda` (the kernels' plain versions on the CPU, f32) vs
    the JAX Pallas diag kernels in interpret mode rel 1e-5;
  * J from the diagnostics objectives is bitwise J from the plain ones,
    and so is the gradient;
  * advance_state(s, a + b) == advance_state(advance_state(s, a), b)
    exactly, and the states match JAX's (rel 1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spheremanopt_torch.convert import state_to_torch
from spheremanopt_torch.problems import swift_hohenberg as tsh
from spheremanopt_torch.problems import swift_hohenberg_bounded as tshb
from spheremanopt_torch.solvers import scan_utils as tscan
from spheremanopt_tpu.problems import swift_hohenberg as jsh
from spheremanopt_tpu.problems import swift_hohenberg_bounded as jshb
from spheremanopt_tpu.solvers import scan_utils as jscan

N = 30
# (torch problem, JAX problem, sizes, torch method, JAX method, dtype)
CASES = {
    "sh23-matmul": ("sh23", dict(npts=32), "matmul", "matmul", "float64"),
    "sh23-fft": ("sh23", dict(npts=32), "fft", "fft", "float64"),
    "sh23-cuda": ("sh23", dict(npts=32), "cuda", "pallas", "float32"),
    "shb23-matmul": ("shb23", dict(npts=48), "matmul", "matmul", "float64"),
    "shb23-cuda": ("shb23", dict(npts=48), "cuda", "pallas", "float32"),
}
STRIDES = [1, 3, 7]


def _pair(case, stride):
    kind, size, tmethod, jmethod, dtype = CASES[case]
    kw = dict(size, n_iters=N, dtype=dtype, diag_stride=stride)
    if kind == "sh23":
        return (tsh.SwiftHohenberg(tsh.SH23Config(method=tmethod, **kw), device="cpu"),
                jsh.SwiftHohenberg(jsh.SH23Config(method=jmethod, **kw)))
    return (tshb.SwiftHohenbergBounded(tshb.SHB23Config(method=tmethod, **kw),
                                       device="cpu"),
            jshb.SwiftHohenbergBounded(jshb.SHB23Config(method=jmethod, **kw)))


def _x(tp):
    n = tp.basis.n_grid if hasattr(tp.basis, "n_grid") else tp.cfg.npts
    return np.random.RandomState(3).randn(n) * 0.1


def _rel(a, b):
    """max |a - b| / max |b|, for real or complex arrays."""
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("case", list(CASES))
def test_fused_diagnostics_match_jax(case, stride):
    tp, jp = _pair(case, stride)
    x = _x(tp)
    tol = 1e-12 if tp.dtype == torch.float64 else 1e-5
    J_t, d_t = tp.objective_and_diagnostics(state_to_torch([x], "cpu", dtype=tp.dtype))
    J_j, d_j = jp.objective_and_diagnostics([jnp.asarray(x, jp.cfg.dtype)])
    steps = jscan.strided_steps(N, stride)
    assert d_t["kinetic_energy"].shape == (len(steps),)
    assert abs(float(J_t) - float(J_j)) <= tol * abs(float(J_j))
    assert _rel(d_t["kinetic_energy"], d_j["kinetic_energy"]) < tol
    assert _rel(d_t["u_final"], d_j["u_final"]) < tol
    np.testing.assert_array_equal(d_t["sim_time"], np.asarray(d_j["sim_time"]))
    grid = "x_grid" if case.startswith("sh23") else "z_grid"
    np.testing.assert_array_equal(d_t[grid], np.asarray(d_j[grid]))


@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("case", list(CASES))
def test_diagnostics_J_and_gradient_bitwise_the_plain_ones(case, stride):
    tp, _ = _pair(case, stride)
    x = state_to_torch([_x(tp)], "cpu", dtype=tp.dtype)
    J, g = tp.objective_and_gradient(x)
    J_gd, g_gd, diag = tp.objective_gradient_and_diagnostics(x)
    J_d, diag_d = tp.objective_and_diagnostics(x)
    assert torch.equal(J_gd, J) and torch.equal(J_d, tp.objective(x))
    assert torch.equal(J_d, J)
    assert torch.equal(g_gd[0], g[0])
    for key in ("kinetic_energy", "u_final"):
        assert not diag[key].requires_grad
        assert torch.equal(diag[key], diag_d[key])
    # the strided series is the per-step series, subsampled
    per_step = _pair(case, 1)[0].objective_and_diagnostics(x)[1]["kinetic_energy"]
    assert torch.equal(diag["kinetic_energy"],
                       per_step[torch.as_tensor(tscan.strided_steps(N, stride))])


@pytest.mark.parametrize("kind", ["sh23", "shb23"])
def test_diagnostics_and_final_state_match_jax(kind):
    tp, jp = _pair(f"{kind}-matmul", 1)
    x = _x(tp)
    d_t = tp.diagnostics(state_to_torch([x], "cpu"))
    d_j = jp.diagnostics([jnp.asarray(x)])
    assert _rel(d_t["kinetic_energy"], d_j["kinetic_energy"]) < 1e-12
    for key in ("u_initial", "u_final") + (("u_hat_final",) if kind == "sh23" else ()):
        assert _rel(d_t[key], d_j[key]) < 1e-12, key
    np.testing.assert_array_equal(d_t["sim_time"], d_j["sim_time"])
    f_t = tp.final_state(state_to_torch([x], "cpu"))
    assert _rel(f_t, jp.final_state([jnp.asarray(x)])) < 1e-12
    assert _rel(f_t, d_t["u_final"]) < 1e-12


@pytest.mark.parametrize("kind", ["sh23", "shb23"])
def test_advance_state_composes_exactly_and_matches_jax(kind):
    tp, jp = _pair(f"{kind}-matmul", 1)
    x = _x(tp)
    s0_t = tp.initial_state(state_to_torch([x], "cpu"))
    s0_j = jp.initial_state([jnp.asarray(x)])
    assert s0_t.keys() == s0_j.keys()
    whole = tp.advance_state(s0_t, 12)
    parts = tp.advance_state(tp.advance_state(s0_t, 7), 5)
    for k in whole:
        assert torch.equal(whole[k], parts[k])
        assert _rel(whole[k], jp.advance_state(s0_j, 12)[k]) < 1e-12
    f_t, f_j = tp.state_fields(whole), jp.state_fields(jp.advance_state(s0_j, 12))
    assert f_t.keys() == f_j.keys()
    assert _rel(f_t["u"], f_j["u"]) < 1e-12
    # a full-length advance lands on the solver's final state
    assert _rel(tp.state_fields(tp.advance_state(s0_t, N))["u"],
                tp.final_state(state_to_torch([x], "cpu"))) < 1e-12


@pytest.mark.parametrize("n,stride", [(30, 1), (30, 3), (30, 7), (5, 9), (12, 12)])
def test_strided_scan_J_bitwise_the_plain_integration(n, stride):
    np.testing.assert_array_equal(tscan.strided_steps(n, stride),
                                  jscan.strided_steps(n, stride))
    m = torch.as_tensor(np.random.RandomState(0).randn(8, 8) * 0.3)

    def step(u):
        return torch.mv(m, u) + 0.1 * u * u

    def energy(u):
        return torch.sum(u * u)

    u0 = torch.as_tensor(np.random.RandomState(1).randn(8) * 0.5)
    uT, J, ser = tscan.strided_energy_scan(step, energy, u0, n, stride,
                                           torch.float64, 0.05)
    u, acc, energies = u0, tscan.kahan_zero(torch.float64), []
    for _ in range(n):
        energies.append(energy(u))
        acc = tscan.kahan_add(acc, energies[-1])
        u = step(u)
    energies.append(energy(u))
    acc = tscan.kahan_add(acc, energies[-1])
    assert torch.equal(J, 0.05 * acc[0]) and torch.equal(uT, u)
    steps = torch.as_tensor(tscan.strided_steps(n, stride))
    assert torch.equal(ser, torch.stack(energies)[steps])


@pytest.mark.parametrize("case", list(CASES))
def test_has_fused_diagnostics_on_every_method_as_jax(case):
    """SH23 (`matmul`, `fft`, `cuda`) and SHB23 (`matmul`, `cuda`) expose
    `has_fused_diagnostics` True on the CPU, as the JAX problems do (a
    fused archiver reads it)."""
    tp, jp = _pair(case, 1)
    assert jp.has_fused_diagnostics is True
    assert tp.has_fused_diagnostics is True
