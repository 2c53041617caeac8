"""Fused integrators of the PyTorch port (plain versions, wrappers and the
autograd Functions) against the JAX package's Pallas kernels, run in
interpret mode on the CPU, and against its XLA matmul paths:

  shared-matrix (SH23)  `FusedObjectiveShared`, `FusedObjectiveSharedDiag`
                        vs `fused_objective_shared(_diag)`
  two-matrix (SHB23)    `FusedObjective`, `FusedObjectiveDiag`
                        vs `fused_objective(_diag)`

Size: SH23 at npts=64 (mg=128), SHB23 at npts=96, n_iters=40. Tolerances:
  * f32 vs the interpret-mode kernel: J rel 1e-5, lambda and the
    operator cotangents rel 1e-4. Both run the same f32 recurrence, but
    the dot products and energy sums are taken in another order, and
    lambda carries 40 steps of it.
  * f64 vs the JAX matmul path: rel 1e-12 (SH23's step u/dt is lin*u
    here, an ulp apart; nothing else differs).
  * the series variants: J and lambda bitwise equal to the plain ones.
  * the operator cotangents with op_grads left at its default (True, as
    in JAX): rel 1e-5 of `jax.grad` of the interpret-mode kernel.
  * the lambda history and `op_grads_plain` against the step-by-step
    op_grads sweeps in f64: rel 1e-12.
  * the product kernel's 3xTF32 arithmetic, emulated with integer
    operations on the bits: within 1e-5 of the largest entry of the f64
    product and 1e-4 of the plain f32 loop (the split keeps ~2^-22 of
    each operand; the dropped lo.lo term is of that order).
The kernels themselves run only on the card: the `requires_cuda` cases
hold them against the plain versions there and skip on the CPU. The
machine with the card has no JAX, so JAX is imported only by the
fixtures of the CPU cases, and the card's cases run without the JAX
conftest:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_fused_kernel.py
"""

import numpy as np
import pytest
import torch

from spheremanopt_torch.ops.cuda import build as kbuild
from spheremanopt_torch.ops.cuda import fused_two_matrix as fk
from spheremanopt_torch.solvers.scan_utils import kahan_add, kahan_zero
from spheremanopt_torch.problems.swift_hohenberg import SH23Config as TConfig
from spheremanopt_torch.problems.swift_hohenberg import SwiftHohenberg as TSH
from spheremanopt_torch.problems.swift_hohenberg_bounded import (
    SHB23Config as TBConfig,
)
from spheremanopt_torch.problems.swift_hohenberg_bounded import (
    SwiftHohenbergBounded as TSHB,
)

NPTS, N = 64, 40
C2, C3 = 1.8, -1.0


@pytest.fixture(scope="module")
def sh23():
    """JAX matmul problem (f64), its operators, and a seeded u0 = P x."""
    from spheremanopt_tpu.problems.swift_hohenberg import SH23Config as JConfig
    from spheremanopt_tpu.problems.swift_hohenberg import SwiftHohenberg as JSH

    p = JSH(JConfig(npts=NPTS, n_iters=N))
    mg = p.basis.n_grid
    x = np.random.RandomState(5).randn(mg)
    x *= np.sqrt(p.cfg.e0 / np.mean(x * x))
    return dict(p=p, mg=mg, x=x, M=np.asarray(p._M), P=np.asarray(p._P),
                dt=p.cfg.dt, lin=1.0 / p.cfg.dt)


def _ops(s, dtype):
    npd = np.float32 if dtype == torch.float32 else np.float64
    b = s["M"].astype(npd)
    w = np.full(s["mg"], 1.0 / s["mg"], npd)
    u0 = (s["P"].astype(npd) @ s["x"].astype(npd)).astype(npd)
    return b, w, u0


def _jax_kernel(s, argnums, op_grads=False):
    """(-J, grads) of the Pallas kernel (interpret mode) in f32."""
    import jax
    import jax.numpy as jnp

    from spheremanopt_tpu.ops.pallas.fused_two_matrix import fused_objective_shared

    b, w, u0 = (jnp.asarray(a) for a in _ops(s, torch.float32))

    def f(b, w, u0):
        return fused_objective_shared(b, w, u0, C2, C3, s["lin"], s["dt"], N,
                                      True, op_grads)

    return jax.value_and_grad(f, argnums=argnums)(b, w, u0)


def _torch_objective(s, dtype, requires=(False, False, True), op_grads=False):
    b, w, u0 = (torch.tensor(a, requires_grad=r)
                for a, r in zip(_ops(s, dtype), requires))
    J = fk.FusedObjectiveShared.apply(b, w, u0, C2, C3, s["lin"], s["dt"], N,
                                      op_grads)
    return J, (b, w, u0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_plain_f32_matches_interpret_kernel(sh23):
    J_j, (dw_j, lam_j) = _jax_kernel(sh23, (1, 2))
    J_t, (b, w, u0) = _torch_objective(sh23, torch.float32, (False, True, True))
    dw_t, lam_t = torch.autograd.grad(J_t, (w, u0))
    assert J_t.dtype == torch.float32
    assert _rel(J_t.detach(), J_j) < 1e-5
    assert _rel(lam_t, lam_j) < 1e-4
    assert _rel(dw_t, dw_j) < 1e-4


def test_plain_f32_operator_cotangent_matches_interpret_kernel(sh23):
    """op_grads=True (plain path only): dB = sum_n lambda_{n+1} (x) v(u_n)."""
    _, db_j = _jax_kernel(sh23, 0, op_grads=True)
    J_t, (b, _, _) = _torch_objective(sh23, torch.float32, (True, False, False),
                                      op_grads=True)
    db_t, = torch.autograd.grad(J_t, b)
    assert _rel(db_t, db_j) < 1e-4


def test_operator_gradient_by_default_matches_jax_grad(sh23):
    """FusedObjectiveShared without an op_grads argument is differentiable
    in B, as `fused_objective_shared` is with its default."""
    _, db_j = _jax_kernel(sh23, 0, op_grads=True)
    b, w, u0 = (torch.tensor(a) for a in _ops(sh23, torch.float32))
    b.requires_grad_(True)
    J = fk.FusedObjectiveShared.apply(b, w, u0, C2, C3, sh23["lin"], sh23["dt"], N)
    db_t, = torch.autograd.grad(J, b)
    assert _rel(db_t, db_j) < 1e-5


@pytest.mark.parametrize("mode", ["shared", "two"])
def test_lam_hist_and_op_grads_plain_match_step_by_step_f64(sh23, shb23, mode):
    """The lambda history (the wrappers on CPU tensors: the plain sweeps)
    and `op_grads_plain` give the operator cotangents of the step-by-step
    op_grads sweeps (f64, rel 1e-12), with lambda_0 unchanged by the
    history."""
    scale = torch.tensor(-0.1, dtype=torch.float64)
    if mode == "shared":
        b, w, u0 = (torch.as_tensor(a) for a in _ops(sh23, torch.float64))
        uT, _, traj, _ = fk.fused_fwd_shared_plain(b, w, u0, C2, C3, sh23["lin"], N)
        args = (b, w, uT, traj, C2, C3, sh23["lin"], scale, N)
        lam_s, *want = fk.fused_bwd_shared_plain(*args, op_grads=True)
        bwd, c, lin = fk.fused_bwd_shared, (C2, C3), sh23["lin"]
    else:
        a, b, w, u0 = (torch.as_tensor(x) for x in _ops2(shb23, torch.float64))
        uT, _, traj, _ = fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, N)
        args = (a, b, w, uT, traj, C2B, C3B, scale, N)
        lam_s, *want = fk.fused_bwd_plain(*args, op_grads=True)
        bwd, c, lin = fk.fused_bwd, (C2B, C3B), 0.0
    hist = torch.full_like(traj, float("nan"))
    lam_h = bwd(*args, lam_hist=hist)[0]
    assert torch.equal(lam_h, bwd(*args)[0]) and torch.equal(lam_h, lam_s)
    assert torch.equal(hist[-1], scale * (w * uT))   # lambda_N
    got = fk.op_grads_product(hist, traj, mode, *c, lin)   # CPU: the plain version
    assert len(got) == len(want) == (1 if mode == "shared" else 2)
    for g, x in zip(got, want):
        assert _rel(g, x) < 1e-12
    with pytest.raises(ValueError, match="mode"):
        fk.op_grads_plain(hist, traj, "three", *c, lin)


def test_plain_sweeps_match_interpret_kernel_directly(sh23):
    """The raw plain sweeps (not through autograd): J_sum and lambda_0."""
    b, w, u0 = (torch.as_tensor(a) for a in _ops(sh23, torch.float32))
    uT, jsum, traj, ser = fk.fused_fwd_shared_plain(b, w, u0, C2, C3, sh23["lin"], N)
    assert traj.shape == (N, sh23["mg"]) and torch.equal(traj[0], u0)
    assert ser is None
    scale = torch.tensor(-2.0 * sh23["dt"], dtype=torch.float32)
    lam, db = fk.fused_bwd_shared_plain(b, w, uT, traj, C2, C3, sh23["lin"],
                                        scale, N)
    J_j, lam_j = _jax_kernel(sh23, 2)
    assert db is None
    assert _rel(-sh23["dt"] * jsum, J_j) < 1e-5
    assert _rel(lam, lam_j) < 1e-4


def test_plain_f64_matches_jax_matmul_path(sh23):
    p, n_grid = sh23["p"], sh23["mg"]
    J_j, g_j = p.objective_and_gradient([sh23["x"]])
    P = torch.as_tensor(sh23["P"])
    x = torch.tensor(sh23["x"], requires_grad=True)
    b, w, _ = (torch.as_tensor(a) for a in _ops(sh23, torch.float64))
    J_t = fk.FusedObjectiveShared.apply(b, w, torch.mv(P, x), C2, C3,
                                        sh23["lin"], sh23["dt"], N)
    g_t, = torch.autograd.grad(J_t, x)
    assert _rel(J_t.detach(), J_j) < 1e-12
    assert _rel(g_t * n_grid, g_j[0]) < 1e-12


def test_primal_only_call_stores_no_trajectory(sh23, monkeypatch):
    seen = []
    real = fk.fused_fwd_shared

    def spy(*a, **kw):
        seen.append(kw["store_traj"])
        return real(*a, **kw)

    monkeypatch.setattr(fk, "fused_fwd_shared", spy)
    _torch_objective(sh23, torch.float32, (False, False, False))
    _torch_objective(sh23, torch.float32, (False, False, True))
    assert seen == [False, True]


def test_cpu_tensors_take_the_plain_version(sh23):
    fk.reset_launches()
    b, w, u0 = (torch.as_tensor(a) for a in _ops(sh23, torch.float32))
    got = fk.fused_fwd_shared(b, w, u0, C2, C3, sh23["lin"], N)
    want = fk.fused_fwd_shared_plain(b, w, u0, C2, C3, sh23["lin"], N)
    for g, x in zip(got[:3], want[:3]):
        assert torch.equal(g, x)
    assert got[3] is None and want[3] is None
    scale = torch.tensor(-0.1, dtype=torch.float32)
    lam, _ = fk.fused_bwd_shared(b, w, got[0], got[2], C2, C3, sh23["lin"], scale, N)
    assert torch.equal(lam, fk.fused_bwd_shared_plain(
        b, w, got[0], got[2], C2, C3, sh23["lin"], scale, N)[0])
    assert not any(fk.LAUNCHES.values())


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No fallback: a missing compiler is an error, not a CPU path."""
    monkeypatch.setattr(kbuild.shutil, "which", lambda name: None)
    monkeypatch.setattr(kbuild, "CUDA_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(kbuild, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.build()
    assert not (tmp_path / "build").exists()


def test_signatures_name_the_exported_functions():
    """Every C function that csrc/*.cu exports has a ctypes signature, and
    every signature names one: `load` binds each of them."""
    import re

    exported = {m for src in kbuild.CSRC.glob("*.cu")
                for m in re.findall(r"^int (sm_\w+)\(", src.read_text(), re.M)}
    assert exported == set(kbuild.SIGNATURES)


def test_library_path_tracks_sources_and_flags(monkeypatch):
    base = kbuild.library_path()
    assert base.parent.parent == kbuild.BUILD_ROOT
    monkeypatch.setattr(kbuild, "NVCC_FLAGS", kbuild.NVCC_FLAGS + ["-DX"])
    assert kbuild.library_path() != base


def test_series_variant_leaves_J_and_lambda_bitwise(sh23):
    """FusedObjectiveSharedDiag: J and the u0 gradient bitwise those of
    FusedObjectiveShared; the series are the energies the Kahan sum
    consumes; the aux outputs carry no gradient."""
    J_p, (_, _, u0p) = _torch_objective(sh23, torch.float32)
    g_p, = torch.autograd.grad(J_p, u0p)
    b, w, u0 = (torch.tensor(a) for a in _ops(sh23, torch.float32))
    u0.requires_grad_(True)
    J_d, ser, uT = fk.FusedObjectiveSharedDiag.apply(
        b, w, u0, C2, C3, sh23["lin"], sh23["dt"], N, False)
    assert not ser.requires_grad and not uT.requires_grad
    g_d, = torch.autograd.grad(J_d, u0)
    assert torch.equal(J_d.detach(), J_p.detach()) and torch.equal(g_d, g_p)
    plain = fk.fused_fwd_shared_plain(b, w, u0.detach(), C2, C3, sh23["lin"], N,
                                      store_series=True)
    assert ser.shape == (N + 1,) and torch.equal(ser, plain[3])
    assert torch.equal(uT, plain[0])
    # the JAX diag kernel's series (interpret mode), f32 sums in another order
    import jax.numpy as jnp

    from spheremanopt_tpu.ops.pallas.fused_two_matrix import (
        fused_objective_shared_diag,
    )
    _, ser_j, uT_j = fused_objective_shared_diag(
        *(jnp.asarray(a) for a in _ops(sh23, torch.float32)), C2, C3,
        sh23["lin"], sh23["dt"], N, True, False)
    assert _rel(ser, ser_j) < 1e-5 and _rel(uT, uT_j) < 1e-5


# ---------------------------------------------------------------------------
# two-matrix form (SHB23)
# ---------------------------------------------------------------------------

NB = 96
C2B, C3B = 2.0, -1.0


@pytest.fixture(scope="module")
def shb23():
    """JAX SHB23 matmul problem (f64), its operators, and a seeded u0."""
    from spheremanopt_tpu.problems.swift_hohenberg_bounded import (
        SHB23Config as JBConfig,
    )
    from spheremanopt_tpu.problems.swift_hohenberg_bounded import (
        SwiftHohenbergBounded as JSHB,
    )

    p = JSHB(JBConfig(npts=NB, n_iters=N))
    u = np.random.RandomState(6).randn(NB)
    u *= np.sqrt(p.cfg.m0 / np.sum(np.asarray(p._w) * u * u))
    return dict(p=p, A=np.asarray(p._A_lin), B=np.asarray(p._A_nl),
                w=np.asarray(p._w), u0=u, dt=p.cfg.dt)


def _ops2(s, dtype):
    npd = np.float32 if dtype == torch.float32 else np.float64
    return tuple(s[k].astype(npd) for k in ("A", "B", "w", "u0"))


def _jax_kernel2(s, argnums, op_grads=False):
    """(-J, grads) of the two-matrix Pallas kernel (interpret mode), f32."""
    import jax
    import jax.numpy as jnp

    from spheremanopt_tpu.ops.pallas.fused_two_matrix import fused_objective

    def f(a, b, w, u0):
        return fused_objective(a, b, w, u0, C2B, C3B, s["dt"], N, True, op_grads)

    return jax.value_and_grad(f, argnums=argnums)(
        *(jnp.asarray(x) for x in _ops2(s, torch.float32)))


def _torch_objective2(s, dtype, requires, op_grads=False, diag=False):
    ts = tuple(torch.tensor(x, requires_grad=r)
               for x, r in zip(_ops2(s, dtype), requires))
    fn = fk.FusedObjectiveDiag if diag else fk.FusedObjective
    out = fn.apply(*ts, C2B, C3B, s["dt"], N, op_grads)
    return out, ts


def test_two_matrix_plain_f32_matches_interpret_kernel(shb23):
    J_j, (dw_j, lam_j) = _jax_kernel2(shb23, (2, 3))
    J_t, (_, _, w, u0) = _torch_objective2(shb23, torch.float32,
                                           (False, False, True, True))
    dw_t, lam_t = torch.autograd.grad(J_t, (w, u0))
    assert J_t.dtype == torch.float32
    assert _rel(J_t.detach(), J_j) < 1e-5
    assert _rel(lam_t, lam_j) < 1e-4
    assert _rel(dw_t, dw_j) < 1e-4


def test_two_matrix_operator_cotangents_match_interpret_kernel(shb23):
    """op_grads=True (plain path only): dA = sum lambda (x) u_n,
    dB = sum lambda (x) g(u_n), rel 1e-4 of the interpret-mode kernel."""
    _, (da_j, db_j) = _jax_kernel2(shb23, (0, 1), op_grads=True)
    J_t, (a, b, _, _) = _torch_objective2(shb23, torch.float32,
                                          (True, True, False, False),
                                          op_grads=True)
    da_t, db_t = torch.autograd.grad(J_t, (a, b))
    assert _rel(da_t, da_j) < 1e-4
    assert _rel(db_t, db_j) < 1e-4


def test_two_matrix_operator_gradients_by_default_match_jax_grad(shb23):
    """FusedObjective without an op_grads argument gives (dA, dB), as
    `fused_objective` does with its default."""
    _, (da_j, db_j) = _jax_kernel2(shb23, (0, 1), op_grads=True)
    a, b, w, u0 = (torch.tensor(x) for x in _ops2(shb23, torch.float32))
    a.requires_grad_(True)
    b.requires_grad_(True)
    J = fk.FusedObjective.apply(a, b, w, u0, C2B, C3B, shb23["dt"], N)
    da_t, db_t = torch.autograd.grad(J, (a, b))
    assert _rel(da_t, da_j) < 1e-5
    assert _rel(db_t, db_j) < 1e-5


def test_two_matrix_plain_f64_matches_jax_matmul_path(shb23):
    p = shb23["p"]
    J_j, g_j = p.objective_and_gradient([shb23["u0"]])
    J_t, (_, _, _, u0) = _torch_objective2(shb23, torch.float64,
                                           (False, False, False, True))
    g_t, = torch.autograd.grad(J_t, u0)
    assert _rel(J_t.detach(), J_j) < 1e-12
    assert _rel(g_t / torch.as_tensor(shb23["w"]), g_j[0]) < 1e-12


def test_two_matrix_series_variant_bitwise_and_aux_without_gradient(shb23):
    """FusedObjectiveDiag: J, lambda and dw bitwise FusedObjective's; the
    series and u_T match the JAX diag kernel; the aux outputs are
    detached, so only J's cotangent flows."""
    req = (False, False, True, True)
    J_p, (_, _, w_p, u_p) = _torch_objective2(shb23, torch.float32, req)
    g_p = torch.autograd.grad(J_p, (w_p, u_p))
    (J_d, ser, uT), (_, _, w_d, u_d) = _torch_objective2(
        shb23, torch.float32, req, diag=True)
    assert not ser.requires_grad and not uT.requires_grad
    with pytest.raises(RuntimeError):
        torch.autograd.grad(ser.sum(), u_d)
    g_d = torch.autograd.grad(J_d, (w_d, u_d))
    assert torch.equal(J_d.detach(), J_p.detach())
    assert all(torch.equal(x, y) for x, y in zip(g_d, g_p))
    assert ser.shape == (N + 1,)

    import jax.numpy as jnp

    from spheremanopt_tpu.ops.pallas.fused_two_matrix import fused_objective_diag
    J_j, ser_j, uT_j = fused_objective_diag(
        *(jnp.asarray(x) for x in _ops2(shb23, torch.float32)), C2B, C3B,
        shb23["dt"], N, True, False)
    assert _rel(J_d.detach(), J_j) < 1e-5
    assert _rel(ser, ser_j) < 1e-5 and _rel(uT, uT_j) < 1e-5


def test_two_matrix_wrappers_take_the_plain_version_on_cpu(shb23):
    fk.reset_launches()
    a, b, w, u0 = (torch.as_tensor(x) for x in _ops2(shb23, torch.float32))
    got = fk.fused_fwd(a, b, w, u0, C2B, C3B, N, store_series=True)
    want = fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, N, store_series=True)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert got[2].shape == (N, NB) and torch.equal(got[2][0], u0)
    # the energies the Kahan sum consumed, in order
    e = torch.stack([torch.sum(w * u * u) for u in list(got[2]) + [got[0]]])
    assert torch.equal(got[3], e)
    scale = torch.tensor(-0.02, dtype=torch.float32)
    lam, da, db = fk.fused_bwd(a, b, w, got[0], got[2], C2B, C3B, scale, N)
    assert da is None and db is None
    assert torch.equal(lam, fk.fused_bwd_plain(a, b, w, got[0], got[2], C2B,
                                               C3B, scale, N)[0])
    assert not any(fk.LAUNCHES.values())


def test_two_matrix_primal_only_call_stores_no_trajectory(shb23, monkeypatch):
    seen = []
    real = fk.fused_fwd

    def spy(*a, **kw):
        seen.append((kw["store_traj"], kw.get("store_series", False)))
        return real(*a, **kw)

    monkeypatch.setattr(fk, "fused_fwd", spy)
    _torch_objective2(shb23, torch.float32, (False,) * 4)
    _torch_objective2(shb23, torch.float32, (False, False, False, True))
    _torch_objective2(shb23, torch.float32, (False,) * 4, diag=True)
    assert seen == [(False, False), (True, False), (False, True)]


# ---------------------------------------------------------------------------
# the product kernel's 3xTF32 arithmetic and the forward's routes (CPU)
# ---------------------------------------------------------------------------


def _tf32_rna(x):
    """cvt.rna.tf32.f32 on an f32 tensor: round to nearest, ties away from
    zero, at a 10-bit mantissa, with integer operations on the bits (add
    half a TF32 ulp to the magnitude, clear the 13 low bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _product_3xtf32(lam_hist, fcat):
    """The kernel's product Lambda^T f(U) as 3xTF32: both operands split
    into hi + lo, the TF32 products lo.hi + hi.lo + hi.hi summed in f32
    (each product of two TF32 values is exact in f32)."""
    ah, al = _split(lam_hist.t())
    bh, bl = _split(fcat)
    return al @ bh + ah @ bl + ah @ bh


def test_tf32_emulation_rounds_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 4,
                      1.0 + 3 * ulp / 4, 3.0e-3], dtype=torch.float32)
    got = _tf32_rna(x)
    assert got[:4].tolist() == [1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + ulp]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    hi, lo = _split(x)
    assert ((x - hi - lo).abs() <= 2.0 ** -21 * x.abs()).all()


@pytest.mark.parametrize("mode", ["shared", "two"])
def test_3xtf32_split_product_keeps_f32_accuracy(mode):
    """The product kernel's 3xTF32 split (emulated) against the f64
    product: within 1e-5 of the largest entry; against the plain f32 loop
    (`op_grads_plain`): within 1e-4. mg = 256, N = 500, seeded data at
    the sweeps' scale."""
    rs = np.random.RandomState(11)
    mg, n = 256, 500
    lam = torch.as_tensor(rs.randn(n, mg), dtype=torch.float32)
    traj = torch.as_tensor(0.3 * rs.randn(n, mg), dtype=torch.float32)
    c, lin = ((C2, C3), 20.0) if mode == "shared" else ((C2B, C3B), 0.0)
    fcat = torch.cat(fk.op_factors(traj, mode, *c, lin), dim=1)
    got = _product_3xtf32(lam, fcat)
    want64 = lam.double().t() @ fcat.double()
    plain = torch.cat(fk.op_grads_plain(lam, traj, mode, *c, lin), dim=1)
    scale = want64.abs().max()
    assert (got.double() - want64).abs().max() <= 1e-5 * scale
    assert (got - plain).abs().max() <= 1e-4 * plain.abs().max()
    # one TF32 product alone is three digits: the split is what keeps f32
    tf32 = _tf32_rna(lam.t()) @ _tf32_rna(fcat)
    assert (tf32.double() - want64).abs().max() > 1e-5 * scale


@pytest.mark.parametrize("mg,n_steps,n_out,blocks", [
    (512, 2000, 2, 128), (512, 1000, 1, 128), (128, 300, 1, 19),
    (128, 0, 2, 2), (1024, 2000, 2, 128), (2048, 17, 2, 512)])
def test_op_grads_split_covers_the_steps(mg, n_steps, n_out, blocks):
    """Every step lies in exactly one chunk, chunks are whole stages, and
    tiles x splits blocks fill the card about once (SH23, SHB23: 128)."""
    chunk, splits = fk.op_grads_split(mg, n_steps, n_out)
    assert chunk % fk.OP_STAGE == 0 and splits >= 1
    assert (splits - 1) * chunk < max(n_steps, 1) <= splits * chunk
    tiles = (mg // fk.OP_TILE) * (n_out * mg // fk.OP_TILE)
    assert tiles * splits == blocks


def _grid_smem(mg, rows, rows_b):
    """Shared memory of one CTA of the grid forward (csrc/fused_two_matrix.cu
    `grid_smem_bytes`): its rows of A, rows_b of its rows of B, u, g and w,
    32 warp sums."""
    return 4 * ((rows + rows_b) * mg + 3 * mg + 32)


@pytest.mark.parametrize("mg", range(128, 2049, 128))
def test_forward_route_by_width(mg):
    """The grid at every width on an H100 SXM: ceil(mg / 132) rows of A
    and 3 mg + 32 floats of state fit each of its 132 SMs (227 KB). All
    of a CTA's B rows fit beside them up to mg = 1792; above, as many as
    fit stay and the others are read from L2."""
    rows = -(-mg // 132)
    assert _grid_smem(mg, rows, 0) <= 232448
    assert fk.fwd_route(mg) == "grid"
    _, _, rows_b = fk.fwd_grid_partition(mg, fk.H100_SXM)
    assert (rows_b == rows) == (mg <= 1792)
    assert _grid_smem(mg, rows, rows_b) <= 232448


@pytest.mark.parametrize("mg", range(128, 2049, 128))
def test_shared_reverse_route_by_width(mg):
    """The shared-matrix reverse sweep's cluster while B's columns fit 16
    SMs' shared memory (227 KB each: mg^2 4 / 16 bytes of columns, lambda
    twice, the P x mg / 16 partial sums, w and u_n of the columns); above,
    the grid on an H100 SXM (132 SMs) and PCIe (114): the P x cols chains
    of B's ceil(mg / SMs) columns, lambda's P chains and the P x cols
    partial sums fit each SM's 227 KB, and a CTA's 256 threads cover its
    (phase, column) pairs. On a card of 16 SMs the grid's columns do not
    fit above mg = 896, and the one-block kernel takes those widths."""
    phases = 1024 // (mg // 4)
    smem = 4 * (mg * mg // 16 + 2 * mg + phases * mg // 16 + 2 * mg // 16)
    assert (smem <= 232448) == (mg <= fk.SHARED_CLUSTER_MG_MAX)
    want = "cluster" if mg <= fk.SHARED_CLUSTER_MG_MAX else "grid"
    assert fk.shared_bwd_route(mg) == want
    ts = _chain(-(-mg // phases))
    for sms in (132, 114):
        cols = -(-mg // sms)
        smem = 4 * (phases * (cols + 1) * ts + phases * cols)
        assert fk.shared_bwd_grid_smem_bytes(mg, cols) == smem <= 232448
        assert phases * cols <= 256
        assert fk.shared_bwd_route(mg, (sms, 232448)) == want
    assert fk.shared_bwd_route(mg, (16, 232448)) == ("cluster" if mg <= 896 else "block")


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("mg", range(128, 1793, 128))
def test_forward_grid_partition_covers_every_row_once(mg, sms):
    """The grid route's rows: ceil(mg / rows) <= sms CTAs of `rows`
    contiguous rows (the last one short or full) cover 0 .. mg - 1 once;
    on the H100 SXM's 132 SMs every width up to 1792 keeps all of a CTA's
    rows of A and B in a block's shared memory."""
    rows, ctas, rows_b = fk.fwd_grid_partition(mg, (sms, 232448))
    assert (rows, ctas) == fk.grid_partition(mg, sms)
    assert 1 <= ctas <= sms
    owned = [r for c in range(ctas) for r in range(c * rows, min((c + 1) * rows, mg))]
    assert owned == list(range(mg))
    assert all(min((c + 1) * rows, mg) > c * rows for c in range(ctas))
    assert fk.grid_smem_bytes(mg, rows, rows) == _grid_smem(mg, rows, rows)
    if sms == 132:
        assert rows_b == rows and _grid_smem(mg, rows, rows) <= 232448


@pytest.mark.parametrize("sms,top", [(132, 1792), (114, 1664), (78, 1408)])
def test_forward_grid_route_follows_the_card(sms, top):
    """The grid route's widths depend on the card: it takes a width while
    ceil(mg / SMs) rows of A and the state fit one block's 227 KB (every
    width on an H100 SXM's 132 SMs and an H100 PCIe's 114, up to 1920 on
    78), and keeps all of a CTA's B rows beside them up to `top`; the
    one-block kernel takes every width above the route, never the grid."""
    card = (sms, 232448)
    for mg in range(128, 2049, 128):
        rows, _, rows_b = fk.fwd_grid_partition(mg, card)
        fits = _grid_smem(mg, rows, 0) <= 232448
        assert fk.fwd_route(mg, card) == ("grid" if fits else "block")
        assert (fits and rows_b == rows) == (mg <= top)
        if fits:
            assert _grid_smem(mg, rows, rows_b) <= 232448
            assert rows_b == rows or _grid_smem(mg, rows, rows_b + 1) > 232448
    assert fk.fwd_route(2048, card) == ("block" if sms == 78 else "grid")


@pytest.mark.parametrize("mg", range(128, 2049, 128))
@pytest.mark.parametrize("card", [(132, 232448), (114, 232448)])
def test_forward_grid_split_partition(card, mg):
    """The grid route's split of B on an H100 SXM (132 SMs) and PCIe
    (114): every row is owned once; a CTA's A rows, its first rows_b B
    rows and the state fit one block's 227 KB; the B rows read from L2
    (local rows rows_b .. nr - 1, warp w taking rows w, w + 8, ... of
    the CTA's 8 warps) differ by at most one between the warps. At
    mg = 2048: 9 of 16 rows kept on the SXM, 7 of 18 on the PCIe card."""
    rows, ctas, rows_b = fk.fwd_grid_partition(mg, card)
    assert 0 <= rows_b <= rows
    owned = [r for c in range(ctas) for r in range(c * rows, min((c + 1) * rows, mg))]
    assert owned == list(range(mg))
    assert fk.grid_smem_bytes(mg, rows, rows_b) == _grid_smem(mg, rows, rows_b) <= card[1]
    for c in range(ctas):
        nr = min(rows, mg - c * rows)
        per_warp = [sum(1 for rl in range(rows_b, nr) if rl % 8 == w) for w in range(8)]
        assert max(per_warp) - min(per_warp) <= 1
    if mg == 2048:
        assert (rows, rows_b) == ((16, 9) if card[0] == 132 else (18, 7))


@pytest.fixture
def one_thread():
    """Step loops of small torch ops: with several test workers on one
    host, torch's intra-op threads fight over the cores. One thread is as
    fast alone and does not degrade."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cluster_reverse(b, w, uT, traj, c2, c3, lin, scale, n, lam_hist):
    """The shared-matrix reverse cluster (csrc/fused_shared.cu) in plain
    torch: rank r of 16 owns columns [r C, (r + 1) C), C = mg / 16; its
    thread (p, col) sums rows p, p + P, ... of its column in ascending
    order (P = 1024 / (mg / 4), the one-block kernel's row phases); each
    entry adds the P partials in phase order and applies the update from
    the rank's slice of u_n. Row n of lam_hist gets lambda_{n+1}."""
    mg = b.shape[0]
    C, P = mg // 16, 1024 // (mg // 4)
    assert P * C <= 256   # one thread of a 256-thread CTA per (phase, column)
    lam = scale * (w * uT)
    for k in range(n):
        row = n - 1 - k
        u = traj[row]
        lam_hist[row] = lam
        new = torch.empty_like(lam)
        for r in range(16):
            cols = slice(r * C, (r + 1) * C)
            part = torch.zeros((P, C), dtype=lam.dtype)
            for m in range(-(-mg // P)):   # the m-th term of each phase's chain
                i = torch.arange(m * P, min((m + 1) * P, mg))
                part[: len(i)] += b[i, cols] * lam[i, None]
            wb = torch.zeros(C, dtype=lam.dtype)
            for q in range(P):
                wb = wb + part[q]
            uc = u[cols]
            new[cols] = (lin + 2.0 * c2 * uc + 3.0 * c3 * uc * uc) * wb + scale * (w[cols] * uc)
        lam = new
    return lam


@pytest.mark.parametrize("mg", [128, 256])
def test_shared_cluster_reverse_partition_matches_plain(mg, one_thread):
    """The cluster reverse's column partition and summation order (plain
    torch, f32) against `fused_bwd_shared_plain` on SH23's operators at
    width mg (npts = mg / 2), N = 20: lambda_0 and the lambda history
    within rel 1e-6 (f32 sums in another order over 20 steps)."""
    p = TSH(TConfig(npts=mg // 2, dtype="float32", method="matmul"), device="cpu")
    b = p._Mt.float().contiguous()
    w = torch.full((mg,), 1.0 / mg)
    x = torch.as_tensor(np.random.RandomState(mg).randn(mg), dtype=torch.float32)
    u0 = torch.mv(p._Pt.float(), x) * 0.3
    lin, n = 1.0 / p.cfg.dt, 20
    uT, _, traj, _ = fk.fused_fwd_shared_plain(b, w, u0, C2, C3, lin, n)
    scale = torch.tensor(-2.0 * p.cfg.dt, dtype=torch.float32)
    hist_p, hist_c = torch.empty_like(traj), torch.empty_like(traj)
    lam_p, _ = fk.fused_bwd_shared_plain(b, w, uT, traj, C2, C3, lin, scale, n,
                                         lam_hist=hist_p)
    lam_c = _cluster_reverse(b, w, uT, traj, C2, C3, lin, scale, n, hist_c)
    assert _rel(lam_c, lam_p) < 1e-6 and _rel(hist_c, hist_p) < 1e-6


def _cta_columns(flat, mg, cols, ctas, first, count, rows):
    """Each CTA's `count` columns from its column `first` on, rows
    `rows`, gathered from the flat row-major (mg, mg) matrix by the
    kernels' index arithmetic (row i, column c0 + c at i mg + c0 + c),
    zero past column mg: (ctas, len(rows), count)."""
    c0 = torch.arange(ctas)[:, None, None] * cols
    c = first + torch.arange(count)[None, None, :]
    idx = rows[None, :, None] * mg + c0 + c
    return torch.where(c0 + c < mg, flat[idx.clamp(max=mg * mg - 1)], 0.0)


def _staged_chunk(bperm, mg, cols, ctas, cols_b, j):
    """Chunk j (rows j STAGE_ROWS on, STAGE_ROWS of them or what is left)
    of each CTA's staged B columns as the kernel copies it from
    `phase_ordered` B: term t of the chain of phase p of staged column c
    at (c0 + cols_b) mg + (c P + p) (mg / P) + j (STAGE_ROWS / P) + t, put
    back in row order: (ctas, rows, cols - cols_b), zero past column mg."""
    P, R = fk.row_phases(mg), fk.STAGE_ROWS
    ns, tpc = cols - cols_b, R // P
    r = torch.arange(min(R, mg - j * R))
    c = torch.arange(ns)
    c0 = torch.arange(ctas)[:, None, None] * cols
    idx = ((c0 + cols_b) * mg + (c[None, None, :] * P + (r % P)[None, :, None]) * (mg // P)
           + j * tpc + (r // P)[None, :, None])
    inside = c0 + cols_b + c[None, None, :] < mg
    return torch.where(inside, bperm.reshape(-1)[torch.where(inside, idx, 0)], 0.0)


def _grid_reverse(mode, mats, w, uT, traj, c2, c3, lin, scale, n, sms, cols_b, lam_hist):
    """A grid reverse (csrc/fused_two_matrix.cu, csrc/fused_shared.cu) in
    plain torch, vectorised over the CTAs of `grid_partition(mg, sms)`:
    CTA k keeps its columns of each matrix but the last, and the first
    cols_b of its columns of the last (B); the other B columns are staged
    a chunk of STAGE_ROWS rows at a time from `phase_ordered` B (where P
    divides STAGE_ROWS / 2). Its thread (p, col) sums rows
    p, p + P, ... of its column in ascending order, a chunk at a time, from
    the kept columns or the stage (P = 1024 / (mg / 4), the one-block
    kernel's row phases); each entry adds the P partials in phase order
    and applies the update ("shared": v'(u) B^T lambda; "two":
    A^T lambda + g'(u) B^T lambda). Row n of lam_hist gets lambda_{n+1}."""
    mg, R = w.shape[0], fk.STAGE_ROWS
    cols, ctas = fk.grid_partition(mg, sms)
    P = fk.row_phases(mg)
    assert P * cols <= 256   # one thread of a 256-thread CTA per (phase, column)
    flats = [m.reshape(-1) for m in mats]
    every = torch.arange(mg)
    kept = [_cta_columns(f, mg, cols, ctas, 0, cols, every) for f in flats[:-1]]
    kept.append(_cta_columns(flats[-1], mg, cols, ctas, 0, cols_b, every))
    bperm = fk.phase_ordered(mats[-1]) if cols_b < cols else None
    lam = scale * (w * uT)
    for k in range(n):
        row = n - 1 - k
        lam_hist[row] = lam
        parts = [torch.zeros((ctas, P, cols), dtype=lam.dtype) for _ in mats]
        for r0 in range(0, mg, R):   # one chunk of rows
            last = kept[-1][:, r0:r0 + R]
            if bperm is not None:
                stage = _staged_chunk(bperm, mg, cols, ctas, cols_b, r0 // R)
                last = torch.cat([last, stage], dim=2)
            srcs = [m[:, r0:r0 + R] for m in kept[:-1]] + [last]
            rr = min(R, mg - r0)
            for m in range(-(-rr // P)):   # the next term of each phase's chain
                i = torch.arange(m * P, min((m + 1) * P, rr))
                li = lam[r0 + i][None, :, None]
                for part, src in zip(parts, srcs):
                    part.index_add_(1, (r0 + i) % P, src[:, i] * li)
        sums = []
        for part in parts:
            s = torch.zeros((ctas, cols), dtype=lam.dtype)
            for q in range(P):
                s = s + part[:, q]
            sums.append(s.reshape(-1)[:mg])
        u = traj[row]
        if mode == "shared":
            lam = (lin + 2.0 * c2 * u + 3.0 * c3 * u * u) * sums[0] + scale * (w * u)
        else:
            lam = sums[0] + (2.0 * c2 * u + 3.0 * c3 * u * u) * sums[1] + scale * (w * u)
    return lam


def test_phase_ordered_keeps_each_chain_together():
    """`phase_ordered` B holds B[p + P m, c] at (c P + p) (mg / P) + m, for
    P = 16 (mg = 256) and 2 (mg = 2048)."""
    for mg in (256, 2048):
        b = torch.as_tensor(np.random.RandomState(mg).randn(mg, mg), dtype=torch.float32)
        P = fk.row_phases(mg)
        bp = fk.phase_ordered(b)
        assert bp.is_contiguous() and bp.numel() == mg * mg
        c, p, m = (torch.as_tensor(np.random.RandomState(1).randint(0, k, 64))
                   for k in (mg, P, mg // P))
        assert torch.equal(bp.reshape(-1)[(c * P + p) * (mg // P) + m], b[p + P * m, c])


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("mode", ["shared", "two"])
def test_grid_reverse_partition_matches_plain(mode, sms, one_thread):
    """The grid reverses' column partition, chunked summation order and
    (two matrices) split of B into kept and staged columns, in plain torch
    (f32), against `fused_bwd_shared_plain` / `fused_bwd_plain` on SH23's
    / SHB23's operators at mg = 256, N = 20, on cards of 132, 114 and 78
    SMs: lambda_0 and the lambda history within rel 1e-6 (f32 sums in
    another order over 20 steps); the two-matrix case with all B columns
    kept and with half of them staged."""
    mg, n = 256, 20
    if mode == "shared":
        p = TSH(TConfig(npts=mg // 2, dtype="float32", method="matmul"), device="cpu")
        mats, w = (p._Mt.float().contiguous(),), torch.full((mg,), 1.0 / mg)
        x = torch.as_tensor(np.random.RandomState(mg).randn(mg), dtype=torch.float32)
        u0, c, lin = torch.mv(p._Pt.float(), x) * 0.3, (C2, C3), 1.0 / p.cfg.dt
        uT, _, traj, _ = fk.fused_fwd_shared_plain(*mats, w, u0, *c, lin, n)
        args = (*mats, w, uT, traj, *c, lin)
        plain, splits = fk.fused_bwd_shared_plain, (None,)
    else:
        p = TSHB(TBConfig(npts=mg, dtype="float32", method="matmul"), device="cpu")
        mats = (p._Alt.float().contiguous(), p._Ant.float().contiguous())
        w = p._wt.float().contiguous()
        u0 = torch.as_tensor(np.random.RandomState(mg).randn(mg), dtype=torch.float32)
        u0, c, lin = u0 * torch.sqrt(p.cfg.m0 / torch.sum(w * u0 * u0)), (C2B, C3B), 0.0
        uT, _, traj, _ = fk.fused_fwd_plain(*mats, w, u0, *c, n)
        args = (*mats, w, uT, traj, *c)
        cols = fk.grid_partition(mg, sms)[0]
        plain, splits = fk.fused_bwd_plain, (cols, cols // 2)
    scale = torch.tensor(-2.0 * p.cfg.dt, dtype=torch.float32)
    hist_p = torch.empty_like(traj)
    lam_p = plain(*args, scale, n, lam_hist=hist_p)[0]
    for cols_b in splits:
        cols_b = fk.grid_partition(mg, sms)[0] if cols_b is None else cols_b
        hist_g = torch.empty_like(traj)
        lam_g = _grid_reverse(mode, mats, w, uT, traj, *c, lin, scale, n, sms, cols_b,
                              hist_g)
        assert _rel(lam_g, lam_p) < 1e-6 and _rel(hist_g, hist_p) < 1e-6


def _lane_dots(arows, u, brows, g):
    """Each row's A u + B g as a warp forms it (csrc/fused_two_matrix.cu
    fwd_dot4): lane l sums the float4s k = l + 32 i in ascending i, each
    float4 the four products of A and u, then those of B and g; then the
    butterfly of warp_sum over the 32 lanes."""
    nr, mg = arows.shape
    cols = lambda t: t.reshape(-1, mg // 128, 32, 4)   # (rows, i, lane, 4)
    a4, b4 = cols(arows), cols(brows)
    u4, g4 = cols(u[None]), cols(g[None])
    s = torch.zeros((nr, 32), dtype=arows.dtype)
    for i in range(mg // 128):
        pa, pb = a4[:, i] * u4[:, i], b4[:, i] * g4[:, i]
        s = s + (((pa[..., 0] + pa[..., 1]) + pa[..., 2]) + pa[..., 3])
        s = s + (((pb[..., 0] + pb[..., 1]) + pb[..., 2]) + pb[..., 3])
    return _butterfly(s)[:, 0]


def _butterfly(v):
    """warp_sum over the last axis (32 lanes): v_l += v_{l xor off} for
    off = 16, 8, 4, 2, 1; every lane ends with the same sum."""
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ off]
    return v


def _energy_tree(u, w):
    """sum_j w_j u_j^2 as the one-block kernels' block_sum forms it (and
    energy_partials reproduces it): reference thread j of 1024 holds
    w u^2 of j, plus that of j + 1024 above mg = 1024; warp sums; the sum
    of the 32 warp sums."""
    mg = u.shape[0]
    e = torch.zeros(2048, dtype=u.dtype)
    e[:mg] = w * u * u
    part = e[:1024] + e[1024:]
    return _butterfly(_butterfly(part.reshape(32, 32))[:, 0])[0]


def _grid_sweep(w, u0, n, sms, poly, dots):
    """A grid-wide forward in plain torch: CTA c of
    `grid_partition(mg, sms)` computes its rows r of u_{n+1} as
    dots(r, u_n, poly(u_n)) from all of u_n; the energies by the
    reduction tree, Kahan-summed. (u_T, J_sum, traj, series)."""
    mg = u0.shape[0]
    rows, ctas = fk.grid_partition(mg, sms)
    acc, u, traj, ser = kahan_zero(u0.dtype, u0.device), u0, [], []
    for _ in range(n):
        traj.append(u)
        ser.append(_energy_tree(u, w))
        acc = kahan_add(acc, ser[-1])
        f = poly(u)
        nxt = torch.empty_like(u)
        for c in range(ctas):
            r = slice(c * rows, min((c + 1) * rows, mg))
            nxt[r] = dots(r, u, f)
        u = nxt
    ser.append(_energy_tree(u, w))
    acc = kahan_add(acc, ser[-1])
    return u, acc[0], torch.stack(traj), torch.stack(ser)


def _grid_forward(a, b, w, u0, c2, c3, n, sms):
    """The two-matrix grid forward (csrc/fused_two_matrix.cu):
    u_{n+1} = A u_n + B g(u_n), each row in the warp's lane order. The
    partition of `fwd_grid_partition` (all B rows kept or some read from
    L2) does not change the arithmetic."""
    return _grid_sweep(w, u0, n, sms, lambda u: c2 * u * u + c3 * u * u * u,
                       lambda r, u, g: _lane_dots(a[r], u, b[r], g))


def test_grid_forward_partition_matches_plain(one_thread):
    """The grid forward's row partition on 132 SMs, lane order and energy
    tree (plain torch, f32) against `fused_fwd_plain` on SHB23's operators
    at mg = 768, N = 10: u_T, J, the trajectory and the series within rel
    1e-6 (f32 sums in another order). The energy tree at mg = 1536 (two
    terms a reference thread) within rel 1e-6 of the plain sum."""
    p = TSHB(TBConfig(npts=768, dtype="float32", method="matmul"), device="cpu")
    a, b = p._Alt.float().contiguous(), p._Ant.float().contiguous()
    w = p._wt.float().contiguous()
    u0 = torch.as_tensor(np.random.RandomState(3).randn(768), dtype=torch.float32)
    u0 = u0 * torch.sqrt(p.cfg.m0 / torch.sum(w * u0 * u0))
    got = _grid_forward(a, b, w, u0, C2B, C3B, 10, 132)
    want = fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, 10, store_series=True)
    for x, y in zip(got, want):
        assert _rel(x, y) < 1e-6
    rs = np.random.RandomState(4)
    u, ww = (torch.as_tensor(rs.rand(1536), dtype=torch.float32) for _ in range(2))
    assert _rel(_energy_tree(u, ww), torch.sum(ww * u * u)) < 1e-6


def _shared_lane_dots(rows, v):
    """Each row's B v as a warp forms it (csrc/fused_shared.cu
    shared_dot4): lane l sums the float4s k = l + 32 i in ascending i, each
    float4 its four products in order; then the butterfly of warp_sum."""
    nr, mg = rows.shape
    b4, v4 = rows.reshape(nr, mg // 128, 32, 4), v.reshape(1, mg // 128, 32, 4)
    s = torch.zeros((nr, 32), dtype=rows.dtype)
    for i in range(mg // 128):
        p = b4[:, i] * v4[:, i]
        s = s + (((p[..., 0] + p[..., 1]) + p[..., 2]) + p[..., 3])
    return _butterfly(s)[:, 0]


def _shared_grid_forward(b, w, u0, c2, c3, lin, n, sms):
    """The shared-matrix grid forward (csrc/fused_shared.cu):
    u_{n+1} = B v(u_n), each row in the warp's lane order."""
    return _grid_sweep(w, u0, n, sms, lambda u: lin * u + c2 * u * u + c3 * u * u * u,
                       lambda r, u, v: _shared_lane_dots(b[r], v))


def test_shared_grid_forward_partition_matches_plain(one_thread):
    """The shared-matrix grid forward's row partition on 132 SMs, lane
    order and energy tree (plain torch, f32) against
    `fused_fwd_shared_plain` on SH23's operators at mg = 768 (npts = 384),
    N = 10: u_T, J, the trajectory and the series within rel 1e-6 (f32
    sums in another order)."""
    p = TSH(TConfig(npts=384, dtype="float32", method="matmul"), device="cpu")
    b = p._Mt.float().contiguous()
    w = torch.full((768,), 1.0 / 768)
    x = torch.as_tensor(np.random.RandomState(768).randn(768), dtype=torch.float32)
    u0 = torch.mv(p._Pt.float(), x) * 0.3
    lin = 1.0 / p.cfg.dt
    got = _shared_grid_forward(b, w, u0, C2, C3, lin, 10, 132)
    want = fk.fused_fwd_shared_plain(b, w, u0, C2, C3, lin, 10, store_series=True)
    for x_, y in zip(got, want):
        assert _rel(x_, y) < 1e-6


@pytest.mark.parametrize("mg", range(128, 2049, 128))
def test_shared_forward_route_by_width(mg):
    """The shared-matrix forward's grid at every width on an H100 SXM (132
    SMs) and PCIe (114): ceil(mg / SMs) rows of B and 3 mg + 32 floats of
    state fit each SM's 227 KB. On a card of 16 SMs they stop fitting
    above mg = 896, and the one-block kernel takes those widths."""
    assert fk.shared_fwd_route(mg) == "grid"
    for sms in (132, 114):
        rows = -(-mg // sms)
        assert fk.shared_grid_smem_bytes(mg, rows) == 4 * (rows * mg + 3 * mg + 32) <= 232448
        assert fk.shared_fwd_route(mg, (sms, 232448)) == "grid"
    assert fk.shared_fwd_route(mg, (16, 232448)) == ("grid" if mg <= 896 else "block")


def _chain(terms):
    """Floats of a chain of `terms` entries in a grid reverse's shared
    memory: whole float4s, an odd number of them."""
    quads = -(-terms // 4)
    return 4 * (quads if quads % 2 else quads + 1)


def _bwd_smem(mg, cols, cols_b):
    """Shared memory of one CTA of the grid reverse (csrc/fused_two_matrix.cu
    `bwd_grid_smem_bytes`): a chain of each phase of each of its columns
    of A and of cols_b of its columns of B, and of lambda; below cols_b =
    cols 3 stages of 256 rows of the other B columns (256 / P terms a
    chain); the P x cols partial sums of each matrix."""
    phases = 1024 // (mg // 4)
    ts = _chain(-(-mg // phases))
    staged = 3 * phases * (cols - cols_b) * _chain(256 // phases) if cols_b < cols else 0
    return 4 * (phases * (cols + cols_b + 1) * ts + staged + 2 * phases * cols)


@pytest.mark.parametrize("mg", range(128, 2049, 128))
def test_reverse_route_by_width(mg):
    """The reverse sweep's cluster while A's and B's columns fit 16 SMs'
    shared memory (227 KB each: 2 mg^2 4 / 16 bytes of columns, lambda
    twice, and the partial sums); above, the grid on an H100 SXM: the
    chains of ceil(mg / 132) columns of A, lambda's and the partial sums
    fit each of its 132 SMs (227 KB). All of a CTA's B columns fit beside
    them up to mg = 1792; above, as many as fit beside the stages stay
    and the others are staged from L2."""
    phases = 1024 // (mg // 4)
    smem = 4 * (2 * mg * mg // 16 + 2 * mg + 2 * phases * mg // 16 + 2 * mg // 16)
    assert (smem <= 232448) == (mg <= fk.CLUSTER_MG_MAX)
    cols = -(-mg // 132)
    assert _bwd_smem(mg, cols, 0) <= 232448
    assert fk.bwd_route(mg) == ("cluster" if mg <= fk.CLUSTER_MG_MAX else "grid")
    _, _, cols_b = fk.bwd_grid_partition(mg, fk.H100_SXM)
    assert (cols_b == cols) == (mg <= 1792)
    assert _bwd_smem(mg, cols, cols_b) <= 232448


@pytest.mark.parametrize("mg", range(128, 2049, 128))
@pytest.mark.parametrize("card", [(132, 232448), (114, 232448)])
def test_reverse_grid_partition_covers_every_column_once(card, mg):
    """The grid reverses' columns on an H100 SXM (132 SMs) and PCIe (114):
    ceil(mg / cols) <= SMs CTAs of `cols` contiguous columns (the last one
    short or full) cover 0 .. mg - 1 once; a CTA's 256 threads cover its
    P x cols (phase, column) pairs; the shared-matrix grid's columns and
    state fit one block's 227 KB, and both reverses take the grid above
    their clusters' widths."""
    cols, ctas, cols_b = fk.bwd_grid_partition(mg, card)
    assert (cols, ctas) == fk.grid_partition(mg, card[0]) and 1 <= ctas <= card[0]
    owned = [c for k in range(ctas) for c in range(k * cols, min((k + 1) * cols, mg))]
    assert owned == list(range(mg))
    phases = 1024 // (mg // 4)
    assert fk.row_phases(mg) == phases and phases * cols <= 256
    ts = _chain(-(-mg // phases))
    assert fk.chain_stride(-(-mg // phases)) == ts >= -(-mg // phases) and ts % 8 == 4
    smem = 4 * (phases * (cols + 1) * ts + phases * cols)
    assert fk.shared_bwd_grid_smem_bytes(mg, cols) == smem <= card[1]
    assert fk.bwd_route(mg, card) == ("cluster" if mg <= fk.CLUSTER_MG_MAX else "grid")
    assert fk.shared_bwd_route(mg, card) == (
        "cluster" if mg <= fk.SHARED_CLUSTER_MG_MAX else "grid")
    assert 0 <= cols_b <= cols


@pytest.mark.parametrize("mg", range(128, 2049, 128))
@pytest.mark.parametrize("card", [(132, 232448), (114, 232448)])
def test_reverse_grid_split_partition(card, mg):
    """The two-matrix grid reverse's split of B on an H100 SXM and PCIe:
    a CTA's A columns, its first cols_b B columns, the state and the
    stages of the other B columns fit one block's 227 KB; cols_b is the
    most that fit; the stages cut every column into chunks of 256 rows,
    the last one of 256 or 128. All kept up to mg = 1792 on the SXM and
    1664 on the PCIe card; at mg = 2048 8 of 16 kept on the SXM, 3 of 18
    on the PCIe card."""
    cols, _, cols_b = fk.bwd_grid_partition(mg, card)
    smem = fk.bwd_grid_smem_bytes(mg, cols, cols_b)
    assert smem == _bwd_smem(mg, cols, cols_b) <= card[1]
    assert cols_b == cols or _bwd_smem(mg, cols, cols_b + 1) > card[1]
    assert (fk.STAGES, fk.STAGE_ROWS) == (3, 256) and mg % (fk.STAGE_ROWS // 2) == 0
    assert (cols_b == cols) == (mg <= (1792 if card[0] == 132 else 1664))
    if mg == 2048:
        assert (cols, cols_b) == ((16, 8) if card[0] == 132 else (18, 3))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("npts", [64, 256])
def test_kernels_match_plain_on_card(cuda, npts):
    """Kernel vs plain f32 on the same card inputs, rel 1e-4 (f32 sums in
    another order over the sweep)."""
    p = TSH(TConfig(npts=npts, dtype="float32", method="cuda"), device=cuda)
    mg = p.basis.n_grid
    x = torch.as_tensor(np.random.RandomState(1).randn(mg), dtype=torch.float32,
                        device=cuda)
    b, w = p._Mt.float().contiguous(), torch.full((mg,), 1.0 / mg, device=cuda)
    u0 = torch.mv(p._Pt.float(), x) * 0.3
    lin, n = 1.0 / p.cfg.dt, 200
    fk.reset_launches()
    k = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n)
    r = fk.fused_fwd_shared_plain(b, w, u0, C2, C3, lin, n)
    scale = torch.tensor(-0.1, device=cuda)
    lk, _ = fk.fused_bwd_shared(b, w, k[0], k[2], C2, C3, lin, scale, n)
    lr, _ = fk.fused_bwd_shared_plain(b, w, k[0], k[2], C2, C3, lin, scale, n)
    torch.cuda.synchronize()
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "fused_fwd_shared_grid": 1, "fused_bwd_shared": 1}
    for got, want in [(k[0], r[0]), (k[1], r[1]), (k[2], r[2]), (lk, lr)]:
        assert _rel(got.cpu(), want.cpu()) < 1e-4


@pytest.mark.requires_cuda
def test_kernel_wrappers_reject_what_they_cannot_run(cuda):
    b = torch.zeros(96, 96, device=cuda)
    w = u = torch.zeros(96, device=cuda)
    with pytest.raises(ValueError, match="mg"):
        fk.fused_fwd_shared(b, w, u, C2, C3, 1.0, 4)
    b, w, u = torch.zeros(128, 128, device=cuda), torch.zeros(128, device=cuda), \
        torch.zeros(128, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        fk.fused_fwd_shared(b, w, u, C2, C3, 1.0, 4)
    traj = torch.zeros(4, 128, device=cuda)
    with pytest.raises(ValueError, match="lam_hist"):
        fk.op_grads_product(traj[:3], traj, "shared", C2, C3, 1.0)
    with pytest.raises(ValueError, match="mode"):
        fk.op_grads_product(traj, traj, "three", C2, C3, 1.0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("npts", [128, 512])
def test_op_grads_kernels_match_plain_on_card(cuda, npts):
    """op_grads=True on the card: the reverse kernel with its lambda
    history (the cluster at mg = 256, the grid at mg = 1024), then the
    product kernel, vs the step-by-step plain f32 sweep on the same inputs
    (rel 1e-4); lambda_0 bitwise that of the kernel without the
    history."""
    p = TSH(TConfig(npts=npts, dtype="float32", method="cuda"), device=cuda)
    mg = p.basis.n_grid
    x = torch.as_tensor(np.random.RandomState(1).randn(mg), dtype=torch.float32,
                        device=cuda)
    b, w = p._Mt.float().contiguous(), torch.full((mg,), 1.0 / mg, device=cuda)
    u0 = torch.mv(p._Pt.float(), x) * 0.3
    lin, n = 1.0 / p.cfg.dt, 200
    uT, _, tr, _ = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n)
    scale = torch.tensor(-0.1, device=cuda)
    fk.reset_launches()
    lk, dbk = fk.fused_bwd_shared(b, w, uT, tr, C2, C3, lin, scale, n, op_grads=True)
    torch.cuda.synchronize()
    sweep = ("fused_bwd_shared_ops" if fk.shared_bwd_route(mg) == "cluster"
             else "fused_bwd_shared_grid_ops")
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {sweep: 1, "op_grads": 1}
    l0, _ = fk.fused_bwd_shared(b, w, uT, tr, C2, C3, lin, scale, n)
    lr, dbr = fk.fused_bwd_shared_plain(b, w, uT, tr, C2, C3, lin, scale, n,
                                        op_grads=True)
    assert torch.equal(lk, l0)
    assert _rel(lk.cpu(), lr.cpu()) < 1e-4 and _rel(dbk.cpu(), dbr.cpu()) < 1e-4


def _card_shb23(cuda, npts):
    """f32 SHB23 kernel operands on the card and a seeded u0 on the sphere."""
    p = TSHB(TBConfig(npts=npts, dtype="float32", method="cuda"), device=cuda)
    a, b = p._Alt.float().contiguous(), p._Ant.float().contiguous()
    w = p._wt.float().contiguous()
    u0 = torch.as_tensor(np.random.RandomState(2).randn(npts), dtype=torch.float32,
                         device=cuda)
    return a, b, w, u0 * torch.sqrt(p.cfg.m0 / torch.sum(w * u0 * u0))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("npts", [128, 512])
def test_two_matrix_kernels_match_plain_on_card(cuda, npts):
    """Two-matrix kernels (with and without the series) vs plain f32 on
    the same card inputs, rel 1e-4; J, u_T and the trajectory bitwise
    between the series and plain variants."""
    a, b, w, u0 = _card_shb23(cuda, npts)
    n = 300
    fk.reset_launches()
    k = fk.fused_fwd(a, b, w, u0, C2B, C3B, n)
    ks = fk.fused_fwd(a, b, w, u0, C2B, C3B, n, store_series=True)
    r = fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, n, store_series=True)
    scale = torch.tensor(-0.02, device=cuda)
    lk, _, _ = fk.fused_bwd(a, b, w, k[0], k[2], C2B, C3B, scale, n)
    lr, _, _ = fk.fused_bwd_plain(a, b, w, k[0], k[2], C2B, C3B, scale, n)
    torch.cuda.synchronize()
    assert {k_: v for k_, v in fk.LAUNCHES.items() if v} == {
        "fused_fwd_grid": 1, "fused_fwd_grid_ser": 1, "fused_bwd": 1}
    for got, want in [(k[0], r[0]), (k[1], r[1]), (k[2], r[2]), (ks[3], r[3]),
                      (lk, lr)]:
        assert _rel(got.cpu(), want.cpu()) < 1e-4
    for x, y in zip(k[:3], ks[:3]):
        assert torch.equal(x, y)


@pytest.mark.requires_cuda
def test_shared_series_kernel_bitwise_on_card(cuda):
    p = TSH(TConfig(npts=256, dtype="float32", method="cuda"), device=cuda)
    mg = p.basis.n_grid
    b, w = p._Mt.float().contiguous(), torch.full((mg,), 1.0 / mg, device=cuda)
    x = torch.as_tensor(np.random.RandomState(1).randn(mg), dtype=torch.float32,
                        device=cuda)
    u0 = torch.mv(p._Pt.float(), x) * 0.3
    lin, n = 1.0 / p.cfg.dt, 200
    k = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n)
    ks = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n, store_series=True)
    r = fk.fused_fwd_shared_plain(b, w, u0, C2, C3, lin, n, store_series=True)
    for x_, y in zip(k[:3], ks[:3]):
        assert torch.equal(x_, y)
    assert _rel(ks[3].cpu(), r[3].cpu()) < 1e-4


@pytest.mark.requires_cuda
def test_two_matrix_wrappers_reject_what_they_cannot_run(cuda):
    a = torch.zeros(128, 128, device=cuda)
    w = u = torch.zeros(128, device=cuda)
    traj = torch.zeros(4, 128, device=cuda)
    with pytest.raises(ValueError, match="traj"):
        fk.fused_bwd(a, a, w, u, traj[:3], C2B, C3B, torch.zeros((), device=cuda), 4,
                     op_grads=True)
    with pytest.raises(ValueError, match="shapes"):
        fk.fused_fwd(a, a[:64], w, u, C2B, C3B, 4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("npts", [128, 512])
def test_two_matrix_op_grads_kernels_match_plain_on_card(cuda, npts):
    """Two-matrix op_grads=True on the card (history sweep, then the
    product kernel) vs the step-by-step plain f32 sweep: lambda_0, dA and
    dB rel 1e-4; lambda_0 bitwise the kernel's without the history; the
    autograd Function gives the same (dA, dB) by default."""
    a, b, w, u0 = _card_shb23(cuda, npts)
    n = 300
    uT, _, tr, _ = fk.fused_fwd(a, b, w, u0, C2B, C3B, n)
    scale = torch.tensor(-0.02, device=cuda)
    fk.reset_launches()
    lk, dak, dbk = fk.fused_bwd(a, b, w, uT, tr, C2B, C3B, scale, n, op_grads=True)
    torch.cuda.synchronize()
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "fused_bwd_ops": 1, "op_grads": 1}
    l0 = fk.fused_bwd(a, b, w, uT, tr, C2B, C3B, scale, n)[0]
    lr, dar, dbr = fk.fused_bwd_plain(a, b, w, uT, tr, C2B, C3B, scale, n,
                                      op_grads=True)
    assert torch.equal(lk, l0)
    for got, want in [(lk, lr), (dak, dar), (dbk, dbr)]:
        assert _rel(got.cpu(), want.cpu()) < 1e-4
    ar, br = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    J = fk.FusedObjective.apply(ar, br, w, u0, C2B, C3B, 0.01, n)   # scale -2 dt
    da, db = torch.autograd.grad(J, (ar, br))
    assert torch.equal(da, dak) and torch.equal(db, dbk)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["shared", "two"])
@pytest.mark.parametrize("n", [320, 301])
@pytest.mark.parametrize("mg", [128, 512])
def test_op_grads_product_matches_plain_on_card(cuda, mg, n, mode):
    """The tensor-core product (3xTF32) against `op_grads_plain` on the
    same card inputs: within 1e-4 of the largest entry in f32 and 1e-5
    against f64; N a multiple of the 16-step stage and not; one launch;
    the same bits again on a second call."""
    rs = np.random.RandomState(mg + n)
    lam = torch.as_tensor(rs.randn(n, mg), dtype=torch.float32, device=cuda)
    traj = torch.as_tensor(0.3 * rs.randn(n, mg), dtype=torch.float32, device=cuda)
    c, lin = ((C2, C3), 20.0) if mode == "shared" else ((C2B, C3B), 0.0)
    fk.reset_launches()
    got = fk.op_grads_product(lam, traj, mode, *c, lin)
    torch.cuda.synchronize()
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {"op_grads": 1}
    want = fk.op_grads_plain(lam, traj, mode, *c, lin)
    want64 = fk.op_grads_plain(lam.double(), traj.double(), mode, *c, lin)
    assert len(got) == len(want) == (1 if mode == "shared" else 2)
    for g, x, x64 in zip(got, want, want64):
        assert _rel(g.cpu(), x.cpu()) < 1e-4 and _rel(g.cpu(), x64.cpu()) < 1e-5
    again = fk.op_grads_product(lam, traj, mode, *c, lin)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("npts,n", [(128, 300), (512, 300), (1024, 200), (2048, 100)])
def test_two_matrix_forward_routes_match_plain_on_card(cuda, npts, n):
    """The two-matrix forward's route on an H100 (the grid-wide kernel at
    every width: all of a CTA's rows of A and B in shared memory up to
    mg = 1792 on an H100 SXM, so at 128, 512 and 1024, and some of its B
    rows read from L2 at 2048, counted as `fused_fwd_grid_stream`)
    against plain f32, rel 1e-4; with and without the series J, u_T and
    the trajectory bitwise; bitwise the one-block kernel's on the same
    inputs."""
    a, b, w, u0 = _card_shb23(cuda, npts)
    route = fk.fwd_route(npts, fk._card(cuda))
    fk.reset_launches()
    k = fk.fused_fwd(a, b, w, u0, C2B, C3B, n)
    ks = fk.fused_fwd(a, b, w, u0, C2B, C3B, n, store_series=True)
    torch.cuda.synchronize()
    rows, _, rows_b = fk.fwd_grid_partition(npts, fk._card(cuda))
    name = "fused_fwd_grid" + ("_stream" if rows_b < rows else "")
    assert route == "grid" and (rows_b < rows) == (npts > 1792)
    assert {k_: v for k_, v in fk.LAUNCHES.items() if v} == {name: 1, name + "_ser": 1}
    r = fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, n, store_series=True)
    for got, want in [(k[0], r[0]), (k[1], r[1]), (k[2], r[2]), (ks[3], r[3])]:
        assert _rel(got.cpu(), want.cpu()) < 1e-4
    for x, y in zip(k[:3], ks[:3]):
        assert torch.equal(x, y)
    blk = fk._fwd_block(a, b, w, u0, C2B, C3B, n, True, True)
    for x, y in zip(ks, blk):
        assert torch.equal(x, y)


@pytest.mark.requires_cuda
def test_two_matrix_forward_rejects_widths_neither_route_takes(cuda):
    for mg in (96, 2176):
        a = torch.zeros(mg, mg, device=cuda)
        v = torch.zeros(mg, device=cuda)
        with pytest.raises(ValueError, match="mg"):
            fk.fused_fwd(a, a, v, v, C2B, C3B, 4)


def _reverse_inputs(cuda, mg, n):
    """Seeded operands of a two-matrix reverse sweep: A and B of spectral
    radius ~0.5, a trajectory of O(0.3) entries."""
    rs = np.random.RandomState(mg + n)
    mats = [torch.as_tensor(0.5 * rs.randn(mg, mg) / np.sqrt(mg), dtype=torch.float32,
                            device=cuda) for _ in range(2)]
    w = torch.as_tensor(rs.rand(mg) / mg, dtype=torch.float32, device=cuda)
    traj = torch.as_tensor(0.3 * rs.randn(n, mg), dtype=torch.float32, device=cuda)
    uT = torch.as_tensor(0.3 * rs.randn(mg), dtype=torch.float32, device=cuda)
    return (*mats, w, uT, traj, torch.tensor(-0.02, device=cuda))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hist", [False, True])
@pytest.mark.parametrize("mg", [128, 512, 640])
def test_cluster_reverse_bitwise_the_block_reverse_on_card(cuda, mg, hist):
    """The 16-CTA cluster reverse sweep against the one-block kernel on the
    same inputs: lambda_0 and the lambda history bitwise; lambda_0 bitwise
    across the two history instantiations; within 1e-4 of plain f32."""
    a, b, w, uT, traj, sc = _reverse_inputs(cuda, mg, 300)
    n = traj.shape[0]
    h_c = torch.empty_like(traj) if hist else None
    h_b = torch.empty_like(traj) if hist else None
    fk.reset_launches()
    lam_c = fk.fused_bwd(a, b, w, uT, traj, C2B, C3B, sc, n, lam_hist=h_c)[0]
    torch.cuda.synchronize()
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "fused_bwd_ops" if hist else "fused_bwd": 1}
    lam_b = fk._bwd_block(a, b, w, uT, traj, C2B, C3B, sc, n, h_b)
    other = fk.fused_bwd(a, b, w, uT, traj, C2B, C3B, sc, n,
                         lam_hist=None if hist else torch.empty_like(traj))[0]
    torch.cuda.synchronize()
    assert torch.equal(lam_c, lam_b) and torch.equal(lam_c, other)
    if hist:
        assert torch.equal(h_c, h_b)
    lam_p = fk.fused_bwd_plain(a, b, w, uT, traj, C2B, C3B, sc, n)[0]
    assert _rel(lam_c.cpu(), lam_p.cpu()) < 1e-4


def _reverse_counter(mg, card, hist):
    """The launch counter of the two-matrix grid reverse at width mg."""
    cols, _, cols_b = fk.bwd_grid_partition(mg, card)
    if cols_b < cols:
        return "fused_bwd_grid_stream"
    return "fused_bwd_grid_ops" if hist else "fused_bwd_grid"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hist", [False, True])
@pytest.mark.parametrize("mg", [128, 512, 640, 768, 1024, 1536, 1920, 2048])
def test_grid_reverse_bitwise_the_block_reverse_on_card(cuda, mg, hist):
    """The grid-wide reverse sweep (`_bwd_grid`, called directly at the
    clusters' widths, the route above) against the one-block kernel on the
    same inputs, from one column a CTA at mg = 128 to mg = 2048 (above 1792
    on an H100 SXM the instance that stages the B columns that do not fit
    from L2): lambda_0 and the lambda history bitwise; lambda_0 bitwise
    across the two history instantiations and the route's; within 1e-4 of
    plain f32."""
    a, b, w, uT, traj, sc = _reverse_inputs(cuda, mg, 300 if mg <= 1024 else 100)
    n = traj.shape[0]
    h_c = torch.empty_like(traj) if hist else None
    h_b = torch.empty_like(traj) if hist else None
    assert fk.bwd_route(mg, fk._card(cuda)) == ("cluster" if mg <= 640 else "grid")
    fk.reset_launches()
    lam_c = fk._bwd_grid(a, b, w, uT, traj, C2B, C3B, sc, n, h_c)
    torch.cuda.synchronize()
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        _reverse_counter(mg, fk._card(cuda), hist): 1}
    lam_b = fk._bwd_block(a, b, w, uT, traj, C2B, C3B, sc, n, h_b)
    other = fk._bwd_grid(a, b, w, uT, traj, C2B, C3B, sc, n,
                         None if hist else torch.empty_like(traj))
    route = fk.fused_bwd(a, b, w, uT, traj, C2B, C3B, sc, n)[0]
    torch.cuda.synchronize()
    assert torch.equal(lam_c, lam_b) and torch.equal(lam_c, other)
    assert torch.equal(lam_c, route)
    if hist:
        assert torch.equal(h_c, h_b)
    lam_p = fk.fused_bwd_plain(a, b, w, uT, traj, C2B, C3B, sc, n)[0]
    assert _rel(lam_c.cpu(), lam_p.cpu()) < 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mg,cols,cols_b", [(2048, 18, 3), (2048, 16, 0), (512, 4, 1)])
def test_grid_reverse_any_split_bitwise_on_card(cuda, mg, cols, cols_b):
    """The grid reverse's instance that stages B columns from L2, launched
    directly at splits its route does not choose on this card (the H100
    PCIe's 114 CTAs of 18 columns, 3 of B kept; no B column kept; 1 of 4
    kept at mg = 512), with and without the history: lambda_0 and the
    history bitwise the one-block kernel's."""
    from spheremanopt_torch.ops.cuda.build import load

    a, b, w, uT, traj, sc = _reverse_inputs(cuda, mg, 100)
    n = traj.shape[0]
    for hist in (False, True):
        assert load().sm_fused_bwd_grid_capacity(mg, cols, cols_b, int(hist)) >= -(-mg // cols)
        lam, h = torch.empty_like(uT), torch.empty_like(traj) if hist else None
        bperm = fk.phase_ordered(b)
        code = load().sm_fused_bwd_grid(
            a.data_ptr(), b.data_ptr(), bperm.data_ptr(), w.data_ptr(), uT.data_ptr(),
            traj.data_ptr(), C2B, C3B, sc.data_ptr(), n, mg, cols, cols_b, lam.data_ptr(),
            fk._ptr(h), fk._tag_slots(uT).data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert code == 0
        h_b = torch.empty_like(traj) if hist else None
        lam_b = fk._bwd_block(a, b, w, uT, traj, C2B, C3B, sc, n, h_b)
        torch.cuda.synchronize()
        assert torch.equal(lam, lam_b)
        if hist:
            assert torch.equal(h, h_b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mg", [512, 1024])
def test_reverse_route_by_width_on_card(cuda, mg):
    """`bwd_route` picks the kernel by mg: the launch counters show the
    cluster up to 640 and the grid-wide kernel above, the history
    variants under `fused_bwd_ops` and `fused_bwd_grid_ops`; lambda within
    1e-4 of plain f32."""
    a, b, w, uT, traj, sc = _reverse_inputs(cuda, mg, 200)
    n = traj.shape[0]
    fk.reset_launches()
    lam = fk.fused_bwd(a, b, w, uT, traj, C2B, C3B, sc, n)[0]
    lam_h = fk.fused_bwd(a, b, w, uT, traj, C2B, C3B, sc, n,
                         lam_hist=torch.empty_like(traj))[0]
    torch.cuda.synchronize()
    route = fk.bwd_route(mg, fk._card(cuda))
    assert route == ("cluster" if mg <= 640 else "grid")
    name = "fused_bwd" if route == "cluster" else "fused_bwd_grid"
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {name: 1, name + "_ops": 1}
    assert torch.equal(lam, lam_h)
    lam_p = fk.fused_bwd_plain(a, b, w, uT, traj, C2B, C3B, sc, n)[0]
    assert _rel(lam.cpu(), lam_p.cpu()) < 1e-4


def _shared_inputs(cuda, mg):
    """SH23's f32 step matrix and lin = 1/dt at width mg (npts = mg / 2),
    w = 1 / mg, and a seeded u0 = 0.3 P x."""
    p = TSH(TConfig(npts=mg // 2, dtype="float32", method="cuda"), device=cuda)
    x = torch.as_tensor(np.random.RandomState(mg).randn(mg), dtype=torch.float32,
                        device=cuda)
    return (p._Mt.float().contiguous(), torch.full((mg,), 1.0 / mg, device=cuda),
            torch.mv(p._Pt.float(), x) * 0.3, 1.0 / p.cfg.dt)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mg", [512, 1024])
def test_shared_forward_route_by_width_on_card(cuda, mg):
    """`shared_fwd_route` picks the kernel by mg: on an H100 the launch
    counters show the grid-wide kernel at every width; u_T, J, the
    trajectory and the series within 1e-4 of plain f32."""
    b, w, u0, lin = _shared_inputs(cuda, mg)
    n = 200
    fk.reset_launches()
    k = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n)
    ks = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n, store_series=True)
    torch.cuda.synchronize()
    assert fk.shared_fwd_route(mg, fk._card(cuda)) == "grid"
    assert {k_: v for k_, v in fk.LAUNCHES.items() if v} == {
        "fused_fwd_shared_grid": 1, "fused_fwd_shared_grid_ser": 1}
    r = fk.fused_fwd_shared_plain(b, w, u0, C2, C3, lin, n, store_series=True)
    for got, want in list(zip(k[:3], r[:3])) + [(ks[3], r[3])]:
        assert _rel(got.cpu(), want.cpu()) < 1e-4
    for x, y in zip(k[:3], ks[:3]):
        assert torch.equal(x, y)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mg", [128, 512, 896, 1024, 1536, 1920, 2048])
def test_shared_grid_forward_bitwise_the_block_forward_on_card(cuda, mg):
    """The grid-wide forward of the shared-matrix step against the
    one-block kernel on the same inputs (SH23's operators from one row a
    CTA at mg = 128 to mg = 2048): u_T, J, the trajectory and the series
    bitwise, with and without the series; the same bits on a second
    call; within 1e-4 of plain f32."""
    b, w, u0, lin = _shared_inputs(cuda, mg)
    n = 200
    assert fk.shared_fwd_route(mg, fk._card(cuda)) == "grid"
    fk.reset_launches()
    k = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n)
    ks = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n, store_series=True)
    torch.cuda.synchronize()
    assert {k_: v for k_, v in fk.LAUNCHES.items() if v} == {
        "fused_fwd_shared_grid": 1, "fused_fwd_shared_grid_ser": 1}
    blk = fk._fwd_shared_block(b, w, u0, C2, C3, lin, n)
    blk_s = fk._fwd_shared_block(b, w, u0, C2, C3, lin, n, True, True)
    again = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n, store_series=True)
    torch.cuda.synchronize()
    for x, y, z in zip(k[:3], blk[:3], ks[:3]):
        assert torch.equal(x, y) and torch.equal(x, z)
    for x, y, z in zip(ks, blk_s, again):
        assert torch.equal(x, y) and torch.equal(x, z)
    r = fk.fused_fwd_shared_plain(b, w, u0, C2, C3, lin, n, store_series=True)
    for got, want in zip(ks, r):
        assert _rel(got.cpu(), want.cpu()) < 1e-4


@pytest.mark.requires_cuda
def test_shared_forward_rejects_widths_neither_route_takes(cuda):
    for mg in (96, 2176):
        b = torch.zeros(mg, mg, device=cuda)
        v = torch.zeros(mg, device=cuda)
        with pytest.raises(ValueError, match="mg"):
            fk.fused_fwd_shared(b, v, v, C2, C3, 20.0, 4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("symbol,mg", [
    ("sm_fused_fwd_grid", 512), ("sm_fused_bwd", 128), ("sm_fused_fwd_shared_grid", 128),
    ("sm_fused_bwd_shared", 128), ("sm_fused_fwd_grid", 1024), ("sm_fused_fwd_grid", 2048),
    ("sm_fused_fwd_shared_grid", 1024), ("sm_fused_bwd_grid", 1024), ("sm_fused_bwd_grid", 2048),
    ("sm_fused_bwd_shared_grid", 1024), ("sm_fused_bwd_shared_grid", 2048)])
def test_cluster_capacity_of_zero_raises(cuda, symbol, mg, monkeypatch):
    """A cluster the card cannot schedule (capacity 0), and a grid-wide
    kernel whose CTAs the card cannot hold at once, raise; nothing falls
    back to the one-block kernel. (The grids replace the cases of the
    cluster forwards they replaced; at mg = 2048 the two-matrix grids'
    instances that read B from L2.)"""
    from spheremanopt_torch.ops.cuda import build

    class NoClusters:
        def __getattr__(self, name):
            if name.endswith("_capacity"):
                return lambda *args: 0
            if name == "sm_smem_optin":
                return lambda: 232448
            raise AssertionError(f"{name} must not be called")

    monkeypatch.setattr(build, "load", lambda: NoClusters())
    for cache in (fk._check_cluster, fk._check_grid, fk._card):
        cache.cache_clear()
    a, b, w, uT, traj, sc = _reverse_inputs(cuda, mg, 4)
    fk.reset_launches()
    with pytest.raises(RuntimeError, match="cannot be (scheduled|co-resident)"):
        if symbol == "sm_fused_fwd_grid":
            fk.fused_fwd(a, b, w, uT, C2B, C3B, 4)
        elif symbol == "sm_fused_fwd_shared_grid":
            fk.fused_fwd_shared(b, w, uT, C2, C3, 20.0, 4)
        elif symbol in ("sm_fused_bwd_shared", "sm_fused_bwd_shared_grid"):
            fk.fused_bwd_shared(b, w, uT, traj, C2, C3, 20.0, sc, 4)
        else:
            fk.fused_bwd(a, b, w, uT, traj, C2B, C3B, sc, 4)
    assert not any(fk.LAUNCHES.values())
    monkeypatch.undo()
    for cache in (fk._check_cluster, fk._check_grid, fk._card):
        cache.cache_clear()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hist", [False, True])
@pytest.mark.parametrize("mg", [128, 512, 896])
def test_shared_cluster_reverse_bitwise_the_block_reverse_on_card(cuda, mg, hist):
    """The 16-CTA cluster reverse sweep of the shared-matrix step against
    the one-block kernel on the same inputs: lambda_0 and the lambda
    history bitwise; lambda_0 bitwise across the two history
    instantiations; within 1e-4 of plain f32."""
    b, w, u0, lin = _shared_inputs(cuda, mg)
    n = 300
    uT, _, traj, _ = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n)
    sc = torch.tensor(-0.1, device=cuda)
    h_c = torch.empty_like(traj) if hist else None
    h_b = torch.empty_like(traj) if hist else None
    fk.reset_launches()
    lam_c = fk.fused_bwd_shared(b, w, uT, traj, C2, C3, lin, sc, n, lam_hist=h_c)[0]
    torch.cuda.synchronize()
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "fused_bwd_shared_ops" if hist else "fused_bwd_shared": 1}
    lam_b = fk._bwd_shared_block(b, w, uT, traj, C2, C3, lin, sc, n, h_b)
    other = fk.fused_bwd_shared(b, w, uT, traj, C2, C3, lin, sc, n,
                                lam_hist=None if hist else torch.empty_like(traj))[0]
    torch.cuda.synchronize()
    assert torch.equal(lam_c, lam_b) and torch.equal(lam_c, other)
    if hist:
        assert torch.equal(h_c, h_b)
    lam_p = fk.fused_bwd_shared_plain(b, w, uT, traj, C2, C3, lin, sc, n)[0]
    assert _rel(lam_c.cpu(), lam_p.cpu()) < 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("hist", [False, True])
@pytest.mark.parametrize("mg", [128, 512, 896, 1024, 2048])
def test_shared_grid_reverse_bitwise_the_block_reverse_on_card(cuda, mg, hist):
    """The grid-wide reverse sweep of the shared-matrix step
    (`_bwd_shared_grid`, called directly at the cluster's widths, the
    route above) against the one-block kernel on the same inputs (SH23's
    operators from one column a CTA at mg = 128 to mg = 2048): lambda_0
    and the lambda history bitwise; lambda_0 bitwise across the two
    history instantiations and the route's; within 1e-4 of plain f32."""
    b, w, u0, lin = _shared_inputs(cuda, mg)
    n = 300
    uT, _, traj, _ = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n)
    sc = torch.tensor(-0.1, device=cuda)
    h_c = torch.empty_like(traj) if hist else None
    h_b = torch.empty_like(traj) if hist else None
    assert fk.shared_bwd_route(mg, fk._card(cuda)) == ("cluster" if mg <= 896 else "grid")
    fk.reset_launches()
    lam_c = fk._bwd_shared_grid(b, w, uT, traj, C2, C3, lin, sc, n, h_c)
    torch.cuda.synchronize()
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "fused_bwd_shared_grid_ops" if hist else "fused_bwd_shared_grid": 1}
    lam_b = fk._bwd_shared_block(b, w, uT, traj, C2, C3, lin, sc, n, h_b)
    other = fk._bwd_shared_grid(b, w, uT, traj, C2, C3, lin, sc, n,
                                None if hist else torch.empty_like(traj))
    route = fk.fused_bwd_shared(b, w, uT, traj, C2, C3, lin, sc, n)[0]
    torch.cuda.synchronize()
    assert torch.equal(lam_c, lam_b) and torch.equal(lam_c, other)
    assert torch.equal(lam_c, route)
    if hist:
        assert torch.equal(h_c, h_b)
    lam_p = fk.fused_bwd_shared_plain(b, w, uT, traj, C2, C3, lin, sc, n)[0]
    assert _rel(lam_c.cpu(), lam_p.cpu()) < 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mg", [512, 1024])
def test_shared_reverse_route_by_width_on_card(cuda, mg):
    """`shared_bwd_route` picks the kernel by mg: the launch counters show
    the cluster up to 896 and the grid-wide kernel above, the history
    variants under `fused_bwd_shared_ops` and `fused_bwd_shared_grid_ops`;
    lambda within 1e-4 of plain f32."""
    b, w, u0, lin = _shared_inputs(cuda, mg)
    n = 200
    uT, _, traj, _ = fk.fused_fwd_shared(b, w, u0, C2, C3, lin, n)
    sc = torch.tensor(-0.1, device=cuda)
    fk.reset_launches()
    lam = fk.fused_bwd_shared(b, w, uT, traj, C2, C3, lin, sc, n)[0]
    lam_h = fk.fused_bwd_shared(b, w, uT, traj, C2, C3, lin, sc, n,
                                lam_hist=torch.empty_like(traj))[0]
    torch.cuda.synchronize()
    route = fk.shared_bwd_route(mg, fk._card(cuda))
    assert route == ("cluster" if mg <= 896 else "grid")
    name = "fused_bwd_shared" if route == "cluster" else "fused_bwd_shared_grid"
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {name: 1, name + "_ops": 1}
    assert torch.equal(lam, lam_h)
    lam_p = fk.fused_bwd_shared_plain(b, w, uT, traj, C2, C3, lin, sc, n)[0]
    assert _rel(lam.cpu(), lam_p.cpu()) < 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("npts", [128, 512, 768, 1024, 1536, 1792, 1920, 2048])
def test_grid_forward_bitwise_the_block_forward_on_card(cuda, npts):
    """The grid-wide two-matrix forward against the one-block kernel on
    the same inputs (SHB23's operators from one row a CTA at mg = 128 to
    mg = 2048; above 1792 on an H100 SXM the instance that reads the B
    rows that do not fit from L2): u_T, J, the trajectory and the series
    bitwise, with and without the series; the same bits on a second call;
    within 1e-4 of plain f32."""
    a, b, w, u0 = _card_shb23(cuda, npts)
    n = 200
    assert fk.fwd_route(npts, fk._card(cuda)) == "grid"
    rows, _, rows_b = fk.fwd_grid_partition(npts, fk._card(cuda))
    name = "fused_fwd_grid" + ("_stream" if rows_b < rows else "")
    fk.reset_launches()
    k = fk.fused_fwd(a, b, w, u0, C2B, C3B, n)
    ks = fk.fused_fwd(a, b, w, u0, C2B, C3B, n, store_series=True)
    torch.cuda.synchronize()
    assert {k_: v for k_, v in fk.LAUNCHES.items() if v} == {name: 1, name + "_ser": 1}
    blk = fk._fwd_block(a, b, w, u0, C2B, C3B, n)
    blk_s = fk._fwd_block(a, b, w, u0, C2B, C3B, n, True, True)
    again = fk.fused_fwd(a, b, w, u0, C2B, C3B, n, store_series=True)
    torch.cuda.synchronize()
    for x, y, z in zip(k[:3], blk[:3], ks[:3]):
        assert torch.equal(x, y) and torch.equal(x, z)
    for x, y, z in zip(ks, blk_s, again):
        assert torch.equal(x, y) and torch.equal(x, z)
    r = fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, n, store_series=True)
    for got, want in zip(ks, r):
        assert _rel(got.cpu(), want.cpu()) < 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mg,rows,rows_b", [(2048, 18, 7), (2048, 16, 0), (512, 4, 1)])
def test_grid_forward_any_split_bitwise_on_card(cuda, mg, rows, rows_b):
    """The grid forward's instance that reads B rows from L2, launched
    directly at splits its route does not choose on this card (the H100
    PCIe's 114 CTAs of 18 rows, 7 of B kept; no B row kept; 1 of 4 kept
    at mg = 512): u_T, J, the trajectory and the series bitwise the
    one-block kernel's."""
    from spheremanopt_torch.ops.cuda.build import load

    a, b, w, u0 = _card_shb23(cuda, mg)
    n = 100
    assert load().sm_fused_fwd_grid_capacity(mg, rows, rows_b, 1) >= -(-mg // rows)
    uT, jsum, traj, ser = fk._fwd_outputs(u0, n, True, True)
    slots = fk._tag_slots(u0)
    code = load().sm_fused_fwd_grid(
        a.data_ptr(), b.data_ptr(), w.data_ptr(), u0.data_ptr(), C2B, C3B, n, mg, rows,
        rows_b, uT.data_ptr(), jsum.data_ptr(), traj.data_ptr(), ser.data_ptr(),
        slots.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert code == 0
    blk = fk._fwd_block(a, b, w, u0, C2B, C3B, n, True, True)
    torch.cuda.synchronize()
    for x, y in zip((uT, jsum, traj, ser), blk):
        assert torch.equal(x, y)
