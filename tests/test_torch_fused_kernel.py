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


@pytest.mark.parametrize("mg", range(128, 2049, 128))
def test_forward_route_by_width(mg):
    """The cluster while A's and B's rows fit 16 SMs' shared memory (227
    KB each: 2 mg^2 4 / 16 bytes of rows and 4 mg floats of state), one
    block above."""
    smem = 2 * mg * mg * 4 // 16 + 4 * mg * 4 + 128
    assert fk.fwd_route(mg) == ("cluster" if mg <= fk.CLUSTER_MG_MAX else "block")
    assert (smem <= 232448) == (mg <= fk.CLUSTER_MG_MAX)


@pytest.mark.parametrize("mg", range(128, 2049, 128))
def test_reverse_route_by_width(mg):
    """The reverse sweep's cluster while A's and B's columns fit 16 SMs'
    shared memory (227 KB each: 2 mg^2 4 / 16 bytes of columns, lambda
    twice, and the partial sums), one block above."""
    phases = 1024 // (mg // 4)
    smem = 4 * (2 * mg * mg // 16 + 2 * mg + 2 * phases * mg // 16 + 2 * mg // 16)
    assert fk.bwd_route(mg) == ("cluster" if mg <= fk.CLUSTER_MG_MAX else "block")
    assert (smem <= 232448) == (mg <= fk.CLUSTER_MG_MAX)


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
        "fused_fwd_shared": 1, "fused_bwd_shared": 1}
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
    history, then the product kernel, vs the step-by-step plain f32 sweep
    on the same inputs (rel 1e-4); lambda_0 bitwise that of the kernel
    without the history."""
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
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == {
        "fused_bwd_shared_ops": 1, "op_grads": 1}
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
        "fused_fwd": 1, "fused_fwd_ser": 1, "fused_bwd": 1}
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


def _fwd_block(a, b, w, u0, n, store_series):
    """The one-block forward kernel called directly, at any mg."""
    uT, jsum, traj, ser = fk._fwd_outputs(u0, n, True, store_series)
    fk._launch("sm_fused_fwd_block", "fused_fwd_block", u0.device, a.data_ptr(),
               b.data_ptr(), w.data_ptr(), u0.data_ptr(), C2B, C3B, n, a.shape[0],
               uT.data_ptr(), jsum.data_ptr(), traj.data_ptr(), fk._ptr(ser))
    return uT, jsum, traj, ser


@pytest.mark.requires_cuda
@pytest.mark.parametrize("npts,n", [(128, 300), (512, 300), (1024, 200)])
def test_two_matrix_forward_routes_match_plain_on_card(cuda, npts, n):
    """Both routes of the two-matrix forward (the cluster up to mg = 640,
    one block above) against plain f32, rel 1e-4; with and without the
    series J, u_T and the trajectory bitwise; the cluster's bitwise the
    one-block kernel's on the same inputs."""
    a, b, w, u0 = _card_shb23(cuda, npts)
    route = fk.fwd_route(npts)
    fk.reset_launches()
    k = fk.fused_fwd(a, b, w, u0, C2B, C3B, n)
    ks = fk.fused_fwd(a, b, w, u0, C2B, C3B, n, store_series=True)
    torch.cuda.synchronize()
    name = "fused_fwd" if route == "cluster" else "fused_fwd_block"
    assert route == ("cluster" if npts <= 640 else "block")
    assert {k_: v for k_, v in fk.LAUNCHES.items() if v} == {name: 1, name + "_ser": 1}
    r = fk.fused_fwd_plain(a, b, w, u0, C2B, C3B, n, store_series=True)
    for got, want in [(k[0], r[0]), (k[1], r[1]), (k[2], r[2]), (ks[3], r[3])]:
        assert _rel(got.cpu(), want.cpu()) < 1e-4
    for x, y in zip(k[:3], ks[:3]):
        assert torch.equal(x, y)
    blk = _fwd_block(a, b, w, u0, n, True)
    for x, y in zip(ks, blk):
        assert torch.equal(x, y)


@pytest.mark.requires_cuda
def test_two_matrix_forward_rejects_widths_neither_route_takes(cuda):
    for mg in (96, 2176):
        a = torch.zeros(mg, mg, device=cuda)
        v = torch.zeros(mg, device=cuda)
        with pytest.raises(ValueError, match="mg"):
            fk.fused_fwd(a, a, v, v, C2B, C3B, 4)


def _bwd_block(a, b, w, uT, traj, scale, n, lam_hist=None):
    """The one-block reverse kernel called directly, at any mg."""
    lam = torch.empty_like(uT)
    fk._launch("sm_fused_bwd_block", "fused_bwd_block", uT.device, a.data_ptr(),
               b.data_ptr(), w.data_ptr(), uT.data_ptr(), traj.data_ptr(), C2B, C3B,
               scale.data_ptr(), n, a.shape[0], lam.data_ptr(), fk._ptr(lam_hist))
    return lam


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
    lam_b = _bwd_block(a, b, w, uT, traj, sc, n, h_b)
    other = fk.fused_bwd(a, b, w, uT, traj, C2B, C3B, sc, n,
                         lam_hist=None if hist else torch.empty_like(traj))[0]
    torch.cuda.synchronize()
    assert torch.equal(lam_c, lam_b) and torch.equal(lam_c, other)
    if hist:
        assert torch.equal(h_c, h_b)
    lam_p = fk.fused_bwd_plain(a, b, w, uT, traj, C2B, C3B, sc, n)[0]
    assert _rel(lam_c.cpu(), lam_p.cpu()) < 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mg", [512, 1024])
def test_reverse_route_by_width_on_card(cuda, mg):
    """`bwd_route` picks the kernel by mg: the launch counters show the
    cluster up to 640 and the one-block kernel above, both variants of the
    latter under `fused_bwd_block`; lambda within 1e-4 of plain f32."""
    a, b, w, uT, traj, sc = _reverse_inputs(cuda, mg, 200)
    n = traj.shape[0]
    fk.reset_launches()
    lam = fk.fused_bwd(a, b, w, uT, traj, C2B, C3B, sc, n)[0]
    lam_h = fk.fused_bwd(a, b, w, uT, traj, C2B, C3B, sc, n,
                         lam_hist=torch.empty_like(traj))[0]
    torch.cuda.synchronize()
    want = ({"fused_bwd": 1, "fused_bwd_ops": 1} if fk.bwd_route(mg) == "cluster"
            else {"fused_bwd_block": 2})
    assert {k: v for k, v in fk.LAUNCHES.items() if v} == want
    assert torch.equal(lam, lam_h)
    lam_p = fk.fused_bwd_plain(a, b, w, uT, traj, C2B, C3B, sc, n)[0]
    assert _rel(lam.cpu(), lam_p.cpu()) < 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("symbol", ["sm_fused_fwd", "sm_fused_bwd"])
def test_cluster_capacity_of_zero_raises(cuda, symbol, monkeypatch):
    """A cluster the card cannot schedule (capacity 0) raises; nothing
    falls back to the one-block kernel."""
    from spheremanopt_torch.ops.cuda import build

    class NoClusters:
        def __getattr__(self, name):
            if name.endswith("_capacity"):
                return lambda mg, variant: 0
            raise AssertionError(f"{name} must not be called")

    monkeypatch.setattr(build, "load", lambda: NoClusters())
    fk._check_cluster.cache_clear()
    a, b, w, uT, traj, sc = _reverse_inputs(cuda, 128, 4)
    fk.reset_launches()
    with pytest.raises(RuntimeError, match="cannot be scheduled"):
        if symbol == "sm_fused_fwd":
            fk.fused_fwd(a, b, w, uT, C2B, C3B, 4)
        else:
            fk.fused_bwd(a, b, w, uT, traj, C2B, C3B, sc, 4)
    assert not any(fk.LAUNCHES.values())
    monkeypatch.undo()
    fk._check_cluster.cache_clear()
