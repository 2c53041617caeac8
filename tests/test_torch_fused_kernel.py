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
    with pytest.raises(NotImplementedError, match="op_grads"):
        fk.fused_bwd_shared(b, w, w, traj, C2, C3, 1.0, torch.zeros((), device=cuda),
                            4, op_grads=True)


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
    with pytest.raises(NotImplementedError, match="op_grads"):
        fk.fused_bwd(a, a, w, u, traj, C2B, C3B, torch.zeros((), device=cuda), 4,
                     op_grads=True)
    with pytest.raises(ValueError, match="shapes"):
        fk.fused_fwd(a, a[:64], w, u, C2B, C3B, 4)
