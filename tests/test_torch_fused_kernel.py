"""Shared-matrix fused integrator of the PyTorch port (plain versions,
wrappers and `FusedObjectiveShared`) against the JAX package's Pallas
kernel `fused_objective_shared`, run in interpret mode on the CPU, and
against its XLA matmul path.

Size: SH23 at npts=64 (mg=128), n_iters=40. Tolerances:
  * f32 vs the interpret-mode kernel: J rel 1e-5, lambda rel 1e-4. Both
    run the same f32 recurrence, but the dot products and energy sums
    are taken in another order, and lambda carries 40 steps of it.
  * f64 vs the JAX matmul path: rel 1e-12 (the step u/dt is lin*u here,
    an ulp apart; nothing else differs).
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
    uT, jsum, traj = fk.fused_fwd_shared_plain(b, w, u0, C2, C3, sh23["lin"], N)
    assert traj.shape == (N, sh23["mg"]) and torch.equal(traj[0], u0)
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
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    scale = torch.tensor(-0.1, dtype=torch.float32)
    lam, _ = fk.fused_bwd_shared(b, w, got[0], got[2], C2, C3, sh23["lin"], scale, N)
    assert torch.equal(lam, fk.fused_bwd_shared_plain(
        b, w, got[0], got[2], C2, C3, sh23["lin"], scale, N)[0])
    assert fk.LAUNCHES == {"fused_fwd_shared": 0, "fused_bwd_shared": 0}


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
    assert fk.LAUNCHES == {"fused_fwd_shared": 1, "fused_bwd_shared": 1}
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
