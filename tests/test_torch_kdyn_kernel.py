"""Fused kinematic-dynamo integrator of the PyTorch port (plain versions,
wrappers and the autograd Function of `ops/cuda/kdyn_step.py`) against
the JAX package's Pallas kernels of `ops/pallas/kdyn_step.py`, run in
interpret mode on the CPU.

Size: 8^3 modes on the 12^3 grid, 12 CNAB1 steps at dt = 1e-3, inputs
from the JAX package's seed-3 `generate_ic`. Tolerances:
  * `step_planes` / `step_planes_T` in f64 vs the JAX functions of the
    same name: rel 1e-12 (the same operations, einsum sums in another
    order);
  * the f32 plain sweeps vs the interpret-mode kernels: 5e-5 of the
    largest entry (the JAX package's own bound for its kernels against
    autodiff: f32 dot products and energy sums in another order over 12
    steps whose factors carry 1/dt = 1000);
  * `FusedEnergy` (f64, CPU) vs torch autograd of the complex step loop:
    rel 1e-10 for all three cotangents.
The kernels themselves run only on the card: the `requires_cuda` cases
hold them against the plain versions there and skip on the CPU. The
card's machine has no JAX, so JAX is imported only by the fixtures of
the CPU cases, and the card's cases run without the JAX conftest:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_kdyn_kernel.py
"""

import numpy as np
import pytest
import torch

from spheremanopt_torch.ops.cuda import kdyn_step as kd
from spheremanopt_torch.problems.kinematic_dynamo import KDynConfig as TConfig
from spheremanopt_torch.problems.kinematic_dynamo import KinematicDynamo as TKDyn
from spheremanopt_torch.solvers.scan_utils import kahan_add, kahan_zero

NPTS, N, DT = 8, 12, 1e-3
COSTS = [False, True]   # integrated


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def jx():
    """JAX f32 problem, its constant pack, and (br0, bi0, u_bl) as numpy."""
    from spheremanopt_tpu.ops.pallas.kdyn_step import make_consts
    from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    p = KinematicDynamo(KDynConfig(npts=NPTS, n_iters=N, dt=DT, dtype="float32",
                                   project_gradients=False))
    x0 = p.generate_ic(seed=3)
    c = p.to_coeff(x0[0])
    planes = [np.asarray(a) for a in (c.real, c.imag, p.to_grid(p.to_coeff(x0[1])))]
    return dict(p=p, C=make_consts(p), planes=planes,
                x0=[np.asarray(a) for a in x0])


def _consts(jx, dtype):
    """The torch constant pack from the JAX problem's constants."""
    npd = np.float32 if dtype == torch.float32 else np.float64
    return kd.consts_to_torch(kd.make_consts(jx["p"], npd), "cpu")


def _planes(jx, dtype):
    return [torch.tensor(a, dtype=dtype) for a in jx["planes"]]


def test_constant_pack_layout(jx):
    C = _consts(jx, torch.float32)
    n, mg, kz = NPTS, 12, NPTS // 2 + 1
    assert C["packed"].dtype == torch.float32
    assert C["packed"].numel() == 4 * n * mg + 4 * kz * mg + 9 * n * n * kz
    assert torch.equal(C["packed"][: n * mg], C["Ffr"].reshape(-1))
    assert torch.equal(C["packed"][-n * n * kz:], C["mean_mask"].reshape(-1))
    assert float(C["mean_mask"][0, 0, 0]) == 0.0 and float(C["mean_mask"].sum()) == n * n * kz - 1
    # from a port problem the pack is the same as from the JAX one
    tp = TKDyn(TConfig(npts=NPTS, n_iters=N, dt=DT, dtype="float32"), device="cpu")
    Ct = kd.consts_to_torch(kd.make_consts(tp), "cpu")
    assert torch.equal(Ct["packed"], C["packed"])


def test_step_planes_and_transpose_match_jax_f64(jx):
    import jax.numpy as jnp

    from spheremanopt_tpu.ops.pallas import kdyn_step as jk

    C64 = kd.make_consts(jx["p"], np.float64)
    Cj = {k: jnp.asarray(v) for k, v in C64.items()}
    Ct = kd.consts_to_torch(C64, "cpu")
    br, bi, u = (a.astype(np.float64) for a in jx["planes"])
    out_j = jk.step_planes(jnp.asarray(br), jnp.asarray(bi), jnp.asarray(u), Cj)
    out_t = kd.step_planes(torch.tensor(br), torch.tensor(bi), torch.tensor(u), Ct)
    for a, b in zip(out_t, out_j):
        assert a.dtype == torch.float64 and _rel(a, b) < 1e-12
    lam = np.random.RandomState(1).randn(2, *br.shape)
    T_j = jk.step_planes_T(jnp.asarray(lam[0]), jnp.asarray(lam[1]), jnp.asarray(u), Cj)
    T_t = kd.step_planes_T(torch.tensor(lam[0]), torch.tensor(lam[1]),
                           torch.tensor(u), Ct)
    for a, b in zip(T_t, T_j):
        assert _rel(a, b) < 1e-12
    assert T_t[2].shape == (3, 12, 12, 12)
    e_j = jk.energy_planes(jnp.asarray(br), jnp.asarray(bi), Cj)
    assert _rel(kd.energy_planes(torch.tensor(br), torch.tensor(bi), Ct), e_j) < 1e-13


def test_step_planes_T_is_the_transpose_of_step_planes(jx):
    """<S b, lam> == <b, S^T lam> in f64, for random b and lam."""
    Ct = kd.consts_to_torch(kd.make_consts(jx["p"], np.float64), "cpu")
    rs = np.random.RandomState(2)
    br, bi, lr, li = (torch.tensor(rs.randn(3, 8, 8, 5)) for _ in range(4))
    u = torch.tensor(jx["planes"][2], dtype=torch.float64)
    sr, si = kd.step_planes(br, bi, u, Ct)
    tr, ti, _ = kd.step_planes_T(lr, li, u, Ct)
    lhs = float((sr * lr).sum() + (si * li).sum())
    rhs = float((br * tr).sum() + (bi * ti).sum())
    assert abs(lhs - rhs) < 1e-12 * abs(lhs)


@pytest.mark.parametrize("integrated", COSTS)
def test_plain_forward_sweeps_match_interpret_kernels(jx, integrated):
    import jax.numpy as jnp

    from spheremanopt_tpu.ops.pallas import kdyn_step as jk

    args_j = [jnp.asarray(a) for a in jx["planes"]]
    brT_j, biT_j, J_j = jk.run_forward(*args_j, jx["C"], N, True,
                                       integrated=integrated, dt=DT)
    tj = jk._run_fwd_traj(*args_j, jx["C"], N, True, jk._HI, integrated, DT)
    C = _consts(jx, torch.float32)
    br0, bi0, u = _planes(jx, torch.float32)
    out = kd.run_forward_plain(br0, bi0, u, C, N, integrated, DT)
    outt = kd.run_fwd_traj_plain(br0, bi0, u, C, N, integrated, DT)
    assert all(a.dtype == torch.float32 for a in outt)
    for a, b in zip(out, outt[:3]):
        assert torch.equal(a, b)
    for a, b in zip(out, (brT_j, biT_j, J_j)):
        assert _rel(a, b) < 5e-5
    assert outt[3].shape == outt[4].shape == (N, 3, 8, 8, 5)
    assert torch.equal(outt[3][0], br0) and torch.equal(outt[4][0], bi0)
    for a, b in zip(outt, tj):
        assert _rel(a, b) < 5e-5


@pytest.mark.parametrize("integrated", COSTS)
def test_plain_reverse_sweep_matches_interpret_kernel(jx, integrated):
    import jax.numpy as jnp

    from spheremanopt_tpu.ops.pallas import kdyn_step as jk

    args_j = [jnp.asarray(a) for a in jx["planes"]]
    brT, biT, _, trr, tri = jk._run_fwd_traj(*args_j, jx["C"], N, True, jk._HI,
                                             integrated, DT)
    gbar = -1.0
    g_j = jk._run_bwd(args_j[2], brT, biT, jnp.float32(gbar), trr, tri, jx["C"], N,
                      True, jk._HI, integrated, DT)
    C = _consts(jx, torch.float32)
    u = _planes(jx, torch.float32)[2]
    t = [torch.tensor(np.asarray(a)) for a in (brT, biT, trr, tri)]
    g_t = kd.run_bwd_plain(u, t[0], t[1], torch.tensor(gbar), t[2], t[3], C, N,
                           integrated, DT)
    for name, a, b in zip(("dbr0", "dbi0", "du"), g_t, g_j):
        assert a.dtype == torch.float32 and _rel(a, b) < 5e-5, name


def _loop_J(p, br, bi, u, n, integrated):
    """J of the port's complex step loop, plain sums as the JAX tests' own."""
    b = torch.complex(br, bi)
    acc = br.new_zeros(())
    for _ in range(n):
        if integrated:
            acc = acc + p._energy(b)
        b = p._cnab1_step(b, u)
    eT = p._energy(b)
    return p.cfg.dt * (acc + eT) if integrated else eT


@pytest.mark.parametrize("integrated", COSTS)
def test_fused_energy_matches_autograd_of_the_complex_loop(jx, integrated):
    """All three cotangents of the hand-transposed sweep, in f64 on the
    CPU, against reverse-mode autograd of the complex CNAB1 loop."""
    p = TKDyn(TConfig(npts=NPTS, n_iters=N, dt=DT), device="cpu")
    C = kd.consts_to_torch(kd.make_consts(p, np.float64), "cpu")
    ins = [a.requires_grad_(True) for a in _planes(jx, torch.float64)]
    J_f = kd.FusedEnergy.apply(*ins, C, N, integrated, DT)
    g_f = torch.autograd.grad(J_f, ins)
    ins2 = [a.detach().clone().requires_grad_(True) for a in ins]
    J_r = _loop_J(p, *ins2, N, integrated)
    g_r = torch.autograd.grad(J_r, ins2)
    assert abs(float(J_f.detach()) - float(J_r.detach())) < 1e-12 * abs(float(J_r.detach()))
    for name, a, b in zip(("dbr0", "dbi0", "du"), g_f, g_r):
        assert _rel(a, b) < 1e-10, name
    # an upstream cotangent scales all three
    J2 = kd.FusedEnergy.apply(*ins, C, N, integrated, DT)
    g2 = torch.autograd.grad(-3.0 * J2, ins)
    for a, b in zip(g2, g_f):
        assert _rel(a, -3.0 * b) < 1e-14


@pytest.mark.parametrize("integrated", COSTS)
def test_fused_energy_f32_matches_jax_custom_vjp(jx, integrated):
    import jax
    import jax.numpy as jnp

    from spheremanopt_tpu.ops.pallas.kdyn_step import make_fused_energy

    f = make_fused_energy(jx["C"], N, interpret=True, integrated=integrated, dt=DT)
    J_j, g_j = jax.value_and_grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in jx["planes"]))
    ins = [a.requires_grad_(True) for a in _planes(jx, torch.float32)]
    kd.reset_launches()
    J_t = kd.FusedEnergy.apply(*ins, _consts(jx, torch.float32), N, integrated, DT)
    g_t = torch.autograd.grad(J_t, ins)
    assert J_t.dtype == torch.float32 and not any(kd.LAUNCHES.values())
    assert abs(float(J_t.detach()) - float(J_j)) < 1e-5 * abs(float(J_j))
    for name, a, b in zip(("dbr0", "dbi0", "du"), g_t, g_j):
        assert _rel(a, b) < 5e-5, name


def test_primal_only_call_stores_no_trajectory(jx, monkeypatch):
    seen = []
    for name in ("run_forward", "run_fwd_traj"):
        real = getattr(kd, name)
        monkeypatch.setattr(kd, name, lambda *a, _n=name, _r=real: (
            seen.append(_n), _r(*a))[1])
    C = _consts(jx, torch.float32)
    ins = _planes(jx, torch.float32)
    kd.FusedEnergy.apply(*ins, C, N, False, DT)
    ins[2].requires_grad_(True)
    kd.FusedEnergy.apply(*ins, C, N, False, DT)
    assert seen == ["run_forward", "run_fwd_traj"]


def test_integrated_needs_a_positive_dt(jx):
    C = _consts(jx, torch.float32)
    ins = _planes(jx, torch.float32)
    with pytest.raises(ValueError, match="dt"):
        kd.FusedEnergy.apply(*ins, C, 4, True)
    with pytest.raises(ValueError, match="dt"):
        kd.FusedEnergy.apply(*ins, C, 4, True, -1.0)


def test_cpu_tensors_take_the_plain_versions(jx):
    kd.reset_launches()
    C = _consts(jx, torch.float32)
    br0, bi0, u = _planes(jx, torch.float32)
    got = kd.run_fwd_traj(br0, bi0, u, C, N, True, DT)
    want = kd.run_fwd_traj_plain(br0, bi0, u, C, N, True, DT)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(
        kd.run_forward(br0, bi0, u, C, N, True, DT), want[:3]))
    g = torch.tensor(-1.0)
    gb = kd.run_bwd(u, got[0], got[1], g, got[3], got[4], C, N, True, DT)
    wb = kd.run_bwd_plain(u, got[0], got[1], g, got[3], got[4], C, N, True, DT)
    assert all(torch.equal(a, b) for a, b in zip(gb, wb))
    assert not any(kd.LAUNCHES.values())
    assert set(kd.LAUNCHES) == set(kd.KERNEL_SOURCES) == {
        "kdyn_fwd", "kdyn_fwd_traj", "kdyn_bwd",
        "kdyn_fwd_rows", "kdyn_fwd_traj_rows", "kdyn_bwd_rows"}


@pytest.mark.parametrize("cost", ["Final", "Integrated"])
def test_cuda_method_on_cpu_matches_plain_method_and_jax_pallas(jx, cost):
    """method="cuda" end to end with the Riesz wrapper (on the CPU: the
    plain versions, f32) vs method="plain" f32 and vs the JAX package's
    method="pallas" in interpret mode."""
    from spheremanopt_tpu.problems.kinematic_dynamo import KDynConfig, KinematicDynamo

    kw = dict(npts=NPTS, n_iters=10, dt=DT, dtype="float32", cost=cost)
    pk = TKDyn(TConfig(method="cuda", **kw), device="cpu")
    pp = TKDyn(TConfig(method="plain", **kw), device="cpu")
    x = [torch.tensor(a) for a in jx["x0"]]
    kd.reset_launches()
    J_k, g_k = pk.objective_and_gradient(x)
    J_p, g_p = pp.objective_and_gradient(x)
    assert not any(kd.LAUNCHES.values())
    assert J_k.dtype == torch.float32 and float(pk.objective(x)) == float(J_k)
    assert abs(float(J_k) - float(J_p)) < 1e-5 * abs(float(J_p))
    for a, b in zip(g_k, g_p):
        assert _rel(a, b) < 5e-5
    import jax.numpy as jnp

    J_j, g_j = KinematicDynamo(KDynConfig(method="pallas", **kw)) \
        .objective_and_gradient([jnp.asarray(a) for a in jx["x0"]])
    assert abs(float(J_k) - float(J_j)) < 1e-5 * abs(float(J_j))
    for a, b in zip(g_k, g_j):
        assert _rel(a, b) < 5e-5


def _two_stage_reverse(u, brT, biT, gbar, trr, tri, C, n_steps, integrated, dt):
    """The reverse kernel's partition, in plain complex torch: stage X by
    mode column (the head, x-analysis^T of p0 -> q1, x-synthesis of the
    stored state -> g1; then x-synthesis^T of r4 plus the direct term),
    stage YZ by x-grid slab and group of y-grid points (y-stages, pencils,
    the group's share of r4). Only q1, g1 and the groups' shares of r4
    cross between the stages; the shares are added in group order, with S
    and the group size chosen as the kernel chooses them."""
    Ff = torch.complex(C["Ffr"], C["Ffi"])      # (n, mg)
    Bf = torch.complex(C["Bfr"], C["Bfi"])      # (mg, n)
    Bz = torch.complex(C["Bzr"], C["Bzi"])      # (mg, kz)
    k, pw = C["k"], C["pw"]
    mg = Bf.shape[0]
    S = -(-mg // 6)
    nb = -(-mg // S)

    def head(lam):
        t = kd._leray_scale(lam.real, C) + 1j * kd._leray_scale(lam.imag, C)
        p0 = (-kd._cross(k, t.imag) + 1j * kd._cross(k, t.real)) * C["keep"]
        return C["rhs_fac"] * t, p0

    def stage_x_tail(lam, state):
        d, p0 = head(lam)
        q1 = torch.einsum("Xa,cXYz->caYz", Ff.conj(), p0)
        g1 = torch.einsum("aX,cXYz->caYz", Bf, state)
        return d, q1, g1

    states = torch.complex(trr, tri)
    lam = ((2.0 * dt if integrated else 2.0) * gbar * pw) * torch.complex(brT, biT)
    d, q1, g1 = stage_x_tail(lam, states[n_steps - 1])
    ubar = torch.zeros_like(u)
    for kk in range(n_steps):
        shares = []
        for grp in range(S):
            bs = slice(grp * nb, min(mg, (grp + 1) * nb))
            q2 = torch.einsum("Yb,caYz->cabz", Ff[:, bs].conj(), q1)
            g2 = torch.einsum("bY,caYz->cabz", Bf[bs], g1)
            e_bar = (torch.einsum("zk,cabz->cabk", C["Fzr"], q2.real)
                     + torch.einsum("zk,cabz->cabk", C["Fzi"], q2.imag))
            bg = torch.einsum("kz,cabz->cabk", Bz, g2).real
            ubar[:, :, bs] += kd._cross(bg, e_bar)
            gs = kd._cross(e_bar, u[:, :, bs])
            r3 = torch.einsum("kz,cabk->cabz", Bz.conj(), gs.to(Bz.dtype))
            shares.append(torch.einsum("bY,cabz->caYz", Bf[bs].conj(), r3))
        r4 = shares[0]
        for sh in shares[1:]:
            r4 = r4 + sh
        n = n_steps - 1 - kk
        lam = torch.einsum("aX,caYz->cXYz", Bf.conj(), r4) + d
        if integrated:
            lam = lam + (2.0 * dt) * gbar * pw * states[n]
        if kk + 1 < n_steps:
            d, q1, g1 = stage_x_tail(lam, states[n - 1])
    return lam.real, lam.imag, ubar


@pytest.mark.parametrize("integrated", COSTS)
def test_reverse_kernel_partition_matches_step_planes_T_f64(jx, integrated):
    """The two-stage partition of the reverse kernel (stage boundaries,
    the groups' shares of r4, the order the stored states are read in),
    emulated in f64: rel 1e-12 against the step-by-step `step_planes_T`
    sweep for 4 steps at n = 8."""
    C = kd.consts_to_torch(kd.make_consts(jx["p"], np.float64), "cpu")
    br0, bi0, u = _planes(jx, torch.float64)
    n = 4
    brT, biT, _, trr, tri = kd.run_fwd_traj_plain(br0, bi0, u, C, n, integrated, DT)
    g = torch.tensor(-1.0, dtype=torch.float64)
    want = kd.run_bwd_plain(u, brT, biT, g, trr, tri, C, n, integrated, DT)
    got = _two_stage_reverse(u, brT, biT, g, trr, tri, C, n, integrated, DT)
    for name, a, b in zip(("dbr0", "dbi0", "du"), got, want):
        assert a.dtype == torch.float64 and _rel(a, b) < 1e-12, name


def _two_stage_forward(br0, bi0, u, C, n_steps, integrated, dt):
    """The forward kernel's partition, in plain complex torch: stage X by
    mode column (the groups' shares of h4 added in group order, the
    x-analysis, the mode-space tail, the chunk's energy partial, the
    x-synthesis of the new state -> g1), stage YZ by x-grid slab and
    group of y-grid points (y-synthesis of g1, the pencils' z-synthesis,
    u x B and z-analysis, the group's share of the y-analysis). Only g1
    and the shares of h4 cross between the stages; S, the group size and
    the chunks of two columns are chosen as the kernel chooses them; the
    energies are per-chunk partials added in chunk order, E(b_0) ..
    E(b_{N-1}) Kahan-summed for the integrated cost. Returns (brT, biT, J,
    trr, tri)."""
    Ff = torch.complex(C["Ffr"], C["Ffi"])      # (n, mg)
    Bf = torch.complex(C["Bfr"], C["Bfi"])      # (mg, n)
    Fz = torch.complex(C["Fzr"], C["Fzi"])      # (kz, mg)
    Bz = torch.complex(C["Bzr"], C["Bzi"])      # (mg, kz)
    k, pw = C["k"], C["pw"]
    mg, n = Bf.shape
    kz = n // 2 + 1
    S = -(-mg // 6)
    nb = -(-mg // S)
    chunks = [slice(c, c + 2) for c in range(0, n * kz, 2)]   # of the (Y, z) columns

    def energy(b):
        per_mode = (pw * (b.real ** 2 + b.imag ** 2)).sum(0).reshape(-1, n * kz)
        total = b.real.new_zeros(())
        for ch in chunks:                 # the chunks' partials, in chunk order
            total = total + per_mode[:, ch].sum()
        return total

    def tail(b, h4):
        e = torch.einsum("Xa,caYz->cXYz", Ff, h4) * C["keep"]
        f = -kd._cross(k, e.imag) + 1j * kd._cross(k, e.real)   # i k x e
        rhs = C["rhs_fac"] * b + f
        div = torch.sum(k * rhs, dim=0) * C["inv_k2"]
        return (rhs - k * div[None]) * C["lhs_inv"] * C["mean_mask"]

    b = torch.complex(br0, bi0)
    traj = [b]
    acc = kahan_zero(br0.dtype, br0.device)
    if integrated:
        acc = kahan_add(acc, energy(b))
    g1 = torch.einsum("aX,cXYz->caYz", Bf, b)
    for step in range(n_steps):
        shares = []
        for grp in range(S):
            bs = slice(grp * nb, min(mg, (grp + 1) * nb))
            g2 = torch.einsum("bY,caYz->cabz", Bf[bs], g1)
            bg = torch.einsum("kz,cabz->cabk", Bz, g2).real
            e = kd._cross(u[:, :, bs], bg)
            h3 = torch.einsum("zk,cabk->cabz", Fz, e.to(Fz.dtype))
            shares.append(torch.einsum("Yb,cabz->caYz", Ff[:, bs], h3))
        h4 = shares[0]
        for sh in shares[1:]:
            h4 = h4 + sh
        b = tail(b, h4)
        if step + 1 < n_steps:
            traj.append(b)
            if integrated:
                acc = kahan_add(acc, energy(b))
        g1 = torch.einsum("aX,cXYz->caYz", Bf, b)
    eT = energy(b)
    J = dt * kahan_add(acc, eT)[0] if integrated else eT
    traj = torch.stack(traj)
    return b.real, b.imag, J, traj.real, traj.imag


@pytest.mark.parametrize("integrated", COSTS)
def test_forward_kernel_partition_matches_step_planes_f64(jx, integrated):
    """The two-stage partition of the forward kernel (stage boundaries,
    the groups' shares of h4 added in group order, the energy at each
    step from per-chunk partials), emulated in f64: rel 1e-12 against the
    step-by-step `run_fwd_traj_plain` and against a sweep of the JAX
    package's `step_planes`, for 4 steps at n = 8."""
    import jax.numpy as jnp

    from spheremanopt_tpu.ops.pallas import kdyn_step as jk

    C64 = kd.make_consts(jx["p"], np.float64)
    C = kd.consts_to_torch(C64, "cpu")
    br0, bi0, u = _planes(jx, torch.float64)
    n = 4
    got = _two_stage_forward(br0, bi0, u, C, n, integrated, DT)
    want = kd.run_fwd_traj_plain(br0, bi0, u, C, n, integrated, DT)
    for name, a, b in zip(("brT", "biT", "J", "trr", "tri"), got, want):
        assert a.dtype == torch.float64 and a.shape == b.shape, name
        assert _rel(a, b) < 1e-12, name
    # the JAX package's step, swept step by step
    Cj = {key: jnp.asarray(v) for key, v in C64.items()}
    bj_r, bj_i, uj = (jnp.asarray(a.numpy()) for a in (br0, bi0, u))
    rows_r, rows_i, acc = [], [], 0.0
    for _ in range(n):
        rows_r.append(np.asarray(bj_r))
        rows_i.append(np.asarray(bj_i))
        acc += float(jk.energy_planes(bj_r, bj_i, Cj))
        bj_r, bj_i = jk.step_planes(bj_r, bj_i, uj, Cj)
    eT = float(jk.energy_planes(bj_r, bj_i, Cj))
    J_j = DT * (acc + eT) if integrated else eT
    for name, a, b in zip(("brT", "biT", "J", "trr", "tri"), got,
                          (bj_r, bj_i, J_j, np.stack(rows_r), np.stack(rows_i))):
        assert _rel(a, b) < 1e-12, name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(cuda, integrated, npts=NPTS, n=N):
    p = TKDyn(TConfig(npts=npts, n_iters=n, dt=DT, dtype="float32", method="cuda",
                      cost="Integrated" if integrated else "Final"), device=cuda)
    with torch.no_grad():
        b0_c, u = p._prepare(p.generate_ic(seed=3))
    return p, b0_c.real.contiguous(), b0_c.imag.contiguous(), u.contiguous()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("npts", [8, 12, 24])
@pytest.mark.parametrize("integrated", COSTS)
def test_kernels_match_plain_on_card(cuda, integrated, npts):
    """The three kernels vs their plain f32 versions on the same card
    inputs, rel 1e-4 (f32 sums in another order over the sweep), at two
    small n and at the 24^3 width (the compile-time instances); the
    forward with and without the trajectory bitwise the same, and two
    calls of the forward bitwise equal."""
    p, br0, bi0, u = _card_case(cuda, integrated, npts, 40)
    C, n = p._consts, 40
    kd.reset_launches()
    k = kd.run_fwd_traj(br0, bi0, u, C, n, integrated, DT)
    k0 = kd.run_forward(br0, bi0, u, C, n, integrated, DT)
    again = kd.run_fwd_traj(br0, bi0, u, C, n, integrated, DT)
    r = kd.run_fwd_traj_plain(br0, bi0, u, C, n, integrated, DT)
    g = torch.tensor(-1.0, device=cuda)
    bk = kd.run_bwd(u, k[0], k[1], g, k[3], k[4], C, n, integrated, DT)
    br = kd.run_bwd_plain(u, k[0], k[1], g, k[3], k[4], C, n, integrated, DT)
    torch.cuda.synchronize()
    assert {k: v for k, v in kd.LAUNCHES.items() if v} == {
        "kdyn_fwd": 1, "kdyn_fwd_traj": 2, "kdyn_bwd": 1}
    for got, want in list(zip(k, r)) + list(zip(bk, br)):
        assert _rel(got.cpu(), want.cpu()) < 1e-4
    for a, b in zip(k0, k[:3]):
        assert torch.equal(a, b)
    for a, b in zip(k, again):
        assert torch.equal(a, b)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cost", ["Final", "Integrated"])
def test_method_cuda_matches_method_plain_on_card(cuda, cost):
    kw = dict(npts=NPTS, n_iters=40, dt=DT, dtype="float32", cost=cost)
    pk = TKDyn(TConfig(method="cuda", **kw), device=cuda)
    pp = TKDyn(TConfig(method="plain", **kw), device=cuda)
    x = pk.generate_ic(seed=5)
    kd.reset_launches()
    J_k, g_k = pk.objective_and_gradient(x)
    assert float(pk.objective(x)) == float(J_k)
    assert {k: v for k, v in kd.LAUNCHES.items() if v} == {
        "kdyn_fwd": 1, "kdyn_fwd_traj": 1, "kdyn_bwd": 1}
    J_p, g_p = pp.objective_and_gradient(x)
    assert abs(float(J_k) - float(J_p)) < 1e-5 * abs(float(J_p))
    for a, b in zip(g_k, g_p):
        assert _rel(a.cpu(), b.cpu()) < 1e-4


@pytest.mark.requires_cuda
def test_kernel_wrappers_reject_what_they_cannot_run(cuda):
    p, br0, bi0, u = _card_case(cuda, False)
    C = p._consts
    with pytest.raises(TypeError, match="float32"):
        kd.run_forward(br0.double(), bi0, u, C, 4)
    with pytest.raises(ValueError, match="shape"):
        kd.run_forward(br0[:, :4].contiguous(), bi0, u, C, 4)
    with pytest.raises(ValueError, match="contiguous"):
        kd.run_forward(br0, bi0, u.transpose(1, 2), C, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kd.run_forward(br0, bi0, u.cpu(), C, 4)
    with pytest.raises(ValueError, match="n_steps"):
        kd.run_forward(br0, bi0, u, C, 0)
    with pytest.raises(ValueError, match="dt"):
        kd.run_fwd_traj(br0, bi0, u, C, 4, True, 0.0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("npts", [8, 24])
@pytest.mark.parametrize("integrated", COSTS)
def test_reverse_kernel_matches_plain_and_repeats_on_card(cuda, integrated, npts):
    """The two-stage reverse kernel against its plain f32 version on the
    same card inputs (rel 1e-4, 40 steps), at a small n and at the 24^3
    width; two calls give bitwise equal (b0_bar, u_bar)."""
    p, br0, bi0, u = _card_case(cuda, integrated, npts, 40)
    C, n = p._consts, 40
    k = kd.run_fwd_traj(br0, bi0, u, C, n, integrated, DT)
    g = torch.tensor(-1.0, device=cuda)
    kd.reset_launches()
    bk = kd.run_bwd(u, k[0], k[1], g, k[3], k[4], C, n, integrated, DT)
    again = kd.run_bwd(u, k[0], k[1], g, k[3], k[4], C, n, integrated, DT)
    torch.cuda.synchronize()
    assert kd.LAUNCHES["kdyn_bwd"] == 2
    br = kd.run_bwd_plain(u, k[0], k[1], g, k[3], k[4], C, n, integrated, DT)
    for got, want in zip(bk, br):
        assert _rel(got.cpu(), want.cpu()) < 1e-4
    for x, y in zip(bk, again):
        assert torch.equal(x, y)
