"""Fused kinematic-dynamo integrator and its reverse sweep, as
hand-written CUDA kernels for Hopper.

PyTorch port of the JAX package's `ops/pallas/kdyn_step.py`:

  run_forward    <- `run_forward` / `_fwd_kernel`        (kernel kdyn_fwd)
  run_fwd_traj   <- `_run_fwd_traj` / `_fwd_traj_kernel` (kdyn_fwd_traj)
  run_bwd        <- `_run_bwd` / `_bwd_kernel`           (kdyn_bwd)
  FusedEnergy    <- `make_fused_energy` (custom_vjp)

and the same kernels over a sweep's rows (the JAX package's `jax.vmap` of
them, where `pallas_call`'s batching rule gives each a grid over the
rows: one launch for every row):

  run_forward_rows   (kdyn_fwd_rows)       run_fwd_traj_rows (kdyn_fwd_traj_rows)
  run_bwd_rows       (kdyn_bwd_rows)       FusedEnergyRows

R states with a leading row axis, up to ROWS_MAX rows a launch (the kRows
instances of the same two kernel templates), each row's outputs bitwise
the one-row kernel's on it.

The whole CNAB1 induction solve — per-axis DFT synthesis, u x B on the
oversampled grid, analysis, curl, Leray projection, diagonal implicit
update, energy — runs in one launch per sweep. All arithmetic is real:
coefficient fields are (re, im) planes of shape (3, n, n, n//2+1) and
the complex transform matrices are applied through their real and
imaginary parts. The induction equation is linear in B, so the
B-cotangent recursion is the exact transpose of the step operator; only
dJ/dU consumes the stored per-step states.

Each wrapper takes its plain PyTorch version (`*_plain`, Python loops
over `step_planes` / `step_planes_T`, f32 or f64; the row versions
`*_rows_plain` a row at a time, each row bitwise the one-row version) for
tensors on the CPU and launches its kernel for CUDA tensors; a CUDA
tensor never falls back. `LAUNCHES` counts kernel launches per wrapper.
The kernels are f32 only.
"""

from __future__ import annotations

import numpy as np
import torch

from spheremanopt_torch.solvers.scan_utils import kahan_add, kahan_zero

KERNEL_SOURCES = {
    "kdyn_fwd": "spheremanopt_torch/csrc/kdyn_step.cu",
    "kdyn_fwd_traj": "spheremanopt_torch/csrc/kdyn_step.cu",
    "kdyn_bwd": "spheremanopt_torch/csrc/kdyn_step.cu",
    "kdyn_fwd_rows": "spheremanopt_torch/csrc/kdyn_step.cu",
    "kdyn_fwd_traj_rows": "spheremanopt_torch/csrc/kdyn_step.cu",
    "kdyn_bwd_rows": "spheremanopt_torch/csrc/kdyn_step.cu",
}
# kernel launches per wrapper since the last reset_launches()
LAUNCHES = {name: 0 for name in KERNEL_SOURCES}
# rows one launch of a row kernel steps (csrc/kdyn_step.cu kMaxRows: each
# row's Kahan sum on its own warp); a wider call runs in chunks of
# ROWS_MAX rows, each chunk one launch
ROWS_MAX = 8

# order of the constants in the flat f32 pack the kernels read
_MATRICES = ("Ffr", "Ffi", "Fzr", "Fzi", "Bfr", "Bfi", "Bzr", "Bzi")
_FACTORS = ("k", "inv_k2", "lhs_inv", "rhs_fac", "keep", "pw", "mean_mask")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def make_consts(p, dtype=np.float32):
    """Numpy constant pack of a KinematicDynamo problem of either package
    (matmul-path matrices and mode-space factors), f32 as the kernels
    read it unless `dtype` says otherwise."""
    mean_mask = np.ones(np.shape(p._inv_k2), dtype)
    mean_mask[0, 0, 0] = 0.0
    return dict(
        Ffr=np.real(p._Ff).astype(dtype), Ffi=np.imag(p._Ff).astype(dtype),
        Fzr=np.real(p._Fz).astype(dtype), Fzi=np.imag(p._Fz).astype(dtype),
        Bfr=np.real(p._Bf).astype(dtype), Bfi=np.imag(p._Bf).astype(dtype),
        Bzr=np.real(p._Bz).astype(dtype), Bzi=np.imag(p._Bz).astype(dtype),
        k=np.asarray(p._k, dtype),
        inv_k2=np.asarray(p._inv_k2, dtype),
        lhs_inv=np.asarray(p._lhs_inv, dtype),
        rhs_fac=np.asarray(p._rhs_fac, dtype),
        keep=np.asarray(p._keep, dtype),
        pw=np.asarray(p._pw, dtype),
        mean_mask=mean_mask,
    )


def consts_to_torch(consts, device):
    """The constant pack as tensors on `device`, each in its own dtype,
    plus `packed`: all of them as one flat f32 tensor in the order the
    kernels read (matrices, then mode-space factors)."""
    C = {k: torch.as_tensor(np.asarray(v), device=device)
         for k, v in consts.items()}
    C["packed"] = torch.cat([C[k].reshape(-1).float()
                             for k in _MATRICES + _FACTORS]).contiguous()
    return C


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _cmul(eq, Mr, Mi, ar, ai, conj=False):
    """(M a) or (conj(M) a) along one axis, on (re, im) planes."""
    s = -1.0 if conj else 1.0
    r = torch.einsum(eq, Mr, ar) - s * torch.einsum(eq, Mi, ai)
    i = torch.einsum(eq, Mr, ai) + s * torch.einsum(eq, Mi, ar)
    return r, i


def _to_grid(br, bi, C):
    """(3,n,n,kz) re/im planes -> (3,mg,mg,mg) real grid (x,y synthesis
    complex, z synthesis keeps only the real output)."""
    gr, gi = _cmul("aX,cXYZ->caYZ", C["Bfr"], C["Bfi"], br, bi)
    gr, gi = _cmul("bY,caYZ->cabZ", C["Bfr"], C["Bfi"], gr, gi)
    return (torch.einsum("kZ,cabZ->cabk", C["Bzr"], gr)
            - torch.einsum("kZ,cabZ->cabk", C["Bzi"], gi))


def _to_coeff(g, C):
    """(3,mg,mg,mg) real grid -> (3,n,n,kz) re/im planes, band-masked."""
    cr = torch.einsum("Zk,cabk->cabZ", C["Fzr"], g)
    ci = torch.einsum("Zk,cabk->cabZ", C["Fzi"], g)
    cr, ci = _cmul("Yb,cabZ->caYZ", C["Ffr"], C["Ffi"], cr, ci)
    cr, ci = _cmul("Xa,caYZ->cXYZ", C["Ffr"], C["Ffi"], cr, ci)
    return cr * C["keep"], ci * C["keep"]


def _cross(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def step_planes(br, bi, u, C):
    """One CNAB1 step on re/im planes."""
    k = C["k"]
    bg = _to_grid(br, bi, C)
    e = _cross(u, bg)
    er, ei = _to_coeff(e, C)
    # F = i k x e_c: multiply by i maps (re, im) -> (-im, re)
    fr = -_cross(k, ei)
    fi = _cross(k, er)
    rr = C["rhs_fac"] * br + fr
    ri = C["rhs_fac"] * bi + fi
    # Leray projection (k real: acts identically on both planes)
    divr = torch.sum(k * rr, dim=0)
    divi = torch.sum(k * ri, dim=0)
    rr = (rr - k * (divr * C["inv_k2"])[None]) * C["lhs_inv"]
    ri = (ri - k * (divi * C["inv_k2"])[None]) * C["lhs_inv"]
    return rr * C["mean_mask"], ri * C["mean_mask"]


def energy_planes(br, bi, C):
    return torch.sum(C["pw"] * (br * br + bi * bi))


def _to_grid_T(gbar, C):
    """Transpose of _to_grid as a real-linear map: grid cotangent ->
    coefficient-plane cotangents. Complex-matrix stages transpose to
    M^H-applications; the real-output z stage splits into (Bzr^T, -Bzi^T)."""
    gr = torch.einsum("kZ,cabk->cabZ", C["Bzr"], gbar)
    gi = -torch.einsum("kZ,cabk->cabZ", C["Bzi"], gbar)
    gr, gi = _cmul("bY,cabZ->caYZ", C["Bfr"], C["Bfi"], gr, gi, conj=True)
    return _cmul("aX,caYZ->cXYZ", C["Bfr"], C["Bfi"], gr, gi, conj=True)


def _to_coeff_T(cr_bar, ci_bar, C):
    """Transpose of _to_coeff: coefficient-plane cotangents -> grid
    cotangent (real)."""
    cr_bar, ci_bar = _cmul("Xa,cXYZ->caYZ", C["Ffr"], C["Ffi"],
                           cr_bar * C["keep"], ci_bar * C["keep"], conj=True)
    cr_bar, ci_bar = _cmul("Yb,caYZ->cabZ", C["Ffr"], C["Ffi"], cr_bar, ci_bar,
                           conj=True)
    return (torch.einsum("Zk,cabZ->cabk", C["Fzr"], cr_bar)
            + torch.einsum("Zk,cabZ->cabk", C["Fzi"], ci_bar))


def _leray_scale(x, C):
    """mean_mask -> lhs_inv -> symmetric k-projector (the transpose of
    the forward's projector-then-scale tail)."""
    t = C["lhs_inv"] * (C["mean_mask"] * x)
    div = torch.sum(C["k"] * t, dim=0)
    return t - C["k"] * (div * C["inv_k2"])[None]


def step_planes_T(cr, ci, u, C):
    """Transpose of step_planes w.r.t. (br, bi): cotangent recursion
    lam_n = S^T lam_{n+1}. Also returns the grid-space e_bar needed for
    the dJ/dU accumulation (u_bar += bg_n x e_bar_n)."""
    tr = _leray_scale(cr, C)
    ti = _leray_scale(ci, C)
    # rhs = rhs_fac*b + F: direct term
    br_bar = C["rhs_fac"] * tr
    bi_bar = C["rhs_fac"] * ti
    # F = (-k x ei, k x er): er_bar = -k x fi_bar, ei_bar = k x fr_bar
    er_bar = -_cross(C["k"], ti)
    ei_bar = _cross(C["k"], tr)
    e_bar = _to_coeff_T(er_bar, ei_bar, C)
    # e = u x bg: bg_bar = e_bar x u
    gr_bar, gi_bar = _to_grid_T(_cross(e_bar, u), C)
    return br_bar + gr_bar, bi_bar + gi_bar, e_bar


def _plain_forward(br0, bi0, u, C, n_steps, integrated, dt, store_traj):
    br, bi = br0, bi0
    acc = kahan_zero(br0.dtype, br0.device)
    trr, tri = [], []
    for _ in range(n_steps):
        if store_traj:
            trr.append(br)
            tri.append(bi)
        if integrated:
            acc = kahan_add(acc, energy_planes(br, bi, C))
        br, bi = step_planes(br, bi, u, C)
    eT = energy_planes(br, bi, C)
    J = dt * kahan_add(acc, eT)[0] if integrated else eT
    if store_traj:
        return br, bi, J, torch.stack(trr), torch.stack(tri)
    return br, bi, J


def run_forward_plain(br0, bi0, u, C, n_steps, integrated=False, dt=0.0):
    """(brT, biT, J), step by step: J = E(b_T), or
    dt * (Kahan sum of E(b_0..b_{N-1}), then E(b_T)) when integrated."""
    return _plain_forward(br0, bi0, u, C, n_steps, integrated, dt, False)


def run_fwd_traj_plain(br0, bi0, u, C, n_steps, integrated=False, dt=0.0):
    """(brT, biT, J, trr, tri): the same solve; row i of the trajectory is
    the state before step i."""
    return _plain_forward(br0, bi0, u, C, n_steps, integrated, dt, True)


def run_bwd_plain(u, brT, biT, gbar, trr, tri, C, n_steps, integrated=False,
                  dt=0.0):
    """(dJ/dbr0, dJ/dbi0, dJ/du): lam_T = w_T gbar pw b_T (w_T = 2, or
    2 dt integrated); lam_n = S^T lam_{n+1} [+ 2 dt gbar pw b_n];
    u_bar += to_grid(b_n) x e_bar_n."""
    wT = (2.0 * dt) if integrated else 2.0
    lam_r = wT * gbar * C["pw"] * brT
    lam_i = wT * gbar * C["pw"] * biT
    ubar = torch.zeros_like(u)
    for kk in range(n_steps):
        lam_r, lam_i, e_bar = step_planes_T(lam_r, lam_i, u, C)
        sr, si = trr[n_steps - 1 - kk], tri[n_steps - 1 - kk]
        if integrated:
            lam_r = lam_r + (2.0 * dt) * gbar * C["pw"] * sr
            lam_i = lam_i + (2.0 * dt) * gbar * C["pw"] * si
        ubar = ubar + _cross(_to_grid(sr, si, C), e_bar)
    return lam_r, lam_i, ubar


def _stack_rows(outs):
    """The one-row calls' outputs `outs`, each output stacked over the rows."""
    return tuple(torch.stack(v) for v in zip(*outs))


def run_forward_rows_plain(br0, bi0, u, C, n_steps, integrated=False, dt=0.0):
    """`run_forward_plain` of each row of br0, bi0 (R, 3, n, n, kz) and u
    (R, 3, mg, mg, mg), a row at a time: (brT, biT, J (R,))."""
    return _stack_rows(run_forward_plain(a, b, c, C, n_steps, integrated, dt)
                       for a, b, c in zip(br0, bi0, u))


def run_fwd_traj_rows_plain(br0, bi0, u, C, n_steps, integrated=False, dt=0.0):
    """`run_fwd_traj_plain` of each row, a row at a time: (brT, biT, J (R,),
    trr, tri (R, n_steps, 3, n, n, kz))."""
    return _stack_rows(run_fwd_traj_plain(a, b, c, C, n_steps, integrated, dt)
                       for a, b, c in zip(br0, bi0, u))


def run_bwd_rows_plain(u, brT, biT, gbar, trr, tri, C, n_steps, integrated=False,
                       dt=0.0):
    """`run_bwd_plain` of each row, gbar (R,), a row at a time: (dJ/dbr0,
    dJ/dbi0, dJ/du), each (R, ...)."""
    return _stack_rows(run_bwd_plain(*row, C, n_steps, integrated, dt)
                       for row in zip(u, brT, biT, gbar, trr, tri))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_dt(integrated, dt):
    if integrated and dt <= 0.0:
        raise ValueError("integrated=True requires dt > 0 (J would be "
                         "identically zero otherwise)")


def _check(n_steps, integrated, dt, C, planes, grids, traj=(), gbar=None, rows=None):
    """(n, mg) of the operands; raises unless they fit the kernels: f32,
    contiguous, on one CUDA device, (3, n, n, n//2+1) planes, (3, mg, mg,
    mg) grids, (n_steps, 3, n, n, n//2+1) trajectories, a 0-dim gbar, a
    constant pack of matching size, n_steps >= 1; with `rows` = R, each
    operand but the pack with a leading axis of R."""
    _check_dt(integrated, dt)
    if n_steps < 1:
        raise ValueError(f"n_steps={n_steps} must be >= 1")
    mg, n = C["Bfr"].shape
    kz = n // 2 + 1
    lead = () if rows is None else (rows,)
    shp = lead + (3, n, n, kz)
    named = ([(k, t, shp) for k, t in planes]
             + [(k, t, lead + (3, mg, mg, mg)) for k, t in grids]
             + [(k, t, lead + (n_steps,) + shp[len(lead):]) for k, t in traj]
             + [("packed constants", C["packed"],
                 (4 * n * mg + 4 * kz * mg + 9 * n * n * kz,))])
    if gbar is not None:
        named.append(("gbar", gbar, lead))
    dev = named[0][1].device
    for name, t, shape in named:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (got {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dev:
            raise ValueError("all tensors must be on one device")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape} (n={n}, mg={mg}, n_steps={n_steps})")
    return n, mg


def _launch(symbol, counter, like, n, mg, *args, rows=1) -> None:
    """Launch `symbol` of the built library on the current stream of
    `like`'s device with a scratch buffer of the size the library asks
    for (`rows` times that for a row launch), count it under
    LAUNCHES[counter] and raise if it failed."""
    from spheremanopt_torch.ops.cuda.build import load

    lib = load()
    work = torch.empty(rows * lib.sm_kdyn_work_floats(n, mg), dtype=torch.float32,
                       device=like.device)
    with torch.cuda.device(like.device):
        code = getattr(lib, symbol)(*args, work.data_ptr(), work.numel(),
                                    torch.cuda.current_stream().cuda_stream)
    LAUNCHES[counter] += 1
    if code != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with cudaError_t "
                           f"{code}")


def _forward(br0, bi0, u, C, n_steps, integrated, dt, store_traj):
    n, mg = _check(n_steps, integrated, dt, C,
                   planes=[("br0", br0), ("bi0", bi0)], grids=[("u", u)])
    brT, biT = torch.empty_like(br0), torch.empty_like(bi0)
    J = torch.empty((), dtype=torch.float32, device=br0.device)
    traj = [torch.empty((n_steps,) + br0.shape, dtype=torch.float32,
                        device=br0.device) for _ in range(2 * store_traj)]
    _launch("sm_kdyn_fwd_traj" if store_traj else "sm_kdyn_fwd",
            "kdyn_fwd_traj" if store_traj else "kdyn_fwd", br0, n, mg,
            br0.data_ptr(), bi0.data_ptr(), u.data_ptr(),
            C["packed"].data_ptr(), n, mg, int(n_steps), int(integrated),
            float(dt), brT.data_ptr(), biT.data_ptr(), J.data_ptr(),
            *[t.data_ptr() for t in traj])
    return (brT, biT, J, *traj)


def run_forward(br0, bi0, u, C, n_steps, integrated=False, dt=0.0):
    """Fused forward solve: (brT, biT, J)."""
    if br0.device.type == "cpu":
        return run_forward_plain(br0, bi0, u, C, n_steps, integrated, dt)
    return _forward(br0, bi0, u, C, n_steps, integrated, dt, False)


def run_fwd_traj(br0, bi0, u, C, n_steps, integrated=False, dt=0.0):
    """Fused forward solve that also stores the state before each step:
    (brT, biT, J, trr, tri)."""
    if br0.device.type == "cpu":
        return run_fwd_traj_plain(br0, bi0, u, C, n_steps, integrated, dt)
    return _forward(br0, bi0, u, C, n_steps, integrated, dt, True)


def run_bwd(u, brT, biT, gbar, trr, tri, C, n_steps, integrated=False, dt=0.0):
    """Fused reverse sweep: (dJ/dbr0, dJ/dbi0, dJ/du). `gbar` is a 0-dim
    tensor, read by the kernel from device memory (no sync)."""
    if brT.device.type == "cpu":
        return run_bwd_plain(u, brT, biT, gbar, trr, tri, C, n_steps,
                             integrated, dt)
    gbar = gbar.reshape(())
    n, mg = _check(n_steps, integrated, dt, C,
                   planes=[("brT", brT), ("biT", biT)], grids=[("u", u)],
                   traj=[("trr", trr), ("tri", tri)], gbar=gbar)
    b0r_bar, b0i_bar = torch.empty_like(brT), torch.empty_like(biT)
    ubar = torch.zeros_like(u)   # the kernel accumulates into it
    _launch("sm_kdyn_bwd", "kdyn_bwd", brT, n, mg,
            u.data_ptr(), brT.data_ptr(), biT.data_ptr(), gbar.data_ptr(),
            C["packed"].data_ptr(), trr.data_ptr(), tri.data_ptr(), n, mg,
            int(n_steps), int(integrated), float(dt), b0r_bar.data_ptr(),
            b0i_bar.data_ptr(), ubar.data_ptr())
    return b0r_bar, b0i_bar, ubar


def _row_count(planes, grid):
    """R of a row call: raises unless the (re, im) planes are (R, 3, n, n,
    kz) and the grid (R, 3, mg, mg, mg), on the CPU too."""
    if any(t.dim() != 5 for t in (*planes, grid)):
        raise ValueError("row operands take a leading row axis: (R, 3, n, n, "
                         "n//2+1) planes and an (R, 3, mg, mg, mg) grid")
    R = grid.shape[0]
    if any(t.shape[0] != R for t in planes):
        raise ValueError("all row operands must have the same number of rows")
    return R


def _row_chunks(R):
    """(start, stop) of each launch of a call over R rows: ROWS_MAX rows
    at a time."""
    return [(i, min(i + ROWS_MAX, R)) for i in range(0, R, ROWS_MAX)]


def _forward_rows(R, br0, bi0, u, C, n_steps, integrated, dt, store_traj):
    n, mg = _check(n_steps, integrated, dt, C, planes=[("br0", br0), ("bi0", bi0)],
                   grids=[("u", u)], rows=R)
    brT, biT = torch.empty_like(br0), torch.empty_like(bi0)
    J = torch.empty((R,), dtype=torch.float32, device=br0.device)
    traj = [torch.empty((R, n_steps) + br0.shape[1:], dtype=torch.float32,
                        device=br0.device) for _ in range(2 * store_traj)]
    symbol = "sm_kdyn_fwd_traj_rows" if store_traj else "sm_kdyn_fwd_rows"
    counter = "kdyn_fwd_traj_rows" if store_traj else "kdyn_fwd_rows"
    for i, j in _row_chunks(R):
        _launch(symbol, counter, br0, n, mg,
                br0[i].data_ptr(), bi0[i].data_ptr(), u[i].data_ptr(),
                C["packed"].data_ptr(), n, mg, int(n_steps), int(integrated),
                float(dt), j - i, brT[i].data_ptr(), biT[i].data_ptr(),
                J[i:].data_ptr(), *[t[i].data_ptr() for t in traj], rows=j - i)
    return (brT, biT, J, *traj)


def run_forward_rows(br0, bi0, u, C, n_steps, integrated=False, dt=0.0):
    """`run_forward` of each row of br0, bi0 (R, 3, n, n, kz) and u (R, 3,
    mg, mg, mg): (brT, biT (R, ...), J (R,)). On the card one launch of
    `sm_kdyn_fwd_rows` per ROWS_MAX rows, each row bitwise `run_forward`
    on it; on the CPU `run_forward_rows_plain`."""
    R = _row_count((br0, bi0), u)
    if br0.device.type == "cpu":
        return run_forward_rows_plain(br0, bi0, u, C, n_steps, integrated, dt)
    return _forward_rows(R, br0, bi0, u, C, n_steps, integrated, dt, False)


def run_fwd_traj_rows(br0, bi0, u, C, n_steps, integrated=False, dt=0.0):
    """`run_fwd_traj` of each row: (brT, biT, J (R,), trr, tri (R, n_steps,
    3, n, n, kz)), `sm_kdyn_fwd_traj_rows` as `run_forward_rows`."""
    R = _row_count((br0, bi0), u)
    if br0.device.type == "cpu":
        return run_fwd_traj_rows_plain(br0, bi0, u, C, n_steps, integrated, dt)
    return _forward_rows(R, br0, bi0, u, C, n_steps, integrated, dt, True)


def run_bwd_rows(u, brT, biT, gbar, trr, tri, C, n_steps, integrated=False, dt=0.0):
    """`run_bwd` of each row, gbar (R,) on the device (no sync): (dJ/dbr0,
    dJ/dbi0, dJ/du), each (R, ...). On the card one launch of
    `sm_kdyn_bwd_rows` per ROWS_MAX rows, each row bitwise `run_bwd` on it;
    on the CPU `run_bwd_rows_plain`."""
    R = _row_count((brT, biT), u)
    if brT.device.type == "cpu":
        return run_bwd_rows_plain(u, brT, biT, gbar, trr, tri, C, n_steps,
                                  integrated, dt)
    n, mg = _check(n_steps, integrated, dt, C, planes=[("brT", brT), ("biT", biT)],
                   grids=[("u", u)], traj=[("trr", trr), ("tri", tri)], gbar=gbar,
                   rows=R)
    b0r_bar, b0i_bar = torch.empty_like(brT), torch.empty_like(biT)
    ubar = torch.zeros_like(u)   # the kernel accumulates into it
    for i, j in _row_chunks(R):
        _launch("sm_kdyn_bwd_rows", "kdyn_bwd_rows", brT, n, mg,
                u[i].data_ptr(), brT[i].data_ptr(), biT[i].data_ptr(),
                gbar[i:].data_ptr(), C["packed"].data_ptr(), trr[i].data_ptr(),
                tri[i].data_ptr(), n, mg, int(n_steps), int(integrated), float(dt),
                j - i, b0r_bar[i].data_ptr(), b0i_bar[i].data_ptr(),
                ubar[i].data_ptr(), rows=j - i)
    return b0r_bar, b0i_bar, ubar


# ---------------------------------------------------------------------------
# differentiable objective (the JAX custom_vjp)
# ---------------------------------------------------------------------------


class FusedEnergy(torch.autograd.Function):
    """J(br0, bi0, u) = <B_T, B_T> ("Final") or dt * (sum_i E(B_i) +
    E(B_T)) ("Integrated", Kahan-compensated), with the forward and the
    reverse sweep as one kernel launch each; differentiable in all three
    (real) inputs.

    apply(br0, bi0, u, C, n_steps, integrated=False, dt=0.0)

    The forward stores the trajectory only when a gradient is wanted.
    """

    @staticmethod
    def forward(ctx, br0, bi0, u, C, n_steps, integrated=False, dt=0.0):
        _check_dt(integrated, dt)
        ctx.consts = (C, n_steps, integrated, dt)
        if not any(ctx.needs_input_grad[:3]):
            return run_forward(br0, bi0, u, C, n_steps, integrated, dt)[2]
        brT, biT, J, trr, tri = run_fwd_traj(br0, bi0, u, C, n_steps,
                                             integrated, dt)
        ctx.save_for_backward(u, brT, biT, trr, tri)
        return J

    @staticmethod
    def backward(ctx, gbar):
        u, brT, biT, trr, tri = ctx.saved_tensors
        C, n_steps, integrated, dt = ctx.consts
        grads = run_bwd(u, brT, biT, gbar.to(brT.dtype), trr, tri, C, n_steps,
                        integrated, dt)
        return (*grads, None, None, None, None)


class FusedEnergyRows(torch.autograd.Function):
    """J (R,) of each row of br0, bi0 (R, 3, n, n, kz) and u (R, 3, mg, mg,
    mg), as `FusedEnergy` of that row, with the row kernels: one forward
    and one reverse launch per ROWS_MAX rows; differentiable in all three.

    apply(br0, bi0, u, C, n_steps, integrated=False, dt=0.0)

    The forward stores the trajectories only when a gradient is wanted;
    the backward takes gbar (R,)."""

    @staticmethod
    def forward(ctx, br0, bi0, u, C, n_steps, integrated=False, dt=0.0):
        _check_dt(integrated, dt)
        ctx.consts = (C, n_steps, integrated, dt)
        if not any(ctx.needs_input_grad[:3]):
            return run_forward_rows(br0, bi0, u, C, n_steps, integrated, dt)[2]
        brT, biT, J, trr, tri = run_fwd_traj_rows(br0, bi0, u, C, n_steps,
                                                  integrated, dt)
        ctx.save_for_backward(u, brT, biT, trr, tri)
        return J

    @staticmethod
    def backward(ctx, gbar):
        u, brT, biT, trr, tri = ctx.saved_tensors
        C, n_steps, integrated, dt = ctx.consts
        grads = run_bwd_rows(u, brT, biT, gbar.to(brT.dtype).contiguous(), trr, tri,
                             C, n_steps, integrated, dt)
        return (*grads, None, None, None, None)
