"""Fused SBDF integrators and their reverse sweeps, as hand-written CUDA
kernels for Hopper.

PyTorch port of the JAX package's `ops/pallas/fused_two_matrix.py`:

  two-matrix form  u' = A u + B (c2 u^2 + c3 u^3)       (SHB23)
    fused_fwd          <- `_run_fwd` / `_fwd_kernel` (has_traj, has_ser): a
                          grid-wide kernel over every SM while A's rows
                          fit (every mg on an H100), with the B rows that
                          do not fit beside them read from L2; one block
                          above (`fwd_route`)
    fused_bwd          <- `_run_bwd` / `_bwd_kernel` (op_grads=True: the
                          sweep stores the lambda history, then
                          `op_grads_product` forms dA and dB): a 16-CTA
                          cluster up to mg = 640, above it a grid-wide
                          kernel over every SM while A's columns fit
                          (every mg on an H100), with the B columns that
                          do not fit beside them staged from L2; one block
                          where they do not (`bwd_route`)
    FusedObjective     <- `fused_objective` (custom_vjp)
    FusedObjectiveDiag <- `fused_objective_diag`
  shared-matrix form  u' = B (lin u + c2 u^2 + c3 u^3)  (SH23: B = M,
  lin = 1/dt)
    fused_fwd_shared   <- `_run_fwd_shared` / `_fwd_kernel_shared` (has_traj,
                          has_ser): a grid-wide kernel over every SM while
                          B's rows fit (every mg on an H100), one block
                          above (`shared_fwd_route`)
    fused_bwd_shared   <- `_run_bwd_shared` / `_bwd_kernel_shared`
                          (op_grads=True: lambda history, then dB): a
                          16-CTA cluster up to mg = 896, above it a
                          grid-wide kernel over every SM while B's columns
                          fit (every mg on an H100), one block where they
                          do not (`shared_bwd_route`)
    FusedObjectiveShared     <- `fused_objective_shared`
    FusedObjectiveSharedDiag <- `fused_objective_shared_diag`
  rows (a sweep's R starting points; the JAX package's `jax.vmap` of the
  same kernels, where `pallas_call`'s batching rule gives each a grid over
  the rows: one launch for every row)
    fused_fwd_shared_rows, fused_bwd_shared_rows, FusedObjectiveSharedRows
                       R forwards in one grid launch (each CTA applies its
                       rows of B to every state), R reverse clusters in one
                       launch
    fused_fwd_rows, fused_bwd_rows, FusedObjectiveRows
                       the forward as groups of G rows on CTAs of their
                       own (`fwd_row_group`), the reverse as clusters of G
                       rows (`bwd_row_group`), both keeping each CTA's share
                       of A and B in registers
                       Each row bitwise the one-row kernels' on that row;
                       differentiable in u0 only. Widths of the reverse
                       clusters only (`rows_width_ok`); the wrappers raise
                       at others, where a sweep runs its rows one at a time

A forward runs all N steps in one launch and returns the final state,
the Kahan-compensated sum J_sum = sum_{n=0..N} sum_j w_j u_n,j^2 and,
on request, the N pre-step states (gradient contexts) and the N+1
per-step energies that the Kahan sum consumes (fused diagnostics; the J
arithmetic does not depend on that flag). A backward carries
lambda_N = s w u_N back through the transposed step. With op_grads=True
it also returns the operator cotangents, sum_n lambda_{n+1} (x) f(u_n):
on the card the reverse kernel stores every lambda_{n+1} it consumes
(the lambda history) and `op_grads_product` (csrc/op_grads.cu) forms
the sum as one product over all SMs, on the tensor cores (3xTF32).

The autograd Functions are differentiable in the operators by default
(op_grads=True), as the JAX package's `fused_objective*` are; the
problems, whose operators are fixed data, pass op_grads=False.

Each wrapper takes its plain PyTorch version (`*_plain`) for tensors on
the CPU and launches its kernel for CUDA tensors; a CUDA tensor never
falls back. `LAUNCHES` counts kernel launches per wrapper (the series
variants of the forwards, the routes of each sweep, and the
lambda-history variants of the cluster and grid reverses apart (`*_ops`),
and the two-matrix grids' instances that read B from L2 under
`fused_fwd_grid_stream*` and `fused_bwd_grid_stream`; that reverse
instance and each one-block reverse count both of their variants, under
`fused_bwd_grid_stream`, `fused_bwd_block` and `fused_bwd_shared_block`).
The kernels are f32 only; the plain versions take f32 or f64.
"""

from __future__ import annotations

import functools

import torch

from spheremanopt_torch.solvers.scan_utils import kahan_add, kahan_zero

KERNEL_SOURCES = {
    "fused_fwd_shared_grid": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_fwd_shared_grid_ser": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_fwd_shared_block": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_fwd_shared_block_ser": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_bwd_shared": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_bwd_shared_grid": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_bwd_shared_grid_ops": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_bwd_shared_block": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_fwd_grid": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_fwd_grid_ser": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_fwd_grid_stream": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_fwd_grid_stream_ser": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_fwd_block": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_fwd_block_ser": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_bwd": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_bwd_grid": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_bwd_grid_ops": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_bwd_grid_stream": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_bwd_block": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_bwd_shared_ops": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_bwd_ops": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "op_grads": "spheremanopt_torch/csrc/op_grads.cu",
    "fused_fwd_shared_rows": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_bwd_shared_rows": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_fwd_rows": "spheremanopt_torch/csrc/fused_rows.cuh",
    "fused_bwd_rows": "spheremanopt_torch/csrc/fused_rows.cuh",
}
# kernel launches per wrapper since the last reset_launches()
LAUNCHES = {name: 0 for name in KERNEL_SOURCES}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _plain_sweep(step, w, u0, n_steps, store_traj, store_series):
    """(uT, J_sum, traj or None, series or None) of N steps of `step`."""
    u = u0
    acc = kahan_zero(u0.dtype, u0.device)
    traj, ser = [], []
    for _ in range(n_steps):
        if store_traj:
            traj.append(u)
        e = torch.sum(w * u * u)
        ser.append(e)
        acc = kahan_add(acc, e)
        u = step(u)
    e = torch.sum(w * u * u)
    ser.append(e)
    acc = kahan_add(acc, e)
    traj = ((torch.stack(traj) if traj else u0.new_zeros((0, len(u0))))
            if store_traj else None)
    return u, acc[0], traj, torch.stack(ser) if store_series else None


def fused_fwd_shared_plain(b, w, u0, c2, c3, lin, n_steps, store_traj=True,
                           store_series=False):
    """(uT, J_sum, traj or None, series or None), step by step with
    `torch.mv`: u' = B (lin u + c2 u^2 + c3 u^3)."""
    return _plain_sweep(
        lambda u: torch.mv(b, lin * u + c2 * u * u + c3 * u * u * u),
        w, u0, n_steps, store_traj, store_series)


def fused_fwd_plain(a, b, w, u0, c2, c3, n_steps, store_traj=True,
                    store_series=False):
    """(uT, J_sum, traj or None, series or None), step by step with
    `torch.mv`: u' = A u + B (c2 u^2 + c3 u^3)."""
    return _plain_sweep(
        lambda u: torch.mv(a, u) + torch.mv(b, c2 * u * u + c3 * u * u * u),
        w, u0, n_steps, store_traj, store_series)


def fused_bwd_shared_plain(b, w, uT, traj, c2, c3, lin, scale, n_steps,
                           op_grads=False, lam_hist=None):
    """(lambda_0, dB or None); `scale` = float32(-2 dt) * gbar. Row n of
    `lam_hist` ((n_steps, mg), when given) receives the lambda_{n+1} that
    step n consumes, as the kernel's lambda history."""
    lam = scale * (w * uT)
    db = torch.zeros_like(b) if op_grads else None
    for k in range(n_steps):
        u = traj[n_steps - 1 - k]
        if lam_hist is not None:
            lam_hist[n_steps - 1 - k] = lam
        if op_grads:
            v = lin * u + c2 * u * u + c3 * u * u * u
            db += torch.outer(lam, v)
        wb = torch.mv(b.t(), lam)
        vprime = lin + 2.0 * c2 * u + 3.0 * c3 * u * u
        lam = vprime * wb + scale * (w * u)
    return lam, db


def fused_bwd_plain(a, b, w, uT, traj, c2, c3, scale, n_steps, op_grads=False,
                    lam_hist=None):
    """(lambda_0, dA or None, dB or None) of the two-matrix reverse sweep:
    lambda_n = A^T lambda + g'(u_n) (B^T lambda) + s w u_n, and with
    `op_grads` dA += lambda (x) u_n, dB += lambda (x) g(u_n). Row n of
    `lam_hist` (when given) receives lambda_{n+1}, as in
    `fused_bwd_shared_plain`."""
    lam = scale * (w * uT)
    da = torch.zeros_like(a) if op_grads else None
    db = torch.zeros_like(b) if op_grads else None
    for k in range(n_steps):
        u = traj[n_steps - 1 - k]
        if lam_hist is not None:
            lam_hist[n_steps - 1 - k] = lam
        if op_grads:
            da += torch.outer(lam, u)
            db += torch.outer(lam, c2 * u * u + c3 * u * u * u)
        wa = torch.mv(a.t(), lam)
        wb = torch.mv(b.t(), lam)
        gprime = 2.0 * c2 * u + 3.0 * c3 * u * u
        lam = wa + gprime * wb + scale * (w * u)
    return lam, da, db


OP_GRADS_MODES = ("shared", "two")


def op_factors(traj, mode, c2, c3, lin):
    """The right factors of the operator cotangents, row by row: v(u) for
    the shared-matrix step, (u, g(u)) for the two-matrix step."""
    if mode not in OP_GRADS_MODES:
        raise ValueError(f"mode must be one of {OP_GRADS_MODES}, got {mode!r}")
    if mode == "shared":   # the association of the step-by-step sweep's v
        return (lin * traj + c2 * traj * traj + c3 * traj * traj * traj,)
    return (traj, c2 * traj * traj + c3 * traj * traj * traj)


def op_grads_plain(lam_hist, traj, mode, c2, c3, lin=0.0):
    """Plain version of `op_grads_product`: the operator cotangents
    sum_n lam_hist[n] (x) f(traj[n]) as a loop of outer products, in the
    reverse sweep's order (n = N-1..0). mode "shared" gives (dB,) with
    f = v(u) = lin u + c2 u^2 + c3 u^3; mode "two" gives (dA, dB) with
    f = u and g(u) = c2 u^2 + c3 u^3."""
    mg = traj.shape[-1]
    fs = op_factors(traj, mode, c2, c3, lin)
    outs = tuple(traj.new_zeros((mg, mg)) for _ in fs)
    for n in reversed(range(traj.shape[0])):
        for out, f in zip(outs, fs):
            out += torch.outer(lam_hist[n], f[n])
    return outs


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

MG_MIN, MG_MAX, MG_ALIGN = 128, 2048, 128


def _check(n_steps, mats, vecs, traj=None, scale=None, hist=None) -> int:
    """mg of the operands; raises unless they fit the kernels: f32,
    contiguous, on one CUDA device, (mg, mg) matrices, (mg,) vectors, an
    (n_steps, mg) trajectory and lambda history, 128 <= mg <= 2048 with
    mg % 128 == 0."""
    mg = (vecs[0][1] if vecs else traj).shape[-1]
    if not (MG_MIN <= mg <= MG_MAX and mg % MG_ALIGN == 0):
        raise ValueError(f"the CUDA kernels take {MG_MIN} <= mg <= {MG_MAX}, "
                         f"mg % {MG_ALIGN} == 0; got mg={mg}")
    extra = [(k, t) for k, t in (("traj", traj), ("scale", scale),
                                 ("lam_hist", hist)) if t is not None]
    dev = None
    for name, t in list(mats) + list(vecs) + extra:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (got {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dev is not None and t.device != dev:
            raise ValueError("all tensors must be on one device")
        dev = t.device
    bad = [f"{k}{tuple(t.shape)}" for k, t in mats if t.shape != (mg, mg)]
    bad += [f"{k}{tuple(t.shape)}" for k, t in vecs if t.shape != (mg,)]
    bad += [f"{k}{tuple(t.shape)}" for k, t in (("traj", traj), ("lam_hist", hist))
            if t is not None and t.shape != (n_steps, mg)]
    if bad:
        raise ValueError(f"shapes {' '.join(bad)} do not match mg={mg}, "
                         f"n_steps={n_steps}")
    return mg


def _launch(symbol, counter, device, *args) -> None:
    """Launch `symbol` of the built library on the current stream of
    `device`, count it under LAUNCHES[counter] and raise if it failed."""
    from spheremanopt_torch.ops.cuda.build import load

    fn = getattr(load(), symbol)
    with torch.cuda.device(device):
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
    LAUNCHES[counter] += 1
    if code != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed with cudaError_t "
                           f"{code}")


def _fwd_outputs(u0, n_steps, store_traj, store_series):
    """(uT, jsum, traj, ser) buffers for a forward launch."""
    mg, dev = u0.shape[-1], u0.device
    return (torch.empty_like(u0),
            torch.empty((), dtype=torch.float32, device=dev),
            torch.empty((n_steps, mg), dtype=torch.float32, device=dev)
            if store_traj else None,
            torch.empty((n_steps + 1,), dtype=torch.float32, device=dev)
            if store_series else None)


def _ptr(t):
    """Device pointer of `t`, or NULL for None and empty buffers."""
    return t.data_ptr() if t is not None and t.numel() else None


def _lam_hist(uT, n_steps, op_grads, lam_hist):
    """The lambda-history buffer of a reverse sweep: `lam_hist`, or a new
    one for op_grads, else None (the sweep without the history)."""
    if lam_hist is None and op_grads:
        lam_hist = torch.empty((n_steps, uT.shape[-1]), dtype=torch.float32,
                               device=uT.device)
    return lam_hist


# the product kernel's tiles (csrc/op_grads.cu): 128 x 128 outputs (in
# mode "two" 64 columns of dA and the same 64 of dB), 16 steps a stage
OP_TILE, OP_STAGE, OP_SMS = 128, 16, 132


@functools.lru_cache(maxsize=None)
def op_grads_split(mg, n_steps, n_out):
    """(chunk, splits) of the product kernel: N is cut into `splits`
    chunks of `chunk` steps (a multiple of the stage depth), so that
    tiles x splits blocks fill the card's 132 SMs about once."""
    tiles = (mg // OP_TILE) * (n_out * mg // OP_TILE)
    want = max(1, OP_SMS // tiles)
    chunk = -(-max(n_steps, 1) // want)
    chunk = -(-chunk // OP_STAGE) * OP_STAGE
    return chunk, -(-max(n_steps, 1) // chunk)


def op_grads_product(lam_hist, traj, mode, c2, c3, lin=0.0):
    """Operator cotangents sum_n lam_hist[n] (x) f(traj[n]) from a reverse
    sweep's lambda history: (dB,) for mode "shared", (dA, dB) for mode
    "two" (see `op_grads_plain`). One product over all SMs on the card,
    on the tensor cores as 3xTF32 (f32 accuracy). The outputs are views
    of one buffer that also holds the split partials."""
    if lam_hist.device.type == "cpu":
        return op_grads_plain(lam_hist, traj, mode, c2, c3, lin)
    if mode not in OP_GRADS_MODES:
        raise ValueError(f"mode must be one of {OP_GRADS_MODES}, got {mode!r}")
    n_steps = traj.shape[0]
    mg = _check(n_steps, mats=[], vecs=[], traj=traj, hist=lam_hist)
    n_out = 1 if mode == "shared" else 2
    chunk, splits = op_grads_split(mg, int(n_steps), n_out)
    buf = torch.empty(((1 + splits if splits > 1 else 1) * n_out, mg, mg),
                      dtype=torch.float32, device=traj.device)
    out, part = buf[:n_out], buf[n_out:]
    _launch("sm_op_grads", "op_grads", traj.device, lam_hist.data_ptr(),
            traj.data_ptr(), int(n_steps), mg, int(mode == "two"), c2, c3, lin,
            chunk, splits, _ptr(part), out.data_ptr())
    return tuple(out)


def fused_fwd_shared(b, w, u0, c2, c3, lin, n_steps, store_traj=True,
                     store_series=False):
    """(uT, J_sum, traj or None, series or None) of N steps of
    u' = B(lin u + g(u)). On the card the route follows
    `shared_fwd_route(mg)` for that card; both give the same numbers bit
    for bit."""
    if u0.device.type == "cpu":
        return fused_fwd_shared_plain(b, w, u0, c2, c3, lin, n_steps,
                                      store_traj, store_series)
    mg = _check(n_steps, mats=[("b", b)], vecs=[("u0", u0), ("w", w)])
    if shared_fwd_route(mg, _card(u0.device)) == "grid":
        return _fwd_shared_grid(b, w, u0, c2, c3, lin, n_steps, store_traj,
                                store_series)
    return _fwd_shared_block(b, w, u0, c2, c3, lin, n_steps, store_traj,
                             store_series)


def _fwd_shared_grid(b, w, u0, c2, c3, lin, n_steps, store_traj=True,
                     store_series=False):
    """`fused_fwd_shared` on the grid-wide kernel
    (`sm_fused_fwd_shared_grid`) at any mg whose rows of B fit the card:
    raises if the card cannot hold its CTAs at once. The caller has
    checked the shapes."""
    mg = u0.shape[-1]
    rows, ctas = grid_partition(mg, _card(u0.device)[0])
    _check_grid(u0.device, "sm_fused_fwd_shared_grid", (mg, rows), ctas,
                bool(store_series))
    uT, jsum, traj, ser = _fwd_outputs(u0, n_steps, store_traj, store_series)
    slots = _tag_slots(u0)
    _launch("sm_fused_fwd_shared_grid",
            "fused_fwd_shared_grid_ser" if store_series else "fused_fwd_shared_grid",
            u0.device, b.data_ptr(), w.data_ptr(), u0.data_ptr(), c2, c3, lin,
            int(n_steps), mg, rows, uT.data_ptr(), jsum.data_ptr(), _ptr(traj),
            _ptr(ser), slots.data_ptr())
    return uT, jsum, traj, ser


def _fwd_shared_block(b, w, u0, c2, c3, lin, n_steps, store_traj=True,
                      store_series=False):
    """`fused_fwd_shared` on the one-block kernel
    (`sm_fused_fwd_shared_block`) at any mg: the route where the grid's
    rows do not fit, and the kernel the grid is held to bit for bit. The
    caller has checked the shapes."""
    uT, jsum, traj, ser = _fwd_outputs(u0, n_steps, store_traj, store_series)
    _launch("sm_fused_fwd_shared_block",
            "fused_fwd_shared_block_ser" if store_series
            else "fused_fwd_shared_block",
            u0.device, b.data_ptr(), w.data_ptr(), u0.data_ptr(), c2, c3, lin,
            int(n_steps), u0.shape[-1], uT.data_ptr(), jsum.data_ptr(),
            _ptr(traj), _ptr(ser))
    return uT, jsum, traj, ser


def fused_bwd_shared(b, w, uT, traj, c2, c3, lin, scale, n_steps,
                     op_grads=False, lam_hist=None):
    """(lambda_0, dB or None) of the reverse sweep; `scale` is a 0-dim
    tensor float32(-2 dt) * gbar (kept on the device: no sync). Row n of
    `lam_hist` ((n_steps, mg), when given) receives the lambda_{n+1} that
    step n consumes: the kernel's history variant. With op_grads,
    dB = sum_n lambda_{n+1} (x) v(u_n): the sweep stores its lambda
    history and `op_grads_product` forms dB. On the card the route
    follows `shared_bwd_route(mg)` for that card; both give the same
    numbers bit for bit."""
    if uT.device.type == "cpu":
        return fused_bwd_shared_plain(b, w, uT, traj, c2, c3, lin, scale,
                                      n_steps, op_grads, lam_hist)
    scale = scale.reshape(())
    hist = _lam_hist(uT, n_steps, op_grads, lam_hist)
    mg = _check(n_steps, mats=[("b", b)], vecs=[("uT", uT), ("w", w)],
                traj=traj, scale=scale, hist=hist)
    route = shared_bwd_route(mg, _card(uT.device))
    if route == "cluster":
        _check_cluster(uT.device, "sm_fused_bwd_shared", mg, hist is not None)
        lam = torch.empty_like(uT)
        _launch("sm_fused_bwd_shared",
                "fused_bwd_shared" if hist is None else "fused_bwd_shared_ops",
                uT.device, b.data_ptr(), w.data_ptr(), uT.data_ptr(),
                _ptr(traj), c2, c3, lin, scale.data_ptr(), int(n_steps), mg,
                lam.data_ptr(), _ptr(hist))
    else:
        bwd = _bwd_shared_grid if route == "grid" else _bwd_shared_block
        lam = bwd(b, w, uT, traj, c2, c3, lin, scale, n_steps, hist)
    if not op_grads:
        return lam, None
    return lam, op_grads_product(hist, traj, "shared", c2, c3, lin)[0]


def _bwd_shared_grid(b, w, uT, traj, c2, c3, lin, scale, n_steps,
                     lam_hist=None):
    """lambda_0 of `fused_bwd_shared` on the grid-wide kernel
    (`sm_fused_bwd_shared_grid`, counted under `fused_bwd_shared_grid`,
    with the history under `fused_bwd_shared_grid_ops`) at any mg whose
    columns of B fit the card: the route above the cluster's width. Raises
    if the card cannot hold its CTAs at once. `scale` is 0-dim; the caller
    has checked the shapes."""
    mg = uT.shape[-1]
    cols, ctas = grid_partition(mg, _card(uT.device)[0])
    _check_grid(uT.device, "sm_fused_bwd_shared_grid", (mg, cols), ctas,
                lam_hist is not None)
    lam = torch.empty_like(uT)
    _launch("sm_fused_bwd_shared_grid",
            "fused_bwd_shared_grid" + ("" if lam_hist is None else "_ops"),
            uT.device, b.data_ptr(), w.data_ptr(), uT.data_ptr(), _ptr(traj),
            c2, c3, lin, scale.data_ptr(), int(n_steps), mg, cols,
            lam.data_ptr(), _ptr(lam_hist), _tag_slots(uT).data_ptr())
    return lam


def _bwd_shared_block(b, w, uT, traj, c2, c3, lin, scale, n_steps,
                      lam_hist=None):
    """lambda_0 of `fused_bwd_shared` on the one-block kernel
    (`sm_fused_bwd_shared_block`, counted under `fused_bwd_shared_block`
    with or without the history) at any mg: the route where the grid's
    columns do not fit, and the kernel the cluster and the grid are held
    to bit for bit. `scale` is 0-dim; the caller has checked the
    shapes."""
    lam = torch.empty_like(uT)
    _launch("sm_fused_bwd_shared_block", "fused_bwd_shared_block", uT.device,
            b.data_ptr(), w.data_ptr(), uT.data_ptr(), _ptr(traj), c2, c3, lin,
            scale.data_ptr(), int(n_steps), uT.shape[-1], lam.data_ptr(),
            _ptr(lam_hist))
    return lam


# The two-matrix reverse sweep's cluster keeps A's and B's columns on 16
# SMs: 2 mg^2 * 4 / 16 bytes must fit one SM's shared memory. The
# shared-matrix reverse sweep's cluster keeps one matrix: mg^2 * 4 / 16
# bytes. Below these widths the clusters beat the grid reverses, whose
# exchange through L2 costs more a step than the cluster's barrier
# (csrc/fused_two_matrix.cu, csrc/fused_shared.cu).
CLUSTER_MG_MAX = 640
SHARED_CLUSTER_MG_MAX = 896
# (SMs, opt-in shared memory per block in bytes) of an H100 SXM: the card
# the routes are worked out for when none is given
H100_SXM = (132, 227 * 1024)


def shared_fwd_route(mg, card=H100_SXM):
    """The shared-matrix forward's kernel for width mg on a card of
    `card` = (SMs, opt-in shared memory per block in bytes): "grid" (one
    CTA on each SM holding its rows of B, `sm_fused_fwd_shared_grid`)
    while one CTA's rows and state fit its shared memory (every mg on an
    H100 SXM and PCIe), else "block" (one thread block streaming B from
    L2, `sm_fused_fwd_shared_block`). A choice by shape, not a fallback:
    both give the same bits."""
    rows, _ = grid_partition(mg, card[0])
    return "grid" if shared_grid_smem_bytes(mg, rows) <= card[1] else "block"


def shared_bwd_route(mg, card=H100_SXM):
    """The shared-matrix reverse sweep's kernel for width mg on a card of
    `card` = (SMs, opt-in shared memory per block in bytes): "cluster" (16
    CTAs holding B's columns in shared memory, `sm_fused_bwd_shared`) up
    to SHARED_CLUSTER_MG_MAX; above, "grid" (one CTA on each SM holding its
    columns of B, `sm_fused_bwd_shared_grid`) while one CTA's columns and
    state fit its shared memory and its threads cover the row phases
    (every mg on an H100 SXM and PCIe), else "block" (one thread block
    streaming B from L2, `sm_fused_bwd_shared_block`). A choice by shape,
    not a fallback: all give the same bits."""
    if mg <= SHARED_CLUSTER_MG_MAX:
        return "cluster"
    cols, _ = grid_partition(mg, card[0])
    fits = shared_bwd_grid_smem_bytes(mg, cols) <= card[1]
    return "grid" if fits and row_phases(mg) * cols <= GRID_THREADS else "block"


def grid_partition(mg, sms):
    """(rows, ctas) of a grid route on a card of `sms` SMs: each CTA owns
    `rows` = ceil(mg / sms) contiguous rows, CTA c rows
    [c rows, min((c + 1) rows, mg)), and ceil(mg / rows) <= sms CTAs cover
    all mg rows."""
    rows = -(-mg // sms)
    return rows, -(-mg // rows)


def grid_smem_bytes(mg, rows, rows_b):
    """Shared memory of one CTA of the two-matrix grid route: its rows of
    A, `rows_b` of its rows of B, u, g, w and 32 partial sums
    (csrc/fused_two_matrix.cu `grid_smem_bytes`)."""
    return 4 * ((rows + rows_b) * mg + 3 * mg + 32)


def shared_grid_smem_bytes(mg, rows):
    """Shared memory of one CTA of the shared-matrix grid route: its rows
    of B, u, v, w and 32 partial sums (csrc/fused_shared.cu
    `shared_grid_smem_bytes`)."""
    return 4 * (rows * mg + 3 * mg + 32)


# threads of a grid route's CTA (csrc/cluster.cuh kClusterThreads)
GRID_THREADS = 256
# the two-matrix grid reverse's stages of the B columns it reads from L2:
# kStages stages of kStageRows rows (csrc/fused_two_matrix.cu)
STAGES, STAGE_ROWS = 3, 256


def row_phases(mg):
    """The one-block reverse kernels' row phases P = 1024 / (mg / 4)
    (csrc/grid.cuh `row_phases`): their thread (p, column group) sums the
    rows p, p + P, ... of its columns; a grid reverse's thread (p, column)
    sums the same rows in the same order."""
    return 1024 // (mg // 4)


def chain_stride(terms):
    """Floats between two chains of `terms` entries in a grid reverse's
    shared memory: whole float4s, an odd number of them
    (csrc/grid.cuh `chain_stride`)."""
    return 4 * (-(-terms // 4) | 1)


def bwd_grid_smem_bytes(mg, cols, cols_b):
    """Shared memory of one CTA of the two-matrix grid reverse: the P x cols
    chains of its columns of A and P x cols_b of B, lambda's P chains, with
    cols_b < cols the stages of the other B columns, and the P x cols
    partial sums of each matrix (csrc/fused_two_matrix.cu
    `bwd_grid_smem_bytes`)."""
    P = row_phases(mg)
    ts = chain_stride(-(-mg // P))
    staged = (STAGES * P * (cols - cols_b) * chain_stride(STAGE_ROWS // P)
              if cols_b < cols else 0)
    return 4 * (P * (cols + cols_b + 1) * ts + staged + 2 * P * cols)


def shared_bwd_grid_smem_bytes(mg, cols):
    """Shared memory of one CTA of the shared-matrix grid reverse: the
    P x cols chains of its columns of B, lambda's P chains and the P x cols
    partial sums (csrc/fused_shared.cu `shared_bwd_grid_smem_bytes`)."""
    P = row_phases(mg)
    return 4 * (P * (cols + 1) * chain_stride(-(-mg // P)) + P * cols)


def bwd_grid_partition(mg, card):
    """(cols, ctas, cols_b) of the two-matrix grid reverse on a card of
    `card` = (SMs, opt-in shared memory per block in bytes): each CTA owns
    `cols` = ceil(mg / SMs) contiguous columns (CTA c columns [c cols,
    min((c + 1) cols, mg)), as `grid_partition`), and keeps all its A
    columns and the first `cols_b` <= cols of its B columns in shared
    memory beside the state (the rest are staged from L2 every step, in
    chunks of STAGE_ROWS rows or, the last one, half of that, whose rows
    the P phases share evenly); cols_b is negative when even the A
    columns do not fit or the CTA's threads do not cover its (phase,
    column) pairs."""
    sms, smem = card
    cols, ctas = grid_partition(mg, sms)
    fits = [x for x in range(cols, -1, -1) if bwd_grid_smem_bytes(mg, cols, x) <= smem
            and (x == cols or STAGE_ROWS // 2 % row_phases(mg) == 0)]
    ok = fits and row_phases(mg) * cols <= GRID_THREADS
    return cols, ctas, fits[0] if ok else -1


def fwd_grid_partition(mg, card):
    """(rows, ctas, rows_b) of the two-matrix grid route on a card of
    `card` = (SMs, opt-in shared memory per block in bytes): the CTAs'
    rows as `grid_partition`, and the number of each CTA's B rows kept in
    shared memory beside all its A rows and the state, at most `rows`
    (the rest are read from L2 every step); negative when even the A
    rows and the state do not fit."""
    sms, smem = card
    rows, ctas = grid_partition(mg, sms)
    return rows, ctas, min(rows, (smem - grid_smem_bytes(mg, rows, 0)) // (4 * mg))


def fwd_route(mg, card=H100_SXM):
    """The two-matrix forward's kernel for width mg on a card of
    `card` = (SMs, opt-in shared memory per block in bytes): "grid" (one
    CTA on each SM holding its rows of A and as many of B as fit,
    `sm_fused_fwd_grid`) while one CTA's A rows and state fit its shared
    memory (every mg on an H100 SXM's 132 SMs and an H100 PCIe's 114),
    else "block" (one thread block streaming A and B from L2,
    `sm_fused_fwd_block`). A choice by shape, not a fallback: both give
    the same bits."""
    return "grid" if fwd_grid_partition(mg, card)[2] >= 0 else "block"


def bwd_route(mg, card=H100_SXM):
    """The two-matrix reverse sweep's kernel for width mg on a card of
    `card` = (SMs, opt-in shared memory per block in bytes): "cluster" (16
    CTAs holding A's and B's columns in shared memory, `sm_fused_bwd`) up
    to CLUSTER_MG_MAX; above, "grid" (one CTA on each SM holding its
    columns of A and as many of B as fit, `sm_fused_bwd_grid`) while one
    CTA's A columns and state fit its shared memory (every mg on an H100
    SXM and PCIe), else "block" (one thread block streaming A and B from
    L2, `sm_fused_bwd_block`). A choice by shape, not a fallback: all give
    the same bits."""
    if mg <= CLUSTER_MG_MAX:
        return "cluster"
    return "grid" if bwd_grid_partition(mg, card)[2] >= 0 else "block"


@functools.lru_cache(maxsize=None)
def _card(device):
    """(SMs, opt-in shared memory per block in bytes) of `device`."""
    from spheremanopt_torch.ops.cuda.build import load

    with torch.cuda.device(device):
        smem = load().sm_smem_optin()
    if smem <= 0:
        raise RuntimeError(f"cudaDevAttrMaxSharedMemoryPerBlockOptin failed: "
                           f"cudaError_t {-smem}")
    return torch.cuda.get_device_properties(device).multi_processor_count, smem


@functools.lru_cache(maxsize=None)
def _check_grid(device, symbol, shape, ctas, variant):
    """Raise unless the card can hold the `ctas` CTAs of the grid-wide
    kernel `symbol` ("sm_fused_fwd_grid" with `shape` = (mg, rows,
    rows_b), "sm_fused_bwd_grid" with (mg, cols, cols_b), the shared-matrix
    grids with (mg, rows) or (mg, cols)) at once, in its template
    `variant` (the series or the lambda history): `<symbol>_capacity`,
    the cudaOccupancyMaxActiveBlocksPerMultiprocessor count times the SMs,
    must reach `ctas`. A pass is remembered."""
    from spheremanopt_torch.ops.cuda.build import load

    with torch.cuda.device(device):
        n = getattr(load(), symbol + "_capacity")(*shape, int(variant))
    if n < ctas:
        raise RuntimeError(
            f"the grid-wide kernel {symbol} (mg={shape[0]}: {ctas} CTAs of {shape[1]} "
            f"rows or columns) cannot be co-resident on "
            f"{torch.cuda.get_device_name(device)}: it holds {n}"
            + ("" if n >= 0 else f" (cudaError_t {-n})"))


def _tag_slots(u0):
    """Scratch of a grid route: two slots of mg (value, step tag) 64-bit
    words that carry u (lambda in a reverse sweep) between the CTAs."""
    return torch.empty((4 * u0.shape[-1],), dtype=torch.float32, device=u0.device)


@functools.lru_cache(maxsize=None)
def _check_cluster(device, symbol, mg, variant):
    """Raise unless the card can schedule the cluster kernel `symbol`
    ("sm_fused_bwd_shared" or "sm_fused_bwd") for this mg and template
    variant (the lambda history):
    `<symbol>_capacity`, the cudaOccupancyMaxActiveClusters count, must be
    > 0. A pass is remembered."""
    from spheremanopt_torch.ops.cuda.build import load

    with torch.cuda.device(device):
        n = getattr(load(), symbol + "_capacity")(mg, int(variant))
    if n <= 0:
        raise RuntimeError(
            f"the 16-CTA cluster kernel {symbol} (mg={mg}) cannot be scheduled on "
            f"{torch.cuda.get_device_name(device)}: cudaOccupancyMaxActiveClusters "
            f"gave {n}" + ("" if n == 0 else f" (cudaError_t {-n})"))


def fused_fwd(a, b, w, u0, c2, c3, n_steps, store_traj=True,
              store_series=False):
    """(uT, J_sum, traj or None, series or None) of N steps of
    u' = A u + B(c2 u^2 + c3 u^3). On the card the route follows
    `fwd_route(mg)` for that card; both give the same numbers bit for
    bit."""
    if u0.device.type == "cpu":
        return fused_fwd_plain(a, b, w, u0, c2, c3, n_steps, store_traj,
                               store_series)
    mg = _check(n_steps, mats=[("a", a), ("b", b)],
                vecs=[("u0", u0), ("w", w)])
    if fwd_route(mg, _card(u0.device)) == "grid":
        return _fwd_grid(a, b, w, u0, c2, c3, n_steps, store_traj, store_series)
    return _fwd_block(a, b, w, u0, c2, c3, n_steps, store_traj, store_series)


def _fwd_grid(a, b, w, u0, c2, c3, n_steps, store_traj=True,
              store_series=False):
    """`fused_fwd` on the grid-wide kernel (`sm_fused_fwd_grid`) at any mg
    whose A rows fit the card: raises if the card cannot hold its CTAs at
    once. Where fewer than all of a CTA's B rows fit, the kernel's
    instance that reads the others from L2 runs, counted under
    `fused_fwd_grid_stream*`. The caller has checked the shapes."""
    mg = u0.shape[-1]
    rows, ctas, rows_b = fwd_grid_partition(mg, _card(u0.device))
    _check_grid(u0.device, "sm_fused_fwd_grid", (mg, rows, rows_b), ctas,
                bool(store_series))
    uT, jsum, traj, ser = _fwd_outputs(u0, n_steps, store_traj, store_series)
    slots = _tag_slots(u0)
    counter = "fused_fwd_grid" + ("_stream" if rows_b < rows else "")
    _launch("sm_fused_fwd_grid", counter + ("_ser" if store_series else ""),
            u0.device, a.data_ptr(), b.data_ptr(), w.data_ptr(), u0.data_ptr(),
            c2, c3, int(n_steps), mg, rows, rows_b, uT.data_ptr(),
            jsum.data_ptr(), _ptr(traj), _ptr(ser), slots.data_ptr())
    return uT, jsum, traj, ser


def _fwd_block(a, b, w, u0, c2, c3, n_steps, store_traj=True,
               store_series=False):
    """`fused_fwd` on the one-block kernel (`sm_fused_fwd_block`) at any
    mg: the route where the grid's A rows do not fit, and the kernel the
    grid is held to bit for bit. The caller has checked the shapes."""
    uT, jsum, traj, ser = _fwd_outputs(u0, n_steps, store_traj, store_series)
    _launch("sm_fused_fwd_block",
            "fused_fwd_block_ser" if store_series else "fused_fwd_block",
            u0.device, a.data_ptr(), b.data_ptr(), w.data_ptr(), u0.data_ptr(),
            c2, c3, int(n_steps), u0.shape[-1], uT.data_ptr(), jsum.data_ptr(),
            _ptr(traj), _ptr(ser))
    return uT, jsum, traj, ser


def fused_bwd(a, b, w, uT, traj, c2, c3, scale, n_steps, op_grads=False,
              lam_hist=None):
    """(lambda_0, dA or None, dB or None) of the two-matrix reverse
    sweep; `scale` is a 0-dim tensor float32(-2 dt) * gbar; `lam_hist` as
    in `fused_bwd_shared`. With op_grads, dA = sum_n lambda_{n+1} (x) u_n
    and dB = sum_n lambda_{n+1} (x) g(u_n), from the sweep's lambda
    history. On the card the route follows `bwd_route(mg)` for that card;
    both give the same numbers bit for bit."""
    if uT.device.type == "cpu":
        return fused_bwd_plain(a, b, w, uT, traj, c2, c3, scale, n_steps,
                               op_grads, lam_hist)
    scale = scale.reshape(())
    hist = _lam_hist(uT, n_steps, op_grads, lam_hist)
    mg = _check(n_steps, mats=[("a", a), ("b", b)],
                vecs=[("uT", uT), ("w", w)], traj=traj, scale=scale, hist=hist)
    route = bwd_route(mg, _card(uT.device))
    if route == "cluster":
        _check_cluster(uT.device, "sm_fused_bwd", mg, hist is not None)
        lam = torch.empty_like(uT)
        _launch("sm_fused_bwd", "fused_bwd" if hist is None else "fused_bwd_ops",
                uT.device, a.data_ptr(), b.data_ptr(), w.data_ptr(),
                uT.data_ptr(), _ptr(traj), c2, c3, scale.data_ptr(),
                int(n_steps), mg, lam.data_ptr(), _ptr(hist))
    else:
        bwd = _bwd_grid if route == "grid" else _bwd_block
        lam = bwd(a, b, w, uT, traj, c2, c3, scale, n_steps, hist)
    if not op_grads:
        return lam, None, None
    return (lam,) + op_grads_product(hist, traj, "two", c2, c3)


def _bwd_grid(a, b, w, uT, traj, c2, c3, scale, n_steps, lam_hist=None):
    """lambda_0 of `fused_bwd` on the grid-wide kernel (`sm_fused_bwd_grid`,
    counted under `fused_bwd_grid`, with the history under
    `fused_bwd_grid_ops`) at any mg whose A columns fit the card: the
    route above the cluster's width. Raises if the card cannot hold its
    CTAs at once. Where fewer than all of a CTA's B columns fit, the
    kernel's instance that stages the others from L2 runs (from B's
    `phase_ordered` copy), counted under `fused_bwd_grid_stream` with or
    without the history. `scale` is 0-dim; the caller has checked the
    shapes."""
    mg = uT.shape[-1]
    cols, ctas, cols_b = bwd_grid_partition(mg, _card(uT.device))
    _check_grid(uT.device, "sm_fused_bwd_grid", (mg, cols, cols_b), ctas,
                lam_hist is not None)
    lam = torch.empty_like(uT)
    bperm = phase_ordered(b) if cols_b < cols else None
    counter = ("fused_bwd_grid_stream" if cols_b < cols
               else "fused_bwd_grid" + ("" if lam_hist is None else "_ops"))
    _launch("sm_fused_bwd_grid", counter, uT.device, a.data_ptr(), b.data_ptr(),
            _ptr(bperm), w.data_ptr(), uT.data_ptr(), _ptr(traj), c2, c3,
            scale.data_ptr(), int(n_steps), mg, cols, cols_b, lam.data_ptr(),
            _ptr(lam_hist), _tag_slots(uT).data_ptr())
    return lam


def phase_ordered(b):
    """B with each column's rows in the reverse's phase order: B[p + P m, c]
    at (c P + p) (mg / P) + m, P = row_phases(mg) (which divides mg where
    the grid reverse stages B's columns). The grid reverse's instance that
    stages B columns from L2 copies whole 16-byte pieces of it; made once a
    call, a layout of the operand and no arithmetic."""
    mg = b.shape[-1]
    P = row_phases(mg)
    return b.t().reshape(mg, mg // P, P).transpose(1, 2).contiguous()


def _bwd_block(a, b, w, uT, traj, c2, c3, scale, n_steps, lam_hist=None):
    """lambda_0 of `fused_bwd` on the one-block kernel
    (`sm_fused_bwd_block`, counted under `fused_bwd_block` with or
    without the history) at any mg: the route where the grid's A columns
    do not fit, and the kernel the cluster and the grid are held to bit
    for bit. `scale` is 0-dim; the caller has checked the shapes."""
    lam = torch.empty_like(uT)
    _launch("sm_fused_bwd_block", "fused_bwd_block", uT.device, a.data_ptr(),
            b.data_ptr(), w.data_ptr(), uT.data_ptr(), _ptr(traj), c2, c3,
            scale.data_ptr(), int(n_steps), uT.shape[-1], lam.data_ptr(),
            _ptr(lam_hist))
    return lam


# ---------------------------------------------------------------------------
# differentiable objectives (the JAX custom_vjp pairs)
# ---------------------------------------------------------------------------


def _dw(gbar, dt, traj, uT):
    """dJ/dw_j = -dt * sum_n u_n,j^2, times the incoming cotangent."""
    return gbar * (-dt) * (torch.sum(traj * traj, dim=0) + uT * uT)


def _scale(dt, gbar, like):
    """float32(-2 dt) * gbar in the working dtype (JAX:
    jnp.float32(-2.0 * dt) * gbar), left on the device: no sync. A fill,
    not a copy from the host, so a CUDA graph can capture it."""
    return torch.full((), -2.0 * dt, dtype=like.dtype, device=like.device) * gbar


class FusedObjective(torch.autograd.Function):
    """-J with J = dt * sum_{n=0..N} sum_j w_j u_n,j^2 under
    u' = A u + B (c2 u^2 + c3 u^3); differentiable in u0, w, A and B.

    apply(a, b, w, u0, c2, c3, dt, n_steps, op_grads=True)

    The forward stores the trajectory only when a gradient is wanted;
    the backward runs the reverse-sweep kernel, and for an A or B that
    requires grad the operator-cotangent product after it.
    op_grads=False opts out of dA and dB (JAX: zero cotangents; here
    None) for callers whose operators are fixed data.
    """

    @staticmethod
    def forward(ctx, a, b, w, u0, c2, c3, dt, n_steps, op_grads=True):
        need_traj = any(ctx.needs_input_grad[:4])
        uT, jsum, traj, _ = fused_fwd(a, b, w, u0, c2, c3, n_steps,
                                      store_traj=need_traj)
        if need_traj:
            ctx.save_for_backward(a, b, w, uT, traj)
        ctx.consts = (c2, c3, dt, n_steps, op_grads)
        return -dt * jsum

    @staticmethod
    def backward(ctx, gbar):
        return _two_matrix_backward(ctx, gbar)


def _two_matrix_backward(ctx, gbar):
    a, b, w, uT, traj = ctx.saved_tensors
    c2, c3, dt, n_steps, op_grads = ctx.consts
    want_ops = op_grads and any(ctx.needs_input_grad[:2])
    lam, da, db = fused_bwd(a, b, w, uT, traj, c2, c3, _scale(dt, gbar, uT),
                            n_steps, op_grads=want_ops)
    dw = _dw(gbar, dt, traj, uT) if ctx.needs_input_grad[2] else None
    return (da, db, dw, lam) + (None,) * 5


class FusedObjectiveDiag(torch.autograd.Function):
    """`FusedObjective` that also returns (energies, uT): the N+1
    per-step weighted energies that the Kahan sum consumes, and the final
    state, from the same forward pass. Only J carries a gradient: the
    two aux outputs are non-differentiable (the JAX `_vjp_bwd_diag`
    consumes only J's cotangent)."""

    @staticmethod
    def forward(ctx, a, b, w, u0, c2, c3, dt, n_steps, op_grads=True):
        need_traj = any(ctx.needs_input_grad[:4])
        uT, jsum, traj, ser = fused_fwd(a, b, w, u0, c2, c3, n_steps,
                                        store_traj=need_traj,
                                        store_series=True)
        if need_traj:
            ctx.save_for_backward(a, b, w, uT, traj)
        ctx.consts = (c2, c3, dt, n_steps, op_grads)
        ctx.mark_non_differentiable(ser, uT)
        return -dt * jsum, ser, uT

    @staticmethod
    def backward(ctx, gbar, _ser_bar, _uT_bar):
        return _two_matrix_backward(ctx, gbar)


class FusedObjectiveShared(torch.autograd.Function):
    """-J with J = dt * sum_{n=0..N} sum_j w_j u_n,j^2 under
    u' = B (lin u + c2 u^2 + c3 u^3); differentiable in u0, w and B.

    apply(b, w, u0, c2, c3, lin, dt, n_steps, op_grads=True)

    The forward stores the trajectory only when a gradient is wanted (the
    primal-only path runs trajectory-free, like `store_traj=False` in the
    JAX primal); the backward runs the reverse-sweep kernel, and for a B
    that requires grad the operator-cotangent product after it.
    op_grads=False opts out of dB, as in `FusedObjective`.
    """

    @staticmethod
    def forward(ctx, b, w, u0, c2, c3, lin, dt, n_steps, op_grads=True):
        need_traj = any(ctx.needs_input_grad[:3])
        uT, jsum, traj, _ = fused_fwd_shared(b, w, u0, c2, c3, lin, n_steps,
                                             store_traj=need_traj)
        if need_traj:
            ctx.save_for_backward(b, w, uT, traj)
        ctx.consts = (c2, c3, lin, dt, n_steps, op_grads)
        return -dt * jsum

    @staticmethod
    def backward(ctx, gbar):
        return _shared_backward(ctx, gbar)


def _shared_backward(ctx, gbar):
    b, w, uT, traj = ctx.saved_tensors
    c2, c3, lin, dt, n_steps, op_grads = ctx.consts
    want_db = ctx.needs_input_grad[0] and op_grads
    lam, db = fused_bwd_shared(b, w, uT, traj, c2, c3, lin,
                               _scale(dt, gbar, uT), n_steps, op_grads=want_db)
    dw = _dw(gbar, dt, traj, uT) if ctx.needs_input_grad[1] else None
    return (db, dw, lam) + (None,) * 6


class FusedObjectiveSharedDiag(torch.autograd.Function):
    """`FusedObjectiveShared` that also returns (energies, uT); the aux
    outputs are non-differentiable, as in `FusedObjectiveDiag`."""

    @staticmethod
    def forward(ctx, b, w, u0, c2, c3, lin, dt, n_steps, op_grads=True):
        need_traj = any(ctx.needs_input_grad[:3])
        uT, jsum, traj, ser = fused_fwd_shared(b, w, u0, c2, c3, lin, n_steps,
                                               store_traj=need_traj,
                                               store_series=True)
        if need_traj:
            ctx.save_for_backward(b, w, uT, traj)
        ctx.consts = (c2, c3, lin, dt, n_steps, op_grads)
        ctx.mark_non_differentiable(ser, uT)
        return -dt * jsum, ser, uT

    @staticmethod
    def backward(ctx, gbar, _ser_bar, _uT_bar):
        return _shared_backward(ctx, gbar)


# ---------------------------------------------------------------------------
# rows: R independent sweeps of one operator (a sweep's starting points)
# ---------------------------------------------------------------------------

# states one launch of a row kernel steps (csrc/grid.cuh kMaxStates); a
# wider call runs in chunks of ROWS_MAX rows, each chunk one launch
ROWS_MAX = 8
# CTAs of the SH23 row forward: at mg = 512 and R = 8 a split of the
# operator's rows over 64 CTAs (8 rows a CTA) took 3.385 ms (SH23 N = 1000)
# against 3.757 over 128 and 4.815 over 32: fewer CTAs read each step's R
# vectors back from L2, more share the products. At R = 1 the 128-CTA
# split led, 1.361 against 1.423 ms; the split is chosen for the sweep's
# R = 8 (H100 SXM at 700 W, tools/time_row_kernels.py)
ROW_CTAS = 64


def rows_partition(mg):
    """(rows, ctas) of the SH23 row forward: `rows` = ceil(mg / ROW_CTAS)
    contiguous rows of B a CTA, as `grid_partition`; at the row kernels'
    widths ctas >= ROWS_MAX (CTA s forms row s's J)."""
    rows = -(-mg // ROW_CTAS)
    return rows, -(-mg // rows)


# SHB23's row kernels (csrc/fused_rows.cuh): the forward runs a launch's
# rows in groups of G rows, each group on its own CTAs, and the reverse in
# clusters of G rows; G is a template parameter of each kernel, one nvcc
# process a G (csrc/fused_rows_g<G>.cu). The wrappers take the smallest G
# that fits (`fwd_row_group`, `bwd_row_group`): on an H100, 1, and 2 for
# the reverse at R = 8 (one wave of 4 clusters) and, on a 114-SM card, for
# the forward at R = 8 (`fwd_rows_most`: where G = 2 does not fit 8 rows
# either, a launch takes 7)
ROW_GROUPS = (1, 2)
# floats of the operators a forward thread keeps in registers (kOpFloats:
# its float4s of its warp's rows of A and B), and terms of each of a reverse
# thread's two chains kept in registers (kOpTerms)
OP_FLOATS, OP_TERMS = 128, 56
ROW_WARPS = GRID_THREADS // 32


def fwd_row_slots(mg, group):
    """Rows a warp of the grouped forward holds at most (its row slots,
    csrc/fused_rows.cuh `fwd_row_slots`): those of a CTA of the narrowest
    group a card of >= 128 SMs gives, ceil(8 / G) groups of 16 G CTAs."""
    return -(-(mg // 128) // group)


def fwd_reg_slots(mg, group):
    """The row slots whose float4s of A and B a lane keeps in registers
    (`fwd_reg_slots`): as many as OP_FLOATS holds, 8 mg / 128 floats a
    slot; the rows of the other slots stay in shared memory."""
    return min(fwd_row_slots(mg, group), OP_FLOATS // (8 * (mg // 128)))


def fwd_rows_groups(mg, R, group, sms):
    """(groups, ctas, rows) of the grouped forward of R rows on a card of
    `sms` SMs: ceil(R / G) groups, each of `ctas` CTAs that split the
    operators' rows as `grid_partition` splits them over sms // groups
    SMs, `rows` a CTA."""
    groups = -(-R // group)
    rows, ctas = grid_partition(mg, sms // groups)
    return groups, ctas, rows


def fwd_rows_fits(mg, R, group, sms):
    """Whether the grouped forward of R rows at G = `group` fits a card of
    `sms` SMs: a CTA's rows fit its warps' row slots and a group has a CTA
    for each of its rows' J."""
    _, ctas, rows = fwd_rows_groups(mg, R, group, sms)
    return -(-rows // ROW_WARPS) <= fwd_row_slots(mg, group) and ctas >= min(group, R)


def fwd_rows_smem_bytes(mg, group, rows):
    """Shared memory of a grouped-forward CTA of `rows` rows: the rows past
    its register slots (of A and B), u of its group's G rows twice
    (ping-pong) and their g, w and 32 partial sums (csrc/fused_rows.cuh
    `fwd_rows_group_smem`)."""
    shared = max(rows - ROW_WARPS * fwd_reg_slots(mg, group), 0)
    return 4 * (2 * shared * mg + 3 * group * mg + mg + 32)


def bwd_reg_terms(mg):
    """Terms of each of a row-reverse thread's two chains (rows p, p + P, ...
    of its column of A and of B) kept in registers: all ceil(mg / P) up to
    OP_TERMS; the tail stays in shared memory (56 of 64 at mg = 512, of 107
    at 640)."""
    return min(-(-mg // row_phases(mg)), OP_TERMS)


def bwd_rows_smem_bytes(mg, group):
    """Shared memory of a row-reverse CTA: the chains' tails of its P x C
    threads (C = mg / 16 columns), lambda [2][P][lts][G] in the chains'
    order (lts = chain_stride(ceil(mg / P))), the partials of both matrices
    [P C][G], u_n [C][G] and w [C] (`bwd_rows_group_smem`)."""
    P, C = row_phases(mg), mg // 16
    tail = -(-mg // P) - bwd_reg_terms(mg)
    ts = chain_stride(tail) if tail > 0 else 0
    lts = chain_stride(-(-mg // P))
    return 4 * (2 * P * C * ts + 2 * P * lts * group + 2 * P * C * group + C * group + C)


def fwd_row_group(R, mg, card=H100_SXM):
    """G of the grouped forward of R (1 .. ROWS_MAX) rows at width mg on a
    card of `card` = (SMs, opt-in shared memory): the smallest G whose
    partition fits the card (G = 1 on an H100 at every row kernels' width:
    the most CTAs a row, the fewest words a CTA polls). At mg = 512,
    N = 2000 on an H100 SXM at 700 W, G = 1 took 3.23 / 3.84 ms at R = 4 / 8
    and G = 2 3.18 / 3.86 (tools/time_row_kernels.py --probe --stamps)."""
    if not 1 <= R <= ROWS_MAX:
        raise ValueError(f"a row launch takes 1 .. {ROWS_MAX} rows (got {R})")
    fits = _fwd_groups_that_fit(R, mg, card)
    if not fits:
        raise ValueError(f"no row group of the SHB23 row forward fits R={R}, mg={mg} on a "
                         f"card of {card[0]} SMs")
    return fits[0]


def _fwd_groups_that_fit(R, mg, card):
    return [g for g in ROW_GROUPS if fwd_rows_fits(mg, R, g, card[0])
            and fwd_rows_smem_bytes(mg, g, fwd_rows_groups(mg, R, g, card[0])[2]) <= card[1]]


def fwd_rows_most(mg, card=H100_SXM):
    """The most rows (<= ROWS_MAX) one launch of the grouped forward takes
    at width mg on `card`: ROWS_MAX on an H100 SXM; on a card of fewer SMs
    a G of ROW_GROUPS may not fit 8 rows (on a 114-SM H100 PCIe at mg 256
    and 512, 7), and the wrapper then launches smaller chunks."""
    return max(R for R in range(1, ROWS_MAX + 1) if _fwd_groups_that_fit(R, mg, card))


def bwd_row_group(R, held):
    """G of the row reverse of R (1 .. ROWS_MAX) rows on a card that holds
    held[G] of its clusters at once (`sm_fused_bwd_rows_capacity`): the
    smallest G whose ceil(R / G) clusters run in one wave, else the largest
    whose cluster can be scheduled; raises where none can. At mg = 512, N = 2000 on an H100 SXM at 700 W (7 clusters held at every
    G), a cluster of one row took 2.97 / 2.96 ms at R = 1 / 4 (G = 2: 3.72
    at R = 4) and 5.82 at R = 8, two waves, against 3.70 at G = 2
    (tools/time_row_kernels.py --probe --stamps)."""
    if not 1 <= R <= ROWS_MAX:
        raise ValueError(f"a row launch takes 1 .. {ROWS_MAX} rows (got {R})")
    ok = [g for g in ROW_GROUPS if held[g] > 0]
    if not ok:
        raise RuntimeError(f"no cluster of the row reverse sm_fused_bwd_rows can be scheduled "
                           f"on this card (clusters held a G: {held}; a negative count is "
                           f"-cudaError_t)")
    one_wave = [g for g in ok if -(-R // g) <= held[g]]
    return one_wave[0] if one_wave else ok[-1]


def rows_width_ok(mg, two_matrix):
    """Whether the row kernels take width mg: the widths of the reverse
    clusters, which they launch once per row (128 <= mg <= 896 for the
    shared matrix, 640 for two matrices, mg % 128 == 0). A sweep at
    another width has no row kernels and runs its rows one at a time."""
    top = CLUSTER_MG_MAX if two_matrix else SHARED_CLUSTER_MG_MAX
    return MG_MIN <= mg <= top and mg % MG_ALIGN == 0


def _plain_rows_sweep(step, w, u0, n_steps, store_traj):
    """(uT (R, mg), J_sum (R,), traj (R, N, mg) or None) of N steps of
    `step` over the rows of u0 (R, mg), each row's energy Kahan-summed."""
    u = u0
    acc = kahan_zero(u0.dtype, u0.device)
    traj = []
    for _ in range(n_steps):
        if store_traj:
            traj.append(u)
        acc = kahan_add(acc, torch.sum(w * u * u, -1))
        u = step(u)
    acc = kahan_add(acc, torch.sum(w * u * u, -1))
    if store_traj:
        traj = (torch.stack(traj, 1) if traj
                else u0.new_zeros((u0.shape[0], 0, u0.shape[-1])))
    return u, acc[0], traj if store_traj else None


def fused_fwd_shared_rows_plain(b, w, u0, c2, c3, lin, n_steps, store_traj=True):
    """`fused_fwd_shared_plain` of each row of u0 (R, mg), all rows a step
    as one product: (uT (R, mg), J_sum (R,), traj (R, N, mg) or None)."""
    return _plain_rows_sweep(
        lambda u: torch.mm(lin * u + c2 * u * u + c3 * u * u * u, b.t()),
        w, u0, n_steps, store_traj)


def fused_fwd_rows_plain(a, b, w, u0, c2, c3, n_steps, store_traj=True):
    """`fused_fwd_plain` of each row of u0 (R, mg), all rows a step as two
    products: (uT (R, mg), J_sum (R,), traj (R, N, mg) or None)."""
    return _plain_rows_sweep(
        lambda u: torch.mm(u, a.t()) + torch.mm(c2 * u * u + c3 * u * u * u, b.t()),
        w, u0, n_steps, store_traj)


def fused_bwd_shared_rows_plain(b, w, uT, traj, c2, c3, lin, scale, n_steps):
    """lambda_0 (R, mg) of `fused_bwd_shared_plain` for each row: uT
    (R, mg), traj (R, N, mg), scale (R,)."""
    s = scale[:, None]
    lam = s * (w * uT)
    for k in range(n_steps):
        u = traj[:, n_steps - 1 - k]
        vprime = lin + 2.0 * c2 * u + 3.0 * c3 * u * u
        lam = vprime * torch.mm(lam, b) + s * (w * u)
    return lam


def fused_bwd_rows_plain(a, b, w, uT, traj, c2, c3, scale, n_steps):
    """lambda_0 (R, mg) of `fused_bwd_plain` for each row, as
    `fused_bwd_shared_rows_plain`."""
    s = scale[:, None]
    lam = s * (w * uT)
    for k in range(n_steps):
        u = traj[:, n_steps - 1 - k]
        gprime = 2.0 * c2 * u + 3.0 * c3 * u * u
        lam = torch.mm(lam, a) + gprime * torch.mm(lam, b) + s * (w * u)
    return lam


def _check_rows(n_steps, two_matrix, mats, w, states, traj=None, scale=None):
    """(R, mg) of a row call; raises unless the operands are (mg, mg)
    matrices, a (mg,) w, (R, mg) states, an (R, N, mg) trajectory and an
    (R,) scale at a width the row kernels take (`rows_width_ok`), on one
    device, and, for CUDA tensors, f32 and contiguous."""
    if states.dim() != 2:
        raise ValueError(f"row states must be (R, mg), got {tuple(states.shape)}")
    R, mg = states.shape
    if not rows_width_ok(mg, two_matrix):
        top = CLUSTER_MG_MAX if two_matrix else SHARED_CLUSTER_MG_MAX
        raise ValueError(f"the row kernels take {MG_MIN} <= mg <= {top}, "
                         f"mg % {MG_ALIGN} == 0 (the reverse clusters' widths); got "
                         f"mg={mg}: a sweep at this width runs its rows one at a time")
    named = list(mats) + [("w", w), ("states", states)]
    named += [(k, t) for k, t in (("traj", traj), ("scale", scale)) if t is not None]
    want = {"w": (mg,), "states": (R, mg), "traj": (R, n_steps, mg), "scale": (R,)}
    bad = [f"{k}{tuple(t.shape)}" for k, t in named
           if tuple(t.shape) != want.get(k, (mg, mg))]
    if bad:
        raise ValueError(f"shapes {' '.join(bad)} do not match R={R}, mg={mg}, "
                         f"n_steps={n_steps}")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("all tensors must be on one device")
    if states.is_cuda:
        for name, t in named:
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32 (got {t.dtype})")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    return R, mg


def _row_chunks(R, most=ROWS_MAX):
    """(start, stop) of each launch of a call over R rows: `most` rows at a
    time."""
    return [(i, min(i + most, R)) for i in range(0, R, most)]


def fused_fwd_shared_rows(b, w, u0, c2, c3, lin, n_steps, store_traj=True):
    """(uT (R, mg), J_sum (R,), traj (R, N, mg) or None) of N steps of
    u' = B(lin u + g(u)) from each row of u0 (R, mg). On the card the row
    grid (`sm_fused_fwd_shared_rows`) runs up to ROWS_MAX rows a launch,
    so R rows take ceil(R / ROWS_MAX) launches, each row bitwise
    `fused_fwd_shared` on it; raises where the card cannot hold its CTAs
    and at widths without row kernels (`rows_width_ok`), also on the
    CPU, where it runs `fused_fwd_shared_rows_plain`."""
    R, mg = _check_rows(n_steps, False, [("b", b)], w, u0)
    if not u0.is_cuda:
        return fused_fwd_shared_rows_plain(b, w, u0, c2, c3, lin, n_steps, store_traj)
    rows, ctas = rows_partition(mg)
    uT, jsum, traj, slots = _rows_outputs(u0, n_steps, store_traj)
    for i, j in _row_chunks(R):
        _check_grid(u0.device, "sm_fused_fwd_shared_rows", (mg, rows), ctas, j - i)
        _launch("sm_fused_fwd_shared_rows", "fused_fwd_shared_rows", u0.device,
                b.data_ptr(), w.data_ptr(), u0[i].data_ptr(), c2, c3, lin,
                int(n_steps), mg, rows, j - i, uT[i].data_ptr(), jsum[i].data_ptr(),
                None if traj is None or not n_steps else traj[i].data_ptr(),
                slots.data_ptr())
    return uT, jsum, traj


def fused_fwd_rows(a, b, w, u0, c2, c3, n_steps, store_traj=True):
    """(uT (R, mg), J_sum (R,), traj (R, N, mg) or None) of N steps of
    u' = A u + B(c2 u^2 + c3 u^3) from each row of u0 (R, mg). On the card
    the grouped row forward (`sm_fused_fwd_rows`) runs up to
    `fwd_rows_most` rows a launch (ROWS_MAX on an H100 SXM), in groups of
    `fwd_row_group` rows, each row bitwise
    `fused_fwd` on it; raises where the card cannot hold its CTAs and at
    widths without row kernels (`rows_width_ok`), also on the CPU, where
    it runs `fused_fwd_rows_plain`."""
    R, mg = _check_rows(n_steps, True, [("a", a), ("b", b)], w, u0)
    if not u0.is_cuda:
        return fused_fwd_rows_plain(a, b, w, u0, c2, c3, n_steps, store_traj)
    card = _card(u0.device)
    uT, jsum, traj, slots = _rows_outputs(u0, n_steps, store_traj)
    for i, j in _row_chunks(R, fwd_rows_most(mg, card)):
        group = fwd_row_group(j - i, mg, card)
        groups, ctas, rows = fwd_rows_groups(mg, j - i, group, card[0])
        _check_rows_grid(u0.device, mg, group, rows, groups * ctas)
        _launch("sm_fused_fwd_rows", "fused_fwd_rows", u0.device, a.data_ptr(),
                b.data_ptr(), w.data_ptr(), u0[i].data_ptr(), c2, c3, int(n_steps), mg,
                group, ctas, rows, j - i, uT[i].data_ptr(), jsum[i].data_ptr(),
                None if traj is None or not n_steps else traj[i].data_ptr(),
                slots.data_ptr())
    return uT, jsum, traj


@functools.lru_cache(maxsize=None)
def _check_rows_grid(device, mg, group, rows, ctas):
    """Raise unless the card can hold the `ctas` CTAs of the grouped row
    forward at (mg, G = group, rows a CTA) at once:
    `sm_fused_fwd_rows_capacity` must reach `ctas`. A pass is remembered."""
    from spheremanopt_torch.ops.cuda.build import load

    with torch.cuda.device(device):
        n = load().sm_fused_fwd_rows_capacity(mg, group, rows)
    if n < ctas:
        raise RuntimeError(
            f"the grouped row forward sm_fused_fwd_rows (mg={mg}, G={group}: {ctas} CTAs of "
            f"{rows} rows) cannot be co-resident on {torch.cuda.get_device_name(device)}: "
            f"it holds {n}" + ("" if n >= 0 else f" (cudaError_t {-n})"))


@functools.lru_cache(maxsize=None)
def _rows_clusters(device, mg):
    """{G: clusters of the row reverse at (mg, G) the card holds at once}
    (`sm_fused_bwd_rows_capacity`: cudaOccupancyMaxActiveClusters, or
    -cudaError_t)."""
    from spheremanopt_torch.ops.cuda.build import load

    with torch.cuda.device(device):
        return {g: load().sm_fused_bwd_rows_capacity(mg, g) for g in ROW_GROUPS}


def _rows_outputs(u0, n_steps, store_traj):
    """(uT, jsum, traj or None, tag slots) of a row forward: the slots hold
    ROWS_MAX rows' words, reused by each chunk (the launches run in order
    on one stream, each clearing the tags first)."""
    R, mg = u0.shape
    dev = u0.device
    traj = (torch.empty((R, n_steps, mg), dtype=torch.float32, device=dev)
            if store_traj else None)
    return (torch.empty_like(u0), torch.empty((R,), dtype=torch.float32, device=dev),
            traj, torch.empty((4 * min(R, ROWS_MAX) * mg,), dtype=torch.float32,
                              device=dev))


def fused_bwd_shared_rows(b, w, uT, traj, c2, c3, lin, scale, n_steps):
    """lambda_0 (R, mg) of the reverse sweep of each row: uT (R, mg), traj
    (R, N, mg) and scale (R,) = float32(-2 dt) * gbar per row, on the
    device (no sync). On the card one launch of the reverse cluster per
    ROWS_MAX rows, one cluster a row (`sm_fused_bwd_shared_rows`), each row
    bitwise `fused_bwd_shared` on it; raises as `fused_fwd_shared_rows`."""
    R, mg = _check_rows(n_steps, False, [("b", b)], w, uT, traj, scale)
    if not uT.is_cuda:
        return fused_bwd_shared_rows_plain(b, w, uT, traj, c2, c3, lin, scale, n_steps)
    _check_cluster(uT.device, "sm_fused_bwd_shared", mg, False)
    lam = torch.empty_like(uT)
    for i, j in _row_chunks(R):
        _launch("sm_fused_bwd_shared_rows", "fused_bwd_shared_rows", uT.device,
                b.data_ptr(), w.data_ptr(), uT[i].data_ptr(), traj[i].data_ptr(), c2, c3,
                lin, scale[i:].data_ptr(), int(n_steps), mg, j - i, lam[i].data_ptr())
    return lam


def fused_bwd_rows(a, b, w, uT, traj, c2, c3, scale, n_steps):
    """lambda_0 (R, mg) of the two-matrix reverse sweep of each row: uT
    (R, mg), traj (R, N, mg) and scale (R,) = float32(-2 dt) * gbar per
    row, on the device (no sync). On the card one launch of the row reverse
    (`sm_fused_bwd_rows`) per ROWS_MAX rows, in clusters of `bwd_row_group`
    rows, each row bitwise `fused_bwd` on it; raises as `fused_fwd_rows`."""
    R, mg = _check_rows(n_steps, True, [("a", a), ("b", b)], w, uT, traj, scale)
    if not uT.is_cuda:
        return fused_bwd_rows_plain(a, b, w, uT, traj, c2, c3, scale, n_steps)
    lam = torch.empty_like(uT)
    for i, j in _row_chunks(R):
        group = bwd_row_group(j - i, _rows_clusters(uT.device, mg))
        _launch("sm_fused_bwd_rows", "fused_bwd_rows", uT.device, a.data_ptr(),
                b.data_ptr(), w.data_ptr(), uT[i].data_ptr(), traj[i].data_ptr(), c2, c3,
                scale[i:].data_ptr(), int(n_steps), mg, group, j - i, lam[i].data_ptr())
    return lam


def _only_u0_grads(ctx, n_data):
    """Raise when one of the first n_data inputs (the operators and w) needs
    a gradient: the row objectives are differentiable in u0 only."""
    if any(ctx.needs_input_grad[:n_data]):
        raise ValueError("the row objectives take no operator cotangents and no dw: "
                         "pass the operators and w without requires_grad (or use "
                         "the one-row FusedObjective*)")


class FusedObjectiveSharedRows(torch.autograd.Function):
    """-J (R,) of each row of u0 (R, mg) under u' = B (lin u + c2 u^2 +
    c3 u^3), J as in `FusedObjectiveShared`; differentiable in u0 only (a
    B or w that requires grad raises).

    apply(b, w, u0, c2, c3, lin, dt, n_steps)

    The forward stores the trajectory only when a gradient is wanted; the
    backward takes gbar (R,) to du0 (R, mg) through the row reverse."""

    @staticmethod
    def forward(ctx, b, w, u0, c2, c3, lin, dt, n_steps):
        _only_u0_grads(ctx, 2)
        uT, jsum, traj = fused_fwd_shared_rows(b, w, u0, c2, c3, lin, n_steps,
                                               store_traj=ctx.needs_input_grad[2])
        if ctx.needs_input_grad[2]:
            ctx.save_for_backward(b, w, uT, traj)
        ctx.consts = (c2, c3, lin, dt, n_steps)
        return -dt * jsum

    @staticmethod
    def backward(ctx, gbar):
        b, w, uT, traj = ctx.saved_tensors
        c2, c3, lin, dt, n_steps = ctx.consts
        lam = fused_bwd_shared_rows(b, w, uT, traj, c2, c3, lin,
                                    _scale(dt, gbar, uT).contiguous(), n_steps)
        return (None, None, lam) + (None,) * 5


class FusedObjectiveRows(torch.autograd.Function):
    """-J (R,) of each row of u0 (R, mg) under u' = A u + B (c2 u^2 +
    c3 u^3), as `FusedObjectiveSharedRows`; differentiable in u0 only.

    apply(a, b, w, u0, c2, c3, dt, n_steps)"""

    @staticmethod
    def forward(ctx, a, b, w, u0, c2, c3, dt, n_steps):
        _only_u0_grads(ctx, 3)
        uT, jsum, traj = fused_fwd_rows(a, b, w, u0, c2, c3, n_steps,
                                        store_traj=ctx.needs_input_grad[3])
        if ctx.needs_input_grad[3]:
            ctx.save_for_backward(a, b, w, uT, traj)
        ctx.consts = (c2, c3, dt, n_steps)
        return -dt * jsum

    @staticmethod
    def backward(ctx, gbar):
        a, b, w, uT, traj = ctx.saved_tensors
        c2, c3, dt, n_steps = ctx.consts
        lam = fused_bwd_rows(a, b, w, uT, traj, c2, c3,
                             _scale(dt, gbar, uT).contiguous(), n_steps)
        return (None, None, None, lam) + (None,) * 4
