"""Fused SBDF integrators and their reverse sweeps, as hand-written CUDA
kernels for Hopper.

PyTorch port of the JAX package's `ops/pallas/fused_two_matrix.py`:

  two-matrix form  u' = A u + B (c2 u^2 + c3 u^3)       (SHB23)
    fused_fwd          <- `_run_fwd` / `_fwd_kernel` (has_traj, has_ser): a
                          16-CTA cluster up to mg = 640, one block above
                          (`fwd_route`)
    fused_bwd          <- `_run_bwd` / `_bwd_kernel` (op_grads=True: the
                          sweep stores the lambda history, then
                          `op_grads_product` forms dA and dB): a 16-CTA
                          cluster up to mg = 640, one block above
                          (`bwd_route`)
    FusedObjective     <- `fused_objective` (custom_vjp)
    FusedObjectiveDiag <- `fused_objective_diag`
  shared-matrix form  u' = B (lin u + c2 u^2 + c3 u^3)  (SH23: B = M,
  lin = 1/dt)
    fused_fwd_shared   <- `_run_fwd_shared` / `_fwd_kernel_shared`
    fused_bwd_shared   <- `_run_bwd_shared` / `_bwd_kernel_shared`
                          (op_grads=True: lambda history, then dB)
    FusedObjectiveShared     <- `fused_objective_shared`
    FusedObjectiveSharedDiag <- `fused_objective_shared_diag`

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
variants of the forwards, the two routes of the two-matrix sweeps and
the lambda-history variants of the reverse sweeps apart; the one-block
reverse counts both of its variants under `fused_bwd_block`). The kernels
are f32 only; the plain versions take f32 or f64.
"""

from __future__ import annotations

import functools

import torch

from spheremanopt_torch.solvers.scan_utils import kahan_add, kahan_zero

KERNEL_SOURCES = {
    "fused_fwd_shared": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_fwd_shared_ser": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_bwd_shared": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_fwd": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_fwd_ser": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_fwd_block": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_fwd_block_ser": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_bwd": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_bwd_block": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "fused_bwd_shared_ops": "spheremanopt_torch/csrc/fused_shared.cu",
    "fused_bwd_ops": "spheremanopt_torch/csrc/fused_two_matrix.cu",
    "op_grads": "spheremanopt_torch/csrc/op_grads.cu",
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
    u' = B(lin u + g(u))."""
    if u0.device.type == "cpu":
        return fused_fwd_shared_plain(b, w, u0, c2, c3, lin, n_steps,
                                      store_traj, store_series)
    mg = _check(n_steps, mats=[("b", b)], vecs=[("u0", u0), ("w", w)])
    uT, jsum, traj, ser = _fwd_outputs(u0, n_steps, store_traj, store_series)
    _launch("sm_fused_fwd_shared",
            "fused_fwd_shared_ser" if store_series else "fused_fwd_shared",
            u0.device, b.data_ptr(), w.data_ptr(), u0.data_ptr(), c2, c3, lin,
            int(n_steps), mg, uT.data_ptr(), jsum.data_ptr(), _ptr(traj),
            _ptr(ser))
    return uT, jsum, traj, ser


def fused_bwd_shared(b, w, uT, traj, c2, c3, lin, scale, n_steps,
                     op_grads=False, lam_hist=None):
    """(lambda_0, dB or None) of the reverse sweep; `scale` is a 0-dim
    tensor float32(-2 dt) * gbar (kept on the device: no sync). Row n of
    `lam_hist` ((n_steps, mg), when given) receives the lambda_{n+1} that
    step n consumes: the kernel's history variant. With op_grads,
    dB = sum_n lambda_{n+1} (x) v(u_n): the sweep stores its lambda
    history and `op_grads_product` forms dB."""
    if uT.device.type == "cpu":
        return fused_bwd_shared_plain(b, w, uT, traj, c2, c3, lin, scale,
                                      n_steps, op_grads, lam_hist)
    scale = scale.reshape(())
    hist = _lam_hist(uT, n_steps, op_grads, lam_hist)
    mg = _check(n_steps, mats=[("b", b)], vecs=[("uT", uT), ("w", w)],
                traj=traj, scale=scale, hist=hist)
    lam = torch.empty_like(uT)
    _launch("sm_fused_bwd_shared",
            "fused_bwd_shared" if hist is None else "fused_bwd_shared_ops",
            uT.device, b.data_ptr(), w.data_ptr(), uT.data_ptr(), _ptr(traj),
            c2, c3, lin, scale.data_ptr(), int(n_steps), mg, lam.data_ptr(),
            _ptr(hist))
    if not op_grads:
        return lam, None
    return lam, op_grads_product(hist, traj, "shared", c2, c3, lin)[0]


# The two-matrix sweeps' cluster routes keep A and B (rows forward,
# columns in reverse) on 16 SMs: 2 mg^2 * 4 / 16 bytes must fit one SM's
# shared memory.
CLUSTER_MG_MAX = 640


def fwd_route(mg):
    """The two-matrix forward's kernel for width mg: "cluster" (16 CTAs
    holding A's and B's rows in shared memory, `sm_fused_fwd`) up to
    CLUSTER_MG_MAX, else "block" (one thread block streaming A and B
    from L2, `sm_fused_fwd_block`). A choice by shape, not a fallback."""
    return "cluster" if mg <= CLUSTER_MG_MAX else "block"


def bwd_route(mg):
    """The two-matrix reverse sweep's kernel for width mg: "cluster" (16
    CTAs holding A's and B's columns in shared memory, `sm_fused_bwd`) up
    to CLUSTER_MG_MAX, else "block" (`sm_fused_bwd_block`). Both give the
    same bits."""
    return "cluster" if mg <= CLUSTER_MG_MAX else "block"


@functools.lru_cache(maxsize=None)
def _check_cluster(device, symbol, mg, variant):
    """Raise unless the card can schedule the cluster kernel `symbol`
    ("sm_fused_fwd" or "sm_fused_bwd") for this mg and template variant
    (the series, the lambda history): `<symbol>_capacity`, the
    cudaOccupancyMaxActiveClusters count, must be > 0. A pass is
    remembered."""
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
    `fwd_route(mg)`; both give the same numbers bit for bit."""
    if u0.device.type == "cpu":
        return fused_fwd_plain(a, b, w, u0, c2, c3, n_steps, store_traj,
                               store_series)
    mg = _check(n_steps, mats=[("a", a), ("b", b)],
                vecs=[("u0", u0), ("w", w)])
    uT, jsum, traj, ser = _fwd_outputs(u0, n_steps, store_traj, store_series)
    if fwd_route(mg) == "cluster":
        _check_cluster(u0.device, "sm_fused_fwd", mg, bool(store_series))
        symbol, counter = "sm_fused_fwd", "fused_fwd"
    else:
        symbol, counter = "sm_fused_fwd_block", "fused_fwd_block"
    _launch(symbol, counter + "_ser" if store_series else counter,
            u0.device, a.data_ptr(), b.data_ptr(), w.data_ptr(), u0.data_ptr(),
            c2, c3, int(n_steps), mg, uT.data_ptr(), jsum.data_ptr(),
            _ptr(traj), _ptr(ser))
    return uT, jsum, traj, ser


def fused_bwd(a, b, w, uT, traj, c2, c3, scale, n_steps, op_grads=False,
              lam_hist=None):
    """(lambda_0, dA or None, dB or None) of the two-matrix reverse
    sweep; `scale` is a 0-dim tensor float32(-2 dt) * gbar; `lam_hist` as
    in `fused_bwd_shared`. With op_grads, dA = sum_n lambda_{n+1} (x) u_n
    and dB = sum_n lambda_{n+1} (x) g(u_n), from the sweep's lambda
    history. On the card the route follows `bwd_route(mg)`; both give
    the same numbers bit for bit."""
    if uT.device.type == "cpu":
        return fused_bwd_plain(a, b, w, uT, traj, c2, c3, scale, n_steps,
                               op_grads, lam_hist)
    scale = scale.reshape(())
    hist = _lam_hist(uT, n_steps, op_grads, lam_hist)
    mg = _check(n_steps, mats=[("a", a), ("b", b)],
                vecs=[("uT", uT), ("w", w)], traj=traj, scale=scale, hist=hist)
    lam = torch.empty_like(uT)
    if bwd_route(mg) == "cluster":
        _check_cluster(uT.device, "sm_fused_bwd", mg, hist is not None)
        symbol = "sm_fused_bwd"
        counter = "fused_bwd" if hist is None else "fused_bwd_ops"
    else:
        symbol, counter = "sm_fused_bwd_block", "fused_bwd_block"
    _launch(symbol, counter, uT.device, a.data_ptr(), b.data_ptr(),
            w.data_ptr(), uT.data_ptr(), _ptr(traj), c2, c3, scale.data_ptr(),
            int(n_steps), mg, lam.data_ptr(), _ptr(hist))
    if not op_grads:
        return lam, None, None
    return (lam,) + op_grads_product(hist, traj, "two", c2, c3)


# ---------------------------------------------------------------------------
# differentiable objectives (the JAX custom_vjp pairs)
# ---------------------------------------------------------------------------


def _dw(gbar, dt, traj, uT):
    """dJ/dw_j = -dt * sum_n u_n,j^2, times the incoming cotangent."""
    return gbar * (-dt) * (torch.sum(traj * traj, dim=0) + uT * uT)


def _scale(dt, gbar, like):
    """float32(-2 dt) * gbar in the working dtype (JAX:
    jnp.float32(-2.0 * dt) * gbar), left on the device: no sync."""
    return torch.tensor(-2.0 * dt, dtype=like.dtype, device=like.device) * gbar


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
