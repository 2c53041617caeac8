"""Shared-matrix fused integrator u' = B (lin u + c2 u^2 + c3 u^3) and its
reverse sweep, as hand-written CUDA kernels for Hopper.

PyTorch port of the shared-matrix pair of
the JAX package's `ops/pallas/fused_two_matrix.py` (SH23's step is one
matrix, u' = M (u/dt + 1.8u^2 - u^3), so B = M, lin = 1/dt):

  fused_fwd_shared   <- `_run_fwd_shared` / `_fwd_kernel_shared`
  fused_bwd_shared   <- `_run_bwd_shared` / `_bwd_kernel_shared`
  FusedObjectiveShared  <- `fused_objective_shared` (custom_vjp)

The forward runs all N steps in one launch and returns the final state,
the Kahan-compensated sum J_sum = sum_{n=0..N} sum_j w_j u_n,j^2 and,
for gradient contexts, the N pre-step states. The backward carries
lambda_N = s w u_N back through
lambda_n = (lin + 2 c2 u_n + 3 c3 u_n^2) (B^T lambda_{n+1}) + s w u_n.

Each wrapper takes its plain PyTorch version (`*_plain`) for tensors on
the CPU and launches its kernel for CUDA tensors; a CUDA tensor never
falls back. `LAUNCHES` counts kernel launches per wrapper. The kernels
are f32 only; the plain versions take f32 or f64 and also provide the
operator cotangent dB (`op_grads=True`), which the kernels do not.
"""

from __future__ import annotations

import torch

from spheremanopt_torch.solvers.scan_utils import kahan_add, kahan_zero

KERNEL_SOURCE = "spheremanopt_torch/csrc/fused_shared.cu"
# kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"fused_fwd_shared": 0, "fused_bwd_shared": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def fused_fwd_shared_plain(b, w, u0, c2, c3, lin, n_steps, store_traj=True):
    """(uT, J_sum, traj or None), step by step with `torch.mv`."""
    u = u0
    acc = kahan_zero(u0.dtype, u0.device)
    traj = []
    for _ in range(n_steps):
        if store_traj:
            traj.append(u)
        acc = kahan_add(acc, torch.sum(w * u * u))
        u = torch.mv(b, lin * u + c2 * u * u + c3 * u * u * u)
    acc = kahan_add(acc, torch.sum(w * u * u))
    if not store_traj:
        return u, acc[0], None
    return u, acc[0], torch.stack(traj) if traj else u0.new_zeros((0, len(u0)))


def fused_bwd_shared_plain(b, w, uT, traj, c2, c3, lin, scale, n_steps,
                           op_grads=False):
    """(lambda_0, dB or None); `scale` = float32(-2 dt) * gbar."""
    lam = scale * (w * uT)
    db = torch.zeros_like(b) if op_grads else None
    for k in range(n_steps):
        u = traj[n_steps - 1 - k]
        if op_grads:
            v = lin * u + c2 * u * u + c3 * u * u * u
            db += torch.outer(lam, v)
        wb = torch.mv(b.t(), lam)
        vprime = lin + 2.0 * c2 * u + 3.0 * c3 * u * u
        lam = vprime * wb + scale * (w * u)
    return lam, db


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

MG_MIN, MG_MAX, MG_ALIGN = 128, 2048, 128


def _check_cuda(mg, **tensors):
    if not (MG_MIN <= mg <= MG_MAX and mg % MG_ALIGN == 0):
        raise ValueError(f"the CUDA kernels take {MG_MIN} <= mg <= {MG_MAX}, "
                         f"mg % {MG_ALIGN} == 0; got mg={mg}")
    dev = None
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 (got {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dev is not None and t.device != dev:
            raise ValueError("all tensors must be on one device")
        dev = t.device


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {code}")


def fused_fwd_shared(b, w, u0, c2, c3, lin, n_steps, store_traj=True):
    """(uT, J_sum, traj or None) of N steps of u' = B(lin u + g(u))."""
    if u0.device.type == "cpu":
        return fused_fwd_shared_plain(b, w, u0, c2, c3, lin, n_steps, store_traj)
    from spheremanopt_torch.ops.cuda.build import load

    mg = u0.shape[-1]
    _check_cuda(mg, b=b, w=w, u0=u0)
    if b.shape != (mg, mg) or w.shape != (mg,) or u0.shape != (mg,):
        raise ValueError(f"shapes b{tuple(b.shape)} w{tuple(w.shape)} "
                         f"u0{tuple(u0.shape)} do not match mg={mg}")
    lib = load()
    with torch.cuda.device(u0.device):
        uT = torch.empty_like(u0)
        jsum = torch.empty((), dtype=torch.float32, device=u0.device)
        traj = (torch.empty((n_steps, mg), dtype=torch.float32, device=u0.device)
                if store_traj else None)
        code = lib.sm_fused_fwd_shared(
            b.data_ptr(), w.data_ptr(), u0.data_ptr(), c2, c3, lin,
            int(n_steps), mg, uT.data_ptr(), jsum.data_ptr(),
            traj.data_ptr() if store_traj and n_steps > 0 else None,
            torch.cuda.current_stream().cuda_stream)
    LAUNCHES["fused_fwd_shared"] += 1
    _raise_on(code, "fused_fwd_shared")
    return uT, jsum, traj


def fused_bwd_shared(b, w, uT, traj, c2, c3, lin, scale, n_steps,
                     op_grads=False):
    """(lambda_0, dB or None) of the reverse sweep; `scale` is a 0-dim
    tensor float32(-2 dt) * gbar (kept on the device: no sync)."""
    if uT.device.type == "cpu":
        return fused_bwd_shared_plain(b, w, uT, traj, c2, c3, lin, scale,
                                      n_steps, op_grads)
    if op_grads:
        raise NotImplementedError(
            "the CUDA reverse kernel has no operator cotangent (op_grads=True) "
            "yet (ROADMAP Queue 2 item 2)")
    from spheremanopt_torch.ops.cuda.build import load

    mg = uT.shape[-1]
    scale = scale.reshape(())
    _check_cuda(mg, b=b, w=w, uT=uT, traj=traj, scale=scale)
    if b.shape != (mg, mg) or w.shape != (mg,) or traj.shape != (n_steps, mg):
        raise ValueError(f"shapes b{tuple(b.shape)} w{tuple(w.shape)} "
                         f"traj{tuple(traj.shape)} do not match mg={mg}, "
                         f"n_steps={n_steps}")
    lib = load()
    with torch.cuda.device(uT.device):
        lam = torch.empty_like(uT)
        code = lib.sm_fused_bwd_shared(
            b.data_ptr(), w.data_ptr(), uT.data_ptr(), traj.data_ptr(),
            c2, c3, lin, scale.data_ptr(), int(n_steps), mg, lam.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    LAUNCHES["fused_bwd_shared"] += 1
    _raise_on(code, "fused_bwd_shared")
    return lam, None


# ---------------------------------------------------------------------------
# differentiable objective
# ---------------------------------------------------------------------------


class FusedObjectiveShared(torch.autograd.Function):
    """-J with J = dt * sum_{n=0..N} sum_j w_j u_n,j^2 under
    u' = B (lin u + c2 u^2 + c3 u^3); differentiable in u0, w and (with
    op_grads=True, plain path only) B.

    apply(b, w, u0, c2, c3, lin, dt, n_steps, op_grads=False)

    The forward stores the trajectory only when a gradient is wanted (the
    primal-only path runs trajectory-free, like `store_traj=False` in the
    JAX primal); the backward runs the reverse-sweep kernel.
    """

    @staticmethod
    def forward(ctx, b, w, u0, c2, c3, lin, dt, n_steps, op_grads=False):
        need_traj = any(ctx.needs_input_grad[:3])
        uT, jsum, traj = fused_fwd_shared(b, w, u0, c2, c3, lin, n_steps,
                                          store_traj=need_traj)
        if need_traj:
            ctx.save_for_backward(b, w, uT, traj)
        ctx.consts = (c2, c3, lin, dt, n_steps, op_grads)
        return -dt * jsum

    @staticmethod
    def backward(ctx, gbar):
        b, w, uT, traj = ctx.saved_tensors
        c2, c3, lin, dt, n_steps, op_grads = ctx.consts
        want_db = ctx.needs_input_grad[0] and op_grads
        # scale folds the cost-term derivative and the incoming cotangent
        # in the working dtype (JAX: jnp.float32(-2.0 * dt) * gbar)
        scale = torch.tensor(-2.0 * dt, dtype=uT.dtype, device=uT.device) * gbar
        lam, db = fused_bwd_shared(b, w, uT, traj, c2, c3, lin, scale,
                                   n_steps, op_grads=want_db)
        dw = None
        if ctx.needs_input_grad[1]:
            # dJ/dw_j = -dt * sum_n u_n,j^2
            dw = gbar * (-dt) * (torch.sum(traj * traj, dim=0) + uT * uT)
        return db, dw, lam, None, None, None, None, None, None
