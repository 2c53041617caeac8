"""Time-stepping helpers: Kahan accumulation, the strided energy scan and
the trajectory-memory policies of a reverse sweep (PyTorch port of the
JAX package's `solvers/scan_utils.py`).

A "scan" here is a Python loop over steps, differentiated by autograd.
Three memory policies for the reverse sweep of a long solve:

  * per-step `torch.utils.checkpoint` (the problems' "step" remat): one
    stored carry per step on the device, each step's internals recomputed;
  * `nested_checkpoint_scan`: sqrt(N) two-level checkpointing, O(sqrt N)
    stored carries and one extra recompute of each chunk;
  * `offload_checkpoint`: per-step remat whose stored carry lives in
    pinned host memory, so the device holds O(1) state in N.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


def strided_steps(n_steps: int, stride: int) -> np.ndarray:
    """Step indices of a strided energy series: every chunk start plus
    the final step (which is also the start index of a short final
    chunk's energy when stride does not divide n_steps — there the
    series carries BOTH that chunk start and step n)."""
    steps = np.arange(0, n_steps + 1, stride)
    if n_steps % stride:
        steps = np.append(steps, n_steps)
    return steps


def strided_energy_scan(step: Callable, energy: Callable, s0, n_steps: int,
                        stride: int, dtype, dt: float):
    """Integrate `n_steps` of `step` while Kahan-accumulating the
    time-integrated energy cost and recording the energy every `stride`
    steps: the fused 'scalar_data'-riding-the-forward-solve capture
    shared by SH23 and SHB23.

    Each step runs the same operations in the same order as the plain
    integration (energy, Kahan add, step), so J is bitwise the plain
    one for any stride. `stride` need not divide `n_steps`: a short
    final chunk records its start energy too, so the series steps are
    `strided_steps(n_steps, stride)` and the final-step energy is last.
    Returns (final_state, dt * integrated_energy, series)."""
    s = s0
    acc = kahan_zero(dtype, s0.device)
    series = []
    for n in range(n_steps):
        e = energy(s)
        acc = kahan_add(acc, e)
        if n % stride == 0:
            series.append(e)
        s = step(s)
    eN = energy(s)
    acc = kahan_add(acc, eN)
    series.append(eN)
    return s, dt * acc[0], torch.stack(series)


def _remat(fn, *args):
    """`fn(*args)`, checkpointed when autograd records (the arithmetic is
    the same either way)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def nested_checkpoint_scan(step: Callable, carry, length: int,
                           inner: Optional[int] = None,
                           return_series: bool = False):
    """Two-level checkpointed loop of `length` steps.

    `step(carry) -> (carry, y)`, y a tensor (a scalar in the problems)
    that is summed over the steps. The steps run in chunks of `inner`
    (default int(sqrt(length))): each chunk is checkpointed, and each step
    inside it is checkpointed too, so the reverse sweep stores one carry
    per chunk and, while it recomputes a chunk, one per step of that
    chunk; the `length % inner` remainder steps are checkpointed one at a
    time. The sum is formed per chunk, then across chunks, then the
    remainder steps are added one by one (the JAX package's order; not
    Kahan). Returns (final_carry, summed_y), or with `return_series`
    (final_carry, summed_y, per-step ys in step order)."""
    if inner is None:
        inner = max(1, int(length ** 0.5))
    outer, rem = divmod(length, inner)

    def chunk(c):
        ys = []
        for _ in range(inner):
            c, y = _remat(step, c)
            ys.append(y)
        ys = torch.stack(ys)
        return c, ys.sum(0), ys

    tots, series = [], []
    for _ in range(outer):
        carry, tot, ys = _remat(chunk, carry)
        tots.append(tot)
        series.append(ys)
    total = torch.stack(tots).sum(0) if tots else None
    rem_ys = []
    for _ in range(rem):
        carry, y = _remat(step, carry)
        total = y if total is None else total + y
        rem_ys.append(y)
    if not return_series:
        return carry, total
    if rem_ys:
        series.append(torch.stack(rem_ys))
    return carry, total, torch.cat(series)


def host_copy(carry):
    """A copy of `carry` in host memory (pinned when it is on a CUDA device;
    a failed pinning raises), differentiable in `carry`, laid out with its
    strides: a reduction over a copy laid out otherwise may sum in another
    order."""
    try:
        host = torch.empty_strided(carry.shape, carry.stride(), dtype=carry.dtype,
                                   pin_memory=carry.is_cuda)
    except RuntimeError as e:
        raise RuntimeError(
            "remat offload: allocating pinned host memory for a step's "
            f"carry failed ({e}); there is no fallback to per-step "
            "device remat") from e
    host.copy_(carry, non_blocking=True)   # differentiable in carry
    return host


def checkpoint_on_host(fn: Callable, host, device, *rest):
    """`fn(host brought to `device`, *rest)`, checkpointed on the host copy:
    its reverse recomputes `fn` from that copy."""
    def on_device(h, *r):
        return fn(h.to(device, non_blocking=True), *r)

    return checkpoint(on_device, host, *rest, use_reentrant=False,
                      preserve_rng_state=False)


def offload_checkpoint(step: Callable) -> Callable:
    """`step(carry, *rest)` as per-step remat whose stored carry lives in
    host memory (`host_copy`; on the CPU a plain copy), and the step is
    checkpointed on that host copy, which it brings back to the device when
    it runs. So the reverse sweep recomputes each step from its host copy
    and the device holds O(1) state in the trajectory length, at the price
    of the host link's bandwidth every step. The checkpoint is the "step"
    mode's (the same graph around the step), so the gradients are bitwise
    step remat's; the cotangent of the carry crosses the link back.
    Without autograd recording, the step runs as it is. A caller that
    applies two functions to one carry shares one `host_copy` between them
    (`checkpoint_on_host`), so that the carry's two cotangents meet in
    host memory."""

    def wrapped(carry, *rest):
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in (carry,) + rest)):
            return step(carry, *rest)
        return checkpoint_on_host(step, host_copy(carry), carry.device, *rest)

    return wrapped


def kahan_add(acc: Tuple[torch.Tensor, torch.Tensor], value):
    """Compensated (Kahan) accumulation step: acc = (sum, compensation).

    Keeps cost integrals accurate over thousands of f32 steps.
    """
    s, comp = acc
    y = value - comp
    t = s + y
    comp = (t - s) - y
    return (t, comp)


def kahan_zero(dtype, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    z = torch.zeros((), dtype=dtype, device=device)
    return (z, z)
