"""Profiling utilities: torch.profiler traces, solve timing, cost models
and rooflines against the H100's peaks (PyTorch port of the JAX
package's `utils/profiling.py`).

  * `trace(dir)`         — context manager writing a Chrome trace (CPU and
    CUDA activities) of everything inside it into `dir`
  * `time_solve(fn, *a)` — first-call-then-steady timing of a solve,
    returning (first_call_s, steady_ms, result)
  * the four cost models — analytic (flops, bytes) of one fused
    forward+gradient of each PDE problem; pure counting, the JAX
    package's numbers for the same arguments
  * `roofline(ms, flops, bytes)` and `bound_ms(flops, bytes, peak)` —
    achieved rates against the H100 SXM data-sheet peaks, and the least
    time the card could take for the same work
  * `card_name()`        — the card's name and power limit, as nvidia-smi
    gives them, to print beside every time
  * `gpu_ms(fn, reps)`   — mean CUDA-event ms per call of `fn`
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Callable

import torch

# H100 SXM data-sheet peaks: dense f32 outside the tensor cores, dense
# TF32 on the tensor cores, HBM3 bytes per second
F32_PEAK = 67e12
TF32_PEAK = 495e12
HBM_RATE = 3.35e12


def card_name() -> str:
    """The first card's name and power limit, the line `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints (or why it
    could not be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def gpu_ms(fn: Callable, reps: int, warm: int = 2) -> float:
    """Mean ms per call of `fn` by CUDA events, after `warm` warm-up
    calls."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU, and CUDA where the card is
    there); the Chrome trace lands in `log_dir/trace.json`. Yields the
    profiler (its `key_averages()` holds the kernels' device times)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(result):
    """Wait for the card when `result` holds CUDA tensors (on the CPU an
    op has finished when it returns)."""
    stack = [result]
    while stack:
        r = stack.pop()
        if isinstance(r, torch.Tensor):
            if r.is_cuda:
                torch.cuda.synchronize(r.device)
                return
        elif isinstance(r, (list, tuple)):
            stack.extend(r)
        elif isinstance(r, dict):
            stack.extend(r.values())


def time_solve(fn: Callable, *args, repeats: int = 10):
    """(first_call_seconds, steady_milliseconds, last_result): the first
    call (allocations, kernel loads, cuBLAS set-up), then the best of
    `repeats` calls, each waited for on the card."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn(*args)
    _sync(r)
    first_s = time.perf_counter() - t0

    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        r = fn(*args)
        _sync(r)
        best = min(best, time.perf_counter() - t0)
    return first_s, best * 1e3, r


def matmul_step_flops(n: int, steps: int, batch: int = 1, complex_ops: bool = False) -> float:
    """FLOPs of `steps` dense NxN matvec steps (x4 for complex)."""
    per = 2.0 * n * n * batch
    if complex_ops:
        per *= 4.0
    return per * steps


def passes_for(mode: str) -> int:
    """Products per multiply for the port's precision modes: plain f32 and
    f64 run one; the `op_grads` product's 3xTF32 runs three TF32 products
    (hi*hi + hi*lo + lo*hi). The JAX package's TPU pass-count modes have
    no counterpart here and raise."""
    passes = {"float32": 1, "float64": 1, "3xtf32": 3}
    if mode not in passes:
        raise ValueError(f"passes_for: no port mode {mode!r} (one of {sorted(passes)})")
    return passes[mode]


def bound_ms(flops: float, nbytes: float, peak: float = F32_PEAK):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of `nbytes` over the HBM rate and `flops` over `peak`."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def roofline(ms: float, flops: float, hbm_bytes: float, peak: float = F32_PEAK) -> dict:
    """Achieved rates of one fused fwd+grad of `ms` milliseconds against
    the card's peaks. `flops` counts the products executed (multi-product
    modes multiplied in by the caller, `passes_for`); `hbm_bytes` is the
    modelled least traffic, so the achieved byte rate is a lower bound."""
    s = ms / 1e3
    return {
        "model_gflops": round(flops / 1e9, 1),
        "model_hbm_gb": round(hbm_bytes / 1e9, 3),
        "achieved_gflops_per_s": round(flops / s / 1e9, 1),
        "achieved_hbm_gbps": round(hbm_bytes / s / 1e9, 1),
        "pct_peak_flops": round(100.0 * flops / s / peak, 2),
        "pct_peak_hbm": round(100.0 * hbm_bytes / s / HBM_RATE, 1),
    }


def sh23_cost_model(npts: int, n_steps: int, pad: float = 2.0,
                    bytes_per: int = 4, passes: int = 1):
    """(flops, hbm_bytes) of a fused fwd+grad: per step one (mg x mg)
    real matvec forward and its transpose in the reverse sweep; the step
    matrix streams from HBM both ways; residual vectors stored and
    reloaded once."""
    mg = int(round(npts * pad))
    flops = 2.0 * (2.0 * mg * mg) * n_steps * passes
    op_bytes = 2.0 * mg * mg * bytes_per * n_steps
    res_bytes = 2.0 * mg * bytes_per * n_steps
    return flops, op_bytes + res_bytes


def shb23_cost_model(n_eff: int, n_steps: int, bytes_per: int = 4,
                     passes: int = 1):
    """Like sh23 but the SBDF1 step applies TWO dense (n x n) grid-space
    propagators (A_lin, A_nl) and the reverse sweep both transposes."""
    flops = 2.0 * 2.0 * (2.0 * n_eff * n_eff) * n_steps * passes
    op_bytes = 4.0 * n_eff * n_eff * bytes_per * n_steps
    res_bytes = 2.0 * n_eff * bytes_per * n_steps
    return flops, op_bytes + res_bytes


def kdyn_cost_model(npts: int, n_steps: int, pad: float = 1.5,
                    bytes_per: int = 4, passes: int = 1):
    """Dominant terms of the CNAB1 induction step: six per-axis complex
    DFT contractions (3 inverse to the padded grid, 3 forward back) over
    the 3-component field, forward, recompute and reverse sweep (3x);
    traffic ~10 (3, mg, mg, mg) field intermediates a step each way."""
    mg = int(round(npts * pad))
    n = npts
    nzr = n // 2 + 1
    # inverse transforms (coeff -> grid), complex x complex = 8 real flops
    inv = 8.0 * 3.0 * (mg * n * n * nzr + mg * mg * n * nzr
                       + mg * mg * mg * nzr)
    per_step = 2.0 * inv   # the forward transforms mirror the shapes
    flops = 3.0 * per_step * n_steps * passes
    field_bytes = 3.0 * mg * mg * mg * bytes_per
    hbm = 3.0 * 10.0 * field_bytes * n_steps
    return flops, hbm


def mixing_cost_model(nx: int, nz: int, n_steps: int, bytes_per: int = 4,
                      passes: int = 1, blocked: bool = True):
    """Dominant term: the batched per-kx tau solve, (kxn, 3nz x 3nz)
    complex applied as real-plane products (4 real products of h x h per
    kx in the blocked two-family form); the operator stacks stream once a
    step each way (an upper-bound traffic model)."""
    kxn = nx // 2 + 1
    m = 3 * nz
    h = m // 2 if blocked else m
    fam = 2 if blocked else 1
    per_step = fam * 2.0 * (2.0 * h * h * 2.0) * kxn
    flops = 3.0 * per_step * n_steps * passes   # fwd + recompute + reverse
    op_bytes = fam * 2.0 * h * h * bytes_per * kxn
    hbm = 2.0 * op_bytes * n_steps
    return flops, hbm
