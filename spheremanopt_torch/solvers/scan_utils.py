"""Kahan accumulation and the strided energy scan (the subset of
the JAX package's `solvers/scan_utils.py` that the SH23 and SHB23 paths
use)."""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


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
