"""Kahan accumulation and strided-step helpers (the subset of
the JAX package's `solvers/scan_utils.py` that the SH23 path uses)."""

from __future__ import annotations

from typing import Tuple

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
