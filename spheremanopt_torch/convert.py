"""Carry data between the JAX package and the port.

Neither side imports the other: data crosses as numpy arrays.

  * `sh23_operators(problem)`: the SH23 step operators `_M`, `_P` of
    either package's `SwiftHohenberg` (matmul/pallas/cuda methods) and
    the f32 kernel operands `b32`, `w32`, `p32` exactly as the JAX
    package's pallas path forms them — all numpy.
  * `shb23_operators(problem)`: the SHB23 propagators `A_lin`, `A_nl`,
    the weights `w` and the f32 kernel operands `a32`, `b32`, `w32` of
    either package's `SwiftHohenbergBounded`, as the JAX pallas path
    forms them — all numpy.
  * `kdyn_operators(problem)`: the constant pack of either package's
    `KinematicDynamo` (per-axis DFT matrices `Ff`, `Fz`, `Bf`, `Bz`,
    wavenumbers `k`, `inv_k2`, the CNAB1 factors `lhs_inv`, `rhs_fac`,
    the band mask `keep` and the Parseval weights `pw`) — all numpy;
    what `ops/cuda/kdyn_step.make_consts` reads.
  * `mixing_operators(problem)`: the per-kx tau solve stacks of either
    package's `OptimalMixing`: `S`, `MN`, and `SA` under
    adjoint="continuous" (exact f64 complex, full (kxn, m, m) form) — all
    numpy; what the port's `OptimalMixing(operators=...)` takes.
  * `operators_to_torch(ops, device, dtype)`: those arrays as tensors
    on `device`.
  * `state_to_torch(xs, device, dtype)` / `state_to_numpy`: state lists
    in either direction: one array per sphere, 1-D for SH23, SHB23 and
    PCA, a pair of (3, mg, mg, mg) fields for KDyn.

Nothing lands on a device unasked: every converter to tensors takes
the device explicitly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def sh23_operators(problem) -> Dict[str, np.ndarray]:
    """The SH23 operators of a `SwiftHohenberg` of either package."""
    if problem._M is None:
        raise ValueError("the problem has no step matrix (method='fft')")
    M, P = np.asarray(problem._M), np.asarray(problem._P)
    mg = M.shape[0]
    return {"M": M, "P": P, "b32": M.astype(np.float32),
            "w32": np.full(mg, 1.0 / mg, np.float32),
            "p32": P.astype(np.float32)}


def shb23_operators(problem) -> Dict[str, np.ndarray]:
    """The SHB23 operators of a `SwiftHohenbergBounded` of either package."""
    A_lin, A_nl = np.asarray(problem._A_lin), np.asarray(problem._A_nl)
    w = np.asarray(problem._w)
    return {"A_lin": A_lin, "A_nl": A_nl, "w": w,
            "a32": A_lin.astype(np.float32), "b32": A_nl.astype(np.float32),
            "w32": w.astype(np.float32)}


def kdyn_operators(problem) -> Dict[str, np.ndarray]:
    """The constant pack of a `KinematicDynamo` of either package."""
    names = ("Ff", "Fz", "Bf", "Bz", "k", "inv_k2", "lhs_inv", "rhs_fac",
             "keep", "pw")
    return {name: np.asarray(getattr(problem, "_" + name)) for name in names}


def mixing_operators(problem) -> Dict[str, np.ndarray]:
    """The solve stacks of an `OptimalMixing` of either package."""
    out = {"S": np.asarray(problem._S_np), "MN": np.asarray(problem._MN_np)}
    if problem.cfg.adjoint == "continuous":
        out["SA"] = np.asarray(
            problem._build_operators(adjoint=True, build_mixnorm=False)[0])
    return out


def operators_to_torch(ops: Dict[str, np.ndarray], device,
                       dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """numpy operators -> tensors on `device`; `dtype` None keeps each
    array's own dtype."""
    return {k: torch.as_tensor(v, device=device, dtype=dtype)
            for k, v in ops.items()}


def state_to_torch(xs: Sequence, device,
                   dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """State arrays (any shape, one per sphere) -> tensors on `device`."""
    # np.array copies: JAX hands out read-only buffers
    return [torch.as_tensor(np.array(x), device=device, dtype=dtype)
            for x in xs]


def state_to_numpy(xs: Sequence[torch.Tensor]) -> List[np.ndarray]:
    return [x.detach().cpu().numpy() for x in xs]
