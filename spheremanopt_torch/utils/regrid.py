"""Spectral resolution continuation for optimisation states.

Port of the JAX package's `utils/regrid.py`. A state from a coarser (or
finer) study of the same problem family is re-expressed on a target
problem's grid: spectral coefficients at the source resolution, the mode
set zero-padded (or truncated), synthesis on the target grid, and a
renormalisation onto the spheres. Every state the optimiser produces is
band-limited (filtered initial conditions, truncated gradients, linear
steps), so upsampling keeps the represented function to machine
precision.

It serves coarse-to-fine warm starts (`--resume <file> --regrid`): the
reference restarts only at the same resolution (`DAL_PROGRESS.h5` stores
flat vectors whose length must match the domain,
`FWD_Solve_SH23.py:787-800`).

Everything here is host numpy in f64, once per study; the states come
back as numpy arrays in the problem's dtype.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from spheremanopt_torch.io.checkpoint import to_numpy
from spheremanopt_torch.ops.chebyshev import ChebyshevBasis1D


def _fourier_resample(u: np.ndarray, dst_sizes: tuple) -> np.ndarray:
    """Resample the trailing len(dst_sizes) periodic axes of a real field
    by rfftn zero-padding / truncation (function values kept). On the
    full-spectrum axes the smaller grid's Nyquist mode is dropped (no
    Hermitian partner; every problem keeps |k| strictly below it)."""
    u = np.asarray(u, np.float64)
    nd = len(dst_sizes)
    axes = tuple(range(u.ndim - nd, u.ndim))
    src_sizes = [u.shape[a] for a in axes]
    c = np.fft.rfftn(u, axes=axes) / float(np.prod(src_sizes))

    out_shape = (list(u.shape[: u.ndim - nd])
                 + list(dst_sizes[:-1]) + [dst_sizes[-1] // 2 + 1])
    out = np.zeros(out_shape, np.complex128)

    # per full axis: positive block [0 : p+1], negative block [-p :]
    blocks = []
    for ns, ndst in zip(src_sizes[:-1], dst_sizes[:-1]):
        m = min(ns, ndst)
        p = (m - 1) // 2
        ax_blocks = [(slice(0, p + 1), slice(0, p + 1))]
        if p > 0:
            ax_blocks.append((slice(ns - p, ns), slice(ndst - p, ndst)))
        blocks.append(ax_blocks)
    rmin = min(src_sizes[-1] // 2 + 1, dst_sizes[-1] // 2 + 1)
    lead = (slice(None),) * (u.ndim - nd)
    for combo in itertools.product(*blocks) if blocks else [()]:
        src_ix = lead + tuple(s for s, _ in combo) + (slice(0, rmin),)
        dst_ix = lead + tuple(d for _, d in combo) + (slice(0, rmin),)
        out[dst_ix] = c[src_ix]

    return np.fft.irfftn(out * float(np.prod(dst_sizes)),
                         s=tuple(dst_sizes), axes=axes)


def _cheb_pad(c: np.ndarray, n_dst: int, axis: int = -1) -> np.ndarray:
    """Zero-pad / truncate a Chebyshev coefficient axis (T_n coefficients
    represent the same function on [z0, z1] whatever their count)."""
    n_src = c.shape[axis]
    if n_src == n_dst:
        return c
    m = min(n_src, n_dst)
    pad_shape = list(c.shape)
    pad_shape[axis] = n_dst
    out = np.zeros(pad_shape, c.dtype)
    sl_src = [slice(None)] * c.ndim
    sl_dst = [slice(None)] * c.ndim
    sl_src[axis] = slice(0, m)
    sl_dst[axis] = slice(0, m)
    out[tuple(sl_dst)] = c[tuple(sl_src)]
    return out


def _renormalise(problem, xs):
    # the inner product of full fields (a distributed KDyn's own takes
    # its rank's shards)
    ip = getattr(problem, "full_inner_product", problem.inner_product)
    out = []
    for x, r in zip(xs, problem.radii):
        t = torch.as_tensor(x, device=problem.device)
        n = float(ip(t, t))
        out.append(x * np.sqrt(r / n))
    return out


def expected_state_shapes(problem):
    """The state components' shapes for `problem` (the layout
    `generate_ic` produces and the solvers take), or None for problems
    without a fixed grid (PCA)."""
    kind = type(problem).__name__
    if kind == "SwiftHohenberg":
        return [(problem.basis.n_grid,)]
    if kind == "SwiftHohenbergBounded":
        return [(problem.cfg.npts,)]
    if kind == "KinematicDynamo":
        return [(3, problem.mg, problem.mg, problem.mg)] * 2
    if kind == "OptimalMixing":
        return [(2, problem.mgx, problem.mgz)]
    return None


def reshape_flat_state(problem, x_list):
    """Loaded states in `problem`'s layout. A reference `DAL_PROGRESS.h5`
    stores each component as a flat Dedalus vector (`Field_to_Vec`
    flattens each field in C order and concatenates them: the byte order
    of these channel-major states), so a flat component of the right
    size is reshaped. Shaped components pass through (another
    resolution's shapes are `--regrid` sources). A flat component at
    another resolution is shaped where the grid is unambiguous (KDyn's
    3 mg^3 cube); anything else raises here rather than inside a
    solver."""
    exp = expected_state_shapes(problem)
    if exp is None:
        return [to_numpy(x) for x in x_list]
    if len(x_list) != len(exp):
        raise ValueError(
            f"state has {len(x_list)} components; "
            f"{type(problem).__name__} expects {len(exp)}")
    kind = type(problem).__name__
    out = []
    for i, (x, shp) in enumerate(zip(x_list, exp)):
        x = to_numpy(x)
        if x.shape == shp or x.ndim == len(shp):
            out.append(x)
            continue
        if x.ndim == 1 and x.size == int(np.prod(shp)):
            out.append(x.reshape(shp))
            continue
        if x.ndim == 1 and kind == "KinematicDynamo" and x.size % 3 == 0:
            mg = int(round((x.size / 3) ** (1.0 / 3.0)))
            if 3 * mg ** 3 == x.size:   # a flat cube at another mg: shape
                out.append(x.reshape(3, mg, mg, mg))   # it for --regrid
                continue
        raise ValueError(
            f"component {i}: loaded array of shape {x.shape} "
            f"({x.size} elements) does not match the expected state "
            f"shape {shp} ({int(np.prod(shp))} elements); for "
            "cross-resolution continuation save in the native .npz "
            "format (shapes preserved) and use --regrid")
    return out


def regrid_state(problem, x_list, renormalise: bool = True):
    """`x_list` (a state of a study of the same problem family at another
    resolution) on `problem`'s grid. The source resolution comes from the
    arrays' shapes, the target transforms from `problem`. Returns numpy
    arrays in the problem's dtype, on the spheres when `renormalise` (the
    optimiser normalises at entry anyway; this keeps direct evaluations
    on the spheres too)."""
    kind = type(problem).__name__
    cfg = getattr(problem, "cfg", None)
    x_list = [to_numpy(x) for x in x_list]

    if kind == "SwiftHohenberg":
        xs = [_fourier_resample(x_list[0], (problem.basis.n_grid,))]

    elif kind == "KinematicDynamo":
        # distributed targets too: the output is the full (c, mg, mg, mg)
        # grid layout (the optimiser's caller shards it, `shard_state`)
        xs = [_fourier_resample(x, (problem.mg,) * 3) for x in x_list]

    elif kind == "SwiftHohenbergBounded":
        u = np.asarray(x_list[0], np.float64)
        src_basis = ChebyshevBasis1D(u.shape[-1], cfg.z0, cfg.z1)
        c = src_basis.analysis @ u
        xs = [problem.basis.synthesis @ _cheb_pad(c, cfg.npts)]

    elif kind == "OptimalMixing":
        g = np.asarray(x_list[0], np.float64)          # (2, mgx_s, mgz_s)
        mgx_s, mgz_s = g.shape[-2:]
        nx_s = int(round(mgx_s / cfg.pad_factor))
        nz_s = int(round(mgz_s / cfg.pad_factor))
        kxn_s = nx_s // 2 + 1
        # the source analysis (exact f64, the problem's formulas)
        j = np.arange(mgx_s)
        kxi = np.arange(kxn_s)
        Fx_s = np.exp(-2j * np.pi * np.outer(kxi, j) / mgx_s) / mgx_s
        Az_s = ChebyshevBasis1D(mgz_s, -1.0, 1.0).analysis[:nz_s]
        xmask_s = np.ones(kxn_s)
        if nx_s % 2 == 0:
            xmask_s[-1] = 0.0
        c = np.einsum("kj,cjz->ckz", Fx_s, g)
        c = np.einsum("nz,ckz->ckn", Az_s, c) * xmask_s[None, :, None]
        # pad / truncate both mode axes into the target layout
        out = np.zeros((g.shape[0], problem.kxn, cfg.nz), np.complex128)
        km, nm = min(kxn_s, problem.kxn), min(nz_s, cfg.nz)
        out[:, :km, :nm] = c[:, :km, :nm]
        out *= np.asarray(problem._xmask)[None, :, None]
        # the target synthesis from the problem's exact f64 matrices
        gz = np.einsum("zn,ckn->ckz", problem._Vz64, out)
        xs = [np.einsum("jk,ckz->cjz", problem._Bx64, gz).real]

    else:
        raise ValueError(f"regrid_state: no rule for problem {kind!r}")

    xs = [np.asarray(x, np.dtype(cfg.dtype)) for x in xs]
    return _renormalise(problem, xs) if renormalise else xs
