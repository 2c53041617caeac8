"""Distributed 3-D real FFTs over a process mesh, slab and pencil
(PyTorch port of the JAX package's `parallel/fft.py`).

The explicit-collective form of what Dedalus does with MPI all-to-all
transposes between grid and coefficient layouts. Each function runs on
every rank of the mesh with that rank's local shard (the counterpart of
the JAX package's `shard_map` bodies) and returns that rank's shard of
the result. For a real field sharded over its first grid axis X (slab):

  1. local rfft over Z, fft over Y             (X/P, Y, Zr)
  2. all_to_all transpose: split Y, gather X    -> (X, Y/P, Zr)
  3. local fft over X

so every FFT is a dense local transform and the only communication is
one all_to_all per direction. The inverse reverses the pipeline. Nothing
gathers the whole field. The transposes are autograd Functions (the
functional collectives' `all_to_all_single` with its reverse transpose
as backward), so the transforms sit inside differentiated solves.
Complex tensors cross the wire as their real views.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed import _functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh


def _wait(t):
    return funcol.wait_tensor(t) if isinstance(t, funcol.AsyncCollectiveTensor) else t


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Tiled all_to_all over `group` (`lax.all_to_all(..., tiled=True)`):
    split `x` into P equal chunks along `split_dim`, send chunk j to the
    group's rank j, and concatenate the chunks received along
    `concat_dim` in rank order. Differentiable. A one-rank group runs the
    collective too, so it drives the same path as P ranks."""
    p = dist.get_world_size(group)
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    if x.shape[split_dim] % p:
        raise ValueError(f"all_to_all: extent {x.shape[split_dim]} of dim "
                         f"{split_dim} is not divisible by {p} ranks")
    cplx = x.is_complex()
    y = torch.view_as_real(x) if cplx else x
    # chunk j of split_dim to the front, contiguous: (P, ...) for rank j
    shp = list(y.shape)
    y = y.reshape(shp[:split_dim] + [p, shp[split_dim] // p] + shp[split_dim + 1:])
    y = y.movedim(split_dim, 0).contiguous()
    buf = _wait(funcol.all_to_all_single_autograd(y, None, None, group))
    # buf[j] came from rank j: block j of concat_dim
    out = torch.cat(buf.unbind(0), dim=concat_dim)
    return torch.view_as_complex(out) if cplx else out


def _check_3d(v: torch.Tensor, what: str):
    if v.dim() < 3:
        raise ValueError(f"{what}: needs a (..., X, Y, Z) field, got shape "
                         f"{tuple(v.shape)}")


def distributed_rfftn(v: torch.Tensor, mesh: DeviceMesh, axis: str = "x") -> torch.Tensor:
    """rfftn of a real (..., X, Y, Z) field sharded over X (this rank's
    (..., X/P, Y, Z) shard); returns this rank's shard of the
    coefficients (..., X, Y, Z//2+1), sharded over Y: (..., X, Y/P, Zr)."""
    _check_3d(v, "distributed_rfftn")
    g = mesh.get_group(axis)
    c = torch.fft.rfft(v, dim=-1)
    c = torch.fft.fft(c, dim=-2)
    # (X/P, Y, Zr) -> (X, Y/P, Zr)
    c = all_to_all(c, g, split_dim=-2, concat_dim=-3)
    return torch.fft.fft(c, dim=-3)


def distributed_irfftn(c: torch.Tensor, mesh: DeviceMesh, n_z: int,
                       axis: str = "x") -> torch.Tensor:
    """Inverse of distributed_rfftn: this rank's coefficient shard
    (..., X, Y/P, Zr) -> its real grid shard (..., X/P, Y, Z)."""
    _check_3d(c, "distributed_irfftn")
    g = mesh.get_group(axis)
    d = torch.fft.ifft(c, dim=-3)
    # (X, Y/P, Zr) -> (X/P, Y, Zr)
    d = all_to_all(d, g, split_dim=-3, concat_dim=-2)
    d = torch.fft.ifft(d, dim=-2)
    return torch.fft.irfft(d, n=n_z, dim=-1)


def _pencil_check(x_extent: int, y_extent: int, mesh: DeviceMesh, axes):
    px, py = (mesh.size(mesh.mesh_dim_names.index(a)) for a in axes)
    if x_extent % (px * py) or y_extent % (px * py):
        raise ValueError(
            f"2-D pencil decomposition needs X ({x_extent}) and Y ({y_extent}) "
            f"divisible by Px*Py = {px * py} (mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))})")
    return px, py


def distributed_rfftn_2d(v: torch.Tensor, mesh: DeviceMesh,
                         axes=("x", "y")) -> torch.Tensor:
    """rfftn of a real (..., X, Y, Z) field sharded over a 2-D process
    mesh (X over axes[0], Y over axes[1]): this rank's (..., X/Px, Y/Py,
    Z) shard -> its coefficient shard (..., X, Y/(Px Py), Zr), Y sharded
    jointly (axes[1] major, axes[0] minor). Z is never sharded, so the
    half spectrum's (Z/2+1) extent never has to divide a mesh axis; the X
    and Y extents must divide Px*Py.

    Three per-axis transposes, each within a smaller process group than
    the slab's:

        (X/Px, Y/Py, Z)   --rfft Z-->  (X/Px, Y/Py, Zr)
        --T1 over axes[1]: split X, gather Y-->  (X/(PxPy), Y, Zr) fft Y
        --T2 over axes[1]: split Y, gather X-->  (X/Px, Y/Py, Zr)
        --T3 over axes[0]: split Y, gather X-->  (X, Y/(PxPy), Zr) fft X
    """
    _check_3d(v, "distributed_rfftn_2d")
    ax, ay = axes
    px, py = _pencil_check(v.shape[-3] * mesh.size(mesh.mesh_dim_names.index(ax)),
                           v.shape[-2] * mesh.size(mesh.mesh_dim_names.index(ay)),
                           mesh, axes)
    gx, gy = mesh.get_group(ax), mesh.get_group(ay)
    c = torch.fft.rfft(v, dim=-1)
    c = all_to_all(c, gy, split_dim=-3, concat_dim=-2)
    c = torch.fft.fft(c, dim=-2)
    c = all_to_all(c, gy, split_dim=-2, concat_dim=-3)
    c = all_to_all(c, gx, split_dim=-2, concat_dim=-3)
    return torch.fft.fft(c, dim=-3)


def distributed_irfftn_2d(c: torch.Tensor, mesh: DeviceMesh, n_z: int,
                          axes=("x", "y")) -> torch.Tensor:
    """Inverse of `distributed_rfftn_2d`: this rank's coefficient shard
    (..., X, Y/(Px Py), Zr) -> its grid shard (..., X/Px, Y/Py, Z). Each
    transpose inverts its forward counterpart, in reverse order."""
    _check_3d(c, "distributed_irfftn_2d")
    ax, ay = axes
    _pencil_check(c.shape[-3], c.shape[-2] * mesh.size(), mesh, axes)
    gx, gy = mesh.get_group(ax), mesh.get_group(ay)
    d = torch.fft.ifft(c, dim=-3)
    d = all_to_all(d, gx, split_dim=-3, concat_dim=-2)
    d = all_to_all(d, gy, split_dim=-3, concat_dim=-2)
    d = torch.fft.ifft(d, dim=-2)
    d = all_to_all(d, gy, split_dim=-2, concat_dim=-3)
    return torch.fft.irfft(d, n=n_z, dim=-1)


class _SumOverRanks(torch.autograd.Function):
    """The sum of a tensor over the group's ranks on every rank. Every
    rank then holds the same global value (a loss all ranks share), so a
    rank's backward passes the cotangent through to its own term."""

    @staticmethod
    def forward(ctx, x, group):
        return _wait(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum over the ranks of `group` (default: all)."""
    return _SumOverRanks.apply(x, group if group is not None else dist.group.WORLD)


def max_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """Maximum over the ranks (no gradient: diagnostics)."""
    return _wait(funcol.all_reduce(x.detach(), "max",
                                   group if group is not None else dist.group.WORLD))


def distributed_mean_product(x: torch.Tensor, y: torch.Tensor, mesh: DeviceMesh,
                             axis: str = "x") -> torch.Tensor:
    """(1/N) sum(x*y) over fields sharded on their first spatial axis
    (this rank's shards), summed over the mesh axis's ranks: the volume
    average inner product of the reference's `allreduce(SUM)`
    (`FWD_Solve_Poiseuille.py:297`)."""
    g = mesh.get_group(axis)
    total = sum_over_ranks(torch.sum(x * y), g)
    n = x.shape[-3] * dist.get_world_size(g) * x.shape[-2] * x.shape[-1]
    return total / n
