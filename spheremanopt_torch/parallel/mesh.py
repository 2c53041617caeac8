"""Process meshes on `torch.distributed` (PyTorch port of the JAX
package's `parallel/mesh.py`): the counterpart of the reference's
`MPI.COMM_WORLD` domain decomposition.

One process drives one device: NCCL on GPUs, gloo on CPUs. A sharded run
is launched with `torchrun` (`RANK`, `WORLD_SIZE`, `LOCAL_RANK` in the
environment); without it `init_distributed` makes a one-rank group. A
mesh spans the whole group: one asked for with more devices than the
group has raises, and none is ever built smaller than asked.

Placements are DTensor placements: `field_sharding(mesh, ndim, dim)`
shards one spatial dimension of a field over the mesh axis `axis`,
`replicated(mesh)` keeps a tensor whole on every rank, and
`shard_fields` turns full arrays into DTensors of those placements (each
rank keeps its slice; nothing is sent).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor


def init_distributed(device="cuda") -> torch.device:
    """Initialise the default process group once and return this rank's
    device: from the `torchrun` environment when it is set, otherwise as
    a one-rank group. Rank r of a CUDA run is bound to `cuda:LOCAL_RANK`."""
    device = torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA GPU found (use a "
                               "CPU device for a gloo group)")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    device_id=device if device.type == "cuda" else None)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    return device


def _world(what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what}: no process group (call "
                           "parallel.mesh.init_distributed first)")
    return dist.get_world_size()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis: str = "x") -> DeviceMesh:
    """1-D mesh over the group's ranks."""
    world = _world("make_mesh")
    n = n_devices or world
    if n > world:
        # fail loudly: a smaller mesh would run a different decomposition
        # than the one configured (or die later in an opaque all_to_all
        # divisibility error)
        raise ValueError(
            f"requested a {n}-device mesh but only {world} device(s) "
            f"are visible (platform={_device_type()}); set n_shards to "
            "a value <= the visible device count, or launch more "
            "processes (torchrun --nproc-per-node)")
    if n < world:
        raise ValueError(
            f"requested a {n}-device mesh in a group of {world} processes; "
            "every process of the group must be in the mesh (launch "
            f"{n} processes)")
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(axis,))


def make_mesh2d(px: int, py: int, axes=("x", "y")) -> DeviceMesh:
    """2-D process mesh for pencil decompositions
    (`parallel.fft.distributed_rfftn_2d`)."""
    world = _world("make_mesh2d")
    n = px * py
    if n > world:
        raise ValueError(
            f"requested a {px}x{py} mesh but only {world} device(s) "
            "are visible")
    if n < world:
        raise ValueError(
            f"requested a {px}x{py} mesh in a group of {world} processes; "
            "every process of the group must be in the mesh")
    return init_device_mesh(_device_type(), (px, py), mesh_dim_names=tuple(axes))


def field_sharding(mesh: DeviceMesh, ndim: int, sharded_dim: int,
                   axis: str = "x") -> tuple:
    """Placements sharding one dimension of an ndim field over the mesh
    axis `axis` (replicated over the mesh's other axes)."""
    if not -ndim <= sharded_dim < ndim:
        raise ValueError(f"sharded_dim {sharded_dim} out of range for ndim {ndim}")
    return tuple(Shard(sharded_dim % ndim) if name == axis else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    return (Replicate(),) * mesh.ndim


def shard_fields(mesh: DeviceMesh, xs: Sequence, sharded_dim: int, axis: str = "x"):
    """DTensors of full field arrays with one spatial dim sharded; every
    rank passes the same arrays and keeps its slice."""
    out = []
    for x in xs:
        t = torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                            device=mesh.device_type)
        out.append(distribute_tensor(t, mesh, field_sharding(mesh, t.dim(), sharded_dim, axis),
                                     src_data_rank=None))
    return out
