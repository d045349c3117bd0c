"""Device meshes (port of ``imagecompression_adversarial_tpu/parallel/mesh.py``).

JAX's layer is one controller over a ``jax.sharding.Mesh``, where XLA
inserts the collectives.  Here every rank is a process of its own
(``parallel/launch.py::run_spmd``) and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named axes, each with its
own process group (``mesh.get_group("sp")``).  Placements are DTensor's
descriptors, one a mesh axis: ``Shard(0)`` splits the batch, ``Shard(2)``
the rows of an NCHW tensor, ``Replicate()`` keeps the whole tensor.  They
only describe where each rank's part sits (``local_part``); the layers
compute on plain local tensors (``ops/shard.py``).

Axes:
  dp — data parallel over images and batches;
  sp — the rows of one image (``parallel/spatial_shard.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..ops import shard

Placements = Tuple[object, ...]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("dp",),
    device_type: str = "cuda",
    shape: Optional[Sequence[int]] = None,
) -> DeviceMesh:
    """A mesh over the first ``n_devices`` ranks (all of them by default)
    with the named axes; axes after the first get size 1 unless ``shape``
    gives every axis's size.  Runs in every rank (``run_spmd``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs in the ranks of an initialized process group "
                           "(parallel/launch.py::run_spmd)")
    n = dist.get_world_size() if n_devices is None else n_devices
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not give {n} ranks "
                         f"over the axes {tuple(axis_names)}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_sharding(mesh: DeviceMesh, axis: str, dim: int) -> Placements:
    """Dimension ``dim`` split along ``axis``, whole along the other axes."""
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has no axis {axis!r}; its axes are {mesh.mesh_dim_names}")
    return tuple(Shard(dim) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def batch_sharding(mesh: DeviceMesh, axis: str = "dp") -> Placements:
    """The leading batch dimension split along ``axis``."""
    return axis_sharding(mesh, axis, 0)


def batch_row_sharding(mesh: DeviceMesh) -> Placements:
    """NCHW tensors with the batch split along ``dp`` and, where the mesh
    has ``sp``, the rows along ``sp`` (the dp x sp training step's input)."""
    dims = {"dp": 0, "sp": 2}
    return tuple(Shard(dims[n]) if n in dims else Replicate() for n in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> Placements:
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def local_part(mesh: DeviceMesh, t, placements: Placements):
    """This rank's block of the global array or tensor ``t`` under
    ``placements``: the rows (dim 2 of NCHW) split by
    ``ops/shard.py::row_blocks`` (even where they divide by the ranks x 64,
    else every rank but the last a multiple of 64 rows), any other
    dimension evenly."""
    index = [slice(None)] * t.ndim
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            size, rank = mesh.size(i), mesh.get_local_rank(i)
            n = t.shape[p.dim]
            if p.dim == 2:
                blocks = shard.row_blocks(n, size)
                start = sum(blocks[:rank])
                index[p.dim] = slice(start, start + blocks[rank])
                continue
            if n % size:
                raise ValueError(f"dim {p.dim} of size {n} does not split evenly over "
                                 f"{size} ranks of axis {mesh.mesh_dim_names[i]!r}")
            block = n // size
            index[p.dim] = slice(rank * block, (rank + 1) * block)
    return t[tuple(index)]


def shard_batch(mesh: DeviceMesh, batch, axis: str = "dp") -> torch.Tensor:
    """This rank's block of a host batch, on the rank's device."""
    part = local_part(mesh, batch, batch_sharding(mesh, axis))
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(mesh_device(mesh))


def _fingerprint(tensors) -> torch.Tensor:
    """Per tensor: its sum and its sum of squares, in float64."""
    rows = [torch.stack([t.double().sum(), (t.double() ** 2).sum()]) for t in tensors]
    return torch.stack(rows)


@torch.no_grad()
def replicate(mesh: DeviceMesh, model: torch.nn.Module) -> torch.nn.Module:
    """Broadcast every parameter and buffer of ``model`` from rank 0 to
    every rank (the mesh must span them all), in place, then check that
    every rank holds the same values (raises where one does not)."""
    world = dist.get_world_size()
    if mesh.size() != world:
        raise ValueError(f"replicate needs a mesh over all {world} ranks, not {mesh.size()}")
    named = list(model.named_parameters()) + list(model.named_buffers())
    for _, t in named:
        buf = t.detach().contiguous()
        dist.broadcast(buf, src=0)
        if buf.data_ptr() != t.data_ptr():
            t.copy_(buf)
    slots = shard.all_gather(_fingerprint([t for _, t in named]), None, world)
    differ = (slots != slots[0]).any(dim=2).any(dim=0)
    if bool(differ.any()):
        bad = [n for (n, _), d in zip(named, differ.tolist()) if d]
        raise RuntimeError(f"ranks hold different values after the broadcast: {bad[:5]}")
    return model
