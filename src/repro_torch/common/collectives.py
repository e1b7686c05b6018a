"""The ``shard_map`` collectives of the JAX package, over the named axes of a
``torch.distributed`` ``DeviceMesh`` (``("pod", "data", "model")`` or a
subset).  Each runs inside the caller's rank on its own blocks; an axis the
mesh lacks has size 1 and index 0 and moves nothing, as in a JAX mesh
without it.

``all_gather`` uses the list form, which gloo and NCCL both support; the
group's rank order is the axis' coordinate order, so a tiled gather
concatenates the blocks as ``jax.lax.all_gather(..., tiled=True)`` does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    names = axis_names(mesh)
    return int(mesh.shape[names.index(name)]) if name in names else 1


def axis_index(mesh, name: str) -> int:
    names = axis_names(mesh)
    return int(mesh.get_coordinate()[names.index(name)]) if name in names else 0


def all_gather(x: torch.Tensor, mesh, name: str, dim: int = 0) -> torch.Tensor:
    """The blocks of every rank along axis ``name``, concatenated on ``dim``."""
    if name not in axis_names(mesh):
        return x
    group = mesh.get_group(name)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def psum(x: torch.Tensor, mesh, names) -> torch.Tensor:
    """The sum over the ranks of every axis in ``names`` (one all-reduce an
    axis), as a new tensor."""
    x = x.clone()
    for name in (names,) if isinstance(names, str) else names:
        if name in axis_names(mesh):
            dist.all_reduce(x, group=mesh.get_group(name))
    return x
