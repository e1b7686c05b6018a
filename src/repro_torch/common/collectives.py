"""The ``shard_map`` collectives of the JAX package, over the named axes of a
``torch.distributed`` ``DeviceMesh`` (``("pod", "data", "model")`` or a
subset).  Each runs inside the caller's rank on its own blocks; an axis the
mesh lacks has size 1 and index 0 and moves nothing, as in a JAX mesh
without it.

``all_gather`` uses the list form, which gloo and NCCL both support; the
group's rank order is the axis' coordinate order, so a tiled gather
concatenates the blocks as ``jax.lax.all_gather(..., tiled=True)`` does.

Each collective is differentiable with its adjoint, so the gradient of the
sum of every rank's loss comes out on each rank for its own inputs:
``all_gather``'s backward is a reduce-scatter, ``psum``'s a ``psum``,
``psum_scatter``'s an ``all_gather``.  A reduce-scatter is one
``reduce_scatter_single`` (``reduce_scatter_tensor``) call, or an
all-reduce and a slice on gloo, which has no reduce-scatter.
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


def mesh_size(mesh) -> int:
    return int(mesh.size())


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over ``group`` of ``x``, this rank's block along ``dim``."""
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "gloo":
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x.chunk(n, dim)[dist.get_rank(group)].contiguous()
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n, *moved.shape[1:]))
    # reduce_scatter_single is the newer torch's name of reduce_scatter_tensor
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.group, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_gather(x: torch.Tensor, mesh, name: str, dim: int = 0) -> torch.Tensor:
    """The blocks of every rank along axis ``name``, concatenated on ``dim``."""
    if name not in axis_names(mesh):
        return x
    return _AllGather.apply(x, mesh.get_group(name), dim)


def psum(x: torch.Tensor, mesh, names) -> torch.Tensor:
    """The sum over the ranks of every axis in ``names`` (one all-reduce an
    axis), as a new tensor."""
    out = None
    for name in (names,) if isinstance(names, str) else names:
        if name in axis_names(mesh):
            out = _Psum.apply(x if out is None else out, mesh.get_group(name))
    return x.clone() if out is None else out


def psum_scatter(x: torch.Tensor, mesh, name: str, dim: int = 0) -> torch.Tensor:
    """``jax.lax.psum_scatter(..., tiled=True)``: the sum over axis ``name``,
    this rank's block of it along ``dim``."""
    if name not in axis_names(mesh):
        return x
    return _PsumScatter.apply(x, mesh.get_group(name), dim)


def pmax(x: torch.Tensor, mesh, names) -> torch.Tensor:
    """The elementwise max over the ranks of every axis in ``names`` (no
    gradient: it shifts a softmax, whose value it does not change)."""
    x = x.detach().contiguous().clone()
    for name in (names,) if isinstance(names, str) else names:
        if name in axis_names(mesh):
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(name))
    return x
