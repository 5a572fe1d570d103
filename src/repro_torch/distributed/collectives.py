"""The collectives of the sharded path, over one named axis of a
DeviceMesh.

They are `torch.distributed`'s c10d calls on the axis's process group.
A gloo group takes CUDA tensors for each of them (all_reduce,
all_gather_into_tensor and reduce_scatter_tensor, float32 and int32;
`probes/gloo_cuda_collectives.py` on the H100), so two ranks sharing one
card run them as they run on the CPU. DTensor's own redistribution
(`full_tensor`, its functional collectives) took a gloo rank on CUDA
down in the same probe, so the port keeps DTensor as the container of a
shard and moves the data with these calls alone. An axis of size 1 moves
nothing.

`all_gather_dim`, `all_reduce_sum` and `all_reduce_max` are the serve
paths' calls: no backward, the sums in place. The partitioned train step
takes gradients through three more, each an autograd Function over the
same calls that runs only where a gradient is wanted (the plain call, or
nothing, otherwise, so a step under no_grad moves the same bits):
  * `sum_over`: forward the sum over the axis, backward the identity
    (what follows the sum is the same on every rank);
  * `enter`: forward the identity, backward the gradient summed over the
    axis (a tensor the same on every rank going into rank-specific work,
    each rank's gradient of it a partial);
  * `gather_over`: forward the all-gather along a dim, backward this
    rank's block of the gradient summed over the axis, one
    reduce-scatter (what follows the gather is rank-specific).
Every backward sums in float32 and casts once to the gradient's dtype.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import AbstractMesh, mesh_shape

__all__ = ["axis_coordinate", "all_gather_dim", "all_reduce_sum",
           "all_reduce_max", "reduce_scatter_dim", "sum_over", "enter",
           "gather_over", "shard_dims", "gather_dims", "gather_dtensor"]


def axis_coordinate(mesh, axis: str) -> Tuple[int, int]:
    """(this rank's coordinate along `axis`, the axis's size)."""
    if isinstance(mesh, AbstractMesh):
        raise mesh.unplaced(dist.get_world_size()
                            if dist.is_initialized() else 1)
    size = mesh_shape(mesh)[axis]
    return (0 if size == 1 else mesh.get_local_rank(axis)), size


def all_gather_dim(t: torch.Tensor, dim: int, mesh, axis: str
                   ) -> torch.Tensor:
    """The blocks of `t` on the ranks along `axis`, concatenated along
    `dim` in coordinate order: every rank gets the whole tensor."""
    _, size = axis_coordinate(mesh, axis)
    if size == 1:
        return t
    dim %= t.ndim
    t = t.contiguous().reshape(1, *t.shape)   # gathered along a new dim 0
    out = torch.empty((size, *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=mesh.get_group(axis))
    shape = list(t.shape[1:])
    shape[dim] *= size
    return out.movedim(0, dim).reshape(shape)


def all_reduce_sum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of `t` over the ranks along `axis`, on every rank, in
    place. A ring all-reduce adds each element once and hands every rank
    the same bits."""
    _, size = axis_coordinate(mesh, axis)
    if size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return t


def all_reduce_max(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise largest of `t` over the ranks along `axis`, on every
    rank, in place (exact: a max rounds nothing)."""
    _, size = axis_coordinate(mesh, axis)
    if size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return t


def reduce_scatter_dim(t: torch.Tensor, dim: int, mesh, axis: str
                       ) -> torch.Tensor:
    """This rank's block along `dim` of the sum of `t` over the ranks
    along `axis` (the backward of `all_gather_dim`), in t's dtype."""
    c, size = axis_coordinate(mesh, axis)
    if size == 1:
        return t
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over the {size} ranks of {axis!r}")
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // size, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                               group=mesh.get_group(axis))
    return out.movedim(0, dim)


def _summed(g: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return all_reduce_sum(g.to(torch.float32, copy=True), mesh,
                          axis).to(g.dtype)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return all_reduce_sum(t.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh, ctx.axis), None, None


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, mesh, axis):
        ctx.dim, ctx.mesh, ctx.axis = dim, mesh, axis
        return all_gather_dim(t, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        out = reduce_scatter_dim(g.to(torch.float32), ctx.dim, ctx.mesh,
                                 ctx.axis).to(g.dtype)
        return out, None, None, None


def _traced(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def sum_over(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of `t` over the ranks along `axis`: `all_reduce_sum` in
    place where no gradient is taken, else a new tensor whose gradient
    goes to `t` unchanged."""
    if _traced(t):
        return _SumOver.apply(t, mesh, axis)
    return all_reduce_sum(t, mesh, axis)


def enter(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """`t` itself; its gradient summed over the ranks along `axis`."""
    if _traced(t) and axis_coordinate(mesh, axis)[1] > 1:
        return _Enter.apply(t, mesh, axis)
    return t


def gather_over(t: torch.Tensor, dim: int, mesh, axis: str
                ) -> torch.Tensor:
    """`all_gather_dim`; its gradient reduce-scattered back over the
    ranks along `axis` (`reduce_scatter_dim`)."""
    if _traced(t) and axis_coordinate(mesh, axis)[1] > 1:
        return _GatherOver.apply(t, dim, mesh, axis)
    return all_gather_dim(t, dim, mesh, axis)


def _axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def shard_dims(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor `t` under `spec` (one entry
    a dim: None, an axis name or a tuple of names, outer axis first), as
    DTensor chunks it. Moves nothing."""
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            c, size = axis_coordinate(mesh, a)
            if t.shape[d] % size:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"split over the {size} ranks of {a!r}")
            n = t.shape[d] // size
            t = t.narrow(d, c * n, n)
    return t


def gather_dims(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from this rank's block `t` under `spec`, on every
    rank: the inverse of `shard_dims` (a dim over two axes gathers its
    inner axis first)."""
    for d, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            t = all_gather_dim(t, d, mesh, a)
    return t


def gather_dtensor(t) -> torch.Tensor:
    """The whole tensor of a DTensor, on every rank: `gather_dims` under
    the spec its placements stand for."""
    spec = [()] * t.ndim
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if pl.is_shard():
            spec[pl.dim] += (name,)
    return gather_dims(t.to_local(), spec, t.device_mesh)
