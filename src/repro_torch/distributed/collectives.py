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
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import AbstractMesh, mesh_shape

__all__ = ["axis_coordinate", "all_gather_dim", "all_reduce_sum",
           "all_reduce_max", "shard_dims", "gather_dims", "gather_dtensor"]


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
