"""The olm matmul sharded over one axis of a mesh (port of
`repro/kernels/online_dot/matmul_sharded.py`).

Every rank holds the whole x and w, as every rank runs the same model
code. The rank takes its block along the mesh axis by its coordinate
there, runs the unchanged single-device `olm_matmul` on it (K1 on a CUDA
tensor, the plain version on a CPU one), and the ranks along the axis
then combine their blocks, so every rank returns the whole (M, N) f32
output:

``partition="m"`` / ``"n"``
    Each rank computes M/d rows (or N/d columns) of the output over the
    FULL contraction, in the single-device K-tile order, so its block is
    **bit-identical** to the single-device kernel's. The blocks are then
    gathered along the sharded dim: that all-gather is the model's
    redistribution of the output, not a part of the GEMM's ledger, so
    `sharded_traffic` counts nothing on the wire for m and n, as the
    reference (whose out_specs leave the output sharded) does.

``partition="k"``
    Each rank computes the full (M, N) partial sum over its K/d slice, and
    the f32 partials are summed over the axis (all-reduce). The additions
    per output element are as many, but their **order differs** from the
    single-device walk over K tiles, so the result is not bit-identical:
    it stays within `olm_error_bound` (the reference's one documented
    numerics caveat of the distributed path).

tiling="auto" resolves the launch plan against the LOCAL (per-rank)
shapes, so a sharded GEMM lands in the autotuner bucket of the
single-device GEMM of the shard's size; pinned knobs win, and auto never
changes k_tile, so auto and static give the same bits on m and n.

The reference hoists an `enable_x64` scope around its n = 32 oracle,
since a shard_map body is always traced; the port has no counterpart:
its plain version of the n = 32 array runs in int64 lanes already.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.collectives import (all_gather_dim,
                                                 all_reduce_sum,
                                                 axis_coordinate)
from repro_torch.launch.mesh import mesh_shape

from .matmul import (DEFAULT_BLOCK_M, DEFAULT_BLOCK_N, DEFAULT_K_TILE,
                     digit_traffic, olm_matmul)

__all__ = ["olm_matmul_sharded", "gemm_partition_specs", "local_shapes",
           "sharded_traffic"]

_PARTITIONS = ("m", "n", "k")


def gemm_partition_specs(partition: str, axis: str = "model"):
    """((x_spec, w_spec), out_spec) for a GEMM sharded on `partition`; a
    spec is a tuple of mesh axis names or None, one entry a dim.

    m: x rows sharded, w replicated, output rows sharded.
    n: x replicated, w columns sharded, output columns sharded.
    k: x columns + w rows co-sharded, output replicated (after the sum).
    """
    if partition == "m":
        return ((axis, None), (None, None)), (axis, None)
    if partition == "n":
        return ((None, None), (None, axis)), (None, axis)
    if partition == "k":
        return ((None, axis), (axis, None)), (None, None)
    raise ValueError(
        f"unknown GEMM partition {partition!r}; expected one of "
        f"{_PARTITIONS}")


def local_shapes(M: int, N: int, K: int, partition: str,
                 devices: int) -> tuple:
    """Per-shard (M, N, K) under `partition` over `devices` shards.
    Raises when the partitioned dimension does not divide evenly: padding
    would change the digit-tile plan (and with it the error ledger) of a
    shard."""
    if partition not in _PARTITIONS:
        raise ValueError(
            f"unknown GEMM partition {partition!r}; expected one of "
            f"{_PARTITIONS}")
    dim = {"m": M, "n": N, "k": K}[partition]
    if dim % devices:
        raise ValueError(
            f"partition={partition!r} needs {partition.upper()} divisible "
            f"by the mesh axis size; got {dim} over {devices} devices")
    return {"m": (M // devices, N, K),
            "n": (M, N // devices, K),
            "k": (M, N, K // devices)}[partition]


def olm_matmul_sharded(
    x: torch.Tensor,  # (M, K) float
    w: torch.Tensor,  # (K, N) float
    *,
    mesh,
    partition: str = "m",
    axis: str = "model",
    n_bits: int = 16,
    k_tile: Optional[int] = None,
    trunc: Optional[int] = None,
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    quantize: str = "kernel",
    tiling: Optional[str] = None,
) -> torch.Tensor:
    """`olm_matmul` sharded over `mesh`'s `axis` (a DeviceMesh); (M, N)
    float32 on every rank.

    partition="m"/"n" shard the output rows/columns (bit-identical to one
    device); partition="k" shards the contraction and sums the f32
    partials (within olm_error_bound; the order of the sum differs, see
    the module docstring). The knobs default to None, "the kernel's
    default, or the autotuner's pick under tiling='auto'", so that pinned
    knobs stay distinguishable from defaults.
    """
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: x (M,{K}) @ w ({K2},N)")
    if tiling not in (None, "auto"):
        raise ValueError(f"tiling must be 'auto' or None, got {tiling!r}")
    sizes = mesh_shape(mesh)
    if axis not in sizes:
        raise ValueError(
            f"mesh has no axis {axis!r}; axes: {tuple(sizes)}")
    Ml, Nl, Kl = local_shapes(M, N, K, partition, sizes[axis])

    knobs = {k: v for k, v in (("k_tile", k_tile), ("block_m", block_m),
                               ("block_n", block_n)) if v is not None}
    if tiling == "auto":
        # the bucket of a single-device GEMM of the LOCAL shard shape
        from .tuning import get_tiling
        knobs = {**get_tiling(Ml, Nl, Kl, n_bits, trunc=trunc), **knobs}
    knobs.setdefault("k_tile", DEFAULT_K_TILE)

    c, d = axis_coordinate(mesh, axis)
    if partition == "m":
        x = x[c * Ml:(c + 1) * Ml]
    elif partition == "n":
        w = w[:, c * Nl:(c + 1) * Nl]
    else:
        x, w = x[:, c * Kl:(c + 1) * Kl], w[c * Kl:(c + 1) * Kl]
    # K1 reads w row-major or transposed: a column block is copied
    out = olm_matmul(x, w.contiguous(), n_bits=n_bits, trunc=trunc,
                     quantize=quantize, **knobs)
    if partition == "k":
        return all_reduce_sum(out, mesh, axis)
    return all_gather_dim(out, 0 if partition == "m" else 1, mesh, axis)


def sharded_traffic(M: int, N: int, K: int, *, partition: str,
                    devices: int, n_bits: int = 16,
                    k_tile: int = DEFAULT_K_TILE,
                    trunc: Optional[int] = None,
                    block_m: int = DEFAULT_BLOCK_M,
                    block_n: int = DEFAULT_BLOCK_N) -> dict:
    """Movement ledger for one sharded GEMM: the per-device LOCAL digit
    traffic (matmul.digit_traffic on the shard shapes) plus the total
    collective bytes on the wire. m/n move nothing between devices; k
    all-reduces an (M, N) f32 buffer, modeled as a ring reduce-scatter
    and all-gather, 2 * 4 * M * N * (devices - 1) bytes in all."""
    Ml, Nl, Kl = local_shapes(M, N, K, partition, devices)
    local = digit_traffic(Ml, Nl, Kl, n_bits=n_bits, k_tile=k_tile,
                          trunc=trunc, block_m=block_m, block_n=block_n)
    collective = 0 if partition in ("m", "n") else 8 * M * N * (devices - 1)
    return {"partition": partition, "devices": devices,
            "local": local, "collective_bytes": collective}
