"""Plain online adder tree and batched inner product of the array (port
of `repro/kernels/online_dot/ref.py::tree_levels, adder_tree,
online_dot_batch_ref`).

The balanced online-adder tree, position-parallel: with e_k the padded
digit sums of a node's two input streams (e_0 = 0 for the /2 pre-scale,
then the sums, then two flush zeros),

    t_k = +1 if e_k >= 2 or (e_k == +1 and e_{k+1} >= 0)
    t_k = -1 if e_k <= -2 or (e_k == -1 and e_{k+1} <  0)
    w_k = e_k - 2 t_k,     out_k = w_k + t_{k+1}

Each level halves the node count (an odd count is padded with a zero
stream) and grows the stream by 2 digits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.online_mul.ref import online_mul_batch_ref

__all__ = ["tree_levels", "adder_tree", "online_dot_batch_ref"]


def tree_levels(k: int) -> int:
    """Number of reduction levels L for k lanes (== ceil(log2 k), 0 for 1)."""
    if k < 1:
        raise ValueError(f"need k >= 1 lanes, got {k}")
    levels, width = 0, k
    while width > 1:
        width = (width + 1) // 2
        levels += 1
    return levels


def adder_tree(streams: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Reduce (..., K, m) signed-digit streams through the online adder
    tree. Returns ((..., m + 2L) digit stream of sum / 2^L, L)."""
    lead = streams.shape[:-2]
    levels = 0
    while streams.shape[-2] > 1:
        K, m = streams.shape[-2], streams.shape[-1]
        if K % 2:
            streams = torch.cat(
                [streams, streams.new_zeros(lead + (1, m))], dim=-2)
            K += 1
        pairs = streams.reshape(lead + (K // 2, 2, m))
        z1 = streams.new_zeros(lead + (K // 2, 1))
        e = torch.cat([z1, pairs[..., 0, :] + pairs[..., 1, :],
                       streams.new_zeros(lead + (K // 2, 2))], dim=-1)
        ek, en = e[..., :-1], e[..., 1:]
        one = torch.ones_like(ek)
        zero = torch.zeros_like(ek)
        t = torch.where((ek >= 2) | ((ek == 1) & (en >= 0)), one,
                        torch.where((ek <= -2) | ((ek == -1) & (en < 0)),
                                    -one, zero))
        w = ek - 2 * t
        out = w[..., :-1] + t[..., 1:]
        streams = torch.cat([out, z1], dim=-1)
        levels += 1
    return streams[..., 0, :], levels


def online_dot_batch_ref(x_digits: torch.Tensor, y_digits: torch.Tensor, *,
                         n: int, delta: int = 3, t: int = 2,
                         truncated: bool = True, tail_gating: bool = True,
                         tail_guard: int = 2) -> torch.Tensor:
    """Batched online inner product, plain version: (B, K, n) digit pairs
    through K multiplier lanes (the int64 recurrence) and the adder tree.
    Returns the (B, n + 2 ceil(log2 K)) int32 digit stream of
    sum_i x_i y_i / 2^L."""
    z, _ = online_mul_batch_ref(x_digits, y_digits, n=n, delta=delta, t=t,
                                truncated=truncated, tail_gating=tail_gating,
                                tail_guard=tail_guard)
    out, _ = adder_tree(z)
    return out
