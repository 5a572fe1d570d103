"""Plain online adder tree of the inner-product array (port of
`repro/kernels/online_dot/ref.py::tree_levels, adder_tree`).

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

__all__ = ["tree_levels", "adder_tree"]


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
