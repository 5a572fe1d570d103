"""Int8 gradient compression with error feedback (port of
`repro/optim/compression.py`).

Gradients are quantized to int8 with a per-tensor scale, and the
quantization residual is fed into the next step's gradient (error
feedback keeps the long-run bias at zero). The reference uses it on the
cross-pod gradient all-reduce; here it runs on one device, in the train
step under compress_grads=True, with the reference's arithmetic: the
scale max(max|g|, 1e-30) / 127, a true division by it (not a multiply by
its reciprocal), and `torch.round`, half to even as `jnp.round`.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.tree import (flatten_like, tree_flatten, tree_map,
                               tree_unflatten)

__all__ = ["compress_int8", "decompress_int8", "ef_compress_tree"]


def compress_int8(g: torch.Tensor, reduce_max: Optional[Callable] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g to int8 and its scale. `reduce_max`, where g is one rank's block
    of a gradient, takes the block's max |g| to the whole gradient's (an
    all-reduce over the axes that split it)."""
    amax = torch.max(torch.abs(g))
    if reduce_max is not None:
        amax = reduce_max(amax)
    amax = torch.clamp(amax, min=1e-30)
    scale = amax / torch.tensor(127.0, dtype=amax.dtype, device=amax.device)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_tree(grads, error_state, reduce_max: Optional[list] = None
                     ) -> Tuple[Any, Any]:
    """Apply error-feedback int8 compression leaf-wise. Returns (the
    decompressed grads, the new error state); an error state of None is
    created as f32 zeros (the first compressed step). `reduce_max`: one
    `compress_int8` reduce_max a leaf, in flattened order, where the
    grads and the error state are one rank's blocks."""
    if error_state is None:
        error_state = tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def one(g, e, reduce):
        corrected = g.to(torch.float32) + e
        q, s = compress_int8(corrected, reduce)
        deq = decompress_int8(q, s)
        return deq.to(g.dtype), corrected - deq

    flat_g, td = tree_flatten(grads)
    flat_e = flatten_like(error_state, td)
    outs = [one(g, e, r) for g, e, r in zip(
        flat_g, flat_e, reduce_max or [None] * len(flat_g))]
    return (tree_unflatten(td, [o[0] for o in outs]),
            tree_unflatten(td, [o[1] for o in outs]))
