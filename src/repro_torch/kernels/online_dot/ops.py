"""Batched fused online inner product (port of
`repro/kernels/online_dot/ops.py`).

`online_dot` dispatches like `online_mul`: a CUDA tensor runs the Hopper
kernel (kernel.online_dot_kernel) when `resolve_use_pallas` allows it,
decided from the configuration before any launch; a configuration past
the int32 datapath, an explicit use_pallas=False, or a CPU tensor runs the
int64 plain version. Both give the same digits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels.common import resolve_use_pallas
from .ref import online_dot_batch_ref, tree_levels

__all__ = ["online_dot", "dot_scale_log2", "dot_stream_length"]


def dot_scale_log2(k: int) -> int:
    """L: the emitted stream encodes sum x_i y_i / 2^L."""
    return tree_levels(k)


def dot_stream_length(n: int, k: int) -> int:
    """Digits in the emitted stream: n + 2 per adder-tree level."""
    return n + 2 * tree_levels(k)


def _decode_f64(z: torch.Tensor) -> torch.Tensor:
    """Stream (..., m) -> float64 sum_i d_i 2^-(i+1), exact for m <= 51."""
    w = 0.5 ** np.arange(1, z.shape[-1] + 1)
    return (z.to(torch.float64) * torch.from_numpy(w).to(z.device)).sum(-1)


def online_dot(x_digits: torch.Tensor, y_digits: torch.Tensor,
               cfg: OnlinePrecision, *, use_pallas: bool | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched fused online inner product over K digit pairs per row.

    Returns (z_digits (B, n + 2L) int32, dot (B,) float64 inner-product
    values with the 2^-L tree scale removed), both on the operands'
    device."""
    B, K, n = x_digits.shape
    if cfg.n != n:
        raise ValueError(f"operand digit count {n} != cfg n {cfg.n}")
    if x_digits.is_cuda and resolve_use_pallas(cfg, use_pallas):
        from .kernel import online_dot_kernel
        z = online_dot_kernel(x_digits.to(torch.int32).contiguous(),
                              y_digits.to(torch.int32).contiguous(), cfg)
    else:
        z = online_dot_batch_ref(
            x_digits, y_digits, n=cfg.n, delta=cfg.delta, t=cfg.t,
            truncated=cfg.truncated, tail_gating=cfg.tail_gating,
            tail_guard=cfg.tail_guard)
    return z, _decode_f64(z) * float(1 << tree_levels(K))
