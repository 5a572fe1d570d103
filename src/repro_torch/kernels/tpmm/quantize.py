"""Signed digit-plane decomposition for the truncated-precision matmul (port
of `repro/kernels/tpmm/quantize.py`).

A tensor row is scaled into [-1/2, 1/2] by a power-of-two scale, then split
into D balanced base-2^b digits, MSD plane first, each an int8 plane:

    a = scale * sum_{d=0}^{D-1} plane_d * 2^(-b*(d+1)),   plane_d in [-B/2, B/2]

with B = 2^b. Power-of-two scales keep the decomposition bit-exact. Plain
PyTorch elementwise code on any device, as it is jnp in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import pow2_scale

__all__ = ["plane_decompose", "plane_reconstruct"]


def plane_decompose(a: torch.Tensor, *, num_planes: int, plane_bits: int = 4,
                    axis: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompose float `a` into signed int8 digit planes along a new axis 0.

    Returns planes (D, *a.shape) int8, MSD plane first (balanced digits),
    and the power-of-two float32 scale, a.shape with `axis` reduced to 1.
    A bf16 or f16 `a` is promoted to float32 before the division, as the
    reference's a / scale does.
    """
    if plane_bits < 2 or plane_bits > 7:
        raise ValueError("plane_bits must be in [2, 7] for int8 planes")
    if plane_bits * num_planes > 30:
        raise ValueError(
            f"plane_bits*num_planes = {plane_bits * num_planes} overflows "
            "the int32 quantizer scale (max 30); n_bits > 28 operand "
            "significance exceeds float32 inputs' 24-bit mantissa anyway")
    B = 1 << plane_bits
    scale = pow2_scale(a, axis)
    u = a.to(torch.float32) / scale
    v = torch.round(u * float(B ** num_planes)).to(torch.int32)  # |v| <= B^D/2
    planes = []
    for _ in range(num_planes):
        # Balanced digit extraction LSD first, digits in [-B/2, B/2]: a
        # round-to-nearest carry with ties toward zero, so both extremes
        # are representable and |v| <= B^D / 2 never overflows.
        q = torch.sign(v) * ((v.abs() + (B // 2 - 1)) // B)
        planes.append((v - B * q).to(torch.int8))
        v = q
    return torch.stack(planes[::-1], dim=0), scale


def plane_reconstruct(planes: torch.Tensor, scale: torch.Tensor, *,
                      plane_bits: int = 4) -> torch.Tensor:
    """Inverse of plane_decompose (float32)."""
    D = planes.shape[0]
    w = np.exp2(-plane_bits * np.arange(1, D + 1, dtype=np.float64))
    w = torch.from_numpy(w.astype(np.float32)).to(planes.device)
    return scale * torch.tensordot(w, planes.to(torch.float32), dims=([0], [0]))
