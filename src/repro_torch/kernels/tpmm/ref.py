"""Plain version of the truncated digit-plane matmul (port of
`repro/kernels/tpmm/ref.py`).

Integer plane-pair matmuls summed per significance level L = da + db,
keeping only the levels below the cutoff, then one float32 scale-and-sum
in level order. The CUDA kernel (`csrc/tpmm.cu`) reproduces it bit for
bit. The pair products run as float64 matmuls of the integer-valued
planes: every partial sum is an integer far below 2^53, so they are exact
in any order on any device (a CUDA card has no integer matmul in
PyTorch), and the float64 -> float32 rounding of the level sum is the
reference's int32 -> float32 one (with a zero sum's sign made +, as an
integer zero has no sign).
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import reduced_precision

__all__ = ["kept_levels", "num_planes_for", "tpmm_ref"]


def num_planes_for(n_bits: int, plane_bits: int) -> int:
    """Planes needed to carry n_bits of operand significance."""
    return -(-n_bits // plane_bits)


def kept_levels(n_bits: int, plane_bits: int, *, mode: str = "nbit") -> int:
    """Number of significance levels L = da + db kept in the product.

    mode="full": all 2D-1 levels (the exact product of the planes).
    mode="nbit": L <= D-1, an n-bit-accurate product from the triangular
      half of the plane pairs (the default).
    mode="eq8": the cutoff at the Eq. 8 residual width
      p = ceil((2n + delta + t)/3): keep L <= ceil(p/b) - 1.
    """
    D = num_planes_for(n_bits, plane_bits)
    if mode == "full":
        return 2 * D - 1
    if mode == "nbit":
        return D
    if mode == "eq8":
        p = reduced_precision(n_bits)
        return min(max(-(-p // plane_bits) - 1, 1), 2 * D - 1)
    raise ValueError(f"unknown tpmm mode {mode!r}")


def tpmm_ref(a_planes: torch.Tensor, b_planes: torch.Tensor,
             a_scale: torch.Tensor, b_scale: torch.Tensor, *, n_bits: int,
             plane_bits: int = 4, mode: str = "nbit") -> torch.Tensor:
    """Matmul over digit planes a (D, M, K) and b (D, K, N) int8 with
    scales a_scale (M, 1) and b_scale (1, N) float32; (M, N) float32."""
    D = a_planes.shape[0]
    lmax = kept_levels(n_bits, plane_bits, mode=mode)
    out = None
    for L in range(min(lmax, 2 * D - 1)):
        acc = None
        for da in range(max(0, L - D + 1), min(L, D - 1) + 1):
            prod = a_planes[da].to(torch.float64) @ b_planes[L - da].to(
                torch.float64)
            acc = prod if acc is None else acc + prod
        # + 0.0 turns a -0.0 sum (K = 1: a zero digit times a negative one)
        # into the +0 an integer sum has
        term = (acc + 0.0).to(torch.float32) * (
            2.0 ** (-plane_bits * (L + 2)))
        out = term if out is None else out + term
    return out * a_scale * b_scale
