"""Truncated-precision matmul of float operands (port of
`repro/kernels/tpmm/ops.py`); DotEngine exposes it as the tpmm8 / tpmm16
numerics modes.

`tpmm` decomposes both operands into digit planes (plain PyTorch, on the
operands' device) and dispatches on that device: a CUDA tensor runs the
Hopper kernel (kernel.tpmm_kernel), a CPU tensor the plain version
(ref.tpmm_ref). Both give the same float32 bits.
"""
from __future__ import annotations

import torch

from .quantize import plane_decompose
from .ref import kept_levels, num_planes_for, tpmm_ref

__all__ = ["tpmm", "tpmm_cost_model", "decompose_operands"]


def tpmm(a: torch.Tensor, b: torch.Tensor, *, n_bits: int = 16,
         plane_bits: int = 4, mode: str = "nbit") -> torch.Tensor:
    """Truncated-precision matmul a (M, K) @ b (K, N) of float operands;
    returns (M, N) float32 carrying ~n_bits of significance from about
    (D^2 + D) / 2 of the D^2 plane-pair products."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"tpmm takes 2-D operands, got a {tuple(a.shape)} "
                         f"and b {tuple(b.shape)}")
    M, K = a.shape
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: a (M,{K}) @ b ({K2},N)")
    if a.device != b.device:
        raise ValueError(f"a on {a.device} but b on {b.device}")
    ap, bp, sa, sb = decompose_operands(a, b, n_bits=n_bits,
                                        plane_bits=plane_bits)
    if a.device.type == "cpu":
        return tpmm_ref(ap, bp, sa, sb, n_bits=n_bits, plane_bits=plane_bits,
                        mode=mode)
    if a.device.type != "cuda":
        raise ValueError(f"tpmm runs on cpu or cuda, got {a.device}")
    from .kernel import tpmm_kernel
    return tpmm_kernel(ap, bp, sa, sb, n_bits=n_bits, plane_bits=plane_bits,
                       mode=mode)


def decompose_operands(a: torch.Tensor, b: torch.Tensor, *, n_bits: int,
                       plane_bits: int = 4):
    """Digit planes and scales of both operands, in the layout both
    versions take: a planes (D, M, K) contiguous, b planes (D, K, N) as
    the transposed view of a contiguous (D, N, K) tensor (b's columns are
    decomposed as rows of b.T, so K is contiguous for the kernel), scales
    (M, 1) and (1, N)."""
    D = num_planes_for(n_bits, plane_bits)
    ap, sa = plane_decompose(a, num_planes=D, plane_bits=plane_bits, axis=1)
    bpt, sb = plane_decompose(b.t(), num_planes=D, plane_bits=plane_bits,
                              axis=1)
    return (ap.contiguous(), bpt.contiguous().transpose(1, 2),
            sa.contiguous(), sb.reshape(1, -1))


def tpmm_cost_model(n_bits: int = 16, plane_bits: int = 4,
                    mode: str = "nbit") -> dict:
    """Plane-pair accounting: full vs truncated plane-pair product counts
    (the paper's area/power saving transposed to matrix-unit occupancy)."""
    D = num_planes_for(n_bits, plane_bits)
    lmax = kept_levels(n_bits, plane_bits, mode=mode)
    full = D * D
    kept = sum(1 for L in range(lmax) for da in range(D) if 0 <= L - da < D)
    return {
        "planes": D,
        "levels_kept": lmax,
        "pair_matmuls_full": full,
        "pair_matmuls_truncated": kept,
        "mxu_savings_pct": 100.0 * (1 - kept / full),
    }
