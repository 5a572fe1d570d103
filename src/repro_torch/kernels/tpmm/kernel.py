"""Hopper kernel for the truncated digit-plane matmul: the port of the TPU
kernel `tpmm_pallas` (`repro/kernels/tpmm/kernel.py`).

The kernel is CUDA C++ (`csrc/tpmm.cu`, its header note says what bounds
it, which order of summation it follows and why). `tpmm_kernel` checks its
operands, allocates the output, launches on the current stream, raises on
a refused launch and counts the launch in `launches`. It takes CUDA
tensors only; the plain PyTorch version of the same function is
`ref.tpmm_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from .ref import kept_levels

__all__ = ["tpmm_kernel", "launches", "SOURCE"]

SOURCE = "tpmm.cu"

# Launches of the kernel since the count was last set to 0.
launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.tpmm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def tpmm_kernel(a_planes: torch.Tensor, b_planes: torch.Tensor,
                a_scale: torch.Tensor, b_scale: torch.Tensor, *, n_bits: int,
                plane_bits: int = 4, mode: str = "nbit") -> torch.Tensor:
    """Matmul over digit planes a (D, M, K) and b (D, K, N) int8 with
    scales a_scale (M, 1) and b_scale (1, N) float32; (M, N) float32.

    a must be contiguous. b must be stored K-contiguous: the (D, K, N)
    transposed view of a contiguous (D, N, K) tensor, the layout
    `ops.tpmm` decomposes the weights into."""
    global launches
    tensors = (a_planes, b_planes, a_scale, b_scale)
    if not all(t.is_cuda and t.device == a_planes.device for t in tensors):
        raise ValueError("tpmm_kernel takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if a_planes.dtype != torch.int8 or b_planes.dtype != torch.int8:
        raise ValueError(f"planes must be int8, got {a_planes.dtype} and "
                         f"{b_planes.dtype}")
    if a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32:
        raise ValueError(f"scales must be float32, got {a_scale.dtype} and "
                         f"{b_scale.dtype}")
    if a_planes.ndim != 3 or b_planes.ndim != 3:
        raise ValueError(f"planes {tuple(a_planes.shape)} and "
                         f"{tuple(b_planes.shape)} must be (D, M, K) and "
                         "(D, K, N)")
    D, M, K = a_planes.shape
    if b_planes.shape[:2] != (D, K):
        raise ValueError(f"b planes {tuple(b_planes.shape)} do not match a "
                         f"planes {tuple(a_planes.shape)}")
    N = b_planes.shape[2]
    if min(M, N, K) < 1:
        raise ValueError(f"empty operand: ({M}, {K}) @ ({K}, {N})")
    if a_scale.shape != (M, 1) or b_scale.shape != (1, N):
        raise ValueError(f"scales {tuple(a_scale.shape)}, "
                         f"{tuple(b_scale.shape)} must be ({M}, 1), (1, {N})")
    if not a_planes.is_contiguous():
        raise ValueError("a planes must be contiguous")
    bt = b_planes.transpose(1, 2)
    if not bt.is_contiguous():
        raise ValueError("b planes must be the (D, K, N) transposed view of "
                         "a contiguous (D, N, K) tensor")
    if not (a_scale.is_contiguous() and b_scale.is_contiguous()):
        raise ValueError("scales must be contiguous")
    levels = min(kept_levels(n_bits, plane_bits, mode=mode), 2 * D - 1)
    # A level sum must stay exact in int32: |digit| <= 2^(b-1).
    if (1 << (2 * plane_bits - 2)) * D * K >= 2 ** 31:
        raise ValueError(f"K={K} overflows the int32 level sum at D={D}, "
                         f"plane_bits={plane_bits}")
    out = torch.empty((M, N), dtype=torch.float32, device=a_planes.device)
    with torch.cuda.device(a_planes.device):
        stream = torch.cuda.current_stream(a_planes.device).cuda_stream
        err = _lib().tpmm(a_planes.data_ptr(), bt.data_ptr(),
                          a_scale.data_ptr(), b_scale.data_ptr(),
                          out.data_ptr(), D, M, N, K, levels, plane_bits,
                          stream)
    if err != 0:
        raise RuntimeError(f"tpmm launch failed: cudaError {err} "
                           f"(D={D} M={M} K={K} N={N} levels={levels})")
    launches += 1
    return out
