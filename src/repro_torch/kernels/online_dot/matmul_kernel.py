"""Hopper kernel for the fused online inner-product array matmul: the port
of the TPU kernel `olm_matmul_fused_pallas`
(`repro/kernels/online_dot/matmul_kernel.py`).

The kernel itself is CUDA C++ (`csrc/olm_matmul_fused.cu`, its header
note says what bounds it and how the design answers that). This module
binds it with ctypes: `olm_matmul_fused` checks its operands, allocates
the output, launches on the current stream, raises on a refused launch
and counts the launch in `launches`. It takes CUDA tensors only; the
plain PyTorch version of the same function is `matmul.olm_matmul_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels import build
from repro_torch.kernels.common import checked_schedule, decode_policy
from .ref import tree_levels

__all__ = ["olm_matmul_fused", "launches", "SOURCE", "MAX_K_TILE",
           "int_ops"]

SOURCE = "olm_matmul_fused.cu"
MAX_K_TILE = 16            # lanes of one output = threads of a half-warp

# Launches of the kernel since the count was last set to 0 (a run that
# must show it went through the kernel sets it to 0, runs, and reads it).
launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.olm_matmul_fused
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, i, i, ll, ll, i, i, i, i, p, i, p]
        fn.restype = ctypes.c_int
    return lib


def olm_matmul_fused(x: torch.Tensor, w: torch.Tensor, *, n: int,
                     k_tile: int = MAX_K_TILE) -> torch.Tensor:
    """x (M, K) float32 @ w (K, N) float32 through the fused online
    inner-product array at n working digits, kt = min(k_tile, K) lanes per
    adder tree; returns (M, N) float32.

    x must be row-major contiguous. w may be row-major (K, N) or the
    transpose of a row-major (N, K) tensor; the kernel reads it in place
    through its strides."""
    global launches
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError(f"olm_matmul_fused takes CUDA tensors on one device,"
                         f" got {x.device} and {w.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"olm_matmul_fused takes float32, got {x.dtype} "
                         f"and {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    if min(M, K, N) < 1:
        raise ValueError(f"empty operand: ({M}, {K}) @ ({K}, {N})")
    if not x.is_contiguous():
        raise ValueError("x must be row-major contiguous")
    if not (w.is_contiguous() or w.t().is_contiguous()):
        raise ValueError("w must be (K, N) row-major or the transpose of an "
                         "(N, K) row-major tensor")
    kt = min(k_tile, K)
    if kt > MAX_K_TILE:
        raise ValueError(f"k_tile {kt} > {MAX_K_TILE}: one output's lanes "
                         "live in one half-warp")
    cfg = OnlinePrecision(n=n)
    sched, S = checked_schedule(cfg)
    L = tree_levels(kt)
    decode_policy(n + 2 * L)                 # raises past 48 digits
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    arr = (ctypes.c_int * len(sched))(*(int(v) for v in sched))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().olm_matmul_fused(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
            w.stride(0), w.stride(1), n, kt, L, S, arr, len(sched), stream)
    if err != 0:
        raise RuntimeError(f"olm_matmul_fused launch failed: cudaError {err} "
                           f"(M={M} K={K} N={N} n={n} kt={kt})")
    launches += 1
    return out


# int32 operations the kernel's source issues, per unit of work (counted
# from csrc/olm_matmul_fused.cu; a 64-bit logic op or shift counts 2):
#  - per lane and recurrence step: digit reads 10, Yf 2, term 3,
#    append 2, X 3, Y 1, V 2;
#  - per lane and digit-producing step: estimate 1, selection 4,
#    residual 3, packing the digit 6;
#  - per online adder: 39 64-bit ops;
#  - per quantized element: flush 2, |v| 1, 4 shuffle-max rounds 8,
#    scale bits 8, digit masks 5;
#  - per output and K tile: decode 12.
OPS_STEP, OPS_DIGIT, OPS_ADDER, OPS_QUANT, OPS_DECODE = 23, 14, 78, 24, 12


def int_ops(M: int, N: int, K: int, *, n: int, k_tile: int = MAX_K_TILE
            ) -> int:
    """int32 operations one (M, K) @ (K, N) call needs: the recurrence of
    every lane, one adder tree per output and K tile, the quantization of
    every row and column slice once, and the decode. The count of work
    the function needs, not of what this kernel repeats (it quantizes a
    slice once per block and runs the tree on all 16 threads)."""
    kt = min(k_tile, K)
    T = -(-K // kt)
    steps = OnlinePrecision(n=n).steps
    per_lane = steps * OPS_STEP + n * OPS_DIGIT
    outs = M * N * T
    return (outs * kt * per_lane + outs * (kt - 1) * OPS_ADDER
            + (M + N) * T * kt * OPS_QUANT + outs * OPS_DECODE)
