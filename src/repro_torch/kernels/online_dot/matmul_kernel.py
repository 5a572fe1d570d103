"""Hopper kernels for the online inner-product array matmul: the ports of
the TPU kernels `olm_matmul_fused_pallas` (K1, quantize in the kernel) and
`olm_matmul_pallas` (K2, operands quantized before the call), both in
`repro/kernels/online_dot/matmul_kernel.py`.

The kernels themselves are CUDA C++ (`csrc/olm_matmul.cu`, one tile body
for both operand formats; its header note says what bounds them and how
the design answers that). This module binds them with ctypes:
`olm_matmul_fused` and `olm_matmul_host` check their operands, allocate
the output, launch on the current stream, raise on a refused launch and
count the launch in `launches` and `host_launches`. They take CUDA tensors
only; the plain PyTorch version of both is `matmul.olm_matmul_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels import build
from repro_torch.kernels.common import checked_schedule, decode_policy
from .ref import tree_levels

__all__ = ["olm_matmul_fused", "olm_matmul_host", "launches",
           "host_launches", "SOURCE", "MAX_K_TILE", "int_ops"]

SOURCE = "olm_matmul.cu"
MAX_K_TILE = 16            # lanes of one output = threads of a half-warp

# Launches of each kernel since its count was last set to 0 (a run that
# must show it went through a kernel sets the count to 0, runs, and reads
# it): K1 in `launches`, K2 in `host_launches`.
launches = 0
host_launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.olm_matmul_fused.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.olm_matmul_fused.argtypes = [p, p, p, i, i, i, ll, ll, i, i, i,
                                         i, p, i, p]
        lib.olm_matmul_host.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                        p, i, p]
        for fn in (lib.olm_matmul_fused, lib.olm_matmul_host):
            fn.restype = ctypes.c_int
    return lib


def _schedule(n: int, kt: int):
    """(T(j) as a ctypes array, S, tree levels L) for n working digits over
    a kt-lane tree; raises past the int32 datapath or the decode window."""
    sched, S = checked_schedule(OnlinePrecision(n=n))
    L = tree_levels(kt)
    decode_policy(n + 2 * L)                 # raises past 48 digits
    return (ctypes.c_int * len(sched))(*(int(v) for v in sched)), S, L


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
    arr, S, L = _schedule(n, kt)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().olm_matmul_fused(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
            w.stride(0), w.stride(1), n, kt, L, S, arr, len(arr), stream)
    if err != 0:
        raise RuntimeError(f"olm_matmul_fused launch failed: cudaError {err} "
                           f"(M={M} K={K} N={N} n={n} kt={kt})")
    launches += 1
    return out


def olm_matmul_host(xd: torch.Tensor, sx: torch.Tensor, wd: torch.Tensor,
                    sw: torch.Tensor, *, n: int) -> torch.Tensor:
    """The array matmul from pre-quantized operands: row digit grids
    xd (M, T, kt, n) and column grids wd (N, T, kt, n), int32 in
    {-1, 0, 1}, with power-of-two scales sx (M, T) and sw (N, T) float32
    (`matmul._quantize_tiles` makes all four). Returns (M, N) float32."""
    global host_launches
    tensors = (xd, sx, wd, sw)
    if not all(t.is_cuda and t.device == xd.device for t in tensors):
        raise ValueError("olm_matmul_host takes CUDA tensors on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if xd.dtype != torch.int32 or wd.dtype != torch.int32:
        raise ValueError(f"digit grids must be int32, got {xd.dtype} and "
                         f"{wd.dtype}")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise ValueError(f"scales must be float32, got {sx.dtype} and "
                         f"{sw.dtype}")
    if xd.ndim != 4 or wd.ndim != 4 or xd.shape[1:] != wd.shape[1:]:
        raise ValueError(f"digit grids {tuple(xd.shape)} and "
                         f"{tuple(wd.shape)} must be (rows, T, kt, n) alike")
    M, T, kt, n_ = xd.shape
    N = wd.shape[0]
    if n_ != n:
        raise ValueError(f"operand digit count {n_} != n {n}")
    if sx.shape != (M, T) or sw.shape != (N, T):
        raise ValueError(f"scales {tuple(sx.shape)}, {tuple(sw.shape)} must "
                         f"be ({M}, {T}) and ({N}, {T})")
    if min(M, N, T) < 1:
        raise ValueError(f"empty operand: M={M} N={N} T={T}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("digit grids and scales must be contiguous")
    if kt > MAX_K_TILE:
        raise ValueError(f"k_tile {kt} > {MAX_K_TILE}: one output's lanes "
                         "live in one half-warp")
    arr, S, L = _schedule(n, kt)
    out = torch.empty((M, N), dtype=torch.float32, device=xd.device)
    with torch.cuda.device(xd.device):
        stream = torch.cuda.current_stream(xd.device).cuda_stream
        err = _lib().olm_matmul_host(
            xd.data_ptr(), sx.data_ptr(), wd.data_ptr(), sw.data_ptr(),
            out.data_ptr(), M, N, T, n, kt, L, S, arr, len(arr), stream)
    if err != 0:
        raise RuntimeError(f"olm_matmul_host launch failed: cudaError {err} "
                           f"(M={M} T={T} kt={kt} N={N} n={n})")
    host_launches += 1
    return out


# int32 operations the kernels' source issues, per unit of work (counted
# from csrc/olm_matmul.cu and csrc/olm_digits.cuh; a 64-bit logic op or
# shift counts 2):
#  - per lane and recurrence step: digit reads 10, Yf 2, term 3,
#    append 2, X 3, Y 1, V 2;
#  - per lane and digit-producing step: estimate 1, selection 4,
#    residual 3, packing the digit 6;
#  - per online adder: 39 64-bit ops;
#  - per quantized element: flush 2, |v| 1, 4 shuffle-max rounds 8,
#    scale bits 8, digit masks 5;
#  - per output and K tile: decode 12.
OPS_STEP, OPS_DIGIT, OPS_ADDER, OPS_QUANT, OPS_DECODE = 23, 14, 78, 24, 12


def int_ops(M: int, N: int, K: int, *, n: int, k_tile: int = MAX_K_TILE,
            quantize: bool = True) -> int:
    """int32 operations one (M, K) @ (K, N) call needs: the recurrence of
    every lane, one adder tree per output and K tile, the quantization of
    every row and column slice once (K1 only: quantize=False counts K2,
    whose operands arrive quantized), and the decode. The count of work
    the function needs, not of what the kernels repeat (they load a slice
    once per block and run the tree on all 16 threads)."""
    kt = min(k_tile, K)
    T = -(-K // kt)
    steps = OnlinePrecision(n=n).steps
    per_lane = steps * OPS_STEP + n * OPS_DIGIT
    outs = M * N * T
    quant = (M + N) * T * kt * OPS_QUANT if quantize else 0
    return (outs * kt * per_lane + outs * (kt - 1) * OPS_ADDER + quant
            + outs * OPS_DECODE)
