"""Hopper kernel for the batched fused online inner product: the port of the
TPU kernel `online_dot_pallas` (`repro/kernels/online_dot/kernel.py`).

The kernel is CUDA C++ (`csrc/online_dot.cu`, its header note says what
bounds it and how the design answers that). `online_dot_kernel` checks its
operands, allocates the output, launches on the current stream, raises on
a refused launch and counts the launch in `launches`. It takes CUDA
tensors only; the plain PyTorch version of the same function is
`ref.online_dot_batch_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels import build
from repro_torch.kernels.online_mul.kernel import OPS_PACK, check_config
from .matmul_kernel import OPS_ADDER, OPS_DIGIT, OPS_STEP
from .ref import tree_levels

__all__ = ["online_dot_kernel", "launches", "SOURCE", "MAX_LANES",
           "int_ops"]

SOURCE = "online_dot.cu"
MAX_LANES = 1024           # the K lanes of one row live in one block

# Launches of the kernel since the count was last set to 0.
launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.online_dot
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, i, p, i, p]
        fn.restype = ctypes.c_int
    return lib


def online_dot_kernel(x_digits: torch.Tensor, y_digits: torch.Tensor,
                      cfg: OnlinePrecision) -> torch.Tensor:
    """(B, K, n) int32 digit pairs in {-1, 0, 1} -> (B, n + 2L) int32
    digit stream of sum_i x_i y_i / 2^L, L = ceil(log2 K)."""
    global launches
    if not (x_digits.is_cuda and y_digits.is_cuda
            and x_digits.device == y_digits.device):
        raise ValueError(f"online_dot_kernel takes CUDA tensors on one "
                         f"device, got {x_digits.device} and "
                         f"{y_digits.device}")
    if x_digits.dtype != torch.int32 or y_digits.dtype != torch.int32:
        raise ValueError(f"digits must be int32, got {x_digits.dtype} and "
                         f"{y_digits.dtype}")
    if (x_digits.ndim != 3 or x_digits.shape != y_digits.shape
            or x_digits.shape[2] != cfg.n):
        raise ValueError(f"operands {tuple(x_digits.shape)} and "
                         f"{tuple(y_digits.shape)} must both be "
                         f"(B, K, {cfg.n})")
    B, K, n = x_digits.shape
    if min(B, K) < 1:
        raise ValueError(f"empty operand: B={B} K={K}")
    if K > MAX_LANES:
        raise ValueError(f"K={K} > {MAX_LANES}: the lanes of one row live "
                         "in one block")
    if not (x_digits.is_contiguous() and y_digits.is_contiguous()):
        raise ValueError("digit operands must be contiguous")
    arr, S = check_config(cfg)
    L = tree_levels(K)
    z = torch.empty((B, n + 2 * L), dtype=torch.int32,
                    device=x_digits.device)
    with torch.cuda.device(x_digits.device):
        stream = torch.cuda.current_stream(x_digits.device).cuda_stream
        err = _lib().online_dot(x_digits.data_ptr(), y_digits.data_ptr(),
                                z.data_ptr(), B, K, L, n, S, arr, len(arr),
                                stream)
    if err != 0:
        raise RuntimeError(f"online_dot launch failed: cudaError {err} "
                           f"(B={B} K={K} n={n})")
    launches += 1
    return z


def int_ops(B: int, K: int, cfg: OnlinePrecision) -> int:
    """int32 operations B rows of K-lane inner products need: every lane's
    recurrence and packing (online_mul_kernel's count) and one adder tree
    of K - 1 adders per row, plus unpacking the stream."""
    lane = cfg.steps * OPS_STEP + cfg.n * (OPS_DIGIT + OPS_PACK)
    m = cfg.n + 2 * tree_levels(K)
    return B * (K * lane + (K - 1) * OPS_ADDER + m * 4)
