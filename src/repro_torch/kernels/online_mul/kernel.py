"""Hopper kernel for the batched radix-2 online multiplier: the port of the
TPU kernel `online_mul_pallas` (`repro/kernels/online_mul/kernel.py`).

The kernel is CUDA C++ (`csrc/online_mul.cu`, its header note says what
bounds it and how the design answers that). `online_mul_kernel` checks
its operands, allocates the output, launches on the current stream, raises
on a refused launch and counts the launch in `launches`. It takes CUDA
tensors only; the plain PyTorch version of the same function is
`ref.online_mul_batch_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels import build
from repro_torch.kernels.common import checked_schedule
from repro_torch.kernels.online_dot.matmul_kernel import OPS_DIGIT, OPS_STEP

__all__ = ["online_mul_kernel", "launches", "SOURCE", "check_config",
           "int_ops", "OPS_PACK"]

SOURCE = "online_mul.cu"

# Launches of the kernel since the count was last set to 0.
launches = 0

# The CUDA recurrence is compiled for the paper's online delay and
# estimate width; other values are refused before any launch.
DELTA, EST = 3, 2

# int32 operations per operand digit to pack both operands into masks and
# to unpack the product digit (counted from csrc/online_mul.cu).
OPS_PACK = 10


def check_config(cfg: OnlinePrecision) -> tuple:
    """(T(j) as a ctypes array, S) for a configuration the CUDA recurrence
    runs; ValueError for one it does not (delta/t other than 3/2, or a
    schedule past the int32 datapath)."""
    if (cfg.delta, cfg.t) != (DELTA, EST):
        raise ValueError(
            f"the CUDA online multiplier runs delta={DELTA}, t={EST}; got "
            f"delta={cfg.delta}, t={cfg.t} (use_pallas=False runs the plain "
            "version)")
    sched, S = checked_schedule(cfg)
    return (ctypes.c_int * len(sched))(*(int(v) for v in sched)), S


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.online_mul
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, ll, i, i, p, i, p]
        fn.restype = ctypes.c_int
    return lib


def online_mul_kernel(x_digits: torch.Tensor, y_digits: torch.Tensor,
                      cfg: OnlinePrecision) -> torch.Tensor:
    """(B, n) int32 digit operands in {-1, 0, 1}, MSD first -> (B, n) int32
    MSDF product digits of the Fig. 7 recurrence under `cfg`."""
    global launches
    if not (x_digits.is_cuda and y_digits.is_cuda
            and x_digits.device == y_digits.device):
        raise ValueError(f"online_mul_kernel takes CUDA tensors on one "
                         f"device, got {x_digits.device} and "
                         f"{y_digits.device}")
    if x_digits.dtype != torch.int32 or y_digits.dtype != torch.int32:
        raise ValueError(f"digits must be int32, got {x_digits.dtype} and "
                         f"{y_digits.dtype}")
    if (x_digits.ndim != 2 or x_digits.shape != y_digits.shape
            or x_digits.shape[1] != cfg.n):
        raise ValueError(f"operands {tuple(x_digits.shape)} and "
                         f"{tuple(y_digits.shape)} must both be (B, {cfg.n})")
    B = x_digits.shape[0]
    if B < 1:
        raise ValueError("empty batch")
    if not (x_digits.is_contiguous() and y_digits.is_contiguous()):
        raise ValueError("digit operands must be contiguous")
    arr, S = check_config(cfg)
    z = torch.empty_like(x_digits)
    with torch.cuda.device(x_digits.device):
        stream = torch.cuda.current_stream(x_digits.device).cuda_stream
        err = _lib().online_mul(x_digits.data_ptr(), y_digits.data_ptr(),
                                z.data_ptr(), B, cfg.n, S, arr, len(arr),
                                stream)
    if err != 0:
        raise RuntimeError(f"online_mul launch failed: cudaError {err} "
                           f"(B={B} n={cfg.n})")
    launches += 1
    return z


def int_ops(B: int, cfg: OnlinePrecision) -> int:
    """int32 operations B multiplications need: the recurrence (the
    per-step and per-digit counts of matmul_kernel.int_ops) plus packing
    the operand digits and unpacking the product."""
    return B * (cfg.steps * OPS_STEP + cfg.n * (OPS_DIGIT + OPS_PACK))
