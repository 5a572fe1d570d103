"""Hopper kernel for the batched radix-2 online multiplier: the port of the
TPU kernel `online_mul_pallas` (`repro/kernels/online_mul/kernel.py`).

The kernel is CUDA C++ (`csrc/online_mul.cu`, its header note says what
bounds it and how the design answers that): an unrolled kernel for the
paper's configuration (delay 3, estimate t = 2) at 4 <= n <= 32. Every
other configuration a kernel holds (`check_config`) runs the general
kernel of `csrc/online_dot.cu` at one lane a row, the same function;
`route` decides between them from the configuration. `online_mul_kernel`
checks its operands, allocates the output, launches on the current
stream, raises on a refused launch and counts the launch in `launches`.
It takes CUDA tensors only; the plain PyTorch version of the same function
is `ref.online_mul_batch_ref`.
"""
from __future__ import annotations

import ctypes
from fractions import Fraction

import torch

from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels import build
from repro_torch.kernels.common import checked_schedule, prove_schedule
from repro_torch.kernels.online_dot.matmul_kernel import OPS_DIGIT, OPS_STEP

__all__ = ["online_mul_kernel", "launches", "SOURCE", "check_config",
           "holds", "route", "lane_bits", "recurrence_peak", "int_ops",
           "OPS_PACK", "ROWS", "MAX_STATIC_SMEM", "static_smem"]

SOURCE = "online_mul.cu"

# Launches of the kernel since the count was last set to 0.
launches = 0

# The unrolled recurrence is compiled for the paper's online delay and
# estimate width at 4 <= n <= 32 digits; the general kernel takes up to
# ANY_STEPS steps (n + delta) and output digits.
DELTA, EST = 3, 2
MAX_DIGITS = 32
ANY_STEPS = 64
# The unrolled kernel's block: ROWS rows, one thread each, whose x and y
# digit rows it stages in static shared memory at a stride of n | 1 words
# (csrc/online_mul.cu kRows).
ROWS = 128
# The most static shared memory a block may hold.
MAX_STATIC_SMEM = 48 * 1024


def static_smem(n: int) -> int:
    """Static shared memory of a block of the unrolled kernel at n digits
    (what ptxas reports for online_mul_kernel<n>; the lint phase holds
    the two equal)."""
    return 2 * ROWS * (n | 1) * 4


# int32 operations per operand digit to pack both operands into masks and
# to unpack the product digit (counted from csrc/online_mul.cu).
OPS_PACK = 10


def recurrence_peak(cfg: OnlinePrecision, sched, scale: int) -> int:
    """A bound on every value the recurrence computes (X, Y, term, V, W and
    2W) at datapath scale 2^scale, over all operand digits: each step's
    term bounded by the partial operands, the residual by interval
    arithmetic through the selection, every floor's loss counted. Sound
    and loose: it does not know that the appends telescope to the
    product."""
    n, delta, t = cfg.n, cfg.delta, cfg.t
    unit = 1 << scale
    if t > n + delta:                 # the estimate fills with V's sign
        hi = lo = None
    elif scale >= t:
        hi, lo = 2 << (scale - t), -(2 << (scale - t))
    else:                             # the estimate is V * 2^(t - scale)
        hi, lo = 1, (-1 if t - scale == 1 else 0)
    bx = by = wlo = whi = top = 0
    for s in range(n + delta):
        T, q, j = int(sched[s]), s + 1, s - delta
        wq = 1 << max(scale - q, 0) if q <= min(T, scale) else 0
        loss = (1 << max(scale - T, 0)) - 1
        d = 1 if s < n else 0
        byf = by + d * wq
        bt = (bx + byf) * d
        ba = -(-bt >> delta) if delta >= 0 else 1
        bx, by = bx + d * wq + loss, byf + loss
        vlo, vhi = 2 * wlo - ba - loss, 2 * whi + ba
        top = max(top, byf, bt, bx, by, -2 * wlo, 2 * whi, -vlo, vhi)
        if j >= 0 and hi is not None:
            lows, highs = [], []
            if vhi >= hi:
                lows.append(max(vlo, hi) - unit)
                highs.append(vhi - unit)
            if max(vlo, lo) <= min(vhi, hi - 1):
                lows.append(max(vlo, lo))
                highs.append(min(vhi, hi - 1))
            if vlo < lo:
                lows.append(vlo + unit)
                highs.append(min(vhi, lo - 1) + unit)
            wlo, whi = min(lows) - loss, max(highs)
        else:
            wlo, whi = vlo - loss, vhi
        top = max(top, -wlo, whi)
    return top


def lane_bits(cfg: OnlinePrecision, sched, S: int) -> int | None:
    """The datapath the general lane (olm_lane.cuh `lane_gen`) runs
    `cfg` in: 32 bits where the residual provably stays in int32, 64 where
    it may not but no value of the plain version (at scale 2^(n + delta),
    so none of the kernel's either) can leave int64 (`recurrence_peak`),
    else None: no kernel holds it.

    32 bits takes two conditions. First, the selection must bound the
    residual at all: 3 * 2^-t + 2^(1 - delta) <= 1 and t <= n + delta
    (the estimate's truncation 2^-t, its thresholds +-2^(1 - t) and the
    largest append 2^(1 - delta) against the digit's weight). That leaves
    out delays below 2 and estimates of one digit. It does not bound |V|
    by a constant times 2^S: the selection threshold is 2 * 2^(S - t),
    which at t >= 3 lies well under 2^S, so the residual can grow step by
    step (at (n, delta, t) = (24, 2, 4) to some 2^17 * 2^S;
    probes/int32_headroom.py). Second, therefore, the overflow prover
    (`common.prove_schedule`, the walk of this recurrence that the
    reference's analyzer makes) must show every value within 31 bits; its
    walk is defined where the estimate fits the datapath (t <= S). It
    proves the paper's (3, 2) at every n `checked_schedule` admits; other
    configurations it cannot prove run in the 64-bit lane, with the same
    digits.

    The 64-bit verdict keeps its own walk, `recurrence_peak`: it takes any
    scale (here the plain version's 2^(n + delta), not 2^S) and covers
    what the prover's walk is not defined for, delays below 1 and
    estimates of t <= 0 or t > S, which the 64-bit lane runs."""
    n, delta, t = cfg.n, cfg.delta, cfg.t
    if (t <= n + delta
            and 3 * Fraction(1, 2) ** t + Fraction(2) ** (1 - delta) <= 1
            and t <= S and prove_schedule(cfg)[0] <= 31):
        return 32
    if recurrence_peak(cfg, sched, n + delta) < 1 << 63:
        return 64
    return None


def check_config(cfg: OnlinePrecision) -> tuple:
    """(T(j) as a ctypes array, S, lane bits) for a configuration the CUDA
    recurrence runs; ValueError, naming the case, for one it does not (see
    `holds`)."""
    sched, S = checked_schedule(cfg)
    # The general lane holds n output digits and n + delta steps in 64.
    if not (1 <= cfg.n + cfg.delta and cfg.n <= ANY_STEPS
            and cfg.n + cfg.delta <= ANY_STEPS):
        raise ValueError(
            f"the CUDA online multiplier runs n <= {ANY_STEPS} digits and "
            f"1 <= n + delta <= {ANY_STEPS} steps; got n={cfg.n} "
            f"delta={cfg.delta}")
    bits = lane_bits(cfg, sched, S)
    if bits is None:
        raise ValueError(
            f"n={cfg.n} delta={cfg.delta} t={cfg.t}: the selection does not "
            "bound the residual within int32 (3 * 2^-t + 2^(1 - delta) > 1, "
            "or prove_schedule proves no 31-bit bound) and its bound "
            "leaves int64 at the plain version's scale 2^(n + delta); no "
            "CUDA kernel runs it")
    return (ctypes.c_int * len(sched))(*(int(v) for v in sched)), S, bits


def holds(cfg: OnlinePrecision) -> bool:
    """Whether a CUDA kernel runs `cfg` (decided before any launch); a CUDA
    operand under a configuration none holds raises."""
    try:
        check_config(cfg)
    except ValueError:
        return False
    return True


def route(cfg: OnlinePrecision) -> str:
    """Which kernel runs `cfg`: "unrolled" for the paper's delay and
    estimate width at 4 <= n <= 32, else "any" (online_dot.cu's general
    kernel)."""
    return ("unrolled" if (cfg.delta, cfg.t) == (DELTA, EST)
            and DELTA < cfg.n <= MAX_DIGITS else "any")


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
    if route(cfg) == "any":
        from repro_torch.kernels.online_dot.kernel import launch_any
        z = launch_any(x_digits.view(B, 1, cfg.n), y_digits.view(B, 1, cfg.n),
                       cfg).view(B, cfg.n)
        launches += 1
        return z
    arr, S, _ = check_config(cfg)
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
