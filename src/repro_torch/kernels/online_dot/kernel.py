"""Hopper kernel for the batched fused online inner product: the port of the
TPU kernel `online_dot_pallas` (`repro/kernels/online_dot/kernel.py`).

The kernel is CUDA C++ (`csrc/online_dot.cu`, its header note says what
bounds it and how the design answers that): a persistent grid of blocks,
each moving groups of rows through a cp.async stage of at most 256 lanes,
one lane a thread, refilled as soon as it is packed, and reducing each
row's streams in an adder tree that issues each adder once.
`launch_plan` is the host's part of that geometry, plain Python the CPU
tests reach. That kernel runs the paper's online delay at 4 <= n <= 32
and K <= MAX_LANES; `online_dot_any` (the same source) runs every other
configuration a kernel holds (`holds`), in aligned subtrees of 256 lanes
merged as a binary counter carries. `route` decides between them from
the configuration and K.

`online_dot_kernel` checks its operands, allocates the output, launches on
the current stream, raises on a refused launch and counts the launch in
`launches`. It takes CUDA tensors only; the plain PyTorch version of the
same function is `ref.online_dot_batch_ref`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels import build
from repro_torch.kernels.online_mul.kernel import (DELTA, MAX_DIGITS,
                                                   OPS_PACK, check_config)
from .matmul_kernel import OPS_ADDER, OPS_DIGIT, OPS_STEP, row_words
from .ref import tree_levels

__all__ = ["online_dot_kernel", "launches", "SOURCE", "MAX_LANES",
           "MAX_STREAM", "THREADS", "Plan", "launch_plan", "geometry",
           "holds", "route", "launch_any", "tree_adders", "int_ops"]

SOURCE = "online_dot.cu"
MAX_LANES = 1024           # the unrolled kernel's K (node arrays a block)
MAX_STREAM = 128           # digits of a row's stream, n + 2L, in a word

# The kernel's geometry (csrc/online_dot.cu): 256 threads a block, one
# lane a thread, so a stage holds 256 lanes; one stage a block.
THREADS = 256
SMEM_PER_BLOCK = 232448    # 227 KB: the most a block may ask for
SMEM_PER_SM = 233472       # 228 KB an SM shares among its blocks
SMEM_RESERVED = 1024       # the runtime's own share of each block
BLOCKS_PER_SM = 2048 // THREADS

# Launches of the kernel since the count was last set to 0.
launches = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: groups of `rows` rows, each moved in `subs` stages of at
    most THREADS lanes, run by `grid` persistent blocks of `smem` bytes of
    shared memory; `vec` takes 16-byte copies."""
    rows: int
    subs: int
    groups: int
    grid: int
    smem: int
    vec: bool

    def rows_of(self, block: int, B: int) -> list:
        """The row ranges block `block` runs, in the order it runs them
        (csrc/online_dot.cu: group g goes to block g % grid)."""
        return [range(g * self.rows, min(B, (g + 1) * self.rows))
                for g in range(block, self.groups, self.grid)]


def launch_plan(B: int, K: int, n: int, vec: bool, sms: int = 132,
                blocks_per_sm: int | None = None) -> Plan:
    """The launch geometry for B rows of K lanes at n digits: as many whole
    rows a group as fill one stage (one row in several stages past 256
    lanes), the shared memory that asks for (one stage of x and y and the
    tree's node arrays), and a persistent grid of one wave: the SMs times
    the blocks one holds (`blocks_per_sm`, from the card; at most what the
    shared memory allows)."""
    if B < 1 or not 1 <= K <= MAX_LANES:
        raise ValueError(f"need B >= 1 and 1 <= K <= {MAX_LANES}, got B={B} "
                         f"K={K}")
    rows = min(B, max(1, THREADS // K))
    subs = -(-rows * K // THREADS)
    L = tree_levels(K)
    nodes = rows << L
    half = (nodes // 2 + 1) & ~1
    word = 4 if n + 2 * L <= 32 else 8    # a stream's +1 or -1 mask
    smem = (8 * THREADS * row_words(n, vec)
            + 2 * word * (nodes + half))
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"n={n} K={K} needs {smem} bytes of shared memory "
                         "a block")
    groups = -(-B // rows)
    fit = min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))
    per_sm = fit if blocks_per_sm is None else max(1, min(fit, blocks_per_sm))
    return Plan(rows, subs, groups, min(groups, sms * per_sm), smem, vec)


def holds(cfg: OnlinePrecision, K: int) -> bool:
    """Whether a CUDA kernel runs K lanes under `cfg` (decided before any
    launch): the multiplier's configuration (online_mul's `check_config`)
    and a stream of n + 2L digits that fits the general kernel's widest
    word, 128 bits (K up to 2^56 at n = 16: more lanes than a card
    holds). A CUDA operand under a case none holds raises."""
    try:
        check_config(cfg)
    except ValueError:
        return False
    return K >= 1 and cfg.n + 2 * tree_levels(K) <= MAX_STREAM


def route(cfg: OnlinePrecision, K: int) -> str:
    """Which kernel runs K lanes under `cfg`: "unrolled" for the paper's
    delay at 4 <= n <= 32 and K <= MAX_LANES, where the estimate fits the
    32-bit datapath (t <= S) and the selection bounds the residual in it
    (`lane_bits`), else "any"."""
    if not (cfg.delta == DELTA and DELTA < cfg.n <= MAX_DIGITS
            and K <= MAX_LANES):
        return "any"
    _, S, bits = check_config(cfg)
    return "unrolled" if bits == 32 and cfg.t <= S else "any"


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.online_dot
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, i, i, i, i, i, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.online_dot_any.argtypes = [p, p, p, ll, ll, i, i, i, i, i, i, i,
                                       p, i, p]
        lib.online_dot_any.restype = ctypes.c_int
        lib.online_dot_geometry.argtypes = [i, i, i, i, p, p]
        lib.online_dot_geometry.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def geometry(n: int, vec: bool, rows: int, L: int) -> tuple:
    """(shared memory bytes, blocks an SM holds) of the kernel's plan, as
    the card reports them."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    err = _lib().online_dot_geometry(n, int(vec), rows, L, ctypes.byref(smem),
                                     ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"online_dot_geometry failed: cudaError {err} "
                           f"(n={n} vec={vec} rows={rows} L={L})")
    return smem.value, blocks.value


def launch_any(x_digits: torch.Tensor, y_digits: torch.Tensor,
               cfg: OnlinePrecision) -> torch.Tensor:
    """Launch `online_dot_any` on checked (B, K, n) CUDA operands -> the
    (B, n + 2L) stream; ValueError, before any launch, for a case no
    kernel holds. Counts nothing: each wrapper counts its own launches."""
    B, K, n = x_digits.shape
    arr, S, bits = check_config(cfg)
    L = tree_levels(K)
    if n + 2 * L > MAX_STREAM:
        raise ValueError(f"K={K} at n={n}: a row's stream of {n + 2 * L} "
                         f"digits must fit {MAX_STREAM} bits")
    # the estimate where t > S (olm_digits.cuh `lane_any`)
    lift = 0 if cfg.t > n + cfg.delta else 1 << min(max(cfg.t - S, 0), 2)
    dev = x_digits.device
    z = torch.empty((B, n + 2 * L), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().online_dot_any(
            x_digits.data_ptr(), y_digits.data_ptr(), z.data_ptr(), B, K, L,
            n, cfg.delta, S, cfg.t, lift, int(bits == 64), arr, len(arr),
            stream)
    if err != 0:
        raise RuntimeError(f"online_dot_any launch failed: cudaError {err} "
                           f"(B={B} K={K} n={n} delta={cfg.delta} t={cfg.t})")
    return z


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
    if not (x_digits.is_contiguous() and y_digits.is_contiguous()):
        raise ValueError("digit operands must be contiguous")
    if route(cfg, K) == "any":
        z = launch_any(x_digits, y_digits, cfg)
        launches += 1
        return z
    arr, S, _ = check_config(cfg)
    L = tree_levels(K)
    dev = x_digits.device
    vec = (n % 4 == 0 and x_digits.data_ptr() % 16 == 0
           and y_digits.data_ptr() % 16 == 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = launch_plan(B, K, n, vec, sms)
    smem, per_sm = geometry(n, vec, plan.rows, L)
    if smem != plan.smem:
        raise RuntimeError(f"launch_plan counts {plan.smem} bytes of shared "
                           f"memory, the kernel {smem} (n={n} K={K})")
    plan = launch_plan(B, K, n, vec, sms, per_sm)
    z = torch.empty((B, n + 2 * L), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().online_dot(x_digits.data_ptr(), y_digits.data_ptr(),
                                z.data_ptr(), B, K, L, n, S, cfg.t, arr,
                                len(arr), plan.rows, plan.subs, plan.grid,
                                int(vec), stream)
    if err != 0:
        raise RuntimeError(f"online_dot launch failed: cudaError {err} "
                           f"(B={B} K={K} n={n})")
    launches += 1
    return z


def tree_adders(K: int) -> int:
    """Adders the reference's tree runs for K lanes: ceil(k / 2) at each
    level of k nodes (an odd level pairs its last node with a zero
    stream), K - 1 when K is a power of two."""
    total, k = 0, K
    while k > 1:
        k = (k + 1) // 2
        total += k
    return total


def int_ops(B: int, K: int, cfg: OnlinePrecision) -> int:
    """int32 operations B rows of K-lane inner products need: every lane's
    recurrence and packing (online_mul_kernel's count), the adders of one
    tree a row (each issued once), plus unpacking the stream."""
    lane = cfg.steps * OPS_STEP + cfg.n * (OPS_DIGIT + OPS_PACK)
    m = cfg.n + 2 * tree_levels(K)
    return B * (K * lane + tree_adders(K) * OPS_ADDER + m * 4)
