"""Hopper kernel for the batched fused online inner product: the port of the
TPU kernel `online_dot_pallas` (`repro/kernels/online_dot/kernel.py`).

The kernels are CUDA C++ (`csrc/online_dot.cu`, its header note says what
bounds them and how the design answers that): a persistent grid of
blocks, each moving groups through a cp.async stage of at most 256 lanes,
one lane a thread, refilled as soon as it is packed, and reducing each
group's streams in an adder tree that issues each adder once. A group is
`rows` whole rows, or, past MAX_LANES lanes a row, one aligned subtree of
MAX_LANES lanes (a level-10 node of the reference's tree), whose streams
the row's last block merges level by level. Two kernels share that body:
`online_dot_kernel` unrolls the paper's online delay at 4 <= n <= 32 for
any K whose stream fits 64 bits, and `online_dot_any` runs every other
configuration a kernel holds (`holds`) with the recurrence as a loop.
`route` decides between them from the configuration and K; `launch_plan`
is the host's part of their geometry, plain Python the CPU tests reach.

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
           "TREE_LEVELS", "MAX_STREAM", "UNROLLED_STREAM", "THREADS",
           "Plan", "launch_plan", "balanced_blocks", "sm_load", "geometry",
           "holds", "route", "launch_any", "stream_word", "tree_adders",
           "int_ops"]

SOURCE = "online_dot.cu"
MAX_LANES = 1024           # lanes of a group's tree: a level-10 subtree
TREE_LEVELS = 10
MAX_STREAM = 128           # digits of a row's stream, n + 2L, in a word
UNROLLED_STREAM = 64       # the unrolled kernel's widest stream word

# The kernels' geometry (csrc/online_dot.cu): 256 threads a block, one
# lane a thread, so a stage holds 256 lanes; one stage a block.
THREADS = 256
SMEM_PER_BLOCK = 232448    # 227 KB: the most a block may ask for
SMEM_PER_SM = 233472       # 228 KB an SM shares among its blocks
SMEM_RESERVED = 1024       # the runtime's own share of each block
BLOCKS_PER_SM = 2048 // THREADS
MAX_GROUPS = 0x7FFFFFFF // 4
WARP_LEVELS = 7            # tree levels a warp runs (128 level-0 nodes)
LOAD_SLACK = 1.1           # balanced_blocks: an SM's load over the least

# Launches of the kernel since the count was last set to 0.
launches = 0


def stream_word(m: int) -> int:
    """Bytes of the word a stream of m digits is packed in: 4, 8 or 16."""
    return 4 if m <= 32 else 8 if m <= 64 else 16


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: groups of `rows` rows (or, with `trees` > 1, one row's
    aligned subtree of MAX_LANES lanes each), each moved in `subs` stages
    of at most THREADS lanes, run by `grid` persistent blocks of `smem`
    bytes of shared memory; `vec` takes 16-byte copies."""
    rows: int
    subs: int
    groups: int
    grid: int
    smem: int
    vec: bool
    trees: int = 1

    def rows_of(self, block: int, B: int) -> list:
        """The row ranges block `block` runs, in the order it runs them
        (csrc/online_dot.cu: group g goes to block g % grid); a row of
        several subtrees once for each."""
        return [range(r, min(B, r + self.rows)) for r, _, _ in
                (self._group(g, B, None) for g in range(block, self.groups,
                                                         self.grid))]

    def lanes_of(self, block: int, B: int, K: int) -> list:
        """(row, lanes) of each group block `block` runs, in order: the
        range of a row's lanes the group reduces in its tree, once for
        each of its rows."""
        out = []
        for g in range(block, self.groups, self.grid):
            r0, lo, hi = self._group(g, B, K)
            out.extend((r, range(lo, hi))
                       for r in range(r0, min(B, r0 + self.rows)))
        return out

    def _group(self, g: int, B: int, K: int | None) -> tuple:
        """(first row, first lane, end lane) of group g."""
        if self.trees == 1:
            return g * self.rows, 0, K
        row, tree = divmod(g, self.trees)
        lo = tree * MAX_LANES
        return row, lo, None if K is None else min(K, lo + MAX_LANES)


def launch_plan(B: int, K: int, n: int, vec: bool, sms: int = 132,
                blocks_per_sm: int | None = None, *,
                general: bool = False) -> Plan:
    """The launch geometry for B rows of K lanes at n digits: as many whole
    rows a group as fill one stage (one row in several stages past 256
    lanes, one row's aligned subtree of MAX_LANES lanes past MAX_LANES),
    the shared memory that asks for (one stage of x and y and the tree's
    node arrays, in words as wide as the row's stream), and a persistent
    grid of one wave: the SMs times the blocks an SM runs
    (`balanced_blocks`, at most the blocks one holds: `blocks_per_sm`,
    from the card, and what the shared memory allows). The tree's
    level-0 streams are parked in the lane's own word, the nodes past the
    warps' 7 levels in the row's stream word. `general`
    plans `online_dot_any` (streams up to MAX_STREAM digits), else the
    unrolled kernel (streams up to UNROLLED_STREAM); both stage rows of
    `row_words`."""
    L = tree_levels(K) if K >= 1 else 0
    widest = MAX_STREAM if general else UNROLLED_STREAM
    if B < 1 or K < 1 or n + 2 * L > widest:
        raise ValueError(f"need B >= 1, K >= 1 and a stream of n + 2L <= "
                         f"{widest} digits, got B={B} K={K} n={n}")
    lanes = min(K, MAX_LANES)              # a row's lanes in a group's tree
    trees = -(-K // MAX_LANES)
    rows = min(B, max(1, THREADS // lanes))
    subs = -(-rows * lanes // THREADS)
    levels = min(L, TREE_LEVELS)           # of a group's tree
    nodes = rows << levels
    # the level-0 streams in the lane's word (none with one lane a row),
    # the nodes left after the warps' levels in the row's stream word
    zero = nodes if levels else 0
    smem = (8 * THREADS * row_words(n, vec) + 2 * (4 if n <= 32 else 8) * zero
            + 2 * stream_word(n + 2 * L) * (nodes >> min(levels, WARP_LEVELS))
            + 15) & ~15                    # rounded up to 16 bytes
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"n={n} K={K} needs {smem} bytes of shared memory "
                         "a block")
    groups = -(-B // rows) * trees
    if groups > MAX_GROUPS:
        raise ValueError(f"B={B} K={K}: {groups} groups exceed {MAX_GROUPS}")
    fit = min(BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))
    most = fit if blocks_per_sm is None else max(1, min(fit, blocks_per_sm))
    per_sm = balanced_blocks(groups, sms, most)
    return Plan(rows, subs, groups, min(groups, sms * per_sm), smem, vec,
                trees)


def sm_load(groups: int, sms: int, per_sm: int) -> int:
    """The most groups one SM runs under a persistent grid of `per_sm`
    blocks an SM: its blocks times the groups of its busiest block."""
    grid = min(groups, sms * per_sm)
    return -(-grid // sms) * -(-groups // grid)


def balanced_blocks(groups: int, sms: int, most: int) -> int:
    """The blocks an SM runs (at most `most`): the most whose SM load
    (`sm_load`) is within LOAD_SLACK of the least any count gives. Block b
    runs groups b, b + grid, ..., so where the groups do not divide over
    the grid the busiest SM runs up to a block's last group more than the
    mean; with few groups a block that costs 4 stages (one subtree of 1024
    lanes) that tail outweighs the latency another resident block hides
    (K3 at B=512 K=2048 n=16: 5 blocks an SM, 2 groups on 364 of 660
    blocks, against 4 and 2 groups on 496 of 528; probes/
    online_dot_waves.py)."""
    loads = {p: sm_load(groups, sms, p) for p in range(1, most + 1)}
    least = min(loads.values())
    return max(p for p, load in loads.items() if load <= LOAD_SLACK * least)


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
    delay at 4 <= n <= 32 and a stream of n + 2L <= UNROLLED_STREAM
    digits (any K up to 2^30 at n = 4, 2^16 at n = 32), where the
    estimate fits the 32-bit datapath (t <= S) and the selection bounds
    the residual in it (`lane_bits`), else "any"."""
    if not (cfg.delta == DELTA and DELTA < cfg.n <= MAX_DIGITS
            and cfg.n + 2 * tree_levels(K) <= UNROLLED_STREAM):
        return "any"
    _, S, bits = check_config(cfg)
    return "unrolled" if bits == 32 and cfg.t <= S else "any"


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.online_dot
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, ll, i, i, i, i, p, i, i, i, i, i, i, p, p,
                       p]
        fn.restype = ctypes.c_int
        lib.online_dot_any.argtypes = [p, p, p, i, ll, i, i, i, i, i, i, i,
                                       p, i, i, i, i, i, i, p, p, p]
        lib.online_dot_any.restype = ctypes.c_int
        lib.online_dot_geometry.argtypes = [i, i, i, i, i, i, p, p]
        lib.online_dot_geometry.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def geometry(n: int, vec: bool, rows: int, L: int, general: bool = False,
             wide: bool = False) -> tuple:
    """(shared memory bytes, blocks an SM holds) of the unrolled kernel's
    plan, or (general) `online_dot_any`'s with an int32 or (wide) int64
    residual, as the card reports them."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    err = _lib().online_dot_geometry(n, int(vec), rows, L, int(general),
                                     int(wide), ctypes.byref(smem),
                                     ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"online_dot_geometry failed: cudaError {err} "
                           f"(n={n} vec={vec} rows={rows} L={L} "
                           f"general={general} wide={wide})")
    return smem.value, blocks.value


def _card_plan(x_digits: torch.Tensor, y_digits: torch.Tensor,
               general: bool, wide: bool) -> tuple:
    """The plan for checked (B, K, n) CUDA operands on their card (16-byte
    copies where n is a multiple of 4 and both are 16-byte aligned), its
    shared memory held to the kernel's own count, and the subtree scratch
    it needs: (plan, scratch, arrived), the last two None for one tree a
    row."""
    B, K, n = x_digits.shape
    L = tree_levels(K)
    dev = x_digits.device
    vec = (n % 4 == 0 and x_digits.data_ptr() % 16 == 0
           and y_digits.data_ptr() % 16 == 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = launch_plan(B, K, n, vec, sms, general=general)
    smem, per_sm = geometry(n, vec, plan.rows, L, general, wide)
    if smem != plan.smem:
        raise RuntimeError(f"launch_plan counts {plan.smem} bytes of shared "
                           f"memory, the kernel {smem} (n={n} K={K} "
                           f"general={general})")
    plan = launch_plan(B, K, n, vec, sms, per_sm, general=general)
    if plan.trees == 1:
        return plan, None, None
    words = 2 * B * plan.trees * stream_word(n + 2 * L)
    return (plan, torch.empty(words, dtype=torch.uint8, device=dev),
            torch.zeros(B, dtype=torch.int32, device=dev))


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


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
    # the estimate where t > S (olm_lane.cuh `lane_gen`)
    lift = 0 if cfg.t > n + cfg.delta else 1 << min(max(cfg.t - S, 0), 2)
    plan, scratch, arrived = _card_plan(x_digits, y_digits, True,
                                        bits == 64)
    dev = x_digits.device
    z = torch.empty((B, n + 2 * L), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().online_dot_any(
            x_digits.data_ptr(), y_digits.data_ptr(), z.data_ptr(), B, K, L,
            n, cfg.delta, S, cfg.t, lift, int(bits == 64), arr, len(arr),
            plan.rows, plan.subs, plan.trees, plan.grid, int(plan.vec),
            _ptr(scratch), _ptr(arrived), stream)
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
    plan, scratch, arrived = _card_plan(x_digits, y_digits, False, False)
    dev = x_digits.device
    z = torch.empty((B, n + 2 * L), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().online_dot(x_digits.data_ptr(), y_digits.data_ptr(),
                                z.data_ptr(), B, K, L, n, S, cfg.t, arr,
                                len(arr), plan.rows, plan.subs, plan.trees,
                                plan.grid, int(plan.vec), _ptr(scratch),
                                _ptr(arrived), stream)
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
