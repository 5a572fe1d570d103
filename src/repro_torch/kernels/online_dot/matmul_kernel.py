"""Hopper kernels for the online inner-product array matmul: the ports of
the TPU kernels `olm_matmul_fused_pallas` (K1, quantize in the kernel) and
`olm_matmul_pallas` (K2, operands quantized before the call), both in
`repro/kernels/online_dot/matmul_kernel.py`.

The kernels themselves are CUDA C++ (`csrc/olm_matmul.cu`, one tile body
for both operand formats; its header note says what bounds them and how
the design answers that): one thread per (output, K tile), a block of
bm x bn outputs x tb K tiles walking K in chunks of tb tiles.
`launch_plan` is the host's part of that geometry, plain Python the CPU
tests reach. This module binds the kernels with ctypes:
`olm_matmul_fused` and `olm_matmul_host` check their operands, allocate
the output, launch on the current stream, raise on a refused launch and
count the launch in `launches` and `host_launches`. They take CUDA tensors
only; the plain PyTorch version of both is `matmul.olm_matmul_ref`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels import build
from repro_torch.kernels.common import checked_schedule, decode_policy
from .ref import tree_levels

__all__ = ["olm_matmul_fused", "olm_matmul_host", "launches",
           "host_launches", "SOURCE", "MAX_K_TILE", "Plan", "launch_plan",
           "smem_bytes", "fits", "geometry", "int_ops", "MAX_GRID_Y"]

SOURCE = "olm_matmul.cu"
MAX_K_TILE = 16            # lanes of one tile: L <= 4 tree levels

# The kernel's geometry (csrc/olm_matmul.cu): a block of bm x bn outputs
# x tb K tiles, one thread each, at most 256 threads and a multiple of 32;
# a slice's 16 lanes sit at a stride of 17 in shared memory.
MAX_THREADS = 256
SLICE = 17
SMEM_PER_BLOCK = 232448    # 227 KB: the most a block may ask for
# Grid y's (and z's) limit: row blocks past it continue in grid z.
MAX_GRID_Y = 65535
# Blocks an SM should have to run before the plan stops trading columns
# of a block for K tiles of it.
FILL_BLOCKS_PER_SM = 3

# Launches of each kernel since its count was last set to 0 (a run that
# must show it went through a kernel sets the count to 0, runs, and reads
# it): K1 in `launches`, K2 in `host_launches`.
launches = 0
host_launches = 0


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def row_words(n: int, vec: bool) -> int:
    """Words of one staged digit row of K2 and K3 (csrc/olm_lane.cuh): with
    16-byte copies n / 4 chunks (swizzled when a power of two, else padded
    to an odd count); with 4-byte copies n padded to an odd count. Either
    way the threads of a warp reading their rows hit distinct banks."""
    if not vec:
        return n | 1
    q = n // 4
    return 4 * (q | 1 if q & (q - 1) else q)


def smem_bytes(n: int, host: bool, vec: bool, bm: int, bn: int,
               tb: int) -> int:
    """Shared memory of one block, as csrc/olm_matmul.cu's `layout` counts
    it: the stage of a chunk's raw operands (K1: 17 floats a slice; K2: 16
    digit rows and a scale a slice), the slices' +1/-1 masks (17 lanes of 8 bytes),
    their scales and the chunk's tile values, each rounded up to 16
    bytes."""
    slices = (bm + bn) * tb
    stage = (slices * 16 * row_words(n, vec) * 4 if host
             else slices * SLICE * 4)

    def r16(b):
        return (b + 15) & ~15
    return (r16(stage) + (r16(slices * 4) if host else 0)
            + r16(slices * SLICE * 8) + r16(slices * 4)
            + r16(bm * bn * tb * 4))


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: blocks of bm rows x bn columns x tb K tiles (one thread
    each) on a grid of grid_x column blocks by grid_y row blocks (launched
    as `launch_grid`); every block walks the T tiles in `chunks` chunks of
    tb."""
    bm: int
    bn: int
    tb: int
    T: int
    kt: int
    grid_x: int
    grid_y: int
    chunks: int
    smem: int

    @property
    def threads(self) -> int:
        return self.bm * self.bn * self.tb

    @property
    def launch_grid(self) -> tuple:
        """(x, y, z) of the launch: row blocks past MAX_GRID_Y continue in
        z (csrc/olm_matmul.cu; the blocks past M of the last z return)."""
        return (self.grid_x, min(self.grid_y, MAX_GRID_Y),
                -(-self.grid_y // MAX_GRID_Y))

    def rows_of(self, by: int, M: int) -> range:
        return range(by * self.bm, min(M, (by + 1) * self.bm))

    def cols_of(self, bx: int, N: int) -> range:
        return range(bx * self.bn, min(N, (bx + 1) * self.bn))

    def tiles_of(self, chunk: int) -> range:
        return range(chunk * self.tb, min(self.T, (chunk + 1) * self.tb))

    def role(self, t: int) -> tuple:
        """(row offset, column offset, tile offset) thread t of a block
        computes in every chunk (csrc/olm_matmul.cu: o = t % (bm * bn))."""
        P = self.bm * self.bn
        o = t % P
        return o // self.bn, o % self.bn, t // P


def _pow2_at_most(v: int) -> int:
    return 1 << (max(1, int(v)).bit_length() - 1)


def fits(n: int, host: bool, vec: bool, bm: int, bn: int, tb: int) -> bool:
    """Whether a block of bm x bn outputs x tb K tiles is one the kernel
    launches: powers of two, 32 to MAX_THREADS threads (a multiple of 32)
    and its shared memory within SMEM_PER_BLOCK."""
    threads = bm * bn * tb
    return (all(v >= 1 and v & (v - 1) == 0 for v in (bm, bn, tb))
            and 32 <= threads <= MAX_THREADS
            and smem_bytes(n, host, vec, bm, bn, tb) <= SMEM_PER_BLOCK)


def launch_plan(M: int, N: int, K: int, n: int, *, k_tile: int = MAX_K_TILE,
                host: bool = False, vec: bool = False, sms: int = 132,
                bm: int | None = None, bn: int | None = None,
                tb: int | None = None) -> Plan:
    """The launch geometry of an (M, K) @ (K, N) call at n digits, kt =
    min(k_tile, K) lanes a tile: bm = M's power of two up to 8 rows, then
    the most threads (256 down to 32) whose shared memory fits a block.
    Columns a block holds are traded for K tiles it runs at once while
    the block is wider than N, or the grid gives fewer than
    FILL_BLOCKS_PER_SM blocks an SM, as long as the tiles are there.

    bm, bn and tb pin the block's shape (a DotEngine's block_m / block_n,
    or the autotuner's plan); the planner's choice stands for any knob
    left None. A pin is taken at the power of two at or below it, then the
    largest knob (tb before bn before bm on a tie) is halved until the
    block has at most MAX_THREADS threads and fits shared memory, and tb
    doubled (tiles past T idle) until it has a whole warp. The block shape
    never changes the bits: K tiles add in tile order whatever it is."""
    if min(M, N, K) < 1 or not 1 <= k_tile:
        raise ValueError(f"need M, N, K, k_tile >= 1, got M={M} N={N} K={K}"
                         f" k_tile={k_tile}")
    kt = min(k_tile, K)
    if kt > MAX_K_TILE:
        raise ValueError(f"k_tile {kt} > {MAX_K_TILE}: a tile's tree has at "
                         "most 4 levels")
    T = -(-K // kt)
    free = _planned(M, N, T, n, host, vec, sms)
    if free is None:
        raise ValueError(f"n={n} M={M} N={N} K={K}: no block fits shared "
                         "memory")
    shape = [v if p is None else _pow2_at_most(p)
             for p, v in zip((bm, bn, tb), free)]
    while not fits(n, host, vec, *shape) and math.prod(shape) >= 32:
        big = max(shape)
        shape[max(i for i in (2, 1, 0) if shape[i] == big)] //= 2
    while math.prod(shape) < 32:
        shape[2] *= 2                     # a whole warp, tiles past T idle
    if not fits(n, host, vec, *shape):
        raise ValueError(f"n={n} M={M} N={N} K={K}: no block of the pinned "
                         f"shape {(bm, bn, tb)} fits")
    bm, bn, tb = shape
    return Plan(bm, bn, tb, T, kt, -(-N // bn), -(-M // bm), -(-T // tb),
                smem_bytes(n, host, vec, bm, bn, tb))


def _planned(M: int, N: int, T: int, n: int, host: bool, vec: bool,
             sms: int):
    """The planner's own (bm, bn, tb) for T K tiles (None if no block fits
    shared memory)."""
    bm = min(_pow2_at_least(M), 8)
    for threads in (256, 128, 64, 32):
        bn, tb = threads // bm, 1

        def blocks(bn):
            return -(-M // bm) * -(-N // bn)
        while (bn > 1 and tb < _pow2_at_least(T)
               and (bn > _pow2_at_least(N)
                    or blocks(bn) < FILL_BLOCKS_PER_SM * sms)):
            bn, tb = bn // 2, tb * 2
        while bn > 1 and bn > _pow2_at_least(N):
            bn //= 2                      # no more tiles: fewer threads
        while bm * bn * tb < 32:
            tb *= 2                       # a whole warp, tiles past T idle
        if smem_bytes(n, host, vec, bm, bn, tb) <= SMEM_PER_BLOCK:
            return bm, bn, tb
    return None


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    if lib.olm_matmul_fused.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.olm_matmul_fused.argtypes = [p, p, p, i, i, i, ll, ll, i, i, i,
                                         i, p, i, i, i, i, p]
        lib.olm_matmul_host.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                        p, i, i, i, i, i, p]
        lib.olm_matmul_geometry.argtypes = [i, i, i, i, i, i, i, p, p]
        for fn in (lib.olm_matmul_fused, lib.olm_matmul_host,
                   lib.olm_matmul_geometry):
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def geometry(n: int, host: bool, vec: bool, bm: int, bn: int, tb: int,
             L: int) -> tuple:
    """(shared memory bytes, blocks an SM holds) of a block of the plan,
    as the card reports them."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    err = _lib().olm_matmul_geometry(n, int(host), int(vec), bm, bn, tb, L,
                                     ctypes.byref(smem), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"olm_matmul_geometry failed: cudaError {err} "
                           f"(n={n} host={host} bm={bm} bn={bn} tb={tb})")
    return smem.value, blocks.value


def _schedule(n: int, kt: int):
    """(T(j) as a ctypes array, S, tree levels L) for n working digits over
    a kt-lane tree; raises past the int32 datapath or the decode window."""
    sched, S = checked_schedule(OnlinePrecision(n=n))
    L = tree_levels(kt)
    decode_policy(n + 2 * L)                 # raises past 48 digits
    return (ctypes.c_int * len(sched))(*(int(v) for v in sched)), S, L


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def olm_matmul_fused(x: torch.Tensor, w: torch.Tensor, *, n: int,
                     k_tile: int = MAX_K_TILE, bm: int | None = None,
                     bn: int | None = None,
                     tb: int | None = None) -> torch.Tensor:
    """x (M, K) float32 @ w (K, N) float32 through the fused online
    inner-product array at n working digits, kt = min(k_tile, K) lanes per
    adder tree; returns (M, N) float32. bm, bn and tb pin the launch's
    block shape (`launch_plan`); the bits are the same whatever it is.

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
        raise ValueError(f"k_tile {kt} > {MAX_K_TILE}: a tile's tree has at "
                         "most 4 levels")
    arr, S, L = _schedule(n, kt)
    plan = launch_plan(M, N, K, n, k_tile=kt, sms=_sms(x.device), bm=bm,
                       bn=bn, tb=tb)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().olm_matmul_fused(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
            w.stride(0), w.stride(1), n, kt, L, S, arr, len(arr), plan.bm,
            plan.bn, plan.tb, stream)
    if err != 0:
        raise RuntimeError(f"olm_matmul_fused launch failed: cudaError {err} "
                           f"(M={M} K={K} N={N} n={n} kt={kt})")
    launches += 1
    return out


def olm_matmul_host(xd: torch.Tensor, sx: torch.Tensor, wd: torch.Tensor,
                    sw: torch.Tensor, *, n: int, bm: int | None = None,
                    bn: int | None = None,
                    tb: int | None = None) -> torch.Tensor:
    """The array matmul from pre-quantized operands: row digit grids
    xd (M, T, kt, n) and column grids wd (N, T, kt, n), int32 in
    {-1, 0, 1}, with power-of-two scales sx (M, T) and sw (N, T) float32
    (`matmul._quantize_tiles` makes all four). Returns (M, N) float32.
    bm, bn and tb pin the block shape, as for `olm_matmul_fused`."""
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
        raise ValueError(f"k_tile {kt} > {MAX_K_TILE}: a tile's tree has at "
                         "most 4 levels")
    arr, S, L = _schedule(n, kt)
    vec = (n % 4 == 0 and xd.data_ptr() % 16 == 0
           and wd.data_ptr() % 16 == 0)
    plan = launch_plan(M, N, T * kt, n, k_tile=kt, host=True, vec=vec,
                       sms=_sms(xd.device), bm=bm, bn=bn, tb=tb)
    out = torch.empty((M, N), dtype=torch.float32, device=xd.device)
    with torch.cuda.device(xd.device):
        stream = torch.cuda.current_stream(xd.device).cuda_stream
        err = _lib().olm_matmul_host(
            xd.data_ptr(), sx.data_ptr(), wd.data_ptr(), sw.data_ptr(),
            out.data_ptr(), M, N, T, n, kt, L, S, arr, len(arr), plan.bm,
            plan.bn, plan.tb, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"olm_matmul_host launch failed: cudaError {err} "
                           f"(M={M} T={T} kt={kt} N={N} n={n})")
    host_launches += 1
    return out


# int32 operation counts of the first K1/K2 design (one thread a lane,
# the schedule recomputed in every lane, a shuffle tree), by source
# operations (of csrc/olm_digits.cuh's `mul_digit_loop` and the 64-bit
# `online_add`, now olm_lane.cuh's; a 64-bit logic op or shift counts 2).
# K3's and K4's `int_ops` count their own work with them:
#  - per lane and recurrence step: digit reads 10, Yf 2, term 3,
#    append 2, X 3, Y 1, V 2;
#  - per lane and digit-producing step: estimate 1, selection 4,
#    residual 3, packing the digit 6;
#  - per online adder: 39 64-bit ops;
#  - per quantized element: flush 2, |v| 1, 4 shuffle-max rounds 8,
#    scale bits 8, digit masks 5;
#  - per output and K tile: decode 12.
OPS_STEP, OPS_DIGIT, OPS_ADDER, OPS_QUANT, OPS_DECODE = 23, 14, 78, 24, 12

# K1's and K2's own counts since their redesign: the instructions the
# device functions of csrc/olm_matmul.cu issue, from the SASS that
# probes/digit_sass.py counts (sm_90a, as olm_matmul.cu compiles them):
#  - per lane, LANE_DIGIT an operand digit: `lane_top` issues 218, 442 and
#    912 at n = 8, 16 and 32 (27.25, 27.6 and 28.5 a digit);
#  - per adder, ADDER_BITS at the stream's width: on 32-bit streams the
#    152 instructions a 16-lane tile spends beyond its 16 lanes for its 15
#    adders (the compiler folds the first level into the lanes' ends; one
#    adder alone is 30); on 64-bit streams one adder alone, 58;
#  - per output tile, TILE for its decode and scale fold (10), and
#    OPS_QUANT (the first design's source count) for quantizing an
#    element.
# A 16-lane tile so counts 7072 at n = 16 against the 7224 it issues.
LANE_DIGIT = 27
ADDER_BITS = {32: 10, 64: 58}
TILE = 10

def int_ops(M: int, N: int, K: int, *, n: int, k_tile: int = MAX_K_TILE,
            quantize: bool = True) -> int:
    """Integer instructions one (M, K) @ (K, N) call needs at the datapath
    the kernels run: the recurrence of every real lane, kt - 1 adders per
    output and K tile at the stream's width, the quantization of every row
    and column slice once (K1 only: quantize=False counts K2, whose
    operands arrive quantized), and a decode per output tile. The count of
    work the function needs, not of what the kernels repeat (padded lanes
    and tiles past K)."""
    kt = min(k_tile, K)
    T = -(-K // kt)
    L = tree_levels(kt)
    adder = ADDER_BITS[32 if n + 2 * L <= 32 else 64]
    outs = M * N * T
    quant = (M + N) * T * kt * OPS_QUANT if quantize else 0
    return (outs * kt * n * LANE_DIGIT + outs * (kt - 1) * adder + quant
            + outs * TILE)

