"""Hopper kernel for the truncated digit-plane matmul: the port of the TPU
kernel `tpmm_pallas` (`repro/kernels/tpmm/kernel.py`).

The kernel is CUDA C++ (`csrc/tpmm.cu`; its header note says what bounds
it, which order of summation it follows and why splitting K is exact).
Each 64-byte K step of a block tile brings every A and B plane into
shared memory once through a cp.async ring, and the int8 tensor cores
(mma m16n8k32) add every kept plane pair into one int32 accumulator per
level. Where the output tiles are too few to fill the card, K is split
across blocks (`split_plan`): each split adds its int32 level partials
into a zeroed workspace with atomics, exact in any order, and the last
split of a tile to arrive folds it in `tpmm_ref`'s order.

`tpmm_kernel` checks its operands, allocates the output (and, for a split
K, the workspace: one zero fill and one kernel, two device launches a
call), launches on the current stream, raises on a refused launch and
counts the call in `launches`. It takes CUDA tensors only; the plain
PyTorch version of the same function is `ref.tpmm_ref`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from .ref import kept_levels

__all__ = ["tpmm_kernel", "launches", "SOURCE", "tile_shape", "split_plan"]

SOURCE = "tpmm.cu"

# Launches of the kernel since the count was last set to 0.
launches = 0

# The kernel's geometry (csrc/tpmm.cu): K steps of BK bytes, one 16-row
# tile for M up to GEMV_ROWS, WARPS warps a block.
BK = 64
GEMV_ROWS = 16
WARPS = 8
# A split plan aims at WAVES blocks per SM (two fit on one at tpmm16) and
# gives each split at least MIN_SPLIT_K bytes of K.
WAVES = 2
MIN_SPLIT_K = BK
MAX_SPLITS = 65535


def tile_shape(M: int, D: int, levels: int) -> tuple:
    """(rows, columns) of the kernel's output tile, as `csrc/tpmm.cu`'s
    Tile picks it (its `tpmm_tile` reports the same on the card): the
    level accumulators bound the tile."""
    lv = D if (D <= 4 and levels <= D) else 2 * D - 1
    if M <= GEMV_ROWS:
        return 16, WARPS * (2 if lv <= 4 else 1) * 8
    mt = 2 if lv <= 8 else 1
    nt = 1 if lv > 8 else 4 if lv <= 2 else 2 if lv <= 4 else 1
    return 2 * mt * 16, WARPS // 2 * nt * 8


def split_plan(M: int, N: int, K: int, D: int, levels: int, plane_bits: int,
               sms: int = 132) -> tuple:
    """(splits, k_split): K cut into `splits` slices of k_split bytes (a
    multiple of BK; the last slice may be shorter, none is empty), enough
    that the grid of output tiles times splits covers the SMs WAVES times
    where K allows. Raises where the int32 level sum would overflow:
    |digit| <= 2^(b-1), so |sum| <= 2^(2b-2) * D * K, and every partial
    over a slice of K is smaller, so a split K is exact too."""
    if (1 << (2 * plane_bits - 2)) * D * K >= 2 ** 31:
        raise ValueError(f"K={K} overflows the int32 level sum at D={D}, "
                         f"plane_bits={plane_bits}")
    bm, bn = tile_shape(M, D, levels)
    tiles = -(-M // bm) * -(-N // bn)
    want = -(-WAVES * sms // tiles)
    splits = max(1, min(want, -(-K // MIN_SPLIT_K), MAX_SPLITS))
    k_split = BK * -(-K // (BK * splits))
    return -(-K // k_split), k_split


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.tpmm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
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
    dev = a_planes.device
    splits, k_split = split_plan(M, N, K, D, levels, plane_bits,
                                 sms=_sms(dev.index))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    ws = None
    if splits > 1:
        # level partials, then one arrival counter per (16 x 8) tile
        ws = torch.zeros(levels * M * N + -(-M // 16) * -(-N // 8),
                         dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().tpmm(a_planes.data_ptr(), bt.data_ptr(),
                          a_scale.data_ptr(), b_scale.data_ptr(),
                          out.data_ptr(),
                          None if ws is None else ws.data_ptr(), D, M, N, K,
                          levels, plane_bits, splits, k_split, stream)
    if err != 0:
        raise RuntimeError(f"tpmm launch failed: cudaError {err} "
                           f"(D={D} M={M} K={K} N={N} levels={levels} "
                           f"splits={splits})")
    launches += 1
    return out
