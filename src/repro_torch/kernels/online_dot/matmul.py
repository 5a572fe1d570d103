"""Float matmul lowered through the fused online inner-product array (port
of `repro/kernels/online_dot/matmul.py`).

A float product ``x (M, K) @ w (K, N)`` is computed the way the hardware
array would compute it:

  1. K is cut into tiles of ``k_tile`` lanes (the array width; one adder
     tree reduces one tile).
  2. Each tile's rows of x and columns of w are quantized to n-digit
     signed-digit grids with power-of-two scales (kernels/common).
  3. kt online multipliers run the Fig. 7 recurrence per (m, n) output,
     the online adder tree reduces their digit streams, the
     (n + 2L)-digit stream is decoded exactly, the 2^L tree scale and the
     two quantization scales are folded in, and the tiles accumulate in
     float32 in K-tile order.

`olm_matmul` dispatches on the device of its operands: a CUDA tensor
goes to a hand-written Hopper kernel, a CPU tensor to `olm_matmul_ref`,
the plain version (the reference's broadcast oracle). On the card,
quantize="kernel" (the default) runs matmul_kernel.olm_matmul_fused, the
port of the TPU kernel `olm_matmul_fused_pallas`, which quantizes inside
the kernel; quantize="host" quantizes here and runs
matmul_kernel.olm_matmul_host, the port of `olm_matmul_pallas`, on the
digit grids. All give the same float32 bits: one quantizer specification,
bit-exact digit arithmetic, an exact decode, power-of-two scale products
and the same accumulation order. `digit_traffic` counts the operand
elements each path delivers to the array.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import OnlinePrecision, truncation_schedule
from repro_torch.kernels.common import (decode_policy, decode_stream,
                                        decode_stream_wide, pad_to_multiple,
                                        pow2_scale, sd_quantize)
from repro_torch.kernels.online_mul.ref import online_mul_batch_ref
from .ref import adder_tree, tree_levels

__all__ = ["olm_matmul", "olm_matmul_ref", "olm_error_bound",
           "digit_traffic", "DEFAULT_K_TILE", "DEFAULT_BLOCK_M",
           "DEFAULT_BLOCK_N", "ULP_PER_LANE", "WIDE_DECODE_ULP"]

# Array width: lanes reduced by one adder tree. A numerics parameter: it
# sets the quantization slice and the tree depth, so it stays 16.
DEFAULT_K_TILE = 16

# The reference's output tile for its TPU grid kernels: digit_traffic
# counts operand loads per (block_m, block_n) tile of that grid, so its
# exact-int ledger uses the same defaults.
DEFAULT_BLOCK_M = 8
DEFAULT_BLOCK_N = 8

# Per-lane error ledger in output ulp at 2^-n: 2 quantized operands plus
# 1.1 of multiplier truncation, rounded up.
ULP_PER_LANE = 3.1

# Extra per-lane budget of the wide-decode modes (stream > 24 digits): one
# decode rounding per K tile plus T accumulator roundings, each
# <= kt * 2^-26 at the tile's scale product.
WIDE_DECODE_ULP = 2.0 ** -26


def _olm_cfg(n_bits: int) -> OnlinePrecision:
    """The paper's array configuration at this output precision (delta=3,
    t=2, Eq. 8 truncation, G=2 tail)."""
    return OnlinePrecision(n=n_bits)


def _tile_plan(x: torch.Tensor, w: torch.Tensor, k_tile: int
               ) -> tuple[int, int, torch.Tensor, torch.Tensor]:
    """(lanes per tile kt, tile count T, x zero-padded to (M, T*kt),
    w.T zero-padded to (N, T*kt)). Zero padding is benign: padded lanes
    quantize to all-zero digit grids and contribute exact zeros."""
    K = x.shape[1]
    kt = min(k_tile, K)
    n_tiles = -(-K // kt)
    xp = pad_to_multiple(x.to(torch.float32), kt, 1)
    wp = pad_to_multiple(w.to(torch.float32), kt, 0)
    return kt, n_tiles, xp, wp.T


def _quantize_tiles(rows: torch.Tensor, kt: int, n_tiles: int, n_bits: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, T*kt) rows -> digits (R, T, kt, n_bits) int32, scales (R, T)."""
    R = rows.shape[0]
    d, s = sd_quantize(rows.reshape(R, n_tiles, kt), n=n_bits, axis=2)
    return d, s[..., 0]


def _decode_plan(n_bits: int, kt: int) -> tuple[int, bool]:
    """(tree levels L, wide decode?) for an n_bits-digit stream reduced
    over a kt-lane tree; raises past the 48-digit wide window."""
    L = tree_levels(kt)
    try:
        policy = decode_policy(n_bits + 2 * L)
    except ValueError as e:
        raise ValueError(f"n_bits={n_bits}, k_tile={kt}: {e}") from None
    return L, policy == "wide"


# Lanes the plain version holds at once: K tiles are processed in chunks
# of at most this many (M, N, kt) lanes, to bound its int64 temporaries.
_REF_LANES = 1 << 24


def _broadcast_ref(xd, sx, wd, sw, L, wide, cfg) -> torch.Tensor:
    """Plain body: the row grids (M, 1, kt, n) and column grids
    (1, N, kt, n) of a chunk of K tiles broadcast to the full (M, N, kt)
    lane fan-out, the int64 recurrence, the adder tree and the exact
    decode, then an f32 accumulate in K-tile order."""
    M, T, kt, n = xd.shape
    N = wd.shape[0]
    decode = decode_stream_wide if wide else decode_stream
    acc = torch.zeros((M, N), dtype=torch.float32, device=xd.device)
    kw = dict(n=cfg.n, delta=cfg.delta, t=cfg.t, truncated=cfg.truncated,
              tail_gating=cfg.tail_gating, tail_guard=cfg.tail_guard)
    chunk = max(1, _REF_LANES // (M * N * kt))
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        z, _ = online_mul_batch_ref(xd[:, None, t0:t1], wd[None, :, t0:t1],
                                    **kw)                  # (M, N, c, kt, n)
        stream, _ = adder_tree(z)                          # (M, N, c, n + 2L)
        val = decode(stream) * float(1 << L)
        for ti in range(t0, t1):
            acc = acc + val[..., ti - t0] * (sx[:, ti:ti + 1]
                                             * sw[:, ti].reshape(1, N))
    return acc


def _resolve_trunc(n_bits: int, trunc: int | None) -> int:
    """Working digits: trunc=p runs the whole array at p < n digits."""
    if trunc is not None:
        truncation_schedule(n_bits, trunc)     # validates delta+1 <= p < n
        return trunc
    return n_bits


def _check_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"olm_matmul takes 2-D operands, got x {tuple(x.shape)}"
                         f" and w {tuple(w.shape)}")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"contraction mismatch: x (M,{x.shape[1]}) @ "
                         f"w ({w.shape[0]},N)")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")


def olm_matmul_ref(x: torch.Tensor, w: torch.Tensor, *, n_bits: int = 16,
                   k_tile: int = DEFAULT_K_TILE,
                   trunc: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of `olm_matmul` on any device: (M, N) float32."""
    _check_operands(x, w)
    n_bits = _resolve_trunc(n_bits, trunc)
    cfg = _olm_cfg(n_bits)
    kt, n_tiles, xp, wpT = _tile_plan(x, w, k_tile)
    L, wide = _decode_plan(n_bits, kt)
    xd, sx = _quantize_tiles(xp, kt, n_tiles, n_bits)    # (M,T,kt,n), (M,T)
    wd, sw = _quantize_tiles(wpT, kt, n_tiles, n_bits)   # (N,T,kt,n), (N,T)
    return _broadcast_ref(xd, sx, wd, sw, L, wide, cfg)


def olm_matmul(x: torch.Tensor, w: torch.Tensor, *, n_bits: int = 16,
               k_tile: int = DEFAULT_K_TILE, trunc: int | None = None,
               quantize: str = "kernel", block_m: int | None = None,
               block_n: int | None = None,
               tb: int | None = None) -> torch.Tensor:
    """Matmul through the fused online inner-product array; (M, N) float32.

    trunc=p selects the truncated family `olm{n}t{p}`: the whole array runs
    at p < n working digits. On a CUDA tensor this launches a Hopper
    kernel: quantize="kernel" fuses the quantization into it, so no digit
    grid ever reaches device memory; quantize="host" quantizes first and
    ships the digit grids (the reference grid path). On a CPU tensor both
    run the plain version, which gives the same bits. Raises when
    n_bits + 2 ceil(log2 k_tile) exceeds the 48-digit exact decode window.

    block_m, block_n and tb pin the kernel's block shape (rows, columns
    and K tiles a block runs; None leaves a knob to the planner,
    `matmul_kernel.launch_plan`). They never change the bits, and the
    plain version ignores them. Under quantize="host" a shape whose block
    does not fit K2's larger stage as given (a plan tuned for K1) is
    re-planned, never launched.
    """
    _check_operands(x, w)
    if quantize not in ("kernel", "host"):
        raise ValueError(f"quantize must be 'kernel' or 'host', "
                         f"got {quantize!r}")
    work = _resolve_trunc(n_bits, trunc)
    kt = min(k_tile, x.shape[1])
    _decode_plan(work, kt)                 # refuse unservable streams early
    if x.device.type == "cpu":
        return olm_matmul_ref(x, w, n_bits=work, k_tile=k_tile)
    if x.device.type != "cuda":
        raise ValueError(f"olm_matmul runs on cpu or cuda, got {x.device}")
    from .matmul_kernel import fits, olm_matmul_fused, olm_matmul_host
    knobs = dict(bm=block_m, bn=block_n, tb=tb)
    if quantize == "host":
        if None not in knobs.values() and not all(
                fits(work, True, vec, block_m, block_n, tb)
                for vec in (False, True)):
            knobs = {}
        kt, n_tiles, xp, wpT = _tile_plan(x, w, k_tile)
        xd, sx = _quantize_tiles(xp, kt, n_tiles, work)
        wd, sw = _quantize_tiles(wpT, kt, n_tiles, work)
        return olm_matmul_host(xd.contiguous(), sx.contiguous(),
                               wd.contiguous(), sw.contiguous(), n=work,
                               **knobs)
    # The same f32 casts as _tile_plan; w keeps its layout (a transposed
    # view is read in place).
    return olm_matmul_fused(x.to(torch.float32).contiguous(),
                            w.to(torch.float32), n=work, k_tile=kt, **knobs)


def olm_error_bound(x: torch.Tensor, w: torch.Tensor, *, n_bits: int = 16,
                    k_tile: int = DEFAULT_K_TILE,
                    trunc: int | None = None) -> torch.Tensor:
    """Documented per-element bound on |olm_matmul(x, w) - x @ w|, (M, N)
    float32: per K tile, kt lanes each contribute <= ULP_PER_LANE ulp at
    2^-n times the tile's scale product; trunc=p adds ULP_PER_LANE * 2^-p
    per lane, and the wide decode adds (T + 1) * WIDE_DECODE_ULP."""
    kt, n_tiles, xp, wpT = _tile_plan(x, w, k_tile)
    M, N = xp.shape[0], wpT.shape[0]
    sx = pow2_scale(xp.reshape(M, n_tiles, kt), 2)[..., 0]    # (M, T)
    sw = pow2_scale(wpT.reshape(N, n_tiles, kt), 2)[..., 0]   # (N, T)
    work = n_bits if trunc is None else trunc
    _, wide = _decode_plan(work, kt)
    per_lane = ULP_PER_LANE * 2.0 ** -n_bits
    if trunc is not None:
        per_lane += ULP_PER_LANE * 2.0 ** -trunc
    if wide:
        per_lane += (n_tiles + 1) * WIDE_DECODE_ULP
    per_lane = torch.tensor(per_lane, dtype=torch.float32)
    return kt * per_lane * torch.einsum("mt,nt->mn", sx, sw)


def digit_traffic(M: int, N: int, K: int, *, n_bits: int = 16,
                  k_tile: int = DEFAULT_K_TILE, trunc: int | None = None,
                  block_m: int = DEFAULT_BLOCK_M,
                  block_n: int = DEFAULT_BLOCK_N) -> dict:
    """Operand traffic ledger for one (M, K) @ (K, N) matmul, in elements
    (4 bytes each: int32 digits or float32 tiles) delivered to the array.

    broadcast: both digit grids replicated to (M*N, kt, n) per K tile.
    grid: the host-quantize grid path, each x-row digit grid loaded once
      per (row tile, K tile) and each w-column grid once per (column tile,
      K tile) of a (block_m, block_n) output tiling; reuse =
      broadcast / grid.
    fused: the quantize-in-kernel path, the same loads as raw float tiles,
      n_bits times fewer elements than their digit grids.
    trunc=p streams p-digit grids instead of n-digit ones, so the digit
    columns shrink by exactly p/n while the float tiles do not.
    """
    if trunc is not None and not 0 < trunc < n_bits:
        raise ValueError(f"trunc must satisfy 0 < trunc < n_bits={n_bits}; "
                         f"got {trunc}")
    work = n_bits if trunc is None else trunc
    kt = min(k_tile, K)
    n_tiles = -(-K // kt)
    bm = max(1, min(block_m, M))
    bn = max(1, min(block_n, N))
    m_tiles = -(-M // bm)
    n_out_tiles = -(-N // bn)
    per_grid = kt * work                        # one row/column digit grid
    loads = m_tiles * bm * n_out_tiles + n_out_tiles * bn * m_tiles
    broadcast = 2 * M * N * per_grid * n_tiles
    grid = loads * per_grid * n_tiles
    fused = loads * kt * n_tiles
    return {
        "broadcast_elems": broadcast,
        "grid_elems": grid,
        "fused_elems": fused,
        "broadcast_bytes": 4 * broadcast,
        "grid_bytes": 4 * grid,
        "fused_bytes": 4 * fused,
        "reuse": broadcast / grid,
        "fused_reuse": broadcast / fused,
        "fused_vs_grid": grid / fused,
    }
