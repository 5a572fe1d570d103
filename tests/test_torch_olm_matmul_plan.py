"""K1's and K2's host-side launch plan, their in-thread adder tree and
their chunked accumulation order, on the CPU.

`matmul_kernel.launch_plan` is the part of `csrc/olm_matmul.cu`'s geometry
the host computes: bm rows x bn columns x tb K tiles a block, one thread
each, and the chunks of tb tiles a block walks. These tests hold it to
what the kernel needs: every (output, K tile) run exactly once, blocks of
a whole number of warps, shared memory inside the 227 KB a block may ask
for. The kernel's tree (one thread runs a tile's lanes two at a time and
merges each level-1 node into a stack of pending nodes) and its f32
accumulation (one thread an output, chunk by chunk, tile by tile) are
replayed here on the reference's own pieces and held to `adder_tree` and
`olm_matmul_ref` bit for bit."""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels.common import decode_stream, decode_stream_wide
from repro_torch.kernels.online_dot import matmul_kernel as k12
from repro_torch.kernels.online_dot.matmul import (_quantize_tiles,
                                                   _tile_plan, olm_matmul_ref)
from repro_torch.kernels.online_dot.ref import adder_tree, tree_levels
from repro_torch.kernels.online_mul.ref import online_mul_batch_ref

WIDTHS = (8, 10, 12, 16, 20, 24, 32)
MS = (1, 3, 4, 5, 16, 17, 64)
NS = (1, 37, 2048, 8192, 92544)
KS = (1, 3, 15, 16, 17, 33, 2048, 8192)


def _once(parts, total):
    seen = [v for p in parts for v in p]
    return sorted(seen) == list(range(total))


@pytest.mark.parametrize("n", WIDTHS)
def test_plan_runs_every_output_tile_once_and_fits(n):
    formats = [(False, False), (True, False)] + ([(True, True)]
                                                 if n % 4 == 0 else [])
    for (M, N, K), (host, vec) in itertools.product(
            itertools.product(MS, NS, KS), formats):
        plan = k12.launch_plan(M, N, K, n, host=host, vec=vec)
        kt = min(16, K)
        T = -(-K // kt)
        where = (M, N, K, host, vec)
        assert (plan.kt, plan.T) == (kt, T), where
        # powers of two, whole warps, at most 256 threads
        for v in (plan.bm, plan.bn, plan.tb):
            assert v & (v - 1) == 0, where
        assert plan.threads % 32 == 0 and plan.threads <= k12.MAX_THREADS
        # rows, columns and tiles each covered exactly once, and the
        # threads of a block take every (row, column, tile) of it once
        assert _once([plan.rows_of(b, M) for b in range(plan.grid_y)], M)
        assert _once([plan.cols_of(b, N) for b in range(plan.grid_x)], N)
        assert _once([plan.tiles_of(c) for c in range(plan.chunks)], T)
        roles = {plan.role(t) for t in range(plan.threads)}
        assert roles == set(itertools.product(range(plan.bm), range(plan.bn),
                                              range(plan.tb))), where
        assert plan.smem == k12.smem_bytes(n, host, vec, plan.bm, plan.bn,
                                           plan.tb)
        assert plan.smem <= k12.SMEM_PER_BLOCK, where


def test_plan_at_the_serve_shapes():
    # M=4 decode: 4 rows, 16 columns, 4 tiles a block, 512 blocks; the
    # 64-row prefill: 8 x 32 outputs a block, one tile a chunk
    dec = k12.launch_plan(4, 8192, 2048, 16)
    assert (dec.bm, dec.bn, dec.tb, dec.grid_x, dec.grid_y, dec.chunks) == (
        4, 16, 4, 512, 1, 32)
    pre = k12.launch_plan(64, 2048, 2048, 16)
    assert (pre.bm, pre.bn, pre.tb, pre.grid_x, pre.grid_y, pre.chunks) == (
        8, 32, 1, 64, 8, 128)
    head = k12.launch_plan(4, 92544, 2048, 16)
    assert (head.bm, head.bn, head.tb, head.grid_x) == (4, 64, 1, 1446)
    # shared memory: 80 slices of 17 floats (K1) or 16 rows of 16 words
    # and a scale (K2), 17 masks of 8 bytes a slice, 80 scales, 256 tile values
    assert dec.smem == 80 * 17 * 4 + 80 * 17 * 8 + 80 * 4 + 256 * 4
    host = k12.launch_plan(4, 8192, 2048, 16, host=True, vec=True)
    assert host.smem == 80 * 16 * 16 * 4 + 80 * 4 + 80 * 17 * 8 + 80 * 4 + 256 * 4
    assert k12.row_words(24, True) == 28 and k12.row_words(10, False) == 11
    # the grid gives every SM at least FILL_BLOCKS_PER_SM blocks where the
    # tiles allow it
    for plan in (dec, pre, head):
        assert plan.grid_x * plan.grid_y >= k12.FILL_BLOCKS_PER_SM * 132


def test_plan_takes_fewer_threads_where_shared_memory_asks():
    # K2 at n = 32 with one output: 256 threads would stage 512 slices
    plan = k12.launch_plan(1, 1, 8192, 32, host=True, vec=True)
    assert plan.threads == 32 and plan.smem <= k12.SMEM_PER_BLOCK
    with pytest.raises(ValueError):
        k12.launch_plan(4, 8, 64, 16, k_tile=32)


def _add(a, b):
    """The reference's online adder on two streams."""
    return adder_tree(torch.stack([a, b]))[0]


def _kernel_tree(lanes, L, rng):
    """csrc/olm_matmul.cu's `tile_tree`, step for step: lanes 2p and 2p + 1
    make a level-1 node, merged into the pending nodes s1, s2, s3 as a
    binary counter carries; the last node made is the root. The pending
    nodes start as garbage (the kernel never reads one before it is
    written)."""
    if L == 0:
        return lanes[0]
    m = lanes[0].numel()
    s = [None] + [torch.from_numpy(rng.integers(-1, 2, m + 2 * lv)).int()
                  for lv in (1, 2, 3)]
    root = None
    for p in range(8):
        if p >= 1 << (L - 1):
            continue
        node = _add(lanes[2 * p], lanes[2 * p + 1])
        for lv in (1, 2, 3):
            if not p >> (lv - 1) & 1:
                s[lv] = node
                break
            node = _add(s[lv], node)
        root = node
    return root


@pytest.mark.parametrize("kt", range(1, 17))
def test_kernel_tree_is_the_reference_tree(kt):
    rng = np.random.default_rng(kt)
    L = tree_levels(kt)
    n = 6
    lanes = [torch.from_numpy(rng.integers(-1, 2, n)).int() for _ in range(kt)]
    # lanes past kt hold zero digits, so zero streams; slots past 2^L are
    # never read, so garbage
    slots = (lanes + [torch.zeros(n, dtype=torch.int32)] * ((1 << L) - kt)
             + [torch.from_numpy(rng.integers(-1, 2, n)).int()
                for _ in range(16 - (1 << L))])
    want, levels = adder_tree(torch.stack(lanes))
    assert levels == L
    assert torch.equal(_kernel_tree(slots, L, rng), want)


@pytest.mark.parametrize("n_bits,k_tile", [(16, 16), (32, 16), (8, 5)])
def test_chunked_accumulation_is_the_reference_order(n_bits, k_tile):
    # a ragged shape whose last chunk is part-filled: the kernel's
    # per-tile values (decode * 2^L) * (sx * sw), added by one thread an
    # output chunk by chunk and tile by tile, give olm_matmul_ref's bits
    rng = np.random.default_rng(n_bits + k_tile)
    M, K, N = 5, 16 * 9 + 3, 11
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) * 0.1)
                         .astype(np.float32))
    kt, T, xp, wpT = _tile_plan(x, w, k_tile)
    xd, sx = _quantize_tiles(xp, kt, T, n_bits)
    wd, sw = _quantize_tiles(wpT, kt, T, n_bits)
    cfg = OnlinePrecision(n=n_bits)
    z, _ = online_mul_batch_ref(xd[:, None], wd[None], n=cfg.n)
    stream, L = adder_tree(z)                              # (M, N, T, m)
    decode = decode_stream_wide if stream.shape[-1] > 24 else decode_stream
    inc = (decode(stream) * float(1 << L)) * (sx[:, None, :] * sw[None])
    # on a card of one SM the plan keeps chunks of several tiles
    plan = k12.launch_plan(M, N, K, n_bits, k_tile=k_tile, sms=1)
    assert plan.chunks > 1 and len(plan.tiles_of(plan.chunks - 1)) < plan.tb
    acc = torch.zeros((M, N), dtype=torch.float32)
    for c in range(plan.chunks):
        for t in plan.tiles_of(c):
            acc = acc + inc[..., t]
    want = olm_matmul_ref(x, w, n_bits=n_bits, k_tile=k_tile)
    assert torch.equal(acc.view(torch.int32), want.view(torch.int32))


def _first_design_ops(M, N, K, n, quantize=True):
    """The first design's count, by source operations, with its constants
    pinned: 23 a step, 14 a digit, 78 an adder, 24 a quantized element, 12
    a decode."""
    kt = min(16, K)
    T = -(-K // kt)
    outs = M * N * T
    lane = (n + 3) * 23 + n * 14
    return (outs * kt * lane + outs * (kt - 1) * 78
            + ((M + N) * T * kt * 24 if quantize else 0) + outs * 12)


@pytest.mark.parametrize("n", WIDTHS)
def test_recounted_ops_never_above_the_first_designs(n):
    for M, N, K in itertools.product(MS, NS, KS):
        for quantize in (True, False):
            new = k12.int_ops(M, N, K, n=n, quantize=quantize)
            assert 0 < new <= _first_design_ops(M, N, K, n, quantize)
    # K3 and K4 count their work with the first design's constants, which
    # stay as they were
    assert (k12.OPS_STEP, k12.OPS_DIGIT, k12.OPS_ADDER, k12.OPS_QUANT,
            k12.OPS_DECODE) == (23, 14, 78, 24, 12)


def test_recounted_ops_at_the_serve_shapes():
    # per output tile at olm16: 16 lanes of LANE_DIGIT x 16, 15 adders on
    # 32-bit streams, the tile's own share; olm32 takes the 64-bit adder
    tile = 16 * 16 * k12.LANE_DIGIT + 15 * k12.ADDER_BITS[32] + k12.TILE
    outs = 4 * 8192 * 128
    assert k12.int_ops(4, 8192, 2048, n=16, quantize=False) == outs * tile
    assert (k12.int_ops(4, 8192, 2048, n=16)
            == outs * tile + (4 + 8192) * 2048 * k12.OPS_QUANT)
    tile32 = 16 * 32 * k12.LANE_DIGIT + 15 * k12.ADDER_BITS[64] + k12.TILE
    assert k12.int_ops(4, 8, 16, n=32, quantize=False) == 32 * tile32
