"""Transformer building blocks: RMSNorm, full and half RoPE, GQA attention
(optional qkv bias and sliding window, plain and flash) with the
contiguous, ring and paged KV caches, SwiGLU and GELU MLPs, embed/unembed
(port of `repro/models/layers.py`, the dense-decoder subset).

Params are plain dicts of tensors. Every weight-bearing matmul goes
through `core.numerics.DotEngine`, so the model runs under any registered
numerics mode. The attention score and value contractions are plain
PyTorch, as they are plain jnp outside any Pallas kernel in the
reference. Shapes: x (B, S, d_model), q (B, S, Hq, Dh), kv (B, S, Hkv, Dh).

Cache updates are made in place (the reference returns new arrays):
an engine's KV pool is the largest tensor it holds, and a copy per layer
per step would double its traffic.

`attention_apply`, `mlp_apply`, `embed` and `unembed` take an optional
partition context `part` (`distributed/partition.py`: the mesh, the
Sharder and this rank's place on `model`). With None they run on whole
tensors, as on one device. With one, each runs on this rank's blocks at
the Sharder's specs and moves what it must through the context's c10d
collectives: the partitioned serve steps
(`distributed/train.py::jit_prefill_step` / `jit_decode_step`).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.numerics import DotEngine
from .config import ModelConfig

Params = Dict[str, Any]

__all__ = ["TRASH_BLOCK", "FLASH_MIN_ELEMS", "dense_init", "rmsnorm",
           "apply_rope", "paged_pool_write", "paged_pool_view",
           "paged_scatter_rows",
           "attention_init", "attention_apply", "mlp_init", "mlp_apply",
           "embedding_init", "embed", "unembed"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device) -> torch.Tensor:
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(dtype)        # in place: one f32 copy at most


# --------------------------------------------------------------------------
# norms and rotary embeddings
# --------------------------------------------------------------------------

def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def rope_angles(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, dim/2)."""
    idx = torch.arange(0, dim, 2, dtype=torch.float32,
                       device=positions.device)
    inv = 1.0 / (theta ** (idx / dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, style: str,
               theta: float) -> torch.Tensor:
    """x (B, S, H, Dh). style "full" rotates every head dim; "half"
    (ChatGLM's 2-D RoPE) rotates the first Dh // 2 dims and passes the
    rest through. The rotated dims pair up interleaved (0::2 with 1::2),
    and the frequencies run over the rotated width."""
    B, S, H, Dh = x.shape
    rot = Dh if style == "full" else Dh // 2
    cos, sin = rope_angles(positions, rot, theta)
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xr = x[..., :rot].to(torch.float32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(B, S, H, rot)
    if rot < Dh:
        out = torch.cat([out, x[..., rot:].to(torch.float32)], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# paged KV cache plumbing (block pools + per-lane block tables)
# --------------------------------------------------------------------------
#
# A paged cache holds a per-layer block pool (num_blocks, block_size, H, D)
# and a per-lane block table (B, max_blocks_per_lane) of pool indices.
# Block 0 is the reserved TRASH block: unowned table entries point at it,
# so padding rows and idle decode lanes write their garbage there. View
# slot t of a lane holds absolute position t, exactly the contiguous
# layout, so causal masking makes the paged read bit-identical to the
# contiguous one. Out-of-range table ids also go to the trash block.

TRASH_BLOCK = 0


def _sanitize(table: torch.Tensor, num_blocks: int) -> torch.Tensor:
    table = table.to(torch.int64)
    ok = (table >= 0) & (table < num_blocks)
    return torch.where(ok, table, torch.full_like(table, TRASH_BLOCK))


def paged_pool_write(pool: torch.Tensor, table: torch.Tensor,
                     lane_pos: torch.Tensor, vals: torch.Tensor) -> None:
    """Write one decode step's k or v (B, 1, H, D) into the pool, in place:
    lane b writes position lane_pos[b] through its table row."""
    NB, bs = pool.shape[0], pool.shape[1]
    table = _sanitize(table, NB)
    lane_pos = lane_pos.to(torch.int64)
    blk = (lane_pos // bs).clamp(0, table.shape[1] - 1)
    off = lane_pos - (lane_pos // bs) * bs
    bid = table[torch.arange(table.shape[0], device=table.device), blk]
    pool[bid, off] = vals[:, 0].to(pool.dtype)


def paged_pool_view(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Each lane's owned blocks as a contiguous (B, MBL * bs, H, D) view;
    unowned slots read the trash block (always causally masked)."""
    NB, bs, H, D = pool.shape
    B, MBL = table.shape
    return pool[_sanitize(table, NB)].reshape(B, MBL * bs, H, D)


def paged_scatter_rows(pool: torch.Tensor, rows: torch.Tensor,
                       scatter_table: torch.Tensor) -> None:
    """Scatter contiguous prefill rows (Bp, S, H, D) into the pool, in
    place, through scatter_table (Bp, ceil(S/bs)); entries past a row's
    owned blocks, and whole padding rows, point at the trash block."""
    NB, bs, H, D = pool.shape
    Bp, S = rows.shape[:2]
    pad = (-S) % bs
    if pad:
        rows = torch.cat([rows, rows.new_zeros((Bp, pad, H, D))], dim=1)
    nb = rows.shape[1] // bs
    blocks = rows.reshape(Bp * nb, bs, H, D).to(pool.dtype)
    ids = scatter_table.reshape(-1).to(torch.int64)
    owned = ids != TRASH_BLOCK            # trash absorbs the rest
    pool[ids[owned]] = blocks[owned]


# --------------------------------------------------------------------------
# attention (GQA)
# --------------------------------------------------------------------------

Keep = Callable[[str, torch.Tensor], torch.Tensor]


def _whole(name: str, t: torch.Tensor) -> torch.Tensor:
    return t


def attention_init(gen: torch.Generator, cfg: ModelConfig, device,
                   keep: Keep = _whole) -> Params:
    """`keep(name, leaf)` takes each leaf as it is drawn, before the next
    draw, and returns what the tree holds (Model.init)."""
    d, dt = cfg.d_model, cfg.pdtype
    p = {}
    for key, (d_in, d_out) in (("wq", (d, cfg.d_head_total)),
                               ("wk", (d, cfg.d_kv_total)),
                               ("wv", (d, cfg.d_kv_total)),
                               ("wo", (cfg.d_head_total, d))):
        p[key] = keep(key, dense_init(gen, d_in, d_out, dt, device))
    if cfg.qkv_bias:
        for key, width in (("bq", cfg.d_head_total), ("bk", cfg.d_kv_total),
                           ("bv", cfg.d_kv_total)):
            p[key] = keep(key, torch.zeros((width,), dtype=dt,
                                           device=device))
    return p


# At S * T >= FLASH_MIN_ELEMS attention runs the chunked online softmax
# (`_attn_flash`), below it the plain one, where the reference switches.
FLASH_MIN_ELEMS = 512 * 1024


def _valid(kp, qpos, *, causal: bool, window: Optional[int]):
    """Which (query, key) pairs attend: kp (B|1, T) key positions (-1 =
    empty slot), qpos (B, S); a (B|1, 1, S|1, T) mask."""
    valid = (kp >= 0)[:, None, None, :]
    if causal:
        rel = kp[:, None, :] <= qpos[:, :, None]        # (B, S, T)
        valid = valid & rel[:, None]
        if window is not None:
            wn = kp[:, None, :] > qpos[:, :, None] - window
            valid = valid & wn[:, None]
    return valid


def _attn_plain(q, k, v, qpos, kpos, *, causal: bool,
                window: Optional[int] = None) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,H,D) with kv already repeated to q heads;
    qpos (B,S), kpos (T,) or (B,T) absolute positions (-1 = empty)."""
    D = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32)
    scores = scores / (D ** 0.5)
    kp = kpos if kpos.ndim == 2 else kpos[None]         # (B|1, T)
    valid = _valid(kp, qpos, causal=causal, window=window)
    scores = scores.masked_fill(~valid, torch.finfo(torch.float32).min)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", w, v)


def _attn_flash(q, k, v, qpos, kpos, *, causal: bool,
                window: Optional[int] = None, chunk: int = 1024
                ) -> torch.Tensor:
    """Online-softmax attention over key/value chunks of `chunk` slots, in
    order (the reference's scan): O(S * chunk) scores a head instead of
    O(S * T). The score and probability tiles are bf16 when q is, f32
    otherwise; their products accumulate in f32, as do m, l and acc.
    Masked scores are -inf, and the m_safe / corr guards keep a wholly
    masked chunk from touching l and acc. Same signature as the plain
    path."""
    B, S, H, D = q.shape
    T = k.shape[1]
    chunk = min(chunk, T)
    kp2 = kpos if kpos.ndim == 2 else kpos[None]
    pad = (-T) % chunk
    if pad:
        k = torch.cat([k, k.new_zeros((B, pad, H, D))], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad, H, D))], dim=1)
        kp2 = torch.cat([kp2, kp2.new_full((kp2.shape[0], pad), -1)], dim=1)
    tile_dt = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    # a product of two tile_dt values is exact in f32: rounding the
    # operands, then multiplying and summing in f32, is a tile_dt matmul
    # with an f32 result
    qt = q.to(tile_dt).to(torch.float32)
    scale = 1.0 / (D ** 0.5)
    m = q.new_full((B, H, S), float("-inf"), dtype=torch.float32)
    l = q.new_zeros((B, H, S), dtype=torch.float32)
    acc = q.new_zeros((B, H, S, D), dtype=torch.float32)
    for c in range(k.shape[1] // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        kb = k[:, sl].to(tile_dt).to(torch.float32)
        vb = v[:, sl].to(tile_dt).to(torch.float32)
        s = torch.einsum("bshd,bthd->bhst", qt, kb) * scale
        valid = _valid(kp2[:, sl], qpos, causal=causal, window=window)
        s = s.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p_ = torch.exp(s - m_safe[..., None])
        p_ = p_.masked_fill(~valid, 0.0).to(tile_dt).to(torch.float32)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros_like(m))
        l = l * corr + p_.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthd->bhsd", p_, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(v.dtype)              # (B,S,H,D)


def _attn_core(q, k, v, qpos, kpos, *, causal: bool,
               window: Optional[int] = None) -> torch.Tensor:
    """GQA by repeating each kv head over its query group; the flash path
    from S * T >= FLASH_MIN_ELEMS on."""
    S, Hq = q.shape[1], q.shape[2]
    T, Hkv = k.shape[1], k.shape[2]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    if S * T >= FLASH_MIN_ELEMS:
        return _attn_flash(q, k, v, qpos, kpos, causal=causal, window=window)
    return _attn_plain(q, k, v, qpos, kpos, causal=causal, window=window)


def _col(eng: DotEngine, x: torch.Tensor, w: torch.Tensor, part
         ) -> torch.Tensor:
    """x @ w for a column-parallel w: this rank's columns under `part`."""
    return eng.dot(x, w) if part is None else part.col(eng, x, w)


def _row(eng: DotEngine, x: torch.Tensor, w: torch.Tensor, part
         ) -> torch.Tensor:
    """x @ w for a row-parallel w: this rank's K block under `part`, the
    partials summed over `model`."""
    return eng.dot(x, w) if part is None else part.row(eng, x, w)


def _ring_positions(lane_pos: torch.Tensor, slots: torch.Tensor, T: int
                    ) -> torch.Tensor:
    """(B, len(slots)): the absolute position each lane's ring of T slots
    holds in `slots` after its newest write at lane_pos (B,), as slot s
    holds position p with s == p mod T; -1 where none is held yet."""
    newest = lane_pos[:, None]
    kpos = newest - torch.remainder(newest - slots[None], T)
    return torch.where(kpos >= 0, kpos, torch.full_like(kpos, -1))


def _attn_partial(q, k, v, qpos, kpos, part,
                  window: Optional[int] = None) -> torch.Tensor:
    """Causal attention of q (B, S, H, D), inside `window` where one is
    given, over the keys of every rank along `model`, each rank holding
    the slots at positions kpos (T,) or (B, T) (-1 = empty) of k / v
    (B, T, Hkv, D): the partial softmax (the largest score, the sum
    of the weights, the weighted values) over this rank's slots, combined
    over the ranks by an all-reduce of the largest score and one of the
    rescaled sums, as a flash chunk is folded into its running sums. Tiles
    and weights are rounded through bf16 where q is bf16, their products
    summed in f32, as in `_attn_flash`; each query head reads kv head
    h // (H / Hkv) without repeating the cache."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    tile = torch.bfloat16 if q.dtype == torch.bfloat16 else torch.float32
    qt = q.to(tile).to(torch.float32).reshape(B, S, -1, G, D)
    kt = k.to(tile).to(torch.float32)
    vt = v.to(tile).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qt, kt) * (1.0 / D ** 0.5)
    valid = _valid(kpos if kpos.ndim == 2 else kpos[None], qpos,
                   causal=True, window=window)
    s = s.reshape(B, H, S, -1).masked_fill(~valid, float("-inf"))
    m = part.max(s.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(s - m_safe[..., None]).masked_fill(~valid, 0.0)
    w = w.to(tile).to(torch.float32)
    acc = torch.einsum("bkgst,btkd->bkgsd",
                       w.reshape(B, -1, G, S, w.shape[-1]), vt)
    sums = part.sum(torch.cat([w.sum(dim=-1)[..., None],
                               acc.reshape(B, H, S, D)], dim=-1))
    out = sums[..., 1:] / torch.clamp(sums[..., :1], min=1e-30)
    return out.transpose(1, 2).to(v.dtype)


def _rank_heads(q, k, v, qpos, kpos, part, H: int, *, causal: bool,
                window: Optional[int] = None, rope=None) -> torch.Tensor:
    """Attention of this rank's whole query heads (`Partition.head_range`)
    over whole k and v (B, T, Hkv, D): q holds this rank's columns of the
    projection, gathered whole over `model` first where the H heads do not
    divide it; `rope`, where given, rotates the rank's query heads. Query
    head h reads kv head h // (H / Hkv). Returns this rank's columns of
    the output (B, S, H * D / model), the heads' outputs gathered over
    `model` where they do not divide it (`Partition.heads_to_columns`)."""
    B, S = q.shape[:2]
    Hkv, D = k.shape[2], k.shape[3]
    h0, h1 = part.head_range(H)
    even = H % part.size == 0
    q = q.reshape(B, S, -1, D) if even else \
        part.gather(q, -1).reshape(B, S, H, D)[:, :, h0:h1]
    if rope is not None:
        q = rope(q)
    kv = torch.arange(h0, h1, device=q.device) // (H // Hkv)
    out = _attn_core(q, k.index_select(2, kv), v.index_select(2, kv), qpos,
                     kpos, causal=causal, window=window)
    return out.reshape(B, S, -1) if even else part.heads_to_columns(out, H)


def _attention_by_length(p: Params, cfg: ModelConfig, q, k, v,
                         positions: torch.Tensor, eng: DotEngine,
                         cache: Dict[str, Any], part) -> torch.Tensor:
    """A partitioned attention layer whose KV cache is split over its
    length (n_kv_heads does not divide `model`): q, k, v hold this rank's
    columns of the projections, the cache this rank's block of T slots of
    the whole cache's T * model. Every rank gathers the new tokens' k and
    v whole over `model` (their columns can cut a head). A decode step
    writes its slot on the rank that owns it, gathers q whole and combines
    the partial softmax of every rank's slots (`_attn_partial`); a
    prefill stores this rank's slot range and attends over the prompt for
    this rank's whole query heads (`_rank_heads`).

    A whole cache of exactly `cfg.sliding_window` slots is a ring, as in
    `attention_apply`: a decode writes slot pos mod T * model and attends
    through each lane's slot -> position map of this rank's slots; a
    prefill longer than the ring keeps its last T * model entries, each
    in slot p mod T * model (the whole path's roll). Every attention
    applies the window. Returns the layer's output after the
    row-parallel wo."""
    B, S = q.shape[:2]
    Dh, H, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    window = cfg.sliding_window
    rope = functools.partial(apply_rope, positions=positions,
                             style=cfg.rope_style, theta=cfg.rope_theta)
    k = rope(part.gather(k, -1).reshape(B, S, Hkv, Dh))
    v = part.gather(v, -1).reshape(B, S, Hkv, Dh)
    ck, cv = cache["k"], cache["v"]
    T = ck.shape[1]
    whole = T * part.size
    ring = window is not None and whole == window
    lo = part.rank * T
    slots = lo + torch.arange(T, device=q.device)       # this rank's
    if S == 1:
        q = rope(part.gather(q, -1).reshape(B, 1, H, Dh))
        lane_pos = positions[:, 0].to(torch.int64)
        slot = (torch.remainder(lane_pos, whole) if ring else
                torch.clamp(lane_pos, max=whole - 1)) - lo
        mine = ((slot >= 0) & (slot < T))[:, None, None]
        slot = slot.clamp(0, T - 1)
        lanes = torch.arange(B, device=q.device)
        ck[lanes, slot] = torch.where(mine, k[:, 0].to(ck.dtype),
                                      ck[lanes, slot])
        cv[lanes, slot] = torch.where(mine, v[:, 0].to(cv.dtype),
                                      cv[lanes, slot])
        kpos = _ring_positions(lane_pos, slots, whole) if ring else slots
        out = _attn_partial(q, ck, cv, positions, kpos, part, window)
        n = H * Dh // part.size
        out = out.reshape(B, 1, H * Dh)[..., part.rank * n:
                                        (part.rank + 1) * n]
    else:
        if S > whole and not ring:
            raise ValueError(f"a partitioned prefill of {S} tokens into a "
                             f"cache of {whole} slots")
        # slot s holds the last prompt position p == s mod whole; the
        # first slots of a ring the prompt does not reach stay as they are
        n = T if S >= whole else max(0, min(S - lo, T))
        src = (slots + whole * torch.div(S - 1 - slots, whole,
                                         rounding_mode="floor"))[:n]
        ck[:, :n] = k.index_select(1, src).to(ck.dtype)
        cv[:, :n] = v.index_select(1, src).to(cv.dtype)
        out = _rank_heads(q, k, v, positions,
                          torch.arange(S, device=q.device), part, H,
                          causal=True, window=window, rope=rope)
    return _row(eng, out, p["wo"], part)


def attention_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, eng: DotEngine, *,
                    kv_cache: Optional[Dict[str, Any]] = None,
                    memory: Optional[torch.Tensor] = None,
                    causal: bool = True, chunked: bool = False, part=None
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Self-attention with an optional KV cache and sliding window, or
    cross-attention to `memory` (B, M, d): q from x, k and v from the
    memory through eng.dot, recomputed on every call (no cache), no RoPE,
    no window and no causal mask.

    {"k","v"} is the contiguous per-lane cache; {"kpool","vpool","table"}
    the paged one (decode steps only: prefill goes through
    a contiguous row cache that the serving engine scatters into the
    pool). An S == 1 call with a cache is a decode step that writes at
    each lane's own position; `chunked=True` treats an S > 1 call the
    same way (chunked prefill: each lane writes S entries from its own
    position and attends over the whole cache, so earlier chunks stay
    visible); any other S > 1 call is a fresh prefill that fills slots
    0..S-1.

    A contiguous cache of exactly `cfg.sliding_window` slots is a ring:
    slot s holds position p with s == p mod T. A decode step writes at
    lane_pos mod T and attends through the lane's slot -> position map; a
    prefill longer than the ring keeps its last T entries, rolled into
    place; a chunked call on a ring raises. Returns (output (B,S,d), the
    updated cache or None).

    With a partition context `part` the layer runs on this rank's blocks:
    wq, wk, wv (and their biases) column-parallel, wo row-parallel (x
    and the memory enter the rank's columns once, `Partition.enter`). Where
    the layer's n_kv_heads divide `model` it attends over this rank's
    heads, the code below on them: a self-attention layer's cache is this
    rank's block over its kv heads (a ring too), cross-attention reads
    this rank's kv heads of the memory (whole over `model` on every rank)
    and the encoder's cache-less layers theirs of x. Otherwise a layer
    with a cache keeps its block over its length
    (`_attention_by_length`), and a cache-less one (cross-attention, the
    encoder) gathers k and v whole over `model` and attends for this
    rank's whole query heads (`_rank_heads`). It takes the contiguous cache
    of a prefill or decode step: no chunks, no paged pool. Without a
    cache (the train step's call) it attends over the sequence, by heads
    or through `_rank_heads`, the window a mask as on one device."""
    B, S, d = x.shape
    Dh = cfg.head_dim
    src = x if memory is None else memory
    if part is not None and (chunked or (kv_cache is not None
                                         and "kpool" in kv_cache)):
        raise NotImplementedError(
            "a partitioned attention layer takes the contiguous KV cache "
            "of a prefill or decode step, not chunks or a paged pool")
    if part is not None:
        x = part.enter(x)
        src = x if memory is None else part.enter(memory)
    q = _col(eng, x, p["wq"], part)
    k = _col(eng, src, p["wk"], part)
    v = _col(eng, src, p["wv"], part)
    if cfg.qkv_bias:
        # in the GEMM output's dtype, as the reference adds them
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    T = src.shape[1]
    rope = functools.partial(apply_rope, positions=positions,
                             style=cfg.rope_style, theta=cfg.rope_theta)
    if part is not None and cfg.n_kv_heads % part.size:
        if kv_cache is not None:
            return _attention_by_length(p, cfg, q, k, v, positions, eng,
                                        kv_cache, part), kv_cache
        k = part.gather(k, -1).reshape(B, T, cfg.n_kv_heads, Dh)
        v = part.gather(v, -1).reshape(B, T, cfg.n_kv_heads, Dh)
        kpos = torch.arange(T, device=x.device)
        if memory is not None:
            out = _rank_heads(q, k, v, positions, kpos, part, cfg.n_heads,
                              causal=False)
        else:
            out = _rank_heads(q, rope(k), v, positions, kpos, part,
                              cfg.n_heads, causal=causal,
                              window=cfg.sliding_window, rope=rope)
        return _row(eng, out, p["wo"], part), None
    # this rank's heads under a partition context, every head without
    q = q.reshape(B, S, -1, Dh)
    k = k.reshape(B, T, -1, Dh)
    v = v.reshape(B, T, -1, Dh)
    if memory is not None:
        out = _attn_core(q, k, v, positions,
                         torch.arange(T, device=x.device), causal=False)
        return _row(eng, out.reshape(B, S, -1), p["wo"], part), None
    q, k = rope(q), rope(k)
    window = cfg.sliding_window

    if kv_cache is not None and "kpool" in kv_cache:
        if S != 1:
            raise ValueError(
                "paged KV cache supports decode steps only (S == 1); "
                "prefill goes through a contiguous row cache that the "
                "serving engine scatters into the pool")
        table = kv_cache["table"]
        lane_pos = positions[:, 0]
        paged_pool_write(kv_cache["kpool"], table, lane_pos, k)
        paged_pool_write(kv_cache["vpool"], table, lane_pos, v)
        ck = paged_pool_view(kv_cache["kpool"], table)
        cv = paged_pool_view(kv_cache["vpool"], table)
        kpos = torch.arange(ck.shape[1], device=x.device)
        out = _attn_core(q, ck, cv, positions, kpos, causal=causal,
                         window=window)
    elif kv_cache is not None and (S == 1 or chunked):
        # decode / chunked prefill: per-lane write of S entries at each
        # lane's own position (lanes in a serving pool sit at different
        # depths), then attend over the whole cache
        ck, cv = kv_cache["k"], kv_cache["v"]
        T = ck.shape[1]
        ring = window is not None and T == window
        lane_pos = positions[:, 0].to(torch.int64)
        if ring:
            if S != 1:
                raise ValueError(
                    "chunked prefill does not support sliding-window ring "
                    "caches; disable prefill chunking for SWA models")
            idx = torch.remainder(lane_pos, T)
        else:
            idx = torch.clamp(lane_pos, max=T - S)
        lanes = torch.arange(B, device=x.device)[:, None]
        slots = idx[:, None] + torch.arange(S, device=x.device)
        ck[lanes, slots] = k.to(ck.dtype)
        cv[lanes, slots] = v.to(cv.dtype)
        kpos = torch.arange(T, device=x.device)
        if ring:                # per-lane slot -> absolute position map
            kpos = _ring_positions(lane_pos, kpos, T)
        out = _attn_core(q, ck, cv, positions, kpos, causal=causal,
                         window=window)
    else:
        if kv_cache is not None:
            # prefill: slot s holds position p with s == p mod T (ring) or
            # s == p; the cache serves the decode steps that follow. A
            # prompt longer than the cache keeps its last T entries.
            T = kv_cache["k"].shape[1]
            kw, vw = k, v
            if S > T:
                shift = (S - T) % T
                kw = torch.roll(k[:, -T:], shift, dims=1)
                vw = torch.roll(v[:, -T:], shift, dims=1)
            kv_cache["k"][:, :kw.shape[1]] = kw.to(kv_cache["k"].dtype)
            kv_cache["v"][:, :vw.shape[1]] = vw.to(kv_cache["v"].dtype)
        kpos = torch.arange(S, device=x.device)
        out = _attn_core(q, k, v, positions, kpos, causal=causal,
                         window=window)
    out = _row(eng, out.reshape(B, S, -1), p["wo"], part)
    return out, kv_cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig, device,
             keep: Keep = _whole) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype
    shapes = (("wg", (d, f)),) if cfg.mlp_type == "swiglu" else ()
    shapes += (("wu", (d, f)), ("wd", (f, d)))
    return {key: keep(key, dense_init(gen, d_in, d_out, dt, device))
            for key, (d_in, d_out) in shapes}


def mlp_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
              eng: DotEngine, part=None) -> torch.Tensor:
    """SwiGLU: wd(silu(wg x) * wu x); GELU: wd(gelu(wu x)), with the
    tanh approximation (jax.nn.gelu's default). Under a partition context
    wg and wu are column-parallel, wd row-parallel."""
    if part is not None:
        x = part.enter(x)
    if cfg.mlp_type == "swiglu":
        g = torch.nn.functional.silu(
            _col(eng, x, p["wg"], part).to(torch.float32)).to(x.dtype)
        u = _col(eng, x, p["wu"], part)
        return _row(eng, g * u, p["wd"], part)
    h = torch.nn.functional.gelu(
        _col(eng, x, p["wu"], part).to(torch.float32),
        approximate="tanh").to(x.dtype)
    return _row(eng, h, p["wd"], part)


# --------------------------------------------------------------------------
# embeddings / head
# --------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    e = torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen,
                    dtype=torch.float32, device=device).mul_(0.02)
    return {"table": e.to(cfg.pdtype)}


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig,
          part=None) -> torch.Tensor:
    """The table's rows of `tokens` in the compute dtype. Under a
    partition context the table is vocab-parallel: each rank looks up the
    ids in its row range, writes zeros elsewhere, and the rows are summed
    over `model` in f32. A row plus exact zeros is the row, up to the sign
    of a zero (-0 + 0 is +0). Under fsdp_tp the rows come whole over
    `data` (`Partition.lookup`). Under gradients each rank's block of the
    table gets the gradient of the ids it holds."""
    if part is None:
        return p["table"].to(cfg.cdtype)[tokens]
    table = p["table"].to(cfg.cdtype)
    rows = table.shape[0]
    ids = tokens.to(torch.int64) - part.rank * rows
    mine = ((ids >= 0) & (ids < rows))[..., None]
    x = part.lookup(table, ids.clamp(0, rows - 1))
    x = torch.where(mine, x, torch.zeros_like(x)).to(torch.float32)
    return part.sum(x).to(cfg.cdtype)


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig,
            eng: DotEngine, part=None) -> torch.Tensor:
    """Logits against the (vocab_padded, d) table. The table is rounded
    through the compute dtype first, as the reference does, and handed to
    the engine as a transposed view. Under a partition context the head
    is column-parallel: this rank's vocab columns, left sharded (with a
    tied table its gradient adds to the embedding's in the rank's
    block)."""
    table = p["table"] if part is None else part.whole_over_data(
        p["table"], 1)
    if part is not None:
        x = part.enter(x)
    logits = eng.dot(x, table.to(cfg.cdtype).T)
    if cfg.vocab_padded != cfg.vocab_size:
        first = 0 if part is None else part.rank * logits.shape[-1]
        cols = torch.arange(logits.shape[-1], device=x.device) + first
        pad = cols >= cfg.vocab_size
        logits = logits + pad.to(logits.dtype) * torch.tensor(
            -1e9, dtype=logits.dtype, device=x.device)
    return logits
