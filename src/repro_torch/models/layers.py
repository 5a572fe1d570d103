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
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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
    return (w * scale).to(dtype)


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

def attention_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, dt = cfg.d_model, cfg.pdtype
    p = {
        "wq": dense_init(gen, d, cfg.d_head_total, dt, device),
        "wk": dense_init(gen, d, cfg.d_kv_total, dt, device),
        "wv": dense_init(gen, d, cfg.d_kv_total, dt, device),
        "wo": dense_init(gen, cfg.d_head_total, d, dt, device),
    }
    if cfg.qkv_bias:
        for key, width in (("bq", cfg.d_head_total), ("bk", cfg.d_kv_total),
                           ("bv", cfg.d_kv_total)):
            p[key] = torch.zeros((width,), dtype=dt, device=device)
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


def attention_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, eng: DotEngine, *,
                    kv_cache: Optional[Dict[str, Any]] = None,
                    causal: bool = True, chunked: bool = False
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Self-attention with an optional KV cache and sliding window.

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
    updated cache or None)."""
    B, S, d = x.shape
    Dh = cfg.head_dim
    q = eng.dot(x, p["wq"])
    k = eng.dot(x, p["wk"])
    v = eng.dot(x, p["wv"])
    if cfg.qkv_bias:
        # in the GEMM output's dtype, as the reference adds them
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = apply_rope(q.reshape(B, S, cfg.n_heads, Dh), positions,
                   style=cfg.rope_style, theta=cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, cfg.n_kv_heads, Dh), positions,
                   style=cfg.rope_style, theta=cfg.rope_theta)
    v = v.reshape(B, S, cfg.n_kv_heads, Dh)
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
            newest = lane_pos[:, None]
            kpos = newest - torch.remainder(newest - kpos[None], T)
            kpos = torch.where(kpos >= 0, kpos, torch.full_like(kpos, -1))
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
    out = eng.dot(out.reshape(B, S, cfg.d_head_total), p["wo"])
    return out, kv_cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype
    if cfg.mlp_type == "swiglu":
        return {"wg": dense_init(gen, d, f, dt, device),
                "wu": dense_init(gen, d, f, dt, device),
                "wd": dense_init(gen, f, d, dt, device)}
    return {"wu": dense_init(gen, d, f, dt, device),
            "wd": dense_init(gen, f, d, dt, device)}


def mlp_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
              eng: DotEngine) -> torch.Tensor:
    """SwiGLU: wd(silu(wg x) * wu x); GELU: wd(gelu(wu x)), with the
    tanh approximation (jax.nn.gelu's default)."""
    if cfg.mlp_type == "swiglu":
        g = torch.nn.functional.silu(
            eng.dot(x, p["wg"]).to(torch.float32)).to(x.dtype)
        u = eng.dot(x, p["wu"])
        return eng.dot(g * u, p["wd"])
    h = torch.nn.functional.gelu(eng.dot(x, p["wu"]).to(torch.float32),
                                 approximate="tanh").to(x.dtype)
    return eng.dot(h, p["wd"])


# --------------------------------------------------------------------------
# embeddings / head
# --------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    e = torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen,
                    dtype=torch.float32, device=device) * 0.02
    return {"table": e.to(cfg.pdtype)}


def embed(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["table"].to(cfg.cdtype)[tokens]


def unembed(p: Params, x: torch.Tensor, cfg: ModelConfig,
            eng: DotEngine) -> torch.Tensor:
    """Logits against the (vocab_padded, d) table. The table is rounded
    through the compute dtype first, as the reference does, and handed to
    the engine as a transposed view."""
    logits = eng.dot(x, p["table"].to(cfg.cdtype).T)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab_size
        logits = logits + pad.to(logits.dtype) * torch.tensor(
            -1e9, dtype=logits.dtype, device=x.device)
    return logits
