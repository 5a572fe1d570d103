"""Transformer building blocks: RMSNorm, RoPE, GQA attention with the
contiguous and the paged KV cache, SwiGLU MLP, embed/unembed (port of
`repro/models/layers.py`, the dense-decoder subset).

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

__all__ = ["TRASH_BLOCK", "dense_init", "rmsnorm", "apply_rope",
           "paged_pool_write", "paged_pool_view", "paged_scatter_rows",
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


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float) -> torch.Tensor:
    """x (B, S, H, Dh), every head dim rotated (interleaved pairs)."""
    B, S, H, Dh = x.shape
    cos, sin = rope_angles(positions, Dh, theta)
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xr = x.to(torch.float32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.stack([o1, o2], dim=-1).reshape(B, S, H, Dh).to(x.dtype)


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
    return {
        "wq": dense_init(gen, d, cfg.d_head_total, dt, device),
        "wk": dense_init(gen, d, cfg.d_kv_total, dt, device),
        "wv": dense_init(gen, d, cfg.d_kv_total, dt, device),
        "wo": dense_init(gen, cfg.d_head_total, d, dt, device),
    }


def _attn_plain(q, k, v, qpos, kpos, *, causal: bool) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,H,D) with kv already repeated to q heads;
    qpos (B,S), kpos (T,) or (B,T) absolute positions (-1 = empty)."""
    D = q.shape[-1]
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32)
    scores = scores / (D ** 0.5)
    kp = kpos if kpos.ndim == 2 else kpos[None]         # (B|1, T)
    valid = (kp >= 0)[:, None, None, :]
    if causal:
        rel = kp[:, None, :] <= qpos[:, :, None]        # (B, S, T)
        valid = valid & rel[:, None]
    scores = scores.masked_fill(~valid, torch.finfo(torch.float32).min)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", w, v)


def _attn_core(q, k, v, qpos, kpos, *, causal: bool) -> torch.Tensor:
    """GQA by repeating each kv head over its query group."""
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hkv != Hq:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    return _attn_plain(q, k, v, qpos, kpos, causal=causal)


def attention_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, eng: DotEngine, *,
                    kv_cache: Optional[Dict[str, Any]] = None,
                    causal: bool = True
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """Self-attention with an optional KV cache.

    {"k","v"} is the contiguous per-lane cache; {"kpool","vpool","table"}
    the paged one (decode steps only: prefill goes through
    a contiguous row cache that the serving engine scatters into the
    pool). An S == 1 call with a cache is a decode step that writes at
    each lane's own position; an S > 1 call is a fresh prefill that fills
    slots 0..S-1. Returns (output (B,S,d), the updated cache or None)."""
    B, S, d = x.shape
    Dh = cfg.head_dim
    q = eng.dot(x, p["wq"])
    k = eng.dot(x, p["wk"])
    v = eng.dot(x, p["wv"])
    q = apply_rope(q.reshape(B, S, cfg.n_heads, Dh), positions,
                   theta=cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, cfg.n_kv_heads, Dh), positions,
                   theta=cfg.rope_theta)
    v = v.reshape(B, S, cfg.n_kv_heads, Dh)

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
        out = _attn_core(q, ck, cv, positions, kpos, causal=causal)
    elif kv_cache is not None and S == 1:
        # decode: per-lane write at each lane's own position (lanes in a
        # serving pool sit at different depths), then attend over the
        # whole cache; slot index == absolute position.
        ck, cv = kv_cache["k"], kv_cache["v"]
        T = ck.shape[1]
        lane_pos = positions[:, 0]
        idx = torch.clamp(lane_pos, max=T - S).to(torch.int64)
        lanes = torch.arange(B, device=x.device)
        ck[lanes, idx] = k[:, 0].to(ck.dtype)
        cv[lanes, idx] = v[:, 0].to(cv.dtype)
        kpos = torch.arange(T, device=x.device)
        out = _attn_core(q, ck, cv, positions, kpos, causal=causal)
    else:
        if kv_cache is not None:
            # prefill: slot s holds position s; the cache serves the
            # decode steps that follow.
            kv_cache["k"][:, :S] = k.to(kv_cache["k"].dtype)
            kv_cache["v"][:, :S] = v.to(kv_cache["v"].dtype)
        kpos = torch.arange(S, device=x.device)
        out = _attn_core(q, k, v, positions, kpos, causal=causal)
    out = eng.dot(out.reshape(B, S, cfg.d_head_total), p["wo"])
    return out, kv_cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype
    return {"wg": dense_init(gen, d, f, dt, device),
            "wu": dense_init(gen, d, f, dt, device),
            "wd": dense_init(gen, f, d, dt, device)}


def mlp_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
              eng: DotEngine) -> torch.Tensor:
    """SwiGLU: wd(silu(wg x) * wu x)."""
    g = torch.nn.functional.silu(
        eng.dot(x, p["wg"]).to(torch.float32)).to(x.dtype)
    u = eng.dot(x, p["wu"])
    return eng.dot(g * u, p["wd"])


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
