"""The decoder block and the layer stack (port of
`repro/models/transformer.py`, the "attn" block of the dense family).

The reference scans stacked pattern groups under jit; here the stack is a
list of per-layer param dicts run by a Python loop.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.numerics import DotEngine
from .config import ModelConfig
from .layers import (attention_apply, attention_init, mlp_apply, mlp_init,
                     rmsnorm)

Params = Dict[str, Any]


def block_init(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    ones = torch.ones((cfg.d_model,), dtype=cfg.pdtype, device=device)
    return {"norm1": {"scale": ones.clone()},
            "attn": attention_init(gen, cfg, device),
            "norm2": {"scale": ones.clone()},
            "mlp": mlp_init(gen, cfg, device)}


def block_cache_init(cfg: ModelConfig, batch: int, max_len: int, device,
                     paged: Optional[Dict[str, Any]] = None) -> Params:
    """One layer's KV cache: contiguous (B, T, Hkv, Dh) k and v, or, with
    paged={"num_blocks", "block_size", "table"}, a block pool per k and v
    plus the lane block table shared by every paged layer. A
    sliding-window layer holds T = min(max_len, window) slots (a ring when
    T == window) and stays contiguous even when `paged` is given: the
    window already bounds what it keeps."""
    H, D, dt = cfg.n_kv_heads, cfg.head_dim, cfg.cdtype
    if paged is not None and cfg.sliding_window is None:
        shape = (paged["num_blocks"], paged["block_size"], H, D)
        return {"kpool": torch.zeros(shape, dtype=dt, device=device),
                "vpool": torch.zeros(shape, dtype=dt, device=device),
                "table": paged["table"]}
    T = max_len
    if cfg.sliding_window is not None:
        T = min(T, cfg.sliding_window)
    shape = (batch, T, H, D)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, eng: DotEngine, *,
                cache: Optional[Params] = None,
                chunked: bool = False) -> torch.Tensor:
    """Pre-norm self-attention + MLP. Attention GEMMs run under
    eng.for_role("attn"), the MLP under eng.for_role("mlp")."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    o, _ = attention_apply(p["attn"], cfg, h, positions, eng.for_role("attn"),
                           kv_cache=cache, chunked=chunked)
    x = x + o
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + mlp_apply(p["mlp"], cfg, h2, eng.for_role("mlp"))


def stack_apply(layers: List[Params], cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, eng: DotEngine, *,
                caches: Optional[List[Params]] = None,
                chunked: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run every layer in order (caches updated in place; `chunked`
    makes an S > 1 call a chunked-prefill write, see attention_apply).
    Returns (x, aux loss): the aux loss of dense blocks is a 0-d f32
    zero, as in the reference."""
    for i, p in enumerate(layers):
        x = block_apply(p, cfg, x, positions, eng,
                        cache=None if caches is None else caches[i],
                        chunked=chunked)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)
