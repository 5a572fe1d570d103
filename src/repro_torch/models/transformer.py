"""The blocks and the layer stack (port of `repro/models/transformer.py`):

  attn - pre-norm self-attention (GQA/SWA/RoPE) + MLP, or MoE when the
         config has experts
  rec  - pre-norm RG-LRU recurrent mixer + MLP            (recurrentgemma)
  ssm  - Mamba2 SSD block (no separate MLP)               (mamba2)
  cross - pre-norm cross-attention to frontend memory + MLP (llama-vision)
  xdec - self-attn + cross-attn + MLP                     (seamless decoder)

The reference scans stacked pattern groups under jit; here the stack is a
list of per-layer param dicts, in execution order (`cfg.layer_kinds`: the
pattern groups, then the remainder), run by a Python loop, each group
under activation checkpointing where the config asks for it (cfg.remat).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.numerics import DotEngine
from .config import ModelConfig
from .layers import (Keep, _whole, attention_apply, attention_init,
                     mlp_apply, mlp_init, rmsnorm)
from .moe import moe_apply, moe_init
from .recurrent import (rglru_apply, rglru_init, rglru_state_init, ssd_apply,
                        ssd_init, ssd_state_init)

Params = Dict[str, Any]


def _under(keep: Keep, prefix: str) -> Keep:
    return lambda name, t: keep(f"{prefix}/{name}", t)


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
               device, keep: Keep = _whole) -> Params:
    """One layer's params. `keep(path, leaf)` (a path under the layer,
    "attn/wq") takes each leaf as it is made and returns what the layer
    holds; every leaf goes to it as it is drawn, before the next draw."""
    def ones(name):
        return keep(f"{name}/scale", torch.ones(
            (cfg.d_model,), dtype=cfg.pdtype, device=device))

    p: Params = {"norm1": {"scale": ones("norm1")}}
    if kind == "attn":
        p["attn"] = attention_init(gen, cfg, device, _under(keep, "attn"))
    elif kind == "rec":
        p["rec"] = rglru_init(gen, cfg, device, _under(keep, "rec"))
    elif kind == "ssm":
        p["ssm"] = ssd_init(gen, cfg, device, _under(keep, "ssm"))
        return p                    # the SSD block has no separate MLP
    elif kind == "cross":
        p["cross"] = attention_init(gen, cfg, device, _under(keep, "cross"))
    elif kind == "xdec":
        p["attn"] = attention_init(gen, cfg, device, _under(keep, "attn"))
        p["norm_x"] = {"scale": ones("norm_x")}
        p["cross"] = attention_init(gen, cfg, device, _under(keep, "cross"))
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    p["norm2"] = {"scale": ones("norm2")}
    if cfg.n_experts and kind == "attn":
        p["moe"] = moe_init(gen, cfg, device, _under(keep, "moe"))
    else:
        p["mlp"] = mlp_init(gen, cfg, device, _under(keep, "mlp"))
    return p


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device, paged: Optional[Dict[str, Any]] = None
                     ) -> Optional[Params]:
    """One layer's decode cache. An "attn" or "xdec" layer holds contiguous
    (B, T, Hkv, Dh) k and v, or, with paged={"num_blocks", "block_size",
    "table"}, a block pool per k and v plus the lane block table shared by
    every paged layer. A sliding-window layer holds T = min(max_len,
    window) slots (a ring when T == window) and stays contiguous even when
    `paged` is given: the window already bounds what it keeps. A "rec" or
    "ssm" layer holds its recurrent state ({"h", "conv"}, f32, O(1) a
    lane), contiguous under either layout. A "cross" layer holds none: its
    k and v are recomputed from the memory on every call."""
    if kind == "rec":
        return rglru_state_init(cfg, batch, device)
    if kind == "ssm":
        return ssd_state_init(cfg, batch, device)
    if kind == "cross":
        return None
    if kind not in ("attn", "xdec"):
        raise ValueError(f"unknown block kind {kind!r}")
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


def block_apply(p: Params, cfg: ModelConfig, kind: str, x: torch.Tensor,
                positions: torch.Tensor, eng: DotEngine, *,
                cache: Optional[Params] = None,
                memory: Optional[torch.Tensor] = None, causal: bool = True,
                chunked: bool = False, part=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, aux loss). Attention GEMMs (self and cross) run under
    eng.for_role("attn"), the MLP and MoE under eng.for_role("mlp");
    recurrent and SSD mixers keep the base engine (their GEMMs are gate
    and in/out projections, not attention). `memory` (B, M, d) is what a
    "cross" or "xdec" layer attends to; causal=False makes self-attention
    bidirectional (the encoder). A partition context `part` runs an
    "attn" layer, with a dense MLP or experts, a "rec" layer and the
    cross-attention blocks ("cross", "xdec": each attention and the MLP)
    on this rank's blocks (layers.py, moe.py, recurrent.py); `memory` is
    then this rank's rows, whole over `model`. An "ssm" block runs whole
    under one: the Sharder replicates every SSD weight."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    attn_eng = eng.for_role("attn")
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind in ("attn", "xdec"):
        o, _ = attention_apply(p["attn"], cfg, h, positions, attn_eng,
                               kv_cache=cache, causal=causal,
                               chunked=chunked, part=part)
        if kind == "xdec":
            x = x + o
            hx = rmsnorm(p["norm_x"], x, cfg.norm_eps)
            o, _ = attention_apply(p["cross"], cfg, hx, positions, attn_eng,
                                   memory=memory, part=part)
    elif kind == "cross":
        o, _ = attention_apply(p["cross"], cfg, h, positions, attn_eng,
                               memory=memory, part=part)
    elif kind == "rec":
        o, _ = rglru_apply(p["rec"], cfg, h, eng, state=cache, part=part)
    elif kind == "ssm":
        o, _ = ssd_apply(p["ssm"], cfg, h, eng, state=cache)
        return x + o, aux
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    x = x + o
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    mlp_eng = eng.for_role("mlp")
    if "moe" in p:
        m, aux = moe_apply(p["moe"], cfg, h2, mlp_eng, part)
    else:
        m = mlp_apply(p["mlp"], cfg, h2, mlp_eng, part)
    return x + m, aux


def stack_apply(layers: List[Params], cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, eng: DotEngine, *,
                caches: Optional[List[Params]] = None,
                memory: Optional[torch.Tensor] = None, causal: bool = True,
                chunked: bool = False, part=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run every layer in execution order (caches updated in place;
    `memory` for the cross-attention layers; causal=False for the
    encoder; `chunked` makes an S > 1 call a chunked-prefill write, see
    attention_apply; `part` a partition context, block_apply). Returns
    (x, the aux loss summed over the layers in that order, a 0-d f32
    tensor: zero without experts).

    Under cfg.remat == "block" and with no caches (the training path),
    each pattern group runs under torch.utils.checkpoint, as the
    reference wraps its scanned group body in jax.checkpoint: the backward
    recomputes the group's forward instead of keeping its activations.
    The remainder layers are outside the scan there, and are not
    checkpointed here either. The bits do not change. Under a partition
    context the recompute runs the group's collectives again, in the same
    order on every rank (the partitioned train step)."""
    kinds = cfg.layer_kinds
    pat = len(cfg.block_pattern)
    n_scan = cfg.pattern_groups * pat

    def run(lo: int, hi: int, x, aux):
        for i in range(lo, hi):
            x, a = block_apply(layers[i], cfg, kinds[i], x, positions, eng,
                               cache=None if caches is None else caches[i],
                               memory=memory, causal=causal, chunked=chunked,
                               part=part)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat == "block" and caches is None
    for lo in range(0, n_scan, pat):
        if remat:
            # the forward draws no random numbers: no RNG state to keep
            x, aux = checkpoint(run, lo, lo + pat, x, aux,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = run(lo, lo + pat, x, aux)
    return run(n_scan, len(kinds), x, aux)
