"""Architecture registry of the port: the dense, MoE, hybrid, SSM, enc-dec
and VLM architectures it runs.

get_config(arch_id)    -> full published config
smoke_config(arch_id)  -> reduced same-family config for CPU tests
list_archs()           -> all registered ids
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.models.config import ModelConfig

_ARCHS = ["qwen3_moe_235b_a22b", "mixtral_8x22b", "recurrentgemma_9b",
          "chatglm3_6b", "qwen1_5_110b", "internlm2_1_8b", "yi_34b",
          "mamba2_130m", "llama_3_2_vision_11b", "seamless_m4t_medium"]

ALIASES = {a.replace("_", "-"): a for a in _ARCHS}
ALIASES.update({"qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
                "mixtral-8x22b": "mixtral_8x22b",
                "recurrentgemma-9b": "recurrentgemma_9b",
                "chatglm3-6b": "chatglm3_6b", "qwen1.5-110b": "qwen1_5_110b",
                "internlm2-1.8b": "internlm2_1_8b", "yi-34b": "yi_34b",
                "mamba2-130m": "mamba2_130m",
                "llama-3.2-vision-11b": "llama_3_2_vision_11b",
                "seamless-m4t-medium": "seamless_m4t_medium"})


def list_archs() -> List[str]:
    return list(_ARCHS)


def get_config(arch: str) -> ModelConfig:
    name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if name not in _ARCHS:
        raise ValueError(f"unknown arch {arch!r}; the port serves "
                         f"{', '.join(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config, the reference's reduced fields: d_model
    128, 4 heads of 32, 2 KV heads, d_ff 256, vocab 512, 8 experts of
    which 2 a token at capacity factor 4 (no drops in tiny batches) where
    the config has experts, an RG-LRU width of 128, an SSM state of 16 in
    heads of 32 and chunks of 8, 2 encoder layers and 16 frontend tokens
    where the config has them, and a window of 16 where it has one; two
    pattern groups, or one and the remainder; no remat."""
    cfg = get_config(arch)
    pat_len = len(cfg.block_pattern)
    n_layers = max(2 * pat_len, pat_len + cfg.n_layers % pat_len)
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=128, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 2, head_dim=32, d_ff=256,
        vocab_size=512,
        n_experts=8 if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2),
        capacity_factor=4.0,
        rnn_width=128 if cfg.rnn_width else None,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else 64,
        ssm_chunk=8,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        n_frontend_tokens=16 if cfg.n_frontend_tokens else 0,
        sliding_window=16 if cfg.sliding_window else None,
        remat="none")
