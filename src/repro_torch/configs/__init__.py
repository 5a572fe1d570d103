"""Architecture registry of the port: the dense decoders it serves.

get_config(arch_id)    -> full published config
smoke_config(arch_id)  -> reduced same-family config for CPU tests
list_archs()           -> all registered ids
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List

from repro_torch.models.config import ModelConfig

_ARCHS = ["chatglm3_6b", "qwen1_5_110b", "internlm2_1_8b", "yi_34b"]

ALIASES = {a.replace("_", "-"): a for a in _ARCHS}
ALIASES.update({"chatglm3-6b": "chatglm3_6b", "qwen1.5-110b": "qwen1_5_110b",
                "internlm2-1.8b": "internlm2_1_8b", "yi-34b": "yi_34b"})


def list_archs() -> List[str]:
    return list(_ARCHS)


def get_config(arch: str) -> ModelConfig:
    name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if name not in _ARCHS:
        raise ValueError(f"unknown arch {arch!r}; the port serves "
                         f"{', '.join(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: the reference's smoke widths (d_model
    128, 4 heads of 32, 2 KV heads, d_ff 256, vocab 512, a window of 16
    where the config has one)."""
    cfg = get_config(arch)
    pat_len = len(cfg.block_pattern)
    n_layers = max(2 * pat_len, pat_len + cfg.n_layers % pat_len)
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=128, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 2, head_dim=32, d_ff=256,
        vocab_size=512,
        sliding_window=16 if cfg.sliding_window else None)
