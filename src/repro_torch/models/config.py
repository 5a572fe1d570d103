"""Architecture configuration of the port's dense decoder (port of
`repro/models/config.py`, the fields the dense family uses)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One dense decoder: pre-norm GQA self-attention with full RoPE and
    a SwiGLU MLP per layer, untied embedding and head (the reference's
    "attn" block kind; other kinds, sliding windows, qkv bias and tied
    embeddings are not ported yet)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default: d_model // n_heads
    rope_theta: float = 10_000.0
    block_pattern: Tuple[str, ...] = ("attn",)
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    dot_mode: str = "native"              # any registered DotEngine mode

    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family != "dense" or set(self.block_pattern) != {"attn"}:
            raise ValueError(
                f"the port runs dense attention decoders only, got family "
                f"{self.family!r} with blocks {self.block_pattern}")
        for f in ("param_dtype", "compute_dtype"):
            if getattr(self, f) not in _DTYPES:
                raise ValueError(f"{f}={getattr(self, f)!r}; expected one "
                                 f"of {sorted(_DTYPES)}")
        from repro_torch.core.numerics import DotEngine
        if self.dot_mode not in DotEngine.modes():
            raise ValueError(
                f"dot_mode {self.dot_mode!r} is not a registered DotEngine "
                f"mode; choose from {DotEngine.modes()}")

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 256; padded logits are masked to -1e9."""
        return -(-self.vocab_size // 256) * 256

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def d_kv_total(self) -> int:
        return self.n_kv_heads * self.head_dim
