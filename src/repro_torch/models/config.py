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
    """One dense decoder: the reference's "attn" block kind, pre-norm GQA
    self-attention and an MLP per layer.

    qkv_bias adds a bias after each of the q/k/v projections; rope_style
    "full" rotates every head dim, "half" (ChatGLM's 2-D RoPE) the first
    half; sliding_window limits attention to the last `sliding_window`
    positions and turns the layer's KV cache into a ring of that length;
    mlp_type is "swiglu" or "gelu"; tie_embeddings reads the LM head from
    the embedding table. The other families and block kinds (MoE,
    recurrent, enc-dec, VLM) are not ported.
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default: d_model // n_heads
    qkv_bias: bool = False
    rope_style: str = "full"              # full | half (chatglm 2d-RoPE)
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # SWA / local attention window
    mlp_type: str = "swiglu"              # swiglu | gelu
    block_pattern: Tuple[str, ...] = ("attn",)
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    dot_mode: str = "native"              # any registered DotEngine mode
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family != "dense" or set(self.block_pattern) != {"attn"}:
            raise ValueError(
                f"the port runs dense attention decoders only, got family "
                f"{self.family!r} with blocks {self.block_pattern}")
        if self.rope_style not in ("full", "half"):
            raise ValueError(f"rope_style={self.rope_style!r}; expected "
                             "'full' or 'half'")
        if self.mlp_type not in ("swiglu", "gelu"):
            raise ValueError(f"mlp_type={self.mlp_type!r}; expected "
                             "'swiglu' or 'gelu'")
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError("sliding_window must be >= 1 (or None)")
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

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once when tied),
        the reference's formula for the dense "attn" block."""
        d, h = self.d_model, self.head_dim
        per_layer = d * (self.n_heads * h) + d * (2 * self.n_kv_heads * h)
        per_layer += (self.n_heads * h) * d
        if self.qkv_bias:
            per_layer += self.n_heads * h + 2 * self.n_kv_heads * h
        per_layer += (3 if self.mlp_type == "swiglu" else 2) * d * self.d_ff
        per_layer += 2 * d                  # norms
        return (self.n_layers * per_layer
                + self.vocab_size * d * (1 if self.tie_embeddings else 2))
