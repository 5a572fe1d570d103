"""Architecture configuration of the port (port of
`repro/models/config.py`): the dense, MoE, hybrid (RG-LRU), SSM (Mamba2),
enc-dec and VLM families."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")
_KINDS = ("attn", "rec", "ssm", "cross", "xdec")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config type drives every ported architecture.

    family: dense | moe | hybrid | ssm | encdec | vlm
    block_pattern: per-layer block kinds, tiled across n_layers: whole
      pattern groups run first, then the remainder layers (e.g.
      RecurrentGemma's 38 = 12 * (rec, rec, attn) + 2 rec). The kinds:
      "attn" (pre-norm GQA self-attention, then an MLP, or a MoE layer
      when n_experts is set), "rec" (an RG-LRU mixer, then an MLP),
      "ssm" (a Mamba2 SSD mixer, no MLP), "cross" (pre-norm
      cross-attention to the frontend memory, then an MLP: Llama-Vision)
      and "xdec" (self-attention, then cross-attention, then an MLP:
      Seamless's decoder).

    qkv_bias adds a bias after each of the q/k/v projections; rope_style
    "full" rotates every head dim, "half" (ChatGLM's 2-D RoPE) the first
    half; sliding_window limits attention to the last `sliding_window`
    positions and turns the layer's KV cache into a ring of that length;
    mlp_type is "swiglu" or "gelu"; tie_embeddings reads the LM head from
    the embedding table. The enc-dec and VLM frontends are stubs that
    hand in n_frontend_tokens embeddings a row (audio frames or image
    patches); an encdec config runs them through n_enc_layers of
    non-causal encoder first.
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
    # --- moe ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- hybrid (RG-LRU) ---
    block_pattern: Tuple[str, ...] = ("attn",)
    rnn_width: Optional[int] = None       # RG-LRU recurrence width
    conv_width: int = 4
    # --- ssm (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    # --- enc-dec / vlm frontends (stubs provide embeddings) ---
    n_enc_layers: int = 0
    n_frontend_tokens: int = 0            # audio frames / image patches
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    dot_mode: str = "native"              # any registered DotEngine mode
    tie_embeddings: bool = False
    # how distributed/sharding.Sharder places the weights on a mesh:
    # "tp" (over `model` alone) or "fsdp_tp" (the non-TP dim over `data`
    # too); a MoE layer's experts over `model` ("ep") or its d_ff ("tp")
    sharding_profile: str = "tp"
    moe_sharding: str = "ep"
    # "block" recomputes each pattern group's forward in the backward
    # (torch.utils.checkpoint, the reference's jax.checkpoint); "none" and
    # "full" keep every activation: the reference takes "full" and acts on
    # "block" alone
    remat: str = "block"

    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.family not in _FAMILIES:
            raise ValueError(
                f"family {self.family!r} is not ported; the port runs "
                f"{', '.join(_FAMILIES)}")
        if len(self.block_pattern) == 0:
            raise ValueError("block_pattern must be nonempty")
        if bad := set(self.block_pattern) - set(_KINDS):
            raise ValueError(
                f"block kinds {sorted(bad)} are not ported; the port runs "
                f"{', '.join(_KINDS)}")
        if self.family == "moe" and not self.n_experts:
            raise ValueError("moe family needs n_experts")
        if self.rope_style not in ("full", "half"):
            raise ValueError(f"rope_style={self.rope_style!r}; expected "
                             "'full' or 'half'")
        if self.mlp_type not in ("swiglu", "gelu"):
            raise ValueError(f"mlp_type={self.mlp_type!r}; expected "
                             "'swiglu' or 'gelu'")
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError("sliding_window must be >= 1 (or None)")
        if self.remat not in ("none", "block", "full"):
            raise ValueError(f"remat={self.remat!r}; expected 'none', "
                             "'block' or 'full'")
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

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def pattern_groups(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def remainder_blocks(self) -> Tuple[str, ...]:
        rem = self.n_layers % len(self.block_pattern)
        return self.block_pattern[:rem]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Every layer's block kind in execution order: the pattern
        `pattern_groups` times, then `remainder_blocks`."""
        return (tuple(self.block_pattern) * self.pattern_groups
                + tuple(self.remainder_blocks))

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once when tied),
        the reference's formula unchanged. Its "rec" term counts wx, wy,
        wo, the conv kernel and the two gate biases, and leaves out the
        RG-LRU's w x w gate matrices wa and wi and its lam vector, as the
        reference does (2 * 4096^2 + 4096 per layer of RecurrentGemma-9B).
        An "xdec" layer counts its norms alone and a "cross" layer an
        attention and its MLP, as the reference's formula does; the encoder
        counts 4 d^2 of attention, its MLP and two norms a layer."""
        d, h = self.d_model, self.head_dim
        counts = 0
        for kind in self.layer_kinds:
            if kind in ("attn", "cross"):
                counts += d * (self.n_heads * h) + d * (2 * self.n_kv_heads * h)
                counts += (self.n_heads * h) * d
                if self.qkv_bias:
                    counts += self.n_heads * h + 2 * self.n_kv_heads * h
            if kind in ("attn", "cross", "rec"):
                if self.n_experts:
                    counts += (self.n_experts * 3 * d * self.d_ff
                               + d * self.n_experts)
                elif self.mlp_type == "swiglu":
                    counts += 3 * d * self.d_ff
                else:
                    counts += 2 * d * self.d_ff
            if kind == "rec":
                w = self.rnn_width or d
                counts += 2 * d * w + w * d + w * self.conv_width + 2 * w
            if kind == "ssm":
                din, N, H = self.d_inner, self.ssm_state, self.ssm_nheads
                counts += d * (2 * din + 2 * N + H) + din * d
                counts += (din + 2 * N) * self.conv_width + 2 * H
            counts += 2 * d                 # norms
        counts += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.n_enc_layers:
            mlp = 2 if self.mlp_type == "gelu" else 3
            counts += self.n_enc_layers * (4 * d * d + mlp * d * self.d_ff
                                           + 2 * d)
        return counts
