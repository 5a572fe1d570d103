"""Mixtral-8x22B [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384, vocab 32768, MoE 8 experts
top-2, sliding-window attention (4096).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    block_pattern=("attn",),
    sharding_profile="fsdp_tp",
    moe_sharding="tp",   # 8 experts < 16-way model axis: TP inside experts
)
