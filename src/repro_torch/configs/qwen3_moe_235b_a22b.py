"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (GQA kv=4) d_ff=1536/expert, vocab 151936,
MoE 128 experts top-8. head_dim = d_model/H = 64, as the reference's
assigned table has it (the HF checkpoint uses 128).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    experts_per_token=8,
    block_pattern=("attn",),
    sharding_profile="fsdp_tp",
    moe_sharding="ep",
)
