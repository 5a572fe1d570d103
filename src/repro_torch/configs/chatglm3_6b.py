"""ChatGLM3-6B [arXiv:2406.12793; hf].

28L d_model=4096 32H (GQA kv=2) d_ff=13696, vocab 65024. 2d-RoPE
(rotary on half the head dims), QKV bias.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    qkv_bias=True,
    rope_style="half",
    block_pattern=("attn",),
    sharding_profile="tp",
)
