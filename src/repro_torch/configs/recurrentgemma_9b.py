"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427; unverified].

38L d_model=4096 16H (MQA kv=1, head_dim 256 per its paper) d_ff=12288,
vocab 256000. RG-LRU + local attention, pattern 2 recurrent : 1 attn
(window 2048): 12 * (rec, rec, attn) + 2 rec remainder = 38 layers.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    sliding_window=2048,
    block_pattern=("rec", "rec", "attn"),
    rnn_width=4096,
    conv_width=4,
    sharding_profile="fsdp_tp",
)
