"""Yi-34B [arXiv:2403.04652; hf].

60L d_model=7168 56H (GQA kv=8) d_ff=20480, vocab 64000 (llama-arch GQA).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    block_pattern=("attn",),
    sharding_profile="fsdp_tp",
)
