"""Mamba2-130M [arXiv:2405.21060; unverified].

24L d_model=768, attention-free SSD (state-space duality), ssm_state=128,
expand 2 (d_inner 1536, headdim 64 -> 24 ssm heads), vocab 50280, the
LM head tied to the embedding.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,          # unused by SSD blocks; kept for head_dim derivation
    n_kv_heads=12,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    conv_width=4,
    block_pattern=("ssm",),
    tie_embeddings=True,
    sharding_profile="tp",
)
