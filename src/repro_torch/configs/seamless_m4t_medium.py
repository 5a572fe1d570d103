"""SeamlessM4T-medium [arXiv:2308.11596; hf] (the reference's
`repro/configs/seamless_m4t_medium.py`, field for field).

Enc-dec: 12 encoder + 12 decoder layers, d_model=1024, 16H MHA (kv=16),
d_ff=4096 (GELU), vocab 256206. The speech frontend is a stub: the caller
hands in precomputed frame embeddings (B, 1024, d_model) as
batch["frames"].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    n_enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    mlp_type="gelu",
    block_pattern=("xdec",),
    n_frontend_tokens=1024,
    sharding_profile="tp",
)
