"""Llama-3.2-Vision-11B [hf:meta-llama/Llama-3.2-11B-Vision; unverified]
(the reference's `repro/configs/llama_3_2_vision_11b.py`, field for field).

40L text backbone d_model=4096 32H (GQA kv=8) d_ff=14336, vocab 128256,
cross-attention image layers every 5th layer: 8 * (attn x4, cross) = 40.
The vision frontend is a stub: the caller hands in projected patch
embeddings (B, 1024, d_model) as batch["patches"].
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=("attn", "attn", "attn", "attn", "cross"),
    n_frontend_tokens=1024,
    sharding_profile="fsdp_tp",
)
