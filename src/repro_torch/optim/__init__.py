"""Optimizer, LR schedule and gradient compression of the port (own
copies of `repro/optim/`, plain PyTorch: the reference computes them in
`jnp`, outside any Pallas kernel)."""
from .adamw import AdamWConfig, adamw_init, adamw_update
from .schedule import cosine_schedule
from .compression import compress_int8, decompress_int8
