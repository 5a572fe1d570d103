"""Checkpointing of the port (own copy of `repro/checkpoint/`)."""
from .manager import CheckpointManager
