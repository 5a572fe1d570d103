"""Kernels of the port: each hand-written CUDA kernel (`csrc/`) beside the
plain PyTorch version it is held against."""
