"""PyTorch + CUDA port of the online-multiplier inner-product array system.

Mirrors the module layout of the JAX package `repro` (the reference it is
held against) but imports nothing from it: every piece it needs is its own
copy. Entry points (`models.model.Model`, `serving.engine.ServeEngine`,
`launch.serve`) run on the CUDA device unless the caller passes
``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain
PyTorch version, on a CUDA tensor it launches the hand-written Hopper
kernel (`csrc/`) or raises.
"""
