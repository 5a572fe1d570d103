"""The fused online inner-product array (multiplier lanes + online adder
tree) as a float matmul front-end and a digit-level batched dot.

  matmul.py        - quantize-and-dispatch float matmul front-end
                     (`olm_matmul`): K1 (quantize in the kernel) or K2
                     (digit grids from the host) on a CUDA tensor, the
                     plain version on a CPU one; `olm_error_bound`
  matmul_kernel.py - K1/K2's launch plans and ctypes bindings
  ops.py           - the digit-level `online_dot` (K3) and its stream
                     helpers
  kernel.py, ref.py, tuning.py, matmul_sharded.py - K3's binding, the
                     plain versions, the autotuner, the sharded GEMM

The package re-exports the reference's public names
(`repro/kernels/online_dot/__init__.py`).
"""
from .matmul import olm_error_bound, olm_matmul, olm_matmul_ref
from .ops import dot_scale_log2, dot_stream_length, online_dot

__all__ = ["online_dot", "dot_scale_log2", "dot_stream_length",
           "olm_matmul", "olm_matmul_ref", "olm_error_bound"]
