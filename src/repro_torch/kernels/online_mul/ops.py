"""Batched online multiply (port of `repro/kernels/online_mul/ops.py`).

`online_mul` dispatches on the device of its operands and on the
configuration: a CUDA tensor runs the Hopper kernel
(kernel.online_mul_kernel) when `resolve_use_pallas` allows it, decided
from the configuration before any launch, as the reference dispatches to
its Pallas kernel; a configuration past the int32 datapath's schedule, an
explicit use_pallas=False, or a CPU tensor runs the int64 plain version.
Both give the same digits. Where the kernel is allowed but no kernel
holds the configuration (`kernel.holds`: a residual the selection does
not bound and whose bound leaves int64), the call raises before any
launch.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels.common import decode_digits, resolve_use_pallas
from .ref import online_mul_batch_ref

__all__ = ["online_mul", "runs_kernel"]


def runs_kernel(cfg: OnlinePrecision, use_pallas: bool | None = None
                ) -> bool:
    """Whether a CUDA operand under `cfg` launches a kernel: the caller
    allows it and the schedule fits (`resolve_use_pallas`), and a kernel
    holds the configuration (`kernel.holds`); where only the first holds,
    `online_mul` raises."""
    from .kernel import holds
    return resolve_use_pallas(cfg, use_pallas) and holds(cfg)


def online_mul(x_digits: torch.Tensor, y_digits: torch.Tensor,
               cfg: OnlinePrecision, *, use_pallas: bool | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched online multiply of (B, n) digit operands.

    Returns (z_digits (B, n) int32, z_int (B,) int64 product scaled by
    2^n), both on the operands' device."""
    B, n = x_digits.shape
    if cfg.n != n:
        raise ValueError(f"operand digit count {n} != cfg n {cfg.n}")
    if x_digits.is_cuda and resolve_use_pallas(cfg, use_pallas):
        from .kernel import online_mul_kernel   # raises where none holds
        z = online_mul_kernel(x_digits.to(torch.int32).contiguous(),
                              y_digits.to(torch.int32).contiguous(), cfg)
    else:
        z, _ = online_mul_batch_ref(
            x_digits, y_digits, n=cfg.n, delta=cfg.delta, t=cfg.t,
            truncated=cfg.truncated, tail_gating=cfg.tail_gating,
            tail_guard=cfg.tail_guard)
    return z, decode_digits(z, n)
