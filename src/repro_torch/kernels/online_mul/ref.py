"""Plain int64 recurrence of the batched radix-2 online multiplier (port of
`repro/kernels/online_mul/ref.py::online_mul_batch_ref`).

The recurrence of the paper (Eqs. 2-7) with exact integer arithmetic at
scale 2^F, F = n + delta, truncated each step to the Fig. 7 working
precision T(j). Operands broadcast against each other over their leading
axes, so a matmul can hand it an (M, 1, k, n) row grid and a (1, N, k, n)
column grid: the X register depends only on x digits and stays
(M, 1, k), the Y register stays (1, N, k), and only the residual W and
the output take the full (M, N, k) fan-out.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels.common import schedule_arrays

__all__ = ["online_mul_batch_ref"]


def _floor_at(v: torch.Tensor, drop: int) -> torch.Tensor:
    """Two's-complement floor of `v` to a multiple of 2^drop."""
    return (v >> drop) << drop if drop > 0 else v


def online_mul_batch_ref(x_digits: torch.Tensor, y_digits: torch.Tensor, *,
                         n: int, delta: int = 3, t: int = 2,
                         truncated: bool = True, tail_gating: bool = True,
                         tail_guard: int = 2
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched online multiplication of (..., n) signed-digit operands
    (digits in {-1, 0, 1}, MSD first; leading axes broadcast).

    Returns (z_digits (..., n) int32 output digits, z_int (...) int64
    product scaled by 2^n)."""
    cfg = OnlinePrecision(n=n, delta=delta, t=t, truncated=truncated,
                          tail_gating=tail_gating, tail_guard=tail_guard)
    if x_digits.shape[-1] != n or y_digits.shape[-1] != n:
        raise ValueError(f"operands must have {n} digits, got "
                         f"{x_digits.shape[-1]} and {y_digits.shape[-1]}")
    F = n + delta
    sched = schedule_arrays(cfg)
    xd = x_digits.to(torch.int64)
    yd = y_digits.to(torch.int64)
    lead = torch.broadcast_shapes(xd.shape[:-1], yd.shape[:-1])
    dev = xd.device
    X = torch.zeros(xd.shape[:-1], dtype=torch.int64, device=dev)
    Y = torch.zeros(yd.shape[:-1], dtype=torch.int64, device=dev)
    W = torch.zeros(lead, dtype=torch.int64, device=dev)
    Z = torch.zeros(lead, dtype=torch.int64, device=dev)
    zout = torch.zeros(lead + (n,), dtype=torch.int32, device=dev)
    for s in range(n + delta):
        j = s - delta
        T = int(sched[s])
        q = j + 1 + delta                    # arriving digit position
        drop = max(F - T, 0)
        if 1 <= q <= n:
            xn, yn = xd[..., q - 1], yd[..., q - 1]
        else:
            xn = yn = 0
        # Register-slice gating: the arriving digit's own bit is stored
        # only while its slice is live (q <= T); it always drives the
        # selector muxes.
        wq = (1 << max(F - q, 0)) if q <= T else 0
        Yf = Y + yn * wq
        term = X * yn + Yf * xn
        append = _floor_at(term >> delta, drop)
        X = _floor_at(X + xn * wq, drop)
        Y = _floor_at(Yf, drop)
        V = 2 * W + append
        if j >= 0:
            vq = V >> (F - t)                # selection estimate, quarters
            zj = (vq >= 2).to(torch.int64) - (vq < -2).to(torch.int64)
            Z = 2 * Z + zj
            W = _floor_at(V - (zj << F), drop)
            zout[..., j] = zj.to(torch.int32)
        else:
            W = _floor_at(V, drop)
    return zout, Z
