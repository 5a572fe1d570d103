"""The Fig. 7 working-precision schedule of the radix-2 online multiplier.

Only `working_precision` is needed by the port: the kernels and the plain
recurrence take the schedule T(j) as an array (kernels/common.py).
"""
from __future__ import annotations

from .precision import OnlinePrecision

__all__ = ["working_precision"]


def working_precision(cfg: OnlinePrecision, j: int) -> int:
    """T(j): live fractional bit-slices of the datapath at step j
    (j in [-delta, n-1]).

    ramp    : T = j + 2*delta + 1
    plateau : T = p = ceil((2n+delta+t)/3)             (paper Eq. 8)
    tail    : T = t + (n-1-j) + tail_guard             (error-profile decay)

    The non-truncated baseline keeps the fill ramp with no plateau cap and
    no tail decay.
    """
    n, d, t = cfg.n, cfg.delta, cfg.t
    full = n + d
    ramp = j + 2 * d + 1
    if not cfg.truncated:
        return max(min(ramp, full), 1)
    T = min(ramp, cfg.p)
    if cfg.tail_gating and j >= 0:
        tail = t + (n - 1 - j) + cfg.tail_guard
        T = min(T, max(tail, t + 1))
    return max(T, 1)
