"""Precision configuration for the online truncated-precision multiplier.

Implements Eq. (8) of the paper:

    p = ceil((2n + delta + t) / 3)

the reduced working precision (number of fractional bit-slices) that
keeps the radix-2 online multiplier's selection function valid with a
`t`-fractional-MSD estimate and a [4:2] redundant adder.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["reduced_precision", "truncation_schedule", "OnlinePrecision"]


def reduced_precision(n: int, delta: int = 3, t: int = 2) -> int:
    """Paper Eq. (8): minimum working fractional bit-slices for n-digit output."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    return math.ceil((2 * n + delta + t) / 3)


def truncation_schedule(n: int, p: int, delta: int = 3,
                        t: int = 2) -> "OnlinePrecision":
    """Working-precision schedule of the truncated `olm{n}t{p}` family:
    the n-digit array run with only p < n working digits, i.e. the Eq. 8
    schedule instanced at p (p + delta recurrence iterations, p-digit
    operand grids). Validates delta + 1 <= p < n."""
    if not delta + 1 <= p < n:
        raise ValueError(
            f"truncated working precision must satisfy delta+1={delta + 1} "
            f"<= p < n; got p={p}, n={n}")
    return OnlinePrecision(n=p, delta=delta, t=t)


@dataclasses.dataclass(frozen=True)
class OnlinePrecision:
    """Numeric configuration of a radix-2 online multiplier instance.

    n: output precision in digits; delta: online delay (3); t: fractional
    MSDs of the selection estimate (2); ib: integer bits of the residual
    datapath (2); truncated: working precision p = Eq. 8 instead of
    n + delta; tail_gating: also gate slices that can no longer reach the
    selection window (Fig. 7 tail); tail_guard: slack positions kept live
    in that tail (G = 2 keeps every n at sub-ulp error).
    """

    n: int
    delta: int = 3
    t: int = 2
    ib: int = 2
    truncated: bool = True
    tail_gating: bool = True
    tail_guard: int = 2

    def __post_init__(self):
        if self.n < self.delta + 1:
            raise ValueError(
                f"n must exceed online delay; got n={self.n} delta={self.delta}")

    @property
    def p(self) -> int:
        """Working fractional precision (bit-slices) of the datapath."""
        full = self.n + self.delta
        if not self.truncated:
            return full
        return min(reduced_precision(self.n, self.delta, self.t), full)

    @property
    def steps(self) -> int:
        """Total iterations: delta initialization + n digit-producing steps."""
        return self.n + self.delta
