"""Bit-exact reference of the radix-2 online multiplier (full & truncated p;
own copy of `repro/core/online_mul.py`).

Implements the recurrence of the paper (Eqs. 2-7) with exact integer
arithmetic, plus the paper's working-precision truncation (Eq. 8 / Fig. 7).

Datapath model
--------------
All quantities are integers scaled by 2^F with F = n + delta (the deepest
bit position any append can reach in the full design).

The *working precision* at step j is a schedule T(j) (Fig. 7):

    ramp    : T = j + 2*delta + 1      (digits accumulated so far + shift)
    plateau : T = p = ceil((2n+delta+t)/3)           (paper Eq. 8)
    tail    : T = t + (n-1-j) + tail_guard           ("error profile" decay)

At step j the appended term, the residual and the operand registers are
truncated (two's-complement floor) below 2^-T(j). Arriving digits always
drive the SELECTOR muxes (their +-register contribution lands at the top of
the scaled residual); only their *storage* into register slices is gated.
The full (non-truncated) design uses T(j) = min(j + 2*delta + 1, n + delta).

Properties the reference validates:
  * full design:      |z - x*y| <= 0.5 ulp @ 2^-n   (exhaustive n=8)
  * truncated (Eq.8): |z - x*y| <  1.1 ulp @ 2^-n   (exhaustive n=8)
  * tail gating with tail_guard >= 1 is bit-identical to plateau-only.

This scalar model is the oracle of the port's batched online_mul (its
CUDA kernel and plain PyTorch version), independent of both.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

from .precision import OnlinePrecision

__all__ = [
    "OnlineMulState",
    "OnlineMulTrace",
    "online_multiply",
    "selm",
    "working_precision",
]


def selm(v_hat_quarters: int) -> int:
    """Digit selection (paper Eq. 7) on the t=2-bit truncated estimate,
    expressed in units of 1/4.

      v_hat >= 1/2          -> +1
      -1/2 <= v_hat <= 1/4  ->  0
      v_hat <= -3/4         -> -1

    v_hat is a multiple of 1/4, so the three cases are exhaustive.
    """
    if v_hat_quarters >= 2:
        return 1
    if v_hat_quarters >= -2:
        return 0
    return -1


def working_precision(cfg: OnlinePrecision, j: int) -> int:
    """T(j): live fractional bit-slices of the datapath at step j
    (j in [-delta, n-1]). This is the Fig. 7 activity schedule.

    The non-truncated baseline keeps the natural fill ramp (registers are
    empty until digits arrive) but no plateau cap and no tail decay; the
    proposed design adds the Eq. 8 plateau and the error-profile tail.
    NOTE: paper Fig. 5's caption suggests the conventional design keeps all
    n slices active in every stage; we use the *conservative* ramped
    baseline, which understates our savings relative to Table I.
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


def _floor_at(value: int, keep_frac_bits: int, scale_bits: int) -> int:
    """Truncate (floor) `value` scaled by 2^scale_bits below 2^-keep_frac_bits."""
    drop = scale_bits - keep_frac_bits
    if drop <= 0:
        return value
    return (value >> drop) << drop


class OnlineMulState:
    """One multiplier's architectural state, advanced one step per cycle.

    Used directly by `online_multiply` and by the unrolled-pipeline
    simulator (core/pipeline.py), which keeps one in-flight state per
    operand pair and advances each through the stage it currently occupies.
    """

    __slots__ = ("cfg", "F", "X", "Y", "W", "Z", "j", "z_digits",
                 "selm_inputs", "active", "wmax", "flips")

    def __init__(self, cfg: OnlinePrecision):
        self.cfg = cfg
        self.F = cfg.n + cfg.delta
        self.X = 0
        self.Y = 0
        self.W = 0
        self.Z = 0
        self.j = -cfg.delta
        self.z_digits: List[int] = []
        self.selm_inputs: List[int] = []
        self.active: List[int] = []
        self.wmax = 0.0
        self.flips = 0  # register bit flips (switching-activity proxy)

    @property
    def done(self) -> bool:
        return self.j >= self.cfg.n

    def step(self, x_digits: Sequence[int], y_digits: Sequence[int]) -> int | None:
        """Advance one iteration; returns the output digit (None during
        initialization). x_digits/y_digits are the full operand digit
        vectors; the state fetches the digit arriving this cycle."""
        cfg, F = self.cfg, self.F
        d, t, n = cfg.delta, cfg.t, cfg.n
        j = self.j
        T = working_precision(cfg, j)
        q = j + 1 + d  # arriving digit position
        xd_new = x_digits[q - 1] if 1 <= q <= n else 0
        yd_new = y_digits[q - 1] if 1 <= q <= n else 0
        # Register (CA-REG) slice gating: a slice beyond the live datapath
        # width is not built, so the arriving digit's own bit is never
        # *stored* (and cannot generate floor-boundary borrows); the digit
        # still drives the SELECTOR muxes below.
        store = 1 <= q <= T
        # v[j] = 2 w[j] + (x[j]*y_{j+1+d} + y[j+1]*x_{j+1+d}) * 2^-d ; the
        # arriving digits are SELECTOR mux *controls* and always apply.
        Y_full = self.Y + yd_new * (1 << (F - q)) if (yd_new and store) else self.Y
        term = self.X * yd_new + Y_full * xd_new  # scaled 2^F
        # 2^-delta scaling; arithmetic shift right == two's-complement
        # floor; then truncation to the live datapath width T(j):
        append = _floor_at(term >> d, T, F)
        X_full = self.X + xd_new * (1 << (F - q)) if (xd_new and store) else self.X
        X_new = _floor_at(X_full, T, F)
        Y_new = _floor_at(Y_full, T, F)
        V = 2 * self.W + append
        out: int | None = None
        if j >= 0:
            vq = V >> (F - t)  # selection estimate in quarters (floor)
            zj = selm(vq)
            self.selm_inputs.append(vq)
            self.z_digits.append(zj)
            self.Z = 2 * self.Z + zj  # builds sum z_i 2^(n-i)
            W_new = V - zj * (1 << F)
            out = zj
        else:
            W_new = V
        W_new = _floor_at(W_new, T, F)
        self.flips += (
            bin((X_new ^ self.X) & ((1 << (F + 4)) - 1)).count("1")
            + bin((Y_new ^ self.Y) & ((1 << (F + 4)) - 1)).count("1")
            + bin((W_new ^ self.W) & ((1 << (F + 4)) - 1)).count("1")
        )
        self.X, self.Y, self.W = X_new, Y_new, W_new
        self.active.append(T)
        self.wmax = max(self.wmax, abs(W_new) / float(1 << F))
        self.j += 1
        return out


@dataclasses.dataclass
class OnlineMulTrace:
    """Full execution trace of one online multiplication."""

    z_digits: List[int]
    z_int: int                      # product digits as integer scaled 2^n
    residual_bound: float           # max |w[j]| observed
    active_per_step: List[int]      # live fractional slices per step (Fig. 7)
    selm_inputs: List[int]          # v-hat (quarters) per digit-producing step
    flips: int                      # register bit flips across the run

    @property
    def n(self) -> int:
        return len(self.z_digits)

    @property
    def z_value(self) -> float:
        return self.z_int / float(1 << self.n)


def online_multiply(
    x_digits: Sequence[int],
    y_digits: Sequence[int],
    cfg: OnlinePrecision | None = None,
) -> OnlineMulTrace:
    """Multiply two n-digit SD fractions with the online algorithm.

    Args:
      x_digits, y_digits: n signed digits each (MSD first), value in (-1, 1).
      cfg: precision configuration; defaults to truncated p per Eq. 8 with
        the Fig. 7 tail schedule.

    Returns an OnlineMulTrace with output digits z_1..z_n.
    """
    n = len(x_digits)
    if len(y_digits) != n:
        raise ValueError("operands must have equal digit counts")
    if cfg is None:
        cfg = OnlinePrecision(n=n)
    if cfg.n != n:
        raise ValueError(f"cfg.n={cfg.n} != len(digits)={n}")
    st = OnlineMulState(cfg)
    while not st.done:
        st.step(x_digits, y_digits)
    return OnlineMulTrace(
        z_digits=st.z_digits,
        z_int=st.Z,
        residual_bound=st.wmax,
        active_per_step=st.active,
        selm_inputs=st.selm_inputs,
        flips=st.flips,
    )
