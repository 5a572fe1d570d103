"""Radix-2 online signed-digit addition (online delay 2; own copy of
`repro/core/online_add.py`).

MSDF digit-serial addition of two SD streams, used to chain online
multipliers into inner-product trees (the paper's target workload: the
product digits of each multiplier feed an online adder tree after only
delta_mul + 2*ceil(log2 k) cycles of total online delay).

Digit-set closure needs one digit of lookahead (hence delta = 2). With
e_k = x_k + y_k in {-2..2}:

    t_k = +1  if e_k >= 2 or (e_k == +1 and e_{k+1} >= 0)
    t_k = -1  if e_k <= -2 or (e_k == -1 and e_{k+1} <  0)
    t_k =  0  otherwise
    w_k = e_k - 2 t_k            in {-1, 0, +1}
    z_k = w_k + t_{k+1}          in {-1, 0, +1}   (proved: no collision)

z_k depends on digits up to position k+2, so the adder emits digit k two
cycles after receiving position-k inputs.
"""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["online_add", "OnlineAdder"]

DELTA_ADD = 2


def _transfer(e_k: int, e_next: int) -> int:
    if e_k >= 2 or (e_k == 1 and e_next >= 0):
        return 1
    if e_k <= -2 or (e_k == -1 and e_next < 0):
        return -1
    return 0


class OnlineAdder:
    """Streaming form: push one (x_k, y_k) digit pair per cycle, pop the
    output digit for position k - DELTA_ADD (None during the delay)."""

    def __init__(self):
        self._e: List[int] = []   # pending digit sums (window of 2)
        self._w_prev: int | None = None
        self._k = 0

    def push(self, x_k: int, y_k: int) -> int | None:
        self._e.append(x_k + y_k)
        self._k += 1
        if len(self._e) < 2:
            return None
        e_k, e_next = self._e[0], self._e[1]
        t_k = _transfer(e_k, e_next)
        w_k = e_k - 2 * t_k
        out = None
        if self._w_prev is not None:
            out = self._w_prev + t_k
        self._w_prev = w_k
        self._e.pop(0)
        return out

    def flush(self) -> List[int]:
        """Feed two zero pairs to drain the delay line; returns last digits."""
        outs = []
        for _ in range(DELTA_ADD):
            o = self.push(0, 0)
            if o is not None:
                outs.append(o)
        return outs


def online_add(x_digits: Sequence[int], y_digits: Sequence[int]) -> List[int]:
    """Add two aligned n-digit SD fractions; returns n+2 SD digits of the sum
    scaled by 1/2 (one extra integer position folded in), i.e.

        sum_i out_i 2^-i  ==  (x + y) / 2

    The /2 pre-scaling keeps the result in (-1, 1) for any SD inputs, which
    is how the inner-product tree normalizes each reduction level.
    """
    n = len(x_digits)
    if len(y_digits) != n:
        raise ValueError("operands must have equal digit counts")
    # Scale by 1/2 = shift digits one position right; position 1 becomes 0 pad.
    xs = [0] + list(x_digits)
    ys = [0] + list(y_digits)
    adder = OnlineAdder()
    out: List[int] = []
    for xk, yk in zip(xs, ys):
        o = adder.push(xk, yk)
        if o is not None:
            out.append(o)
    out.extend(adder.flush())
    assert len(out) == n + 1
    # Append one more exact digit slot (delay line emits n+1 of n+1 inputs);
    # pad to n+2 for callers that track the full significance range.
    out.append(0)
    return out
