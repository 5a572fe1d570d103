"""Signed-digit (SD) codec utilities for radix-2 online arithmetic (own
copy of `repro/core/sd.py`).

A value x in (-1, 1) is represented by n signed digits x_1..x_n, each in
{-1, 0, +1}, with x = sum_i x_i * 2^-i. Hardware encodes each digit as a
(x+, x-) bit pair with x_i = x+ - x- (borrow-save). These helpers convert
between dyadic fractions, digit vectors, and scaled integers, and implement
the OTFC (on-the-fly conversion) algorithm of Ercegovac & Lang used by the
multiplier to keep x[j]/y[j] in conventional two's-complement form without
carry propagation.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

__all__ = [
    "int_to_digits",
    "frac_to_digits",
    "digits_to_int",
    "digits_to_frac",
    "digits_to_nonredundant",
    "random_digits",
    "OTFC",
]


def int_to_digits(value: int, n: int) -> List[int]:
    """Encode integer `value` (|value| < 2^n) as n SD digits of value * 2^-n.

    Uses the sign-magnitude encoding: binary digits of |value| with the sign
    applied to every digit. This is always a valid SD representation.
    """
    if abs(value) >= 2**n:
        raise ValueError(f"|value| must be < 2^{n}, got {value}")
    sign = 1 if value >= 0 else -1
    mag = abs(value)
    return [sign * ((mag >> (n - i)) & 1) for i in range(1, n + 1)]


def frac_to_digits(x: float, n: int) -> List[int]:
    """Encode x in (-1, 1) as n SD digits (rounding to nearest 2^-n)."""
    v = int(round(x * (1 << n)))
    v = max(-(2**n) + 1, min(2**n - 1, v))
    return int_to_digits(v, n)


def digits_to_int(digits: Sequence[int], n: int | None = None) -> int:
    """Value of the digit vector scaled by 2^n (exact integer)."""
    if n is None:
        n = len(digits)
    acc = 0
    for i, d in enumerate(digits, start=1):
        acc += d * (1 << (n - i))
    return acc


def digits_to_frac(digits: Sequence[int]) -> float:
    return digits_to_int(digits, len(digits)) / float(1 << len(digits))


def digits_to_nonredundant(digits: Sequence[int]) -> List[int]:
    """Convert SD digits to conventional {0,1} bits of the two's complement
    representation of the same value (via exact integer round-trip)."""
    n = len(digits)
    v = digits_to_int(digits, n)
    return int_to_digits(abs(v), n) if v >= 0 else int_to_digits(v, n)


def random_digits(rng: np.random.Generator, n: int, batch: int | None = None):
    """Uniform random SD digit vectors in {-1,0,1}^n (batch x n if batch)."""
    shape = (n,) if batch is None else (batch, n)
    return rng.integers(-1, 2, size=shape)


class OTFC:
    """On-the-fly conversion of an MSDF signed-digit stream to conventional
    two's-complement form (Ercegovac & Lang 1987).

    Maintains Q (the converted prefix) and QM (= Q - ulp) so that appending a
    digit never needs carry propagation:

        d = +1:  Q' = Q.1   QM' = Q.0      (append bit to the chosen register)
        d =  0:  Q' = Q.0   QM' = QM.1
        d = -1:  Q' = QM.1  QM' = QM.0

    Register values are tracked as integers scaled by 2^j after j digits.
    """

    def __init__(self):
        self.q = 0
        self.qm = -1
        self.j = 0

    def append(self, d: int) -> None:
        if d not in (-1, 0, 1):
            raise ValueError(f"digit must be in {{-1,0,1}}, got {d}")
        q, qm = self.q, self.qm
        if d == 1:
            self.q, self.qm = 2 * q + 1, 2 * q
        elif d == 0:
            self.q, self.qm = 2 * q, 2 * qm + 1
        else:
            self.q, self.qm = 2 * qm + 1, 2 * qm
        self.j += 1

    def value(self) -> int:
        """Converted value scaled by 2^j (exact)."""
        return self.q

    @staticmethod
    def convert(digits: Iterable[int]) -> int:
        conv = OTFC()
        for d in digits:
            conv.append(d)
        return conv.value()
