"""Kernel engine core: symbolic worst-case magnitude propagation (Eq. 8)
(port of `repro/analysis/overflow.py`, the same walk and the same answers:
bits and detail strings).

The walk itself, `prove_schedule`, lives beside the runtime guards in
`kernels/common.py`, since `online_mul.kernel.lane_bits` decides the
general lane's datapath with it; this module holds the reference's
contracts over it. `checked_schedule` guards kernel entry with the coarse
bound max T(j) + 3 <= 31; `prove_schedule` *proves* the property that
guard stands for, and `check_schedule` reports a width it cannot prove
(and whether the runtime guard would wrongly accept it).

The online adder tree needs no interval walk: its digits provably never
leave {-2..2}, shown by exhaustive enumeration of the 2-digit-window
recurrence over all (e_k, e_{k+1}, e_{k+2}) triples. What k_tile actually
constrains is the *stream length* into the exact decode, checked against
the per-width window for every k_tile in the autotuner's legal range.
"""
from __future__ import annotations

import itertools
from typing import Iterable

from repro_torch.configs.olm_array import MATMUL_MODES, TRUNCATED_SPECS
from repro_torch.core.precision import OnlinePrecision
from repro_torch.kernels.common import (decode_policy, fits_int32,
                                        prove_schedule)
from repro_torch.kernels.online_dot.ref import tree_levels
from repro_torch.kernels.online_dot.tuning import decode_window, max_k_tile

from .contracts import Violation

__all__ = ["prove_schedule", "adder_tree_digit_bound", "check_schedule",
           "check_decode_windows", "run"]

def adder_tree_digit_bound() -> int:
    """Max |output digit| of the online adder-tree recurrence, proven by
    exhaustive enumeration of its 2-digit window over every consistent
    (e_k, e_{k+1}, e_{k+2}) triple with e in [-2, 2] (pairwise sums of SD
    digits). Must be 1: then level outputs are again SD digits, the
    per-level bound holds inductively down the whole tree, and no tree
    value ever stresses int32."""
    def transfer(e, en):
        if e >= 2 or (e == 1 and en >= 0):
            return 1
        if e <= -2 or (e == -1 and en < 0):
            return -1
        return 0

    worst = 0
    rng = range(-2, 3)
    for ek, e1, e2 in itertools.product(rng, rng, rng):
        w_k = ek - 2 * transfer(ek, e1)
        out = w_k + transfer(e1, e2)
        worst = max(worst, abs(out))
    return worst


def check_schedule(cfg: OnlinePrecision, *, where: str) -> list[Violation]:
    """int32-overflow contract for one precision config."""
    bits, detail = prove_schedule(cfg)
    if bits <= 31:
        return []
    extra = ("" if not fits_int32(cfg) else
             " — and the runtime fits_int32 guard WRONGLY accepts it")
    return [Violation("int32-overflow", where,
                      f"recurrence needs {bits} bits: {detail}{extra}")]


def check_decode_windows(n_bits: int, *, where: str) -> list[Violation]:
    """decode-window contract over the autotuner's legal k_tile range
    (every power of two up to max_k_tile), plus the tree-digit lemma that
    makes stream length the only k_tile-dependent hazard."""
    out: list[Violation] = []
    bound = adder_tree_digit_bound()
    if bound > 1:
        out.append(Violation(
            "int32-overflow", where,
            f"adder-tree output digits reach |{bound}| > 1: the "
            "per-level SD-digit induction is broken"))
    kt, window = 1, decode_window(n_bits)
    while kt <= max_k_tile(n_bits):
        m = n_bits + 2 * tree_levels(kt)
        try:
            decode_policy(m)
            legal = m <= window
        except ValueError:
            legal = False
        if not legal:
            out.append(Violation(
                "decode-window", f"{where} k_tile={kt}",
                f"stream length {m} = {n_bits} + 2*ceil(log2 {kt}) "
                f"exceeds this width's exact window of {window} digits"))
        kt *= 2
    return out


def run(widths: Iterable[int] | None = None) -> list[Violation]:
    """Prove the overflow/decode contracts for every registered width,
    including each width's truncated olm{n}t{p} tiers (their schedules are
    the p-digit arrays; the proofs run at p under the family label)."""
    widths = tuple(sorted(widths if widths is not None else MATMUL_MODES))
    out: list[Violation] = []
    for n in widths:
        cfg = OnlinePrecision(n=n)
        out.extend(check_schedule(cfg, where=f"schedule/olm{n}"))
        out.extend(check_decode_windows(n, where=f"decode/olm{n}"))
        for nn, p in TRUNCATED_SPECS:
            if nn != n:
                continue
            out.extend(check_schedule(OnlinePrecision(n=p),
                                      where=f"schedule/olm{n}t{p}"))
            out.extend(check_decode_windows(p, where=f"decode/olm{n}t{p}"))
    return out
