"""Online inner products: pipelined multiplier array + online adder tree
(own copy of `repro/core/inner_product.py`; the scalar oracle of the
port's batched online_dot).

The paper's target workload: inner products for CNN/matmul accelerators
(Eyeriss PEs, FPGA matmul engines). Each PE multiplies streamed operand
pairs MSDF; product digit streams feed a balanced tree of online adders
(delta_add = 2 per level), so the whole dot product is digit-serial with a
total online delay of

    delta_dot = delta_mul + 2 * ceil(log2 k)

and never waits for any full-precision intermediate.

Normalization: each adder level emits (a + b)/2 to stay in (-1, 1), so the
tree output equals  sum_i x_i y_i / 2^L  with L = ceil(log2 k) (documented
scale, exact).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

from .online_add import online_add
from .online_mul import online_multiply
from .pipeline import PipelineRun, run_pipeline
from .precision import OnlinePrecision

__all__ = ["OnlineDotResult", "online_dot", "online_dot_pipelined"]


@dataclasses.dataclass
class OnlineDotResult:
    digits: List[int]          # SD digits of sum(x_i y_i) / 2^L
    value: float               # decoded value (already includes the 2^-L scale)
    scale_log2: int            # L: result = dot / 2^L
    online_delay: int          # delta_mul + 2 L
    cycles: int                # pipelined cycles to drain all k products
    pipeline: PipelineRun | None = None

    @property
    def dot_value(self) -> float:
        """The actual inner product value (scale removed)."""
        return self.value * (1 << self.scale_log2)


def _tree_reduce(streams: List[List[int]]) -> Tuple[List[int], int]:
    """Reduce SD digit streams pairwise with the online adder; returns the
    final stream and the number of levels (scale log2)."""
    level = 0
    while len(streams) > 1:
        if len(streams) % 2:
            streams = streams + [[0] * len(streams[0])]
        nxt = []
        for a, b in zip(streams[::2], streams[1::2]):
            nxt.append(online_add(a, b))
        streams = nxt
        level += 1
    return streams[0], level


def online_dot(
    xs: Sequence[Sequence[int]],
    ys: Sequence[Sequence[int]],
    cfg: OnlinePrecision | None = None,
) -> OnlineDotResult:
    """Functional online inner product of k SD operand pairs (non-pipelined
    timing; use online_dot_pipelined for the streamed-array timing)."""
    k = len(xs)
    if k == 0 or len(ys) != k:
        raise ValueError("need equal, nonzero operand counts")
    n = len(xs[0])
    if cfg is None:
        cfg = OnlinePrecision(n=n)
    prods = [online_multiply(x, y, cfg).z_digits for x, y in zip(xs, ys)]
    out, levels = _tree_reduce([list(p) for p in prods])
    val = sum(d * 2.0 ** -(i + 1) for i, d in enumerate(out))
    return OnlineDotResult(
        digits=out,
        value=val,
        scale_log2=levels,
        online_delay=cfg.delta + 2 * levels,
        cycles=(cfg.n + cfg.delta + 1) * k,  # non-pipelined (Table III row 3)
    )


def online_dot_pipelined(
    xs: Sequence[Sequence[int]],
    ys: Sequence[Sequence[int]],
    cfg: OnlinePrecision | None = None,
) -> OnlineDotResult:
    """Inner product with the k pairs streamed through the unrolled
    pipelined multiplier (paper's proposed design): the multiplier array
    drains in (n + delta + 1) + (k - 1) cycles (Table III rows 4-5), and
    the adder tree adds 2*ceil(log2 k) cycles of online delay."""
    k = len(xs)
    n = len(xs[0])
    if cfg is None:
        cfg = OnlinePrecision(n=n)
    run = run_pipeline(list(zip(xs, ys)), cfg)
    prods = [t.z_digits for t in run.traces]
    out, levels = _tree_reduce([list(p) for p in prods])
    val = sum(d * 2.0 ** -(i + 1) for i, d in enumerate(out))
    return OnlineDotResult(
        digits=out,
        value=val,
        scale_log2=levels,
        online_delay=cfg.delta + 2 * levels,
        cycles=run.cycles + 2 * int(math.ceil(math.log2(max(k, 2)))),
        pipeline=run,
    )
