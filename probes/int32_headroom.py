#!/usr/bin/env python3
"""Which configurations of the online multiplier leave the int32 datapath.

`checked_schedule` admits a configuration when max T(j) + 3 <= 31, which
bounds the live slices but not the residual: where the selection cannot
keep W in range (a delay of 1 or an estimate of 1 fractional digit at
large n) an int32 datapath overflows on some inputs, while the int64
plain versions do not. This script replays the kernels' recurrence
(csrc/olm_digits.cuh `lane_any`, the same arithmetic as every kernel's
lane) in exact Python integers over random digit pairs and the all-ones
and alternating operands, and prints for each configuration the lanes
whose values leave int32, the largest |value| / 2^S seen, and the
datapath the kernels run it in (kernels/online_mul/kernel.py
`lane_bits`: 32 bits only where the selection condition holds and
kernels/common.py's `prove_schedule` shows every value within 31
bits). Plain Python and numpy; runs anywhere in about a minute:

    python3 probes/int32_headroom.py [--lanes 1000]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.precision import OnlinePrecision  # noqa: E402
from repro_torch.kernels.common import checked_schedule  # noqa: E402
from repro_torch.kernels.online_mul.kernel import lane_bits  # noqa: E402

CONFIGS = (dict(n=16), dict(n=32), dict(n=16, delta=4), dict(n=16, t=3),
           dict(n=16, delta=2, t=1), dict(n=8, delta=0), dict(n=36),
           dict(n=40), dict(n=16, delta=4, truncated=False,
                            tail_gating=False),
           dict(n=32, delta=1), dict(n=34, delta=1), dict(n=36, delta=1),
           dict(n=16, t=1), dict(n=24, t=1), dict(n=32, t=1),
           dict(n=40, t=1), dict(n=24, truncated=False),
           dict(n=16, delta=2), dict(n=28, delta=2, t=3),
           # F6: the selection condition holds, the residual grows
           dict(n=24, delta=2, t=4), dict(n=28, delta=2, t=4),
           dict(n=32, delta=2, t=5), dict(n=24, delta=3, t=4))


def lane_peak(x, y, cfg: OnlinePrecision, sched, S: int) -> int:
    """The largest |term| or |V| of one lane's recurrence."""
    n, delta, t = cfg.n, cfg.delta, cfg.t
    X = Y = W = top = 0
    for s in range(n + delta):
        T = sched[s]
        keep = -(1 << max(S - T, 0))          # the mask below 2^-T(j)
        wq = (1 << max(S - s - 1, 0)) if s + 1 <= min(T, S) else 0
        xd = int(x[s]) if s < n else 0
        yd = int(y[s]) if s < n else 0
        Yf = Y + yd * wq
        term = X * yd + Yf * xd
        X = (X + xd * wq) & keep
        Y = Yf & keep
        V = 2 * W + ((term >> delta) & keep)
        top = max(top, abs(term), abs(V))
        if s >= delta:
            vq = V >> (S - t)
            z = 1 if vq >= 2 else (0 if vq >= -2 else -1)
            W = (V - z * (1 << S)) & keep
        else:
            W = V & keep
    return top


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    for kw in CONFIGS:
        cfg = OnlinePrecision(**kw)
        sched, S = checked_schedule(cfg)
        sched = [int(v) for v in sched]
        ones = np.ones(cfg.n, np.int64)
        alt = np.resize(np.array([1, -1], np.int64), cfg.n)
        pairs = [(ones, ones), (ones, -ones), (alt, alt), (alt, ones)] + [
            (rng.integers(-1, 2, cfg.n), rng.integers(-1, 2, cfg.n))
            for _ in range(args.lanes)]
        peaks = [lane_peak(x, y, cfg, sched, S) for x, y in pairs]
        bad = sum(p >= 2**31 for p in peaks)
        print(f"{kw}: S={S}, {bad} of {len(pairs)} lanes leave int32, "
              f"largest |value| / 2^S = {max(peaks) / 2**S:.4f}, lane "
              f"{lane_bits(cfg, sched, S)} bits")
    return 0


if __name__ == "__main__":
    sys.exit(main())
