#!/usr/bin/env python3
"""K3's kernels (`csrc/online_dot.cu`) at each count of resident blocks an
SM: does a persistent grid whose groups do not divide evenly over its
blocks cost time?

Run on a machine with one CUDA card and the CUDA toolkit:

    python3 probes/online_dot_waves.py

A launch's grid is the SMs times the blocks an SM holds (`launch_plan`),
and block b runs groups b, b + grid, ...: an SM runs `per_sm` blocks of
ceil(groups / grid) or one fewer groups each. For every shape
`chip_smoke.py` times K3 and K4's general route at (DOT_CASES,
GENERAL_TIMED, LONG_TIMED) this prints the blocks the card fits an SM,
then for each count per_sm from 1 to that, the most groups one SM runs
(per_sm * ceil(groups / grid)) over the mean (groups / SMs) and the
median time of the launch (chip_smoke's `cuda_ms`, cold L2) with the grid
cut to per_sm blocks an SM.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
REPS = 21


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("online_dot_waves: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import (DOT_B, DOT_CASES, GENERAL_TIMED, LONG_TIMED,
                            cuda_ms, digits, smi)
    from repro_torch.core.precision import OnlinePrecision
    from repro_torch.kernels.online_dot import kernel as k3
    from repro_torch.kernels.online_mul import kernel as k4

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [((DOT_B, K, n), OnlinePrecision(n=n)) for K, n in DOT_CASES]
    cases += [((B, cfg.n) if K is None else (B, K, cfg.n), cfg)
              for K, kw, B in GENERAL_TIMED
              for cfg in (OnlinePrecision(**kw),)]
    cases += [((B, K, n), OnlinePrecision(n=n)) for B, K, n in LONG_TIMED]
    card_geometry = k3.geometry
    cap = [None]

    def capped(*args):
        smem, blocks = card_geometry(*args)
        return smem, blocks if cap[0] is None else min(blocks, cap[0])

    k3.geometry = capped
    for shape, cfg in cases:
        xd, yd = digits(shape, shape[-2] + cfg.n, dev)
        if len(shape) == 2:
            fn, route, B, K = k4.online_mul_kernel, k4.route(cfg), shape[0], 1
        else:
            fn, route = k3.online_dot_kernel, k3.route(cfg, shape[1])
            B, K = shape[0], shape[1]
        general = route == "any"
        vec = cfg.n % 4 == 0
        plan = k3.launch_plan(B, K, cfg.n, vec, sms, general=general)
        wide = general and k3.check_config(cfg)[2] == 64
        L = k3.tree_levels(K)
        fit = card_geometry(cfg.n, vec, plan.rows, L, general, wide)[1]
        fit = min(fit, k3.BLOCKS_PER_SM)
        out = []
        for per_sm in range(1, fit + 1):
            cap[0] = per_sm
            grid = min(plan.groups, sms * per_sm)
            load = per_sm * -(-plan.groups // grid) / (plan.groups / sms)
            ms = cuda_ms(lambda: fn(xd, yd, cfg), reps=REPS, warmup=2)
            out.append(f"{per_sm}: {load:.3f} {ms:.4f}")
        cap[0] = None
        print(f"[waves] {shape} {cfg} ({route}) groups={plan.groups} "
              f"fit={fit}: " + "; ".join(out), flush=True)
        del xd, yd
    print(smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
