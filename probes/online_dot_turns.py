#!/usr/bin/env python3
"""K3 (`online_dot`) times of one or more checkouts of the port, on one
card, in turns: the A/B comparison of two trees at `chip_smoke.py`'s timed
shapes that two separate `chip_smoke.py` runs cannot give.

Run on a machine with one CUDA card and the CUDA toolkit, naming the roots
of the checkouts to compare (each builds and imports its own `src/` in its
own process), e.g. the parent unpacked by `git archive` and this tree, in
the order parent, change, change, parent:

    python3 probes/online_dot_turns.py PARENT . . PARENT

Each process times K3 at B=4096 for every (K, n) of `chip_smoke.py`'s
DOT_CASES (truncated), the general K3/K4 routes at GENERAL_TIMED and K3
past 1024 lanes at LONG_TIMED, with this tree's `chip_smoke.cuda_ms`
(cold L2, median of single launches), and prints one line a shape with
the route the checkout takes there. `--only dot|general|long` keeps one
of the three groups.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 41


def times(root: str, only: str | None) -> None:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (DOT_B, DOT_CASES, GENERAL_TIMED, LONG_TIMED,
                            cuda_ms, digits)
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch
    from repro_torch.core.precision import OnlinePrecision
    from repro_torch.kernels.online_dot import kernel as k3
    from repro_torch.kernels.online_mul import kernel as k4
    if not k3.__file__.startswith(str(Path(root).resolve())):
        raise SystemExit(f"imported {k3.__file__}, not {root}'s kernel")
    dev = torch.device("cuda", 0)
    cases = []                  # (label, operand shape, configuration)
    if only in (None, "dot"):
        cases += [(f"online_dot B={DOT_B} K={K} n={n}", (DOT_B, K, n),
                   OnlinePrecision(n=n)) for K, n in DOT_CASES]
    if only in (None, "general"):
        for K, kw, B in GENERAL_TIMED:
            cfg = OnlinePrecision(**kw)
            shape = (B, cfg.n) if K is None else (B, K, cfg.n)
            kernel = "online_mul" if K is None else "online_dot"
            cases.append((f"{kernel} general B={B} K={K} {kw}", shape, cfg))
    if only in (None, "long"):
        cases += [(f"online_dot long B={B} K={K} n={n}", (B, K, n),
                   OnlinePrecision(n=n)) for B, K, n in LONG_TIMED]
    for label, shape, cfg in cases:
        xd, yd = digits(shape, shape[-2] + cfg.n, dev)
        if len(shape) == 2:
            fn, route = k4.online_mul_kernel, k4.route(cfg)
        else:
            fn, route = k3.online_dot_kernel, k3.route(cfg, shape[1])
        ms = cuda_ms(lambda: fn(xd, yd, cfg), reps=REPS, warmup=3)
        print(f"[turns] {root} {label} ({route} kernel): {ms:.4f} ms",
              flush=True)
        del xd, yd


def main() -> int:
    args = sys.argv[1:]
    only = None
    if args[:1] == ["--only"]:
        only, args = args[1], args[2:]
    if args[:1] == ["--one"]:
        times(args[1], None if args[2] == "all" else args[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("online_dot_turns: no CUDA card", file=sys.stderr)
        return 2
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    failed = [root for root in args if subprocess.run(
        [sys.executable, __file__, "--one", root, only or "all"]).returncode]
    if failed:
        print(f"online_dot_turns: failed on {failed}", file=sys.stderr)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(out.stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
