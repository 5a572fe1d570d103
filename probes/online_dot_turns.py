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
DOT_CASES (truncated), with this tree's `chip_smoke.cuda_ms` (cold L2,
median of single launches), and prints one line a shape.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 41


def times(root: str) -> None:
    sys.path.insert(0, str(ROOT))
    from chip_smoke import DOT_B, DOT_CASES, cuda_ms, digits
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch
    from repro_torch.core.precision import OnlinePrecision
    from repro_torch.kernels.online_dot import kernel as k3
    if not k3.__file__.startswith(str(Path(root).resolve())):
        raise SystemExit(f"imported {k3.__file__}, not {root}'s kernel")
    dev = torch.device("cuda", 0)
    for K, n in DOT_CASES:
        cfg = OnlinePrecision(n=n)
        xd, yd = digits((DOT_B, K, n), K + n, dev)
        ms = cuda_ms(lambda: k3.online_dot_kernel(xd, yd, cfg), reps=REPS,
                     warmup=3)
        print(f"[turns] {root} online_dot B={DOT_B} K={K} n={n}: {ms:.4f} ms",
              flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        times(args[1])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("online_dot_turns: no CUDA card", file=sys.stderr)
        return 2
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    for root in args:
        subprocess.run([sys.executable, __file__, "--one", root], check=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(out.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
