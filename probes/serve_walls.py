#!/usr/bin/env python3
"""Serve walls of one or more checkouts of the port, on one card, in turns:
the A/B comparison of two trees that a single `chip_smoke.py` run cannot
give (its walls move with the host from one machine to the next).

Run on a machine with one CUDA card, naming the roots of the checkouts to
compare (each is imported from its own `src/` in its own process), e.g.
the parent unpacked by `git archive` and this tree, in the order parent,
change, change, parent:

    python3 probes/serve_walls.py PARENT . . PARENT

Each process serves `chip_smoke.py`'s requests (InternLM2-1.8B at full
width, weights from seed 0, 4 requests of 4-12 prompt tokens, 6 new
tokens each) three times under tpmm16 and three times under olm16 (or
under the modes of `--modes tpmm16,...`, given first) and prints the
walls, each ending in torch.cuda.synchronize(). The first serve of a
mode in a process builds its kernels and warms the caches.
"""
from __future__ import annotations

import subprocess
import sys
import time

MODES = ("tpmm16", "olm16")
REPEATS = 3


def serve(root: str, modes) -> None:
    sys.path.insert(0, f"{root}/src")
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.numerics import DotEngine
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServeEngine
    dev = torch.device("cuda", 0)
    cfg = get_config("internlm2_1_8b")
    params = Model(cfg, device=dev).init(seed=0)
    for mode in modes:
        model = Model(cfg, DotEngine(mode=mode), device=dev)
        walls = []
        for _ in range(REPEATS):
            engine = ServeEngine(model, params, slots=4, max_len=128,
                                 kv_block_size=16, device=dev)
            rng = np.random.default_rng(0)
            for rid in range(4):
                prompt = rng.integers(0, cfg.vocab_size,
                                      int(rng.integers(4, 13)))
                engine.submit(Request(rid=rid, prompt=prompt.astype(np.int32),
                                      max_new_tokens=6))
            torch.cuda.synchronize()
            t0 = time.monotonic()
            engine.run()
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        print(f"[walls] {root} {mode}: "
              + ", ".join(f"{w:.3f}" for w in walls) + " s", flush=True)


def main() -> int:
    args = sys.argv[1:]
    modes = MODES
    if args[:1] == ["--modes"]:
        modes, args = tuple(args[1].split(",")), args[2:]
    if args[:1] == ["--one"]:
        serve(args[1], modes)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("serve_walls: no CUDA card", file=sys.stderr)
        return 2
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    for root in args:
        subprocess.run([sys.executable, __file__, "--modes", ",".join(modes),
                        "--one", root], check=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(out.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
