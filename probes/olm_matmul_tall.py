#!/usr/bin/env python3
"""K1 and K2 at more row blocks than a grid's y dimension holds (65,535):
an (M, 16) @ (16, 3) product at M = 65,535 x 8 + 37 rows, on one card, for
one or more checkouts of the port (each imported from its own `src/` in
its own process), e.g. the parent unpacked by `git archive` and this tree:

    python3 probes/olm_matmul_tall.py PARENT .

For each checkout and each quantize path ("kernel": K1, "host": K2) it
prints whether the launch ran and, if it did, whether the rows at both
ends and across the 65,535-block boundary equal the plain version
(`olm_matmul_ref`) bit for bit, or the error the launch raised.
"""
from __future__ import annotations

import subprocess
import sys

ROWS = 65535 * 8 + 37
SPANS = ((0, 64), (65535 * 8 - 32, 65535 * 8 + 32), (ROWS - 64, ROWS))


def run(root: str) -> None:
    sys.path.insert(0, f"{root}/src")
    import torch
    from repro_torch.kernels.online_dot.matmul import (olm_matmul,
                                                       olm_matmul_ref)
    g = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(ROWS, 16, device="cuda", generator=g)
    w = torch.randn(16, 3, device="cuda", generator=g)
    for quantize in ("kernel", "host"):
        try:
            got = olm_matmul(x, w, n_bits=16, quantize=quantize)
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"{root} {quantize}: refused: {e}", flush=True)
            continue
        same = all(torch.equal(
            got[a:b].view(torch.int32),
            olm_matmul_ref(x[a:b].contiguous(), w, n_bits=16)
            .view(torch.int32)) for a, b in SPANS)
        print(f"{root} {quantize}: ran, rows {SPANS} bit-identical to the "
              f"plain version: {same}", flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        run(args[1])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("olm_matmul_tall: no CUDA card", file=sys.stderr)
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
