#!/usr/bin/env python
"""olmlint_torch - the port's static kernel-contract and numerics analyzer.

The CLI twin of tools/olmlint.py over src/repro_torch/analysis/:

  kernels  the int32 non-overflow proof of the Fig. 7 / Eq. 8 schedule at
           every registered width and truncated tier, decode-window
           coverage of the autotuner's legal k_tile range, every kernel's
           launch plan at every width x shape bucket and every entry of
           results/tuning_torch.json against Hopper's limits, and the SASS
           contracts where the card's build of every source exists.
  ast      repo architecture rules over src/repro_torch/ (raw-dot
           confinement, no transcendental calls in scale modules, no
           contractions inside the serving scheduler) with a committed
           suppression baseline (tools/olmlint_torch_baseline.json).
  sass     the SASS contracts alone over `cuobjdump -sass` of each built
           source, with each kernel's registers and spills: needs the
           kernels built on the card (nvcc, cuobjdump) and fails without.
  all      kernels and ast (the default).

Exit codes: 0 clean, 1 violations found, 2 usage/internal error.

    python tools/olmlint_torch.py [--engine all|kernels|ast|sass]
        [--widths 8,16] [--baseline PATH] [--write-baseline]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO_ROOT, "src"))

from repro_torch.analysis import (run_ast_lint, run_kernel_lint,  # noqa: E402
                                  sass)
from repro_torch.analysis.ast_lint import DEFAULT_BASELINE_PATH  # noqa: E402
from repro_torch.configs.olm_array import MATMUL_MODES  # noqa: E402


def _sass() -> list:
    """Build every source (on the card), then its SASS contracts."""
    from repro_torch.kernels import build
    build.build(list(sass.SOURCES))
    violations, reports, exempt = sass.run()
    for kernel, row in sass.summarize(reports).items():
        print(f"olmlint sass: {kernel}: {row['instances']} instances, "
              f"registers {row['registers'][0]}-{row['registers'][1]}, "
              f"spill stores {row['spill_stores']} B, spill loads "
              f"{row['spill_loads']} B")
    print(f"olmlint sass: {len(violations)} violation(s); instructions of "
          f"the compiler's IEEE division slow path, exempt: {exempt}")
    return violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--engine", choices=("all", "kernels", "ast", "sass"),
                    default="all")
    ap.add_argument("--widths", default=None,
                    help="comma-separated subset of MATMUL_MODES widths "
                         "for the kernel engine (default: all registered)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE_PATH,
                    help="AST suppression baseline JSON")
    ap.add_argument("--write-baseline", action="store_true",
                    help="record current AST findings as the new baseline "
                         "instead of failing on them")
    args = ap.parse_args(argv)

    widths = None
    if args.widths:
        try:
            widths = tuple(int(w) for w in args.widths.split(","))
        except ValueError:
            ap.error(f"--widths must be comma-separated ints: {args.widths!r}")
        bad = sorted(set(widths) - set(MATMUL_MODES))
        if bad:
            ap.error(f"unregistered widths {bad}; registered: "
                     f"{sorted(MATMUL_MODES)}")

    violations = []
    if args.engine == "sass":
        try:
            violations.extend(_sass())
        except RuntimeError as e:
            print(f"olmlint sass: {e}", file=sys.stderr)
            return 2
    if args.engine in ("all", "kernels"):
        kv = run_kernel_lint(widths)
        violations.extend(kv)
        print(f"olmlint kernels: {len(kv)} violation(s) "
              f"[widths={','.join(str(w) for w in sorted(widths or MATMUL_MODES))}]")
    if args.engine in ("all", "ast"):
        if args.write_baseline:
            _, raw_keys, _ = run_ast_lint(baseline=set())
            payload = {"comment": "olmlint_torch AST suppressions: "
                                  "grandfathered sites only; keys are "
                                  "rule::relpath::qualname, so moving or "
                                  "adding a call invalidates its entry",
                       "suppressions": sorted(set(raw_keys))}
            with open(args.baseline, "w") as f:
                json.dump(payload, f, indent=2)
                f.write("\n")
            print(f"olmlint ast: wrote {len(payload['suppressions'])} "
                  f"suppression(s) to {args.baseline}")
        else:
            av, _, unused = run_ast_lint(baseline=args.baseline)
            violations.extend(av)
            print(f"olmlint ast: {len(av)} violation(s)")
            for key in sorted(unused):
                print(f"  note: stale baseline suppression {key!r} "
                      "(site gone: prune it)")

    if violations:
        print(f"\nolmlint: FAIL - {len(violations)} violation(s):\n",
              file=sys.stderr)
        for v in violations:
            print(str(v), file=sys.stderr)
            print(file=sys.stderr)
        return 1
    print("olmlint: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
