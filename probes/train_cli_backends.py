#!/usr/bin/env python3
"""The train CLI over several ranks, one card a rank, under the backend
that `--backend auto` picks (NCCL there) and under gloo, held against one
rank's run.

Run from the repo root on a host with at least `--ranks` CUDA cards:

    python3 probes/train_cli_backends.py --ranks 4

Runs `python -m repro_torch.launch.train` (InternLM2-1.8B at smoke width,
4 x 16 a step, then Mamba2-130M as published at the reference example's
8 x 256) four ways: one rank; `--ranks` ranks through
`torch.distributed.run` with --backend auto, saving a checkpoint every 2
steps; the same run resumed 2 steps further; and `--ranks` ranks with
--backend gloo. Every multi-rank run must print the backend it chose,
and each step's loss and grad_norm must agree with one rank's to the
printed digits within 2.5e-4 and 1e-3 of themselves (a missing or wrong
sum over the ranks moves the grad_norm by 0.19-1.0 of itself:
probes/sharded_train_faults.py). Prints each run's wall, its first line
and the largest differences, then one JSON object; exits 1 on any
disagreement.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

STEP = re.compile(r"^step +(\d+) loss (\S+) gnorm (\S+) lr", re.M)
CASES = {"internlm2_1_8b": ["--smoke", "--batch", "4", "--seq", "16",
                            "--steps", "4"],
         "mamba2_130m": ["--batch", "8", "--seq", "256", "--steps", "6",
                         "--lr", "3e-3"]}


def run(cmd, env) -> dict:
    t0 = time.monotonic()
    p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=600)
    wall = time.monotonic() - t0
    if p.returncode:
        raise SystemExit(f"{' '.join(cmd)} exited {p.returncode}:\n"
                         f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    steps = {int(m[1]): (float(m[2]), float(m[3]))
             for m in STEP.finditer(p.stdout)}
    return {"wall_s": wall, "first": p.stdout.splitlines()[0],
            "steps": steps}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--arch", action="append", choices=sorted(CASES),
                    help="the cases to run (default: both)")
    ap.add_argument("--device", default=None,
                    help="'cpu' tries the probe itself on the CPU (gloo)")
    args = ap.parse_args()
    env = dict(os.environ, PYTHONPATH="src", PYTHONWARNINGS="ignore")
    tail = ["--log-every", "1"] + (["--device", args.device]
                                   if args.device else [])
    cli = [sys.executable, "-m", "repro_torch.launch.train", *tail]
    dist = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(args.ranks), "-m",
            "repro_torch.launch.train", *tail]
    if args.device != "cpu":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    report, ok = {}, True
    with tempfile.TemporaryDirectory() as tmp:
        for arch in args.arch or CASES:
            flags = CASES[arch]
            base = ["--arch", arch, *flags]
            at = base.index("--steps") + 1
            n = int(base[at])
            more = [*base[:at], str(n + 2), *base[at + 1:]]
            runs = {
                "one": run(cli + more + ["--ckpt-dir", f"{tmp}/{arch}1"],
                           env),
                "auto": run(dist + base + ["--ckpt-every", "2", "--ckpt-dir",
                                           f"{tmp}/{arch}a"], env),
                "auto_resumed": run(dist + more + [
                    "--ckpt-every", "2", "--ckpt-dir", f"{tmp}/{arch}a",
                    "--resume"], env),
                "gloo": run(dist + base + ["--backend", "gloo", "--ckpt-dir",
                                           f"{tmp}/{arch}g"], env),
            }
            one = runs["one"]["steps"]
            for name, r in runs.items():
                if name == "one":
                    continue
                dl = max(abs(a[0] - one[k][0]) / abs(one[k][0])
                         for k, a in r["steps"].items())
                dg = max(abs(a[1] - one[k][1]) / abs(one[k][1])
                         for k, a in r["steps"].items())
                r["loss_rel"], r["grad_norm_rel"] = dl, dg
                good = (dl <= 2.5e-4 + 1e-4 / min(abs(v[0]) for v in
                                                  one.values())
                        and dg <= 1e-3 + 1e-3 / min(abs(v[1]) for v in
                                                    one.values())
                        and "backend" in r["first"])
                want = list(range(n, n + 2)) if name == "auto_resumed" \
                    else list(range(n))
                good = good and sorted(r["steps"]) == want
                ok = ok and good
                print(f"{arch} {name}: {r['first']!r}; {len(r['steps'])} "
                      f"steps, wall {r['wall_s']:.1f} s (one rank "
                      f"{runs['one']['wall_s']:.1f} s for {n + 2}); largest "
                      f"relative |diff| from one rank: loss {dl:.3e}, "
                      f"grad_norm {dg:.3e}: {'ok' if good else 'DISAGREES'}",
                      flush=True)
            report[arch] = {k: {f: v[f] for f in v if f != "steps"}
                            for k, v in runs.items()}
    print(json.dumps({"ranks": args.ranks, "runs": report, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
