#!/usr/bin/env python3
"""The dry run's full sweep, every cell in a process of its own with a time
limit, and its table.

    python3 probes/dryrun_sweep.py [--jobs 4] [--out results/dryrun_torch]
        [--archs A,B] [--shapes S,T]

runs `python -m repro_torch.launch.dryrun --arch A --shape S [--multi-pod]`
for every arch x shape x mesh (10 x 4 x 2; `--archs` and `--shapes` keep
some), `--jobs` at a time, each cut
after CUT_S seconds, then prints one markdown row a cell from the records
under `--out`: the peak a rank against an H100's 80 GB, the dot FLOPs a
rank, the collective bytes a rank, the dominant roofline term and its
seconds, and the walk's wall; a skipped cell with its reason, a failed or
cut one with its last error line or its limit. It needs no card: the
numbers are the dry run's predictions from the published H100 SXM peaks.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CUT_S = 300     # a cell's walk past five minutes is cut


def run(arch: str, shape: str, multi_pod: bool, out: Path):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", str(out)]
    if multi_pod:
        cmd.append("--multi-pod")
    mesh = "2x16x16" if multi_pod else "16x16"
    (out / f"{arch}__{shape}__{mesh}.json").unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.monotonic()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=CUT_S, cwd=ROOT)
    except subprocess.TimeoutExpired:
        return f"CUT  after {CUT_S} s"
    lines = [ln for ln in (p.stdout + p.stderr).splitlines()
             if ln.startswith(("OK", "SKIP", "FAIL"))]
    wall = time.monotonic() - t0
    return (lines[0] if lines else f"FAIL exit {p.returncode}: "
            f"{(p.stderr.strip().splitlines() or [''])[-1]}") + \
        f" [{wall:.0f} s]"


def table(archs, shapes, out: Path, notes) -> None:
    print("| arch | shape | mesh | peak GB/rank (of 80) | dot FLOPs/rank | "
          "collective B/rank | dominant term | walk s |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- |")
    for arch in archs:
        for shape in shapes:
            for mesh in ("16x16", "2x16x16"):
                f = out / f"{arch}__{shape}__{mesh}.json"
                note = notes.get((arch, shape, mesh), "")
                if not f.exists():
                    why = note or "no record"
                    print(f"| {arch} | {shape} | {mesh} | {why} | | | | |")
                    continue
                r = json.loads(f.read_text())
                peak = r["bytes_per_device"]["peak"] / 1e9
                roof = r["roofline"]
                fit = "" if r["fits"] else " **no fit**"
                print(f"| {arch} | {shape} | {mesh} | {peak:.2f}{fit} | "
                      f"{r['flops']:.3e} | "
                      f"{r['collectives']['total_bytes']:.3e} | "
                      f"{roof['dominant'][:-2]} {roof['bound_s']:.3g} s | "
                      f"{r['walk_s']} |")


def main() -> None:
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.shapes import SHAPES, applicable
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--archs", default=",".join(list_archs()))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    out = Path(args.out)
    archs, shapes = args.archs.split(","), args.shapes.split(",")
    notes = {}
    for arch in archs:
        for shape in shapes:
            ok, why = applicable(get_config(arch), shape)
            for mesh in ("16x16", "2x16x16"):
                if not ok:
                    notes[(arch, shape, mesh)] = f"skipped: {why}"
    cells = [(a, s, mp) for a in archs for s in shapes
             for mp in (False, True) if applicable(get_config(a), s)[0]]
    with ThreadPoolExecutor(args.jobs) as ex:
        futs = {c: ex.submit(run, *c, out) for c in cells}
        for (a, s, mp), fut in futs.items():
            line = fut.result()
            mesh = "2x16x16" if mp else "16x16"
            print(f"{a} x {s} x {mesh}: {line}", flush=True)
            if not line.startswith("OK"):
                notes[(a, s, mesh)] = line
    table(archs, shapes, out, notes)


if __name__ == "__main__":
    main()
