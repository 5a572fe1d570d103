#!/usr/bin/env python3
"""The SASS of K3's kernels (`csrc/online_dot.cu`) in one or more checkouts:
where a lane's recurrence step spends its instructions.

Run on a machine with the CUDA toolkit (nvcc, cuobjdump), naming the roots
of the checkouts, e.g. the parent unpacked by `git archive` and this tree:

    python3 probes/online_dot_sass.py PARENT .

For each checkout it builds `online_dot.cu` with that checkout's own
`kernels/build.py` (in a process of its own), and prints, for every
instance of the general kernel (`online_dot_any`) and for the unrolled
kernel at n = 16 and 32 with 16-byte copies, its registers and spills
(ptxas), then each loop of its SASS (a backward branch) of at least
LOOP_MIN instructions: its size and its loads from the kernel's parameters
(LDC, ULDC), shared memory (LDS) and local memory (LDL), its stores to
local memory (STL), and its integer-divide subroutine calls. A lane's step
loop is the one that loads the schedule's per-step constants; its size
over the steps one pass runs is the instructions a step.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

LOOP_MIN = 20
LOADS = ("LDC", "ULDC", "LDS", "LDL", "STL", "CALL")
WANTED = re.compile(r"online_dot_any|online_dot_kernelILi(16|32)ELb1")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)\s*(.*?);")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return "/usr/local/cuda/bin/cuobjdump"


def loops(code: list) -> list:
    """(start, end, Counter of opcodes) of every backward branch's loop."""
    out = []
    for off, op, _, args in code:
        if op != "BRA":
            continue
        target = int(args.split()[-1], 16)
        if target < off:
            body = Counter(o for a, o, _, _ in code if target <= a <= off)
            out.append((target, off, body))
    return out


def one(root: str) -> None:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    from repro_torch.kernels import build
    from repro_torch.analysis import sass
    if not build.__file__.startswith(str(Path(root).resolve())):
        raise SystemExit(f"imported {build.__file__}, not {root}'s build")
    b = build.build(["online_dot.cu"])["online_dot.cu"]
    ptxas = sass.parse_ptxas(b.log)
    text = subprocess.run([_cuobjdump(), "-sass", str(b.path)], check=True,
                          capture_output=True, text=True).stdout
    fn, code = None, {}
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            code[fn] = []
            continue
        m = _INSTR.match(line)
        if m and fn is not None:
            code[fn].append((int(m.group(1), 16), m.group(2), m.group(3),
                             m.group(4)))
    for name in sorted(code):
        if not WANTED.search(name):
            continue
        short = re.search(r"(online_dot_\w+?I\w+?E)E", name)
        r = ptxas.get(name, {})
        print(f"[sass] {root} {short.group(1) if short else name}: "
              f"{len(code[name])} instructions, {r.get('registers')} "
              f"registers, spills {r.get('spill_stores')}/"
              f"{r.get('spill_loads')} B", flush=True)
        for start, end, body in loops(code[name]):
            size = sum(body.values())
            if size < LOOP_MIN:
                continue
            loads = {k: body[k] for k in LOADS if body[k]}
            print(f"[sass]   loop {start:#06x}-{end:#06x}: {size} "
                  f"instructions; {loads}; top {dict(body.most_common(6))}",
                  flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        one(args[1])
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    failed = [root for root in args if subprocess.run(
        [sys.executable, __file__, "--one", root]).returncode]
    if failed:
        print(f"online_dot_sass: failed on {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
