#!/usr/bin/env python3
"""The device's busy share under torch.profiler read three ways, on one
card: whether `chip_smoke.py`'s `device_busy` needs the host's ops
recorded, or the profiler's table of events, to read the device's spans.

Run from the root of a checkout on a machine with one CUDA card:

    python3 probes/device_busy_activities.py

It serves `chip_smoke.py`'s requests (InternLM2-1.8B at full width, weights
from seed 0, 4 requests of 4-12 prompt tokens, 6 new tokens each) under
olm16 and under tpmm16: once unprofiled (its wall), then three times
under the profiler: (1) `profile(activities=[CPU, CUDA])` read through
`prof.events()`, the profiler's table of events; (2) `chip_smoke.py`'s
`device_busy`: `profile(activities=[CUDA])` read from the profiler's raw
events; (3) `profile(activities=[CUDA])` read both ways, the raw events
first, from the one trace. For each reading it prints the union of the
device's kernel intervals (the busy seconds), the device seconds of the
path's kernel (names holding olm_matmul_kernel or tpmm_kernel), the
number of device kernels, and the seconds the serve took under the
profiler and the reading after it.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts src/ on the path; no torch at import)

KERNEL = {"olm16": "olm_matmul_kernel", "tpmm16": "tpmm_kernel"}


def union(spans, per_s: float) -> float:
    """Seconds covered by the union of (start, end) intervals, in units
    of 1 / per_s seconds."""
    busy, lo, hi = 0, None, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            busy += 0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (busy + (0 if hi is None else hi - lo)) / per_s


def from_table(prof, name: str):
    """(busy s, `name`'s device s, device kernels) from prof.events()
    (microseconds from the trace's start)."""
    import torch
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return (union(((e.time_range.start, e.time_range.end) for e in events),
                  1e6),
            sum(e.time_range.end - e.time_range.start for e in events
                if name in e.name) / 1e6, len(events))


def from_raw(prof, name: str):
    """The same from the profiler's raw events (integer nanoseconds), as
    device_busy reads them."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == cuda]
    return (union(((a, b) for a, b, _ in events), 1e9),
            sum(b - a for a, b, k in events if name in k) / 1e9, len(events))


def profiled(fn, cpu: bool):
    """(the profiler, fn()'s seconds under it)"""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        t1 = time.monotonic()
    return prof, t1 - t0


def show(mode, how, reading, wall, serve_s, read_s):
    busy, own, n = reading
    print(f"[busy] {mode} {how}: device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f}% of the unprofiled wall), "
          f"{KERNEL[mode]} {own:.4f} s, {n} device kernels; the serve "
          f"{serve_s:.3f} s under the profiler, read in {read_s:.3f} s "
          "(the profiler's exit included)", flush=True)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("device_busy_activities: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.numerics import DotEngine
    from repro_torch.kernels import build
    from repro_torch.kernels.online_dot import matmul_kernel as k12
    from repro_torch.kernels.tpmm import kernel as k5
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build([k12.SOURCE, k5.SOURCE])
    dev = torch.device("cuda", 0)
    cfg = get_config("internlm2_1_8b")
    params = Model(cfg, device=dev).init(seed=0)
    for mode in ("olm16", "tpmm16"):
        model = Model(cfg, DotEngine(mode=mode), device=dev)

        def run():
            engine = ServeEngine(model, params, slots=4, max_len=128,
                                 kv_block_size=16, device=dev)
            rng = np.random.default_rng(0)
            for rid in range(4):
                prompt = rng.integers(0, cfg.vocab_size,
                                      int(rng.integers(4, 13)))
                engine.submit(Request(rid=rid, prompt=prompt.astype(np.int32),
                                      max_new_tokens=6))
            engine.run()

        run()                                  # builds caches, warms up
        torch.cuda.synchronize()
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        print(f"[busy] {mode}: unprofiled serve wall {wall:.3f} s",
              flush=True)
        # (1) the host's ops and the device's, through the table
        prof, serve_s = profiled(run, cpu=True)
        t1 = time.monotonic()
        reading = from_table(prof, KERNEL[mode])
        show(mode, "(1) CPU + CUDA, prof.events()", reading, wall, serve_s,
             time.monotonic() - t1)
        del prof
        # (2) chip_smoke.py's reading
        laps = chip_smoke.Laps()
        laps("serve")
        reading = chip_smoke.device_busy(run, KERNEL[mode], laps)
        laps()
        (_, serve_s), (_, read_s) = laps.rows
        show(mode, "(2) chip_smoke.device_busy: CUDA, raw events", reading,
             wall, serve_s, read_s)
        # (3) one CUDA trace, read both ways
        prof, serve_s = profiled(run, cpu=False)
        t1 = time.monotonic()
        raw = from_raw(prof, KERNEL[mode])
        t2 = time.monotonic()
        table = from_table(prof, KERNEL[mode])
        t3 = time.monotonic()
        show(mode, "(3) CUDA, raw events", raw, wall, serve_s, t2 - t1)
        show(mode, "(3) the same trace, prof.events()", table, wall,
             serve_s, t3 - t2)
        print(f"[busy] {mode} (3): the two readings of one trace agree "
              f"to 1 us: busy {abs(raw[0] - table[0]) < 1e-6}, "
              f"{KERNEL[mode]} {abs(raw[1] - table[1]) < 1e-6}; kernels "
              f"equal {raw[2] == table[2]}", flush=True)
        del prof
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
