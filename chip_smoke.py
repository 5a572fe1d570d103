#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA card and hold each of its
hand-written kernels against the kernel's plain PyTorch version.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device  - the card's name, count, power limit and SM clock;
  2. build   - every kernel, compiled with nvcc for sm_90a from the sources
               in the checkout, all sources at once (ptxas summary, seconds);
  3. check   - each kernel against its plain version on the card, bit for
               bit: olm_matmul_fused (K1) and olm_matmul_host (K2), against
               it and against each other, at every olm width and tier on a
               ragged shape, at K of 1, 3, 15, 17 and 33 lanes, M of 1, 5
               and 17 rows with a ragged N, w transposed (olm16, olm24 and
               olm32 at each), an all-subnormal tile, every GEMM shape of
               the serve path (its LM head included, at decode and
               prefill), online_mul (K4) and online_dot (K3) at a million
               and four thousand rows, tpmm (K5) at tpmm16 and tpmm8 under
               its three level cutoffs on a ragged shape, an all-subnormal
               row, the tile and split edges, A planes at an odd address
               and every serve GEMM shape; K3 also at a ragged B with K
               of 1, 3, 33 and 1024 lanes, an odd n, full working
               precision and operands at a 4-byte offset; plus the
               smoke-size model under olm16 and under tpmm16 on the card
               against the same model on the CPU;
  4. time    - each kernel at those shapes beside its bound, its plain
               version and a PyTorch context call: the median of CUDA
               event pairs, one per launch, with the L2 cache overwritten
               before each; a time below its bound fails the run;
  5. serve   - ServeEngine at the full published InternLM2-1.8B width,
               4 seeded requests, once under dot_mode="olm16" (every GEMM
               through K1) and once under "tpmm16" (every GEMM through K5):
               the path's kernel launch count must equal the GEMMs the
               forward passes issued. Each is run a second time with the
               kernel's launches (and, under tpmm16, the plane
               decompositions) between CUDA events, for their share of the
               wall, and a third time under torch.profiler, for the
               device's busy share;
  6. paths   - the other two paths a user calls: olm_matmul(quantize="host")
               over one decoder layer's GEMMs at decode (K2), and the
               digit-level API online_mul / online_dot (K4, K3), each with
               the launch counts set to 0 just before and read just after.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
and prints no result; so does a machine without a CUDA card, and a
directory holding this script without the rest of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
INT8_OPS_PER_S = 1.979e15          # H100 SXM int8 tensor cores, dense
# Integer operations an SM can retire per clock: its 4 schedulers issue
# one 32-thread instruction each (the same 128 lanes the guide's 67 TFLOP/s
# float32 peak counts). The integer ALU pipe (LOP3, SHF, ISETP, SEL) takes
# only 64 lanes a clock, but IMAD issues to the FMA pipe, so a mix of the
# two issues up to 128: the issue rate is the bound (PERF.md).
INT_OPS_PER_SM_CLOCK = 128
RAGGED = (5, 70, 37)               # (M, K, N)
DECODE_GEMV = (4, 2048, 8192)      # an MLP up-projection at decode
PREFILL_GEMM = (64, 2048, 2048)    # a q/o projection of the 4 x 16 prefill
# K1/K2's edges: K of one lane, a two-level tree, a short tile, one and 17
# lanes past a tile; M on both sides of the 4- and 8-row blocks with N not a
# power of two; one row and three columns of a long K (blocks of more than
# 32 K tiles); each at olm16, olm24 (the 32-bit stream's limit) and olm32
# (64-bit streams)
K12_EDGES = (tuple((5, K, 37) for K in (1, 3, 15, 17, 33))
             + tuple((M, 70, 1003) for M in (1, 5, 17)) + ((1, 8192, 3),))
K12_EDGE_MODES = ("olm16", "olm24", "olm32")
# Every weight-bearing GEMM shape of the serve path: (K, N) of q/o, k/v,
# gate/up, down and the LM head, at the 4-lane decode and the 64-row prefill.
# K1, K2 and K5 are checked at each: K1/K2's launch plan differs by shape.
SERVE_KN = ((2048, 8192), (2048, 2048), (2048, 1024), (8192, 2048),
            (2048, 92544))
SERVE_SHAPES = tuple((M, K, N) for M in (4, 64) for K, N in SERVE_KN)
# Outputs of one call of the plain olm_matmul_ref in K1/K2's checks: wider
# GEMMs are checked against it a slice of columns at a time (an output's
# bits depend on its own column of w alone), to bound its int64
# temporaries at the 64-row LM head.
PLAIN_OUTPUTS = 1 << 17
# K5's edges: M on both sides of the 16-row decode tile, K of 1, 31 and 33
# bytes (not whole 16-byte copies) and one long enough to split, N not a
# multiple of 8; and A planes starting at an odd address.
TPMM_EDGES = ((1, 2048, 1003), (16, 2048, 1003), (17, 2048, 1003),
              (4, 1, 37), (4, 31, 37), (4, 33, 37), (4, 8192, 1003),
              (17, 8192, 1003))
TPMM_ODD = (5, 2048, 1003)
TPMM_MODES = ("nbit", "full", "eq8")
MUL_B = 1 << 20
MUL_CASES = ((8, True), (16, True), (24, True), (32, True), (8, False),
             (16, False), (24, False))
DOT_B = 4096
DOT_CASES = tuple((K, n) for K in (16, 64, 256) for n in (8, 16, 32))
# K3's edges: a ragged B (a part-filled last group, persistent blocks with
# a group fewer than others), K of one lane, an odd tree, one lane past a
# power of two and the most lanes, an odd n (4-byte copies, a row stride
# that does not divide 32), full working precision, and operands at a
# 4-byte offset (4-byte copies at n = 16). (B, K, n, truncated)
DOT_RAGGED_B = DOT_B - 37
DOT_EDGES = (tuple((DOT_RAGGED_B, K, n, True) for K in (1, 3, 33, 1024)
                   for n in (8, 13, 16, 32))
             + ((DOT_RAGGED_B, 256, 16, False), (DOT_RAGGED_B, 33, 16, False)))
DOT_OFFSET = (1000, 33, 16)
SERVE = dict(arch="internlm2_1_8b", modes=("olm16", "tpmm16"), requests=4,
             prompt=(4, 12), max_new=6, slots=4, max_len=128, block=16,
             seed=0)
SERVE_LAYERS = None                # None = the full published depth


def smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


FLUSH_BYTES = 256 << 20            # > 5x the H100's 50 MB L2
SPIN_CYCLES = 1_000_000            # ~0.5 ms of the SM clock
_flush = []


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() over reps launches after warmup ones,
    each between its own pair of CUDA events, with the L2 cache
    overwritten before each (outside the events): every operand is read
    from device memory, as the serve reads each weight once a pass. A
    plain version that spends longer on the host than the spin kernel
    lasts is timed with its host gaps."""
    import torch
    if not _flush:
        _flush.append(torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                                  device="cuda"))
    for _ in range(warmup):
        fn()
    spans = []
    for _ in range(reps):
        _flush[0].zero_()
        # a spin kernel keeps the stream busy while the host enqueues the
        # events and fn's launches, so the pair times the device alone
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        spans.append((start, stop))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in spans)
    mid = len(times) // 2
    return times[mid] if len(times) % 2 else (times[mid - 1] + times[mid]) / 2


def device_busy(fn, name: str):
    """Run fn() under torch.profiler: (seconds the device ran any kernel,
    seconds in kernels whose name holds `name`, device kernels seen)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, lo, hi = 0, None, None
    for a, b in spans:
        if hi is None or a > hi:
            busy += 0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += 0 if hi is None else hi - lo
    own = sum(e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and name in e.name)
    return busy / 1e6, own / 1e6, len(spans)


def operands(shape, seed, device):
    import torch
    M, K, N = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, device=device, generator=g)
    w = torch.randn(K, N, device=device, generator=g) * (2.0 / (K + N)) ** 0.5
    return x, w


def digits(shape, seed, device):
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randint(-1, 2, shape, device=device, generator=g,
                               dtype=torch.int32) for _ in range(2))


def mode_bits(mode: str):
    body = mode[len("olm"):]
    n, _, p = body.partition("t")
    return int(n), (int(p) if p else None)


def bits_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def bound(byte_count: int, ops: float, rate: float):
    """(bound ms, "bytes" or "operations", bytes ms, operations ms)."""
    byte_ms = byte_count / HBM_BYTES_PER_S * 1e3
    op_ms = ops / rate * 1e3
    return (max(byte_ms, op_ms), "operations" if op_ms >= byte_ms else "bytes",
            byte_ms, op_ms)


def ptxas_summary(log: str) -> str:
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    smem = [int(s) for s in re.findall(r"(\d+) bytes smem", log)] or [0]
    if not regs:
        return "no ptxas report"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes of spill stores, up to {max(smem)} bytes smem")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.numerics import DotEngine
    from repro_torch.core.precision import OnlinePrecision
    from repro_torch.kernels import build
    from repro_torch.kernels.online_dot import kernel as k3
    from repro_torch.kernels.online_dot import matmul_kernel as k12
    from repro_torch.kernels.online_dot.matmul import (_quantize_tiles,
                                                       _tile_plan,
                                                       olm_matmul,
                                                       olm_matmul_ref)
    from repro_torch.kernels.online_dot.ops import online_dot
    from repro_torch.kernels.online_dot.ref import (online_dot_batch_ref,
                                                    tree_levels)
    from repro_torch.kernels.online_mul import kernel as k4
    from repro_torch.kernels.online_mul.ops import online_mul
    from repro_torch.kernels.online_mul.ref import online_mul_batch_ref
    from repro_torch.kernels.tpmm import kernel as k5
    from repro_torch.kernels.tpmm import ops as tpmm_ops
    from repro_torch.kernels.tpmm.ops import (decompose_operands,
                                              tpmm_cost_model)
    from repro_torch.kernels.tpmm.ref import tpmm_ref
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def reset_counts():
        k12.launches = k12.host_launches = 0
        k3.launches = k4.launches = k5.launches = 0

    def read_counts():
        return {"olm_matmul_fused": k12.launches,
                "olm_matmul_host": k12.host_launches,
                "online_dot": k3.launches, "online_mul": k4.launches,
                "tpmm": k5.launches}

    # 1. device --------------------------------------------------------
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi_line = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[device] {name} x{count}, {sms} SMs, max SM clock {clock_mhz} MHz, "
          f"torch {torch.__version__} cuda {torch.version.cuda}; {smi_line}",
          flush=True)
    rate = sms * INT_OPS_PER_SM_CLOCK * clock_mhz * 1e6

    # 2. build ---------------------------------------------------------
    t0 = time.monotonic()
    built = build.build([k12.SOURCE, k3.SOURCE, k4.SOURCE, k5.SOURCE])
    for b in built.values():
        print(f"[build] {b.source}: {b.seconds:.1f} s; "
              f"{ptxas_summary(b.log)}")
    print(f"[build] all kernels in {time.monotonic() - t0:.1f} s", flush=True)

    # 3. each kernel against its plain version, bit for bit -------------
    max_err = dict.fromkeys(read_counts(), 0.0)

    def hold(kernel, label, got, want):
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        max_err[kernel] = max(max_err[kernel], err)
        ok = bits_equal(got, want)
        if got.is_floating_point():
            ok = ok and bool(torch.isfinite(got).all())
        print(f"[check] {kernel} {label}: bit-identical={ok} "
              f"max_abs_err={err}", flush=True)
        if not ok:
            raise SystemExit(f"{kernel} disagrees with its plain version at "
                             f"{label}")

    def hold_both(label, xs, ws, n, p=None, transposed=False):
        """K1 and K2 against the plain version and K2 against K1; K1 also
        reading w through the transpose of an (N, K) row-major copy."""
        cols = max(1, PLAIN_OUTPUTS // xs.shape[0])
        want = torch.cat([olm_matmul_ref(xs, ws[:, c:c + cols], n_bits=n,
                                         trunc=p)
                          for c in range(0, ws.shape[1], cols)], dim=1)
        fused = olm_matmul(xs, ws, n_bits=n, trunc=p)
        hold("olm_matmul_fused", label, fused, want)
        if transposed:
            hold("olm_matmul_fused", f"{label} w transposed",
                 olm_matmul(xs, ws.t().contiguous().t(), n_bits=n, trunc=p),
                 want)
        host = olm_matmul(xs, ws, n_bits=n, trunc=p, quantize="host")
        hold("olm_matmul_host", label, host, want)
        hold("olm_matmul_host", f"{label} against olm_matmul_fused", host,
             fused)

    x, w = operands(RAGGED, 1, dev)
    olm_modes = sorted(m for m in DotEngine.modes() if m.startswith("olm"))
    for mode in olm_modes:
        hold_both(f"{mode} M,K,N={RAGGED}", x, w, *mode_bits(mode))
    for shape in K12_EDGES:
        xs, ws = operands(shape, 12, dev)
        for mode in K12_EDGE_MODES:
            hold_both(f"{mode} M,K,N={shape}", xs, ws, *mode_bits(mode),
                      transposed=True)
    sub = x.clone()
    sub[0, :16] = 1e-40                      # an all-subnormal K tile
    zeroed = sub.clone()
    zeroed[0, :16] = 0.0
    hold_both(f"olm16 subnormal tile M,K,N={RAGGED}", sub, w, 16)
    for quantize in ("kernel", "host"):
        if not bits_equal(olm_matmul(sub, w, quantize=quantize),
                          olm_matmul(zeroed, w, quantize=quantize)):
            raise SystemExit("an all-subnormal tile did not contribute "
                             f"exactly 0 (quantize={quantize!r})")
    print("[check] all-subnormal tile contributes exactly 0 in K1 and K2: "
          "True")
    for shape in SERVE_SHAPES:
        hold_both(f"olm16 M,K,N={shape}", *operands(shape, 2, dev), 16)
        torch.cuda.empty_cache()

    for n, truncated in MUL_CASES:
        cfg = OnlinePrecision(n=n, truncated=truncated, tail_gating=truncated)
        xd, yd = digits((MUL_B, n), n, dev)
        want, _ = online_mul_batch_ref(xd, yd, n=n, truncated=truncated,
                                       tail_gating=truncated)
        hold("online_mul", f"B={MUL_B} n={n} "
             f"{'truncated' if truncated else 'full'}",
             k4.online_mul_kernel(xd, yd, cfg), want)
    xd, yd = digits((MUL_B - 37, 16), 3, dev)   # a ragged last block
    want, _ = online_mul_batch_ref(xd, yd, n=16)
    hold("online_mul", f"B={MUL_B - 37} n=16 truncated",
         k4.online_mul_kernel(xd, yd, OnlinePrecision(n=16)), want)
    for B, K, n, truncated in (tuple((DOT_B, K, n, True) for K, n in DOT_CASES)
                               + DOT_EDGES):
        cfg = OnlinePrecision(n=n, truncated=truncated, tail_gating=truncated)
        xd, yd = digits((B, K, n), K + n, dev)
        hold("online_dot", f"B={B} K={K} n={n} "
             f"{'truncated' if truncated else 'full'}",
             k3.online_dot_kernel(xd, yd, cfg),
             online_dot_batch_ref(xd, yd, n=n, truncated=truncated,
                                  tail_gating=truncated))
    B, K, n = DOT_OFFSET
    xd, yd = digits((B * K * n + 1,), 11, dev)
    xd, yd = xd[1:].view(B, K, n), yd[:-1].view(B, K, n)
    hold("online_dot", f"operands at a 4-byte offset B={B} K={K} n={n}",
         k3.online_dot_kernel(xd, yd, OnlinePrecision(n=n)),
         online_dot_batch_ref(xd, yd, n=n))
    del xd, yd, want

    subrow = x.clone()
    subrow[1] = 1e-40                        # an all-subnormal row

    def tpmm_cases(n_bits):
        """(label, operands) of every K5 check at one width."""
        yield (f"M,K,N={RAGGED}", decompose_operands(x, w, n_bits=n_bits))
        yield (f"subnormal row M,K,N={RAGGED}",
               decompose_operands(subrow, w, n_bits=n_bits))
        for shape in TPMM_EDGES:
            yield (f"M,K,N={shape}",
                   decompose_operands(*operands(shape, 9, dev), n_bits=n_bits))
        ap, *rest = decompose_operands(*operands(TPMM_ODD, 10, dev),
                                       n_bits=n_bits)
        odd = torch.empty(ap.numel() + 1, dtype=torch.int8,
                          device=dev)[1:].view(ap.shape)
        odd.copy_(ap)
        yield (f"A planes at an odd address M,K,N={TPMM_ODD}", (odd, *rest))
        for shape in SERVE_SHAPES:
            yield (f"M,K,N={shape}",
                   decompose_operands(*operands(shape, 4, dev), n_bits=n_bits))

    for n_bits in (16, 8):
        for label, ops in tpmm_cases(n_bits):
            for mode in TPMM_MODES:
                hold("tpmm", f"tpmm{n_bits} {mode} {label}",
                     k5.tpmm_kernel(*ops, n_bits=n_bits, mode=mode),
                     tpmm_ref(*ops, n_bits=n_bits, mode=mode))
    del ops

    scfg = dataclasses.replace(smoke_config(SERVE["arch"]),
                               compute_dtype="float32")
    cpu_model = Model(scfg, device="cpu")
    cpu_params = cpu_model.init(seed=0)
    gpu_params = {k: ([{a: {b: t.to(dev) for b, t in d.items()}
                        for a, d in layer.items()} for layer in v]
                      if k == "layers" else {b: t.to(dev) for b, t in v.items()})
                  for k, v in cpu_params.items()}
    toks = torch.from_numpy(np.random.default_rng(0)
                            .integers(0, scfg.vocab_size, (2, 7)))
    for mode in SERVE["modes"]:
        cpu_model = Model(scfg, DotEngine(mode=mode), device="cpu")
        gpu_model = Model(scfg, DotEngine(mode=mode), device=dev)
        want, _, _ = cpu_model.prefill(cpu_params, {"tokens": toks},
                                       cpu_model.init_cache(2, 8))
        got, _, _ = gpu_model.prefill(gpu_params, {"tokens": toks},
                                      gpu_model.init_cache(2, 8))
        rel = float((got.cpu() - want).abs().max() / want.abs().max())
        print(f"[check] smoke model {mode} f32 prefill logits, card vs CPU: "
              f"rel err {rel:.3e} (limit 1e-3)", flush=True)
        if not rel <= 1e-3:
            raise SystemExit(f"smoke model under {mode} on the card disagrees "
                             "with the CPU")

    # 4. times ---------------------------------------------------------
    timed = {}

    def record(kernel, label, ms, plain_ms, byte_count, ops, op_rate,
               context=None):
        b_ms, by, byte_ms, op_ms = bound(byte_count, ops, op_rate)
        if ms < b_ms:
            raise SystemExit(f"{kernel} {label} timed {ms:.4f} ms, below its "
                             f"bound {b_ms:.4f} ms: the bound or the timing "
                             "is wrong")
        row = dict(label=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=by, context=context)
        timed.setdefault(kernel, []).append(row)
        ctx = f"; context {context}" if context else ""
        print(f"[time] {kernel} {label}: {ms:.4f} ms; bound {b_ms:.4f} ms "
              f"({by}: bytes {byte_ms:.4f} ms, operations {op_ms:.4f} ms); "
              f"plain version {plain_ms:.3f} ms{ctx}", flush=True)

    for label, shape in (("decode_gemv", DECODE_GEMV),
                         ("prefill_gemm", PREFILL_GEMM)):
        M, K, N = shape
        x, w = operands(shape, 3, dev)
        mm_ms = cuda_ms(lambda: torch.matmul(x, w), reps=20, warmup=3)
        plain_ms = cuda_ms(lambda: olm_matmul_ref(x, w, n_bits=16), reps=1)
        ctx = f"torch.matmul f32 (not the same function) {mm_ms:.4f} ms"
        plans = [k12.launch_plan(M, N, K, 16, host=host, vec=host)
                 for host in (False, True)]
        planned = [f"{ctx}; plan bm x bn x tb {p.bm} x {p.bn} x {p.tb}"
                   for p in plans]
        record("olm_matmul_fused", f"olm16 {label} M={M} K={K} N={N}",
               cuda_ms(lambda: k12.olm_matmul_fused(x, w, n=16), reps=10,
                       warmup=2), plain_ms, (M * K + K * N + M * N) * 4,
               k12.int_ops(M, N, K, n=16), rate, planned[0])
        kt, T, xp, wpT = _tile_plan(x, w, 16)
        xd, sx = (t.contiguous() for t in _quantize_tiles(xp, kt, T, 16))
        wd, sw = (t.contiguous() for t in _quantize_tiles(wpT, kt, T, 16))
        grids = (xd.numel() + wd.numel() + sx.numel() + sw.numel()) * 4
        record("olm_matmul_host", f"olm16 {label} M={M} K={K} N={N}",
               cuda_ms(lambda: k12.olm_matmul_host(xd, sx, wd, sw, n=16),
                       reps=10, warmup=2), plain_ms, grids + M * N * 4,
               k12.int_ops(M, N, K, n=16, quantize=False), rate,
               planned[1])
        del xd, wd
    for n, truncated in MUL_CASES[:4]:
        cfg = OnlinePrecision(n=n)
        xd, yd = digits((MUL_B, n), n, dev)
        record("online_mul", f"B={MUL_B} n={n}",
               cuda_ms(lambda: k4.online_mul_kernel(xd, yd, cfg), reps=20,
                       warmup=2),
               cuda_ms(lambda: online_mul_batch_ref(xd, yd, n=n), reps=1),
               3 * MUL_B * n * 4, k4.int_ops(MUL_B, cfg), rate)
    for K, n in DOT_CASES:
        cfg = OnlinePrecision(n=n)
        xd, yd = digits((DOT_B, K, n), K + n, dev)
        m = n + 2 * tree_levels(K)
        record("online_dot", f"B={DOT_B} K={K} n={n}",
               cuda_ms(lambda: k3.online_dot_kernel(xd, yd, cfg), reps=20,
                       warmup=2),
               cuda_ms(lambda: online_dot_batch_ref(xd, yd, n=n), reps=1),
               (2 * DOT_B * K * n + DOT_B * m) * 4,
               k3.int_ops(DOT_B, K, cfg), rate)
    del xd, yd
    for n_bits, shapes in ((16, SERVE_SHAPES), (8, (DECODE_GEMV, PREFILL_GEMM))):
        for shape in shapes:
            M, K, N = shape
            x, w = operands(shape, 5, dev)
            ops = decompose_operands(x, w, n_bits=n_bits)
            cost = tpmm_cost_model(n_bits)
            D, pairs = cost["planes"], cost["pair_matmuls_truncated"]
            # context: one plane pair through torch._int_mm (int8 -> int32),
            # which needs more than 16 rows: M = 4 is padded to 32 rows
            a8 = torch.nn.functional.pad(ops[0][0], (0, 0, 0, max(0, 32 - M)))
            b8 = ops[1][0].contiguous()
            int_mm = cuda_ms(lambda: torch._int_mm(a8, b8), reps=10, warmup=2)
            dec_ms = cuda_ms(
                lambda: decompose_operands(x, w, n_bits=n_bits), reps=3)
            ctx = (f"torch._int_mm of one plane pair {int_mm:.4f} ms"
                   f"{' (rows padded to 32)' if M < 32 else ''}; plane "
                   f"decomposition of both operands {dec_ms:.4f} ms")
            record("tpmm", f"tpmm{n_bits} M={M} K={K} N={N}",
                   cuda_ms(lambda: k5.tpmm_kernel(*ops, n_bits=n_bits),
                           reps=21, warmup=2),
                   cuda_ms(lambda: tpmm_ref(*ops, n_bits=n_bits), reps=1),
                   D * (M * K + K * N) + 4 * (M + N) + 4 * M * N,
                   2 * M * N * K * pairs, INT8_OPS_PER_S, ctx)
            timed["tpmm"][-1]["int_mm_ms"] = int_mm
    del x, w, ops, a8, b8

    # 5. serve ---------------------------------------------------------
    _flush.clear()                           # keep the peak the serve's own
    torch.cuda.empty_cache()
    cfg = get_config(SERVE["arch"])
    if SERVE_LAYERS is not None:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS)
        print(f"[serve] depth cut to {SERVE_LAYERS} of 24 layers; widths as "
              "published")
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}; params {cfg.param_dtype}, compute "
          f"{cfg.compute_dtype}", flush=True)
    params = Model(cfg, device=dev).init(seed=SERVE["seed"])
    kernel_name = {"olm16": "olm_matmul_kernel", "tpmm16": "tpmm_kernel"}
    path_extra = {"olm16": [], "tpmm16": [("plane decomposition", tpmm_ops,
                                           "decompose_operands")]}
    path_kernel = {"olm16": ("olm_matmul_fused", k12, "olm_matmul_fused"),
                   "tpmm16": ("tpmm", k5, "tpmm_kernel")}
    launches, outputs = {}, {}
    for mode in SERVE["modes"]:
        model = Model(cfg, DotEngine(mode=mode), device=dev)

        def seeded_engine():
            engine = ServeEngine(model, params, slots=SERVE["slots"],
                                 max_len=SERVE["max_len"],
                                 kv_block_size=SERVE["block"], device=dev)
            rng = np.random.default_rng(SERVE["seed"])
            lo, hi = SERVE["prompt"]
            for rid in range(SERVE["requests"]):
                prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(
                    lo, hi + 1))).astype(np.int32)
                engine.submit(Request(rid=rid, prompt=prompt,
                                      max_new_tokens=SERVE["max_new"]))
            return engine

        engine = seeded_engine()
        passes = {"prefill": 0, "decode": 0}
        finite = []

        def counted(kind, fn):
            def run(*a, **kw):
                out = fn(*a, **kw)
                passes[kind] += 1
                finite.append(bool(torch.isfinite(out[0]).all()))
                return out
            return run

        engine.model.prefill = counted("prefill", engine.model.prefill)
        engine.model.decode_step = counted("decode", engine.model.decode_step)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.monotonic()
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = read_counts()
        kernel, module, attr = path_kernel[mode]
        launches[kernel] = counts[kernel]
        gemms = (passes["prefill"] + passes["decode"]) * (7 * cfg.n_layers + 1)
        tokens = sum(len(r.output) for r in done)
        reasons = {r.rid: r.finish_reason
                   for r in sorted(done, key=lambda r: r.rid)}
        peak = torch.cuda.max_memory_allocated()
        print(f"[serve] {mode}: answered {len(done)}/{SERVE['requests']} "
              f"requests, {tokens} tokens, finish reasons {reasons}")
        print(f"[serve] {mode}: wall {wall:.3f} s (ends in "
              f"torch.cuda.synchronize), {tokens / wall:.3f} tokens/s, peak "
              f"memory {peak} bytes ({peak / 2**30:.2f} GiB)")
        print(f"[serve] {mode}: forward passes: {passes['prefill']} prefill, "
              f"{passes['decode']} decode; GEMMs issued {gemms}; kernel "
              f"launches {counts}", flush=True)
        if len(done) != SERVE["requests"]:
            raise SystemExit("not every request was answered")
        if any(r.finish_reason not in ("length", "eos") for r in done):
            raise SystemExit(f"unexpected finish reasons {reasons}")
        if not all(finite):
            raise SystemExit("non-finite logits in the serve phase")
        if counts[kernel] != gemms or gemms == 0:
            raise SystemExit(f"{kernel} launched {counts[kernel]} times for "
                             f"{gemms} GEMMs under {mode}")

        # Where the serve time goes: the same requests again, every launch
        # of the path's kernel (and, under tpmm, every plane decomposition
        # of its operands) bracketed by CUDA events on its stream (an upper
        # bound on the device time: a gap while the host prepares a launch
        # counts too).
        engine = seeded_engine()
        parts = [(kernel, module, attr), *path_extra[mode]]
        spans = {label: [] for label, _, _ in parts}

        def bracketed(label, wrapped):
            def run(*a, **kw):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out = wrapped(*a, **kw)
                stop.record()
                spans[label].append((start, stop))
                return out
            return run

        originals = [getattr(m, at) for _, m, at in parts]
        for (label, m, at), fn in zip(parts, originals):
            setattr(m, at, bracketed(label, fn))
        t0 = time.monotonic()
        again = engine.run()
        torch.cuda.synchronize()
        wall2 = time.monotonic() - t0
        for (_, m, at), fn in zip(parts, originals):
            setattr(m, at, fn)
        secs = {label: sum(a.elapsed_time(b) for a, b in sp) / 1e3
                for label, sp in spans.items()}
        outputs[mode] = [r.output for r in sorted(done, key=lambda r: r.rid)]
        same = [r.output for r in sorted(again, key=lambda r: r.rid)] == \
            outputs[mode]
        shares = ", ".join(f"{label} {secs[label]:.3f} s over "
                           f"{len(spans[label])} calls "
                           f"({100 * secs[label] / wall2:.1f}%)"
                           for label in spans)
        print(f"[serve] {mode}: breakdown, second run of the same requests: "
              f"wall {wall2:.3f} s, {shares}, everything else "
              f"{wall2 - sum(secs.values()):.3f} s; same tokens as the first "
              f"run: {same}", flush=True)
        if not same:
            raise SystemExit("a second serve of the same requests gave other "
                             "tokens")

        # The device's busy share: the same requests a third time under
        # torch.profiler, the union of the device's kernel intervals over
        # the first run's (unprofiled) wall, and the path kernel's own
        # device time from the trace.
        engine = seeded_engine()
        busy, kernel_s, n_events = device_busy(engine.run, kernel_name[mode])
        if n_events:
            print(f"[serve] {mode}: profiled run: {n_events} device kernels "
                  f"({n_events / gemms:.1f} a GEMM), device busy {busy:.3f} s"
                  f", {100 * busy / wall:.1f}% of the first run's wall (idle "
                  f"{100 * (1 - busy / wall):.1f}%); {kernel} device time "
                  f"{kernel_s:.4f} s", flush=True)
        else:
            print(f"[serve] {mode}: device busy share not measured (the "
                  "profiler saw no device kernels)", flush=True)
        del model, engine
    agree = sum(a == b for r1, r2 in zip(*outputs.values())
                for a, b in zip(r1, r2))
    print(f"[serve] olm16 and tpmm16 agree on {agree} of "
          f"{sum(map(len, outputs['olm16']))} generated tokens (random "
          "weights; both within their documented error)")
    del params
    torch.cuda.empty_cache()

    # 6. the host-quantize path and the digit-level API ------------------
    layer = [(2048, 2048), (2048, 1024), (2048, 1024), (2048, 2048),
             (2048, 8192), (2048, 8192), (8192, 2048)]   # q k v o g u d
    gemms = [operands((4, K, N), 6 + i, dev) for i, (K, N) in enumerate(layer)]
    reset_counts()
    host = [olm_matmul(xs, ws, n_bits=16, quantize="host") for xs, ws in gemms]
    torch.cuda.synchronize()
    counts = read_counts()
    launches["olm_matmul_host"] = counts["olm_matmul_host"]
    print(f"[paths] olm_matmul(quantize='host') over one decoder layer's 7 "
          f"GEMMs at decode: launches {counts}", flush=True)
    if counts["olm_matmul_host"] != len(layer):
        raise SystemExit("the host-quantize path did not launch "
                         "olm_matmul_host once per GEMM")
    for (xs, ws), got in zip(gemms, host):
        if not bits_equal(got, olm_matmul(xs, ws, n_bits=16)):
            raise SystemExit("the host-quantize path disagrees with the "
                             "fused one")
    del gemms, host

    n, K = 16, 256
    cfg = OnlinePrecision(n=n)
    xm, ym = digits((MUL_B, n), 7, dev)
    xdot, ydot = digits((DOT_B, K, n), 8, dev)
    reset_counts()
    _, z_int = online_mul(xm, ym, cfg)
    _, dot = online_dot(xdot, ydot, cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    launches["online_mul"] = counts["online_mul"]
    launches["online_dot"] = counts["online_dot"]
    print(f"[paths] online_mul B={MUL_B} n={n} and online_dot B={DOT_B} K={K} "
          f"n={n}: launches {counts}", flush=True)
    if counts["online_mul"] != 1 or counts["online_dot"] != 1:
        raise SystemExit("the digit-level API did not go through its kernels")
    wts = torch.tensor(0.5 ** np.arange(1, n + 1), device=dev)
    exact = (xm.double() @ wts) * (ym.double() @ wts)
    mul_ulp = float((z_int.double() / 2 ** n - exact).abs().max()) * 2 ** n
    exact = ((xdot.double() @ wts) * (ydot.double() @ wts)).sum(-1)
    dot_ulp = float((dot - exact).abs().max()) * 2 ** n
    print(f"[paths] online_mul worst error {mul_ulp:.3f} ulp at 2^-{n} "
          f"(documented <= 1.1); online_dot {dot_ulp:.3f} ulp "
          f"(documented <= 1.1 per lane: {1.1 * K:.1f})", flush=True)
    if not (mul_ulp <= 1.1 and dot_ulp <= 1.1 * K):
        raise SystemExit("the digit-level API exceeds its documented error")

    # the kernels line --------------------------------------------------
    src = "src/repro_torch/csrc/"
    meta = {
        "olm_matmul_fused": ("olm_matmul.cu",
                             "src/repro/kernels/online_dot/matmul_kernel.py:269"),
        "olm_matmul_host": ("olm_matmul.cu",
                            "src/repro/kernels/online_dot/matmul_kernel.py:196"),
        "online_dot": ("online_dot.cu",
                       "src/repro/kernels/online_dot/kernel.py:87"),
        "online_mul": ("online_mul.cu",
                       "src/repro/kernels/online_mul/kernel.py:134"),
        "tpmm": ("tpmm.cu", "src/repro/kernels/tpmm/kernel.py:109"),
    }
    # the time each entry reports: the decode GEMV for the GEMM kernels
    shown = {"olm_matmul_fused": "decode_gemv", "olm_matmul_host": "decode_gemv",
             "online_dot": "K=256 n=16", "online_mul": "n=16",
             "tpmm": "tpmm16 M=4 K=2048 N=8192"}
    entries = []
    for kernel, (source, replaces) in meta.items():
        head = next(r for r in timed[kernel] if shown[kernel] in r["label"])
        entries.append({
            "name": kernel, "route": "cuda", "source": src + source,
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": max_err[kernel], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None,
            "shape": head["label"],
            "times": [{k: r[k] for k in ("label", "ms", "plain_ms",
                                         "bound_ms", "bound_by")}
                      for r in timed[kernel] if r is not head]})
    print(smi_line)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
