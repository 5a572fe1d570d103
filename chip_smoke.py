#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and hold each of
its hand-written kernels against the kernel's plain PyTorch version.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device  - the card's name, count, power limit and SM clock;
  2. build   - every kernel of the path, compiled with nvcc for sm_90a
               from the sources in the checkout (ptxas report, seconds);
  3. check   - each kernel against its plain version on the card, bit for
               bit, on a ragged shape at every olm width and at the
               slice's real shapes; plus the smoke-size model on the card
               against the same model on the CPU;
  4. time    - each kernel at the real shapes (CUDA events) beside its
               bound, its plain version and the PyTorch context call;
  5. serve   - ServeEngine at the full published InternLM2-1.8B width
               under dot_mode="olm16": 4 seeded requests; every kernel's
               launch count must equal the GEMMs the forward passes issued.
               Then the same requests again, with each kernel launch
               between CUDA events, for the share of the wall it takes.

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
# Integer operations an SM can retire per clock: its 4 schedulers issue
# one 32-thread instruction each (the same 128 lanes the guide's 67 TFLOP/s
# float32 peak counts). Hopper's 64 INT32 units per SM are not the limit:
# IMAD issues to the FMA pipe and LOP3 folds three logic operations into
# one, and olm_matmul_fused runs faster than a 64-lane figure on an H100
# SXM at 700 W (PERF.md).
INT_OPS_PER_SM_CLOCK = 128
RAGGED = (5, 70, 37)               # (M, K, N)
DECODE_GEMV = (4, 2048, 8192)      # an MLP up-projection at decode
PREFILL_GEMM = (64, 2048, 2048)    # a q/o projection of the 4 x 16 prefill
CHECK_MODES = ("olm8", "olm16", "olm16t12", "olm24", "olm32")
SERVE = dict(arch="internlm2_1_8b", mode="olm16", requests=4, prompt=(4, 12),
             max_new=6, slots=4, max_len=128, block=16, seed=0)
SERVE_LAYERS = None                # None = the full published depth


def smi(fields: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() over reps launches, after warmup ones."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def operands(shape, seed, device):
    import torch
    M, K, N = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, device=device, generator=g)
    w = torch.randn(K, N, device=device, generator=g) * (2.0 / (K + N)) ** 0.5
    return x, w


def mode_bits(mode: str):
    body = mode[len("olm"):]
    n, _, p = body.partition("t")
    return int(n), (int(p) if p else None)


def bits_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.numerics import DotEngine
    from repro_torch.kernels import build
    from repro_torch.kernels.online_dot import matmul_kernel as k1
    from repro_torch.kernels.online_dot.matmul import olm_matmul, olm_matmul_ref
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device --------------------------------------------------------
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi_line = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[device] {name} x{count}, {sms} SMs, max SM clock {clock_mhz} MHz, "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build ---------------------------------------------------------
    t0 = time.monotonic()
    built = build.build([k1.SOURCE])
    for b in built.values():
        print(f"[build] {b.source}: {b.seconds:.1f} s -> {b.path.name}")
        entry = "?"
        for line in b.log.splitlines():
            m = re.search(r"Compiling entry function '(\S+?)'", line)
            if m:
                n = re.search(r"ILi(\d+)E", m.group(1))
                entry = f"n={n.group(1)}" if n else m.group(1)
            elif "Used" in line or "spill" in line:
                print(f"[build]   {entry}: {line.split(' : ')[-1].strip()}")
    print(f"[build] all kernels in {time.monotonic() - t0:.1f} s", flush=True)

    # 3. kernel against plain version, bit for bit ----------------------
    max_err = 0.0

    def check(label, x, w, n, p):
        nonlocal max_err
        got = olm_matmul(x, w, n_bits=n, trunc=p)
        want = olm_matmul_ref(x, w, n_bits=n, trunc=p)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        ok = bits_equal(got, want) and bool(torch.isfinite(got).all())
        print(f"[check] olm_matmul_fused {label}: bit-identical={ok} "
              f"max_abs_err={err}", flush=True)
        if not ok:
            raise SystemExit(f"olm_matmul_fused disagrees with its plain "
                             f"version at {label}")

    x, w = operands(RAGGED, 1, dev)
    for mode in CHECK_MODES:
        n, p = mode_bits(mode)
        check(f"{mode} M,K,N={RAGGED}", x, w, n, p)
    sub = x.clone()
    sub[0, :16] = 1e-40                      # an all-subnormal K tile
    zeroed = sub.clone()
    zeroed[0, :16] = 0.0
    check(f"olm16 subnormal tile M,K,N={RAGGED}", sub, w, 16, None)
    if not bits_equal(olm_matmul(sub, w), olm_matmul(zeroed, w)):
        raise SystemExit("an all-subnormal tile did not contribute exactly 0")
    print("[check] all-subnormal tile contributes exactly 0: True")
    for shape in (DECODE_GEMV, PREFILL_GEMM):
        check(f"olm16 M,K,N={shape}", *operands(shape, 2, dev), 16, None)

    scfg = dataclasses.replace(smoke_config(SERVE["arch"]),
                               compute_dtype="float32")
    cpu_model = Model(scfg, DotEngine(mode="olm16"), device="cpu")
    cpu_params = cpu_model.init(seed=0)
    gpu_model = Model(scfg, DotEngine(mode="olm16"), device=dev)
    gpu_params = {k: ([{a: {b: t.to(dev) for b, t in d.items()}
                        for a, d in layer.items()} for layer in v]
                      if k == "layers" else {b: t.to(dev) for b, t in v.items()})
                  for k, v in cpu_params.items()}
    toks = torch.from_numpy(np.random.default_rng(0)
                            .integers(0, scfg.vocab_size, (2, 7)))
    want, _, _ = cpu_model.prefill(cpu_params, {"tokens": toks},
                                   cpu_model.init_cache(2, 8))
    got, _, _ = gpu_model.prefill(gpu_params, {"tokens": toks},
                                  gpu_model.init_cache(2, 8))
    rel = float((got.cpu() - want).abs().max() / want.abs().max())
    print(f"[check] smoke model olm16 f32 prefill logits, card vs CPU: "
          f"rel err {rel:.3e} (limit 1e-3)", flush=True)
    if not rel <= 1e-3:
        raise SystemExit("smoke model on the card disagrees with the CPU")

    # 4. times ---------------------------------------------------------
    rate = sms * INT_OPS_PER_SM_CLOCK * clock_mhz * 1e6
    timed = {}
    for label, shape in (("decode_gemv", DECODE_GEMV),
                         ("prefill_gemm", PREFILL_GEMM)):
        M, K, N = shape
        x, w = operands(shape, 3, dev)
        ms = cuda_ms(lambda: k1.olm_matmul_fused(x, w, n=16), reps=10, warmup=2)
        plain_ms = cuda_ms(lambda: olm_matmul_ref(x, w, n_bits=16), reps=1)
        mm_ms = cuda_ms(lambda: torch.matmul(x, w), reps=20, warmup=3)
        byte_ms = (M * K + K * N + M * N) * 4 / HBM_BYTES_PER_S * 1e3
        op_ms = k1.int_ops(M, N, K, n=16) / rate * 1e3
        bound = max(byte_ms, op_ms)
        timed[label] = dict(shape=f"M={M} K={K} N={N}", ms=ms, plain_ms=plain_ms,
                            bound_ms=bound,
                            bound_by="operations" if op_ms >= byte_ms else "bytes",
                            matmul_f32_ms=mm_ms)
        print(f"[time] olm_matmul_fused olm16 {label} M={M} K={K} N={N}: "
              f"{ms:.4f} ms; bound {bound:.4f} ms ({timed[label]['bound_by']}: "
              f"bytes {byte_ms:.4f} ms, int32 ops {op_ms:.4f} ms); plain "
              f"version {plain_ms:.2f} ms; context, torch.matmul f32 (not the "
              f"same function): {mm_ms:.4f} ms", flush=True)

    # 5. serve ---------------------------------------------------------
    cfg = get_config(SERVE["arch"])
    if SERVE_LAYERS is not None:
        cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS)
        print(f"[serve] depth cut to {SERVE_LAYERS} of 24 layers; widths as "
              "published")
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}; params {cfg.param_dtype}, compute "
          f"{cfg.compute_dtype}, dot_mode {SERVE['mode']}", flush=True)
    model = Model(cfg, DotEngine(mode=SERVE["mode"]), device=dev)
    params = model.init(seed=SERVE["seed"])

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
    k1.launches = 0
    t0 = time.monotonic()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = k1.launches
    gemms = (passes["prefill"] + passes["decode"]) * (7 * cfg.n_layers + 1)
    tokens = sum(len(r.output) for r in done)
    reasons = {r.rid: r.finish_reason for r in sorted(done, key=lambda r: r.rid)}
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] answered {len(done)}/{SERVE['requests']} requests, "
          f"{tokens} tokens, finish reasons {reasons}", flush=True)
    print(f"[serve] wall {wall:.3f} s (ends in torch.cuda.synchronize), "
          f"{tokens / wall:.3f} tokens/s, peak memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB)")
    print(f"[serve] forward passes: {passes['prefill']} prefill, "
          f"{passes['decode']} decode; olm GEMMs issued {gemms}; "
          f"olm_matmul_fused launches {launches}", flush=True)
    if len(done) != SERVE["requests"]:
        raise SystemExit("not every request was answered")
    if any(r.finish_reason not in ("length", "eos") for r in done):
        raise SystemExit(f"unexpected finish reasons {reasons}")
    if not all(finite):
        raise SystemExit("non-finite logits in the serve phase")
    if launches != gemms or launches == 0:
        raise SystemExit(f"olm_matmul_fused launched {launches} times for "
                         f"{gemms} olm GEMMs")

    # Where the serve time goes: the same requests again, every K1 launch
    # bracketed by CUDA events on its stream (an upper bound on K1's device
    # time: a gap while the host prepares a launch counts too).
    engine = seeded_engine()
    fused, spans = k1.olm_matmul_fused, []

    def bracketed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fused(*a, **kw)
        stop.record()
        spans.append((start, stop))
        return out

    k1.olm_matmul_fused = bracketed
    t0 = time.monotonic()
    again = engine.run()
    torch.cuda.synchronize()
    wall2 = time.monotonic() - t0
    k1.olm_matmul_fused = fused
    k1_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    same = ([r.output for r in sorted(again, key=lambda r: r.rid)]
            == [r.output for r in sorted(done, key=lambda r: r.rid)])
    print(f"[serve] breakdown, second run of the same requests: wall "
          f"{wall2:.3f} s, olm_matmul_fused {k1_s:.3f} s over {len(spans)} "
          f"launches ({100 * k1_s / wall2:.1f}%), everything else "
          f"{wall2 - k1_s:.3f} s; same tokens as the first run: {same}",
          flush=True)
    if not same:
        raise SystemExit("a second serve of the same requests gave other "
                         "tokens")

    g = timed["decode_gemv"]
    entry = {"name": "olm_matmul_fused", "route": "cuda",
             "source": "src/repro_torch/csrc/olm_matmul_fused.cu",
             "replaces": "src/repro/kernels/online_dot/matmul_kernel.py:269",
             "launches": launches, "max_abs_err": max_err, "ms": g["ms"],
             "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
             "bound_by": g["bound_by"], "library_ms": None,
             "shape": g["shape"], "prefill_gemm": timed["prefill_gemm"]}
    print(smi_line)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
