#!/usr/bin/env python3
"""Instruction-level bounds for K1 and K2 (`olm_matmul_fused`,
`olm_matmul_host`): the machine instructions their device functions
really issue on Hopper, counted in the compiled code, and the two kernels
timed against the bounds they give.

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit (nvcc, cuobjdump):

    python3 probes/digit_sass.py

It compiles small kernels for sm_90a with the port's flags and counts
their SASS (`cuobjdump -sass`):
  * around `csrc/olm_digits.cuh`, the first K1/K2 design's recurrence: a
    lane's `mul_digit_loop<N>` at N = 8, 16, 17, 24 and 32, and a baseline
    that loads and stores the same words;
  * around `csrc/olm_lane.cuh`, the recurrence with the schedule's
    constants from the host (`lane_loop<N>`), the 16-byte lane `pack`, and
    chains of the 32-bit and the 64-bit `online_add<W>` (the 64-bit one is
    the first design's adder too);
  * around `csrc/olm_matmul.cu` up to its kernel, K1/K2's tile body as it
    compiles there: `tile_tree` at one lane (L = 0) and at a whole 16-lane
    tile (L = 4, 32-bit streams; 64-bit at n = 32), and a tile's decode
    and scale fold.
The recurrence is unrolled at compile time and the adder has no branch,
so a kernel's static count is what each of its threads issues;
differences between kernels isolate one lane, one adder or one tree.

Two bounds follow, over the 128 instructions an SM issues a clock, as
`chip_smoke.py` counts them: the first design's, with the measured
`mul_digit_loop` lane and 64-bit adder in place of the source counts
(the fixed reference the redesign is measured against), and the
redesign's, the count `matmul_kernel.int_ops` now makes, whose
constants (LANE_DIGIT, the adders' ADDER_BITS, TILE) this script's
counts set. It checks that those
constants stay at or under what it counted, then times K1 and K2 at
`chip_smoke.py`'s two shapes with cold L2 and prints each as a share of
both bounds, and prints the registers and spills of every kernel of
`csrc/olm_matmul.cu` from its build.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

LANE_NS = (8, 16, 17, 24, 32)
DOT_NS = (8, 16, 32)
# K1/K2's device functions: csrc/olm_matmul.cu up to its kernel template.
TILE_END = "// Slices of a chunk:"
TILE_NS = (8, 16, 32)
SOURCE = r"""
#include "olm_digits.cuh"

#define MUL(NN)                                                              \
  extern "C" __global__ void mul##NN(const uint32_t* __restrict__ m,         \
                                     uint64_t* __restrict__ z, int S,        \
                                     olm::Sched sc) {                        \
    const int t = threadIdx.x;                                               \
    uint64_t zp, zn;                                                         \
    olm::mul_digit_loop<NN>(m[4 * t], m[4 * t + 1], m[4 * t + 2],            \
                            m[4 * t + 3], sc, S, zp, zn);                    \
    z[2 * t] = zp;                                                           \
    z[2 * t + 1] = zn;                                                       \
  }
MUL(8) MUL(16) MUL(17) MUL(24) MUL(32)

// The same loads and stores around no recurrence.
extern "C" __global__ void lane_base(const uint32_t* __restrict__ m,
                                     uint64_t* __restrict__ z, int S,
                                     olm::Sched sc) {
  const int t = threadIdx.x;
  z[2 * t] = (uint64_t)(m[4 * t] ^ m[4 * t + 2]) << (S & 31);
  z[2 * t + 1] = (uint64_t)(m[4 * t + 1] ^ m[4 * t + 3]) << sc.T[0];
}
"""

LANE_SOURCE = r"""
#include "olm_lane.cuh"

#define DOT(NN)                                                              \
  extern "C" __global__ void dot##NN(const uint32_t* __restrict__ m,         \
                                     uint32_t* __restrict__ z,               \
                                     olm::Steps st) {                        \
    const int t = threadIdx.x;                                               \
    uint32_t zp, zn;                                                         \
    olm::lane_loop<NN>(m[4 * t], m[4 * t + 1], m[4 * t + 2], m[4 * t + 3],   \
                       st, zp, zn);                                          \
    z[2 * t] = zp;                                                           \
    z[2 * t + 1] = zn;                                                       \
  }                                                                          \
  extern "C" __global__ void pack##NN(const int* __restrict__ d,             \
                                      uint32_t* __restrict__ z) {            \
    const int t = threadIdx.x;                                               \
    uint32_t p = 0, q = 0;                                                   \
    olm::pack<NN, true>(d + t * NN, 0, p, q);                                \
    z[2 * t] = p;                                                            \
    z[2 * t + 1] = q;                                                        \
  }
DOT(8) DOT(16) DOT(32)

extern "C" __global__ void dot_base(const uint32_t* __restrict__ m,
                                    uint32_t* __restrict__ z, olm::Steps st) {
  const int t = threadIdx.x;
  z[2 * t] = (m[4 * t] ^ m[4 * t + 2]) << (st.shift & 31);
  z[2 * t + 1] = (m[4 * t + 1] ^ m[4 * t + 3]) << st.keep[0];
}

template <typename W, int C>
__device__ __forceinline__ void chain_w(const W* __restrict__ a,
                                        W* __restrict__ z) {
  const int t = threadIdx.x;
  W p = a[(2 * C + 2) * t], q = a[(2 * C + 2) * t + 1];
#pragma unroll
  for (int c = 1; c <= C; ++c) {
    W rp, rn;
    olm::online_add<W>(p, q, a[(2 * C + 2) * t + 2 * c],
                       a[(2 * C + 2) * t + 2 * c + 1], rp, rn);
    p = rp;
    q = rn;
  }
  z[2 * t] = p;
  z[2 * t + 1] = q;
}
extern "C" __global__ void add32_1(const uint32_t* a, uint32_t* z) { chain_w<uint32_t, 1>(a, z); }
extern "C" __global__ void add32_3(const uint32_t* a, uint32_t* z) { chain_w<uint32_t, 3>(a, z); }
extern "C" __global__ void add64_1(const uint64_t* a, uint64_t* z) { chain_w<uint64_t, 1>(a, z); }
extern "C" __global__ void add64_3(const uint64_t* a, uint64_t* z) { chain_w<uint64_t, 3>(a, z); }
"""

TILE_SOURCE = r"""
}  // namespace

// A tile of K1/K2: its x and w masks (16 lanes each, as the kernel's
// shared memory holds them) and `tile_tree` at L levels.
#define TILE(NN, W, LL, NAME)                                                \
  extern "C" __global__ void NAME(const uint2* __restrict__ m,               \
                                  W* __restrict__ z, Steps st) {             \
    const uint2* b = m + 32 * threadIdx.x;                                   \
    W zp, zn;                                                                \
    tile_tree<NN, W>(b, b + 16, st, LL, zp, zn);                             \
    z[2 * threadIdx.x] = zp;                                                 \
    z[2 * threadIdx.x + 1] = zn;                                             \
  }
TILE(8, uint32_t, 0, lane8) TILE(16, uint32_t, 0, lane16)
TILE(32, uint32_t, 0, lane32)
TILE(8, uint32_t, 4, tile8) TILE(16, uint32_t, 4, tile16)
TILE(32, uint64_t, 4, tile32)

// The same loads and stores around no recurrence.
extern "C" __global__ void tile_base(const uint2* __restrict__ m,
                                     uint32_t* __restrict__ z, Steps st) {
  const uint2* b = m + 32 * threadIdx.x;
  z[2 * threadIdx.x] = (b[0].x ^ b[16].x) << (st.shift & 31);
  z[2 * threadIdx.x + 1] = (b[0].y ^ b[16].y) << st.keep[0];
}

// A tile's decode and scale fold, as the kernel does them, from its root
// stream and two scales; and the same loads and store around none.
extern "C" __global__ void decode32(const uint32_t* __restrict__ s,
                                    const float* __restrict__ f,
                                    float* __restrict__ z, int L) {
  const int t = threadIdx.x;
  const int m = 16 + 2 * L;
  const float dec = __fmul_rn(
      __ll2float_rn(stream_int<uint32_t>(s[2 * t], s[2 * t + 1], m)),
      olm::pow2f(-m));
  z[t] = __fmul_rn(__fmul_rn(dec, olm::pow2f(L)),
                   __fmul_rn(f[2 * t], f[2 * t + 1]));
}
extern "C" __global__ void decode_base(const uint32_t* __restrict__ s,
                                       const float* __restrict__ f,
                                       float* __restrict__ z, int L) {
  const int t = threadIdx.x;
  z[t] = __int_as_float((s[2 * t] ^ s[2 * t + 1]) << (L & 7)) + f[2 * t]
         + f[2 * t + 1];
}
"""

MEMORY = ("LDG", "STG", "LDC", "ULDC", "LDS", "STS")
# Opcodes that issue to the integer ALU pipe.
ALU = ("LOP3", "SHF", "ISETP", "SEL", "IADD3", "VIADDMNMX", "VIMNMX", "PRMT",
       "LEA", "IMNMX", "IABS", "MOV", "SGXT", "BMSK", "PLOP3", "VIADD")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / name
    if default.exists():
        return str(default)
    raise RuntimeError(f"{name} not found: this script needs the CUDA toolkit")


def sass_counts() -> dict:
    """{kernel: Counter of opcodes} from the compiled probe kernels."""
    from repro_torch.kernels import build
    out = build.BUILD_ROOT.parent / "probes"
    out.mkdir(parents=True, exist_ok=True)
    src, cubin = out / "digit_sass.cu", out / "digit_sass.cubin"
    tile = (build.CSRC / "olm_matmul.cu").read_text()
    src.write_text(SOURCE + LANE_SOURCE + tile[:tile.index(TILE_END)]
                   + TILE_SOURCE)
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    done = subprocess.run([_tool("nvcc"), *flags, "-cubin", "-I",
                           str(build.CSRC), "-o", str(cubin), str(src)],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed:\n{done.stdout}{done.stderr}")
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                          check=True, capture_output=True, text=True).stdout
    (out / "digit_sass.sass").write_text(sass)
    counts, name = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\w+)", line)
        if fn:
            name = fn.group(1)
            counts[name] = Counter()
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                       r"([A-Z][A-Z0-9_]*)", line)
        if ins and name and ins.group(1) != "NOP":
            counts[name][ins.group(1)] += 1
    # the trailing `BRA` to itself after EXIT is padding, never issued
    for c in counts.values():
        if c["BRA"]:
            c["BRA"] -= 1
            if not c["BRA"]:
                del c["BRA"]
    return counts


def issued(c: Counter, memory: bool = True) -> int:
    return sum(v for k, v in c.items() if memory or k not in MEMORY)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("digit_sass: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import (DECODE_GEMV, INT_OPS_PER_SM_CLOCK, PREFILL_GEMM,
                            cuda_ms, operands, ptxas_summary, smi)
    from repro_torch.kernels import build
    from repro_torch.kernels.online_dot import matmul_kernel as k12
    from repro_torch.kernels.online_dot.matmul import (_quantize_tiles,
                                                       _tile_plan)
    smi_line = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sms * INT_OPS_PER_SM_CLOCK * clock_mhz * 1e6
    print(f"[device] {torch.cuda.get_device_name(0)}, {sms} SMs, max SM "
          f"clock {clock_mhz} MHz; {smi_line}", flush=True)

    counts = sass_counts()
    for name, c in counts.items():
        branches = c.get("BRA", 0)
        print(f"[sass] {name}: {issued(c)} instructions "
              f"({issued(c, False)} outside memory){'; ' if branches else ''}"
              f"{f'{branches} branches' if branches else ''}; "
              f"{dict(c.most_common(8))}", flush=True)
    # a lane: every instruction past the baseline (the schedule's uniform
    # constant loads included); an adder: past one adder, outside the
    # loads of the extra streams
    lane = {n: issued(counts[f"mul{n}"]) - issued(counts["lane_base"])
            for n in LANE_NS}
    for n in LANE_NS:
        src = (n + 3) * k12.OPS_STEP + n * k12.OPS_DIGIT
        print(f"[sass] one lane's mul_digit_loop<{n}> ({n + 3} steps): "
              f"{lane[n]} instructions; the source count says {src}",
              flush=True)
    print(f"[sass] a step and a digit more (N 16 -> 17): "
          f"{lane[17] - lane[16]} instructions; per step and digit from N 16 "
          f"-> 32: {(lane[32] - lane[16]) / 16:.2f}; the source count says "
          f"{k12.OPS_STEP + k12.OPS_DIGIT}", flush=True)
    for n in DOT_NS:
        print(f"[sass] olm_lane.cuh: one lane's lane_loop<{n}>: "
              f"{issued(counts[f'dot{n}']) - issued(counts['dot_base'])} "
              f"instructions; pack<{n}> of one operand: "
              f"{issued(counts[f'pack{n}'])} in all", flush=True)
    add_w = {b: (issued(counts[f"add{b}_3"], False)
                 - issued(counts[f"add{b}_1"], False)) / 2 for b in (32, 64)}
    adder = add_w[64]              # the first design's adder
    print(f"[sass] the first design's 64-bit online_add: {adder:.1f} "
          f"instructions (add64_3 - add64_1, halved); the source count says "
          f"{k12.OPS_ADDER}", flush=True)
    for b in (32, 64):
        print(f"[sass] olm_lane.cuh: one {b}-bit online_add: {add_w[b]:.1f} "
              f"instructions; matmul_kernel.ADDER_BITS counts "
              f"{k12.ADDER_BITS[b]} an adder of a tile", flush=True)
    # K1/K2's tile body as olm_matmul.cu compiles it: a lane (tile_tree at
    # L = 0, its two mask loads included), a whole 16-lane tile, and what
    # the tile's tree adds to its 16 lanes
    base = issued(counts["tile_base"])
    k1_lane = {n: issued(counts[f"lane{n}"]) - base for n in TILE_NS}
    tile = {n: issued(counts[f"tile{n}"]) - base for n in TILE_NS}
    decode = issued(counts["decode32"]) - issued(counts["decode_base"])
    for n in TILE_NS:
        bits = 64 if n == 32 else 32
        print(f"[sass] olm_matmul.cu: one lane at n={n}: {k1_lane[n]} "
              f"instructions ({k1_lane[n] / n:.2f} a digit; "
              f"matmul_kernel.LANE_DIGIT says {k12.LANE_DIGIT}); a 16-lane "
              f"tile on {bits}-bit streams: {tile[n]}, of which the tree "
              f"beside its 16 lanes {tile[n] - 16 * k1_lane[n]} (15 adders "
              f"at {add_w[bits]:.1f}: {15 * add_w[bits]:.0f})", flush=True)
    print(f"[sass] olm_matmul.cu: a tile's decode and scale fold: {decode} "
          f"instructions; matmul_kernel.TILE says {k12.TILE}", flush=True)
    # int_ops's count of a 16-lane tile at or under the tile's own, and
    # each constant at or under what it stands for
    counted = {n: 16 * n * k12.LANE_DIGIT + 15 * k12.ADDER_BITS[
        64 if n == 32 else 32] + k12.TILE for n in TILE_NS}
    for n in TILE_NS:
        print(f"[sass] int_ops counts a 16-lane tile at n={n} as {counted[n]}"
              f"; it issues {tile[n] + decode} with its decode", flush=True)
    within = (all(k12.LANE_DIGIT * n <= k1_lane[n]
                  and counted[n] <= tile[n] + decode for n in TILE_NS)
              and 15 * k12.ADDER_BITS[32] <= tile[16] - 16 * k1_lane[16]
              and k12.ADDER_BITS[64] <= add_w[64] and k12.TILE <= decode)
    print(f"[sass] matmul_kernel.int_ops's constants at or under these "
          f"counts: {within}", flush=True)
    # Hopper issues one instruction a clock on each of an SM's four
    # schedulers, but its integer ALU pipe (LOP3, SHF, ISETP, SEL, IADD3,
    # ...) takes a warp instruction every other clock; IMAD runs on the
    # FMA pipe. A kernel whose ALU share passes half of its instructions
    # waits on that pipe.
    for name in ("mul16", "dot16", "lane16", "tile16", "tile32"):
        c = counts[name]
        fma = sum(v for k, v in c.items() if k.startswith(("IMAD", "FFMA",
                                                           "FMUL", "FADD")))
        alu = sum(v for k, v in c.items() if k in ALU)
        print(f"[pipe] {name}: {issued(c)} instructions, {alu} on the "
              f"integer ALU pipe ({100 * alu / issued(c):.1f}%), {fma} on "
              f"the FMA pipe", flush=True)

    def first_design_ops(M, N, K, n, quantize):
        kt = min(k12.MAX_K_TILE, K)
        T = -(-K // kt)
        outs = M * N * T
        quant = (M + N) * T * kt * k12.OPS_QUANT if quantize else 0
        return (outs * kt * lane[n] + outs * (kt - 1) * adder + quant
                + outs * k12.OPS_DECODE)

    dev = torch.device("cuda", 0)
    n = 16
    for label, shape in (("decode_gemv", DECODE_GEMV),
                         ("prefill_gemm", PREFILL_GEMM)):
        M, K, N = shape
        x, w = operands(shape, 3, dev)
        kt, T, xp, wpT = _tile_plan(x, w, n)
        xd, sx = (t.contiguous() for t in _quantize_tiles(xp, kt, T, n))
        wd, sw = (t.contiguous() for t in _quantize_tiles(wpT, kt, T, n))
        for name, quantize, fn in (
                ("olm_matmul_fused", True,
                 lambda: k12.olm_matmul_fused(x, w, n=n)),
                ("olm_matmul_host", False,
                 lambda: k12.olm_matmul_host(xd, sx, wd, sw, n=n))):
            ms = cuda_ms(fn, reps=10, warmup=2)
            first_ms = first_design_ops(M, N, K, n, quantize) / rate * 1e3
            new_ms = k12.int_ops(M, N, K, n=n, quantize=quantize) / rate * 1e3
            print(f"[bound] {name} olm16 {label} M={M} K={K} N={N}: "
                  f"{ms:.4f} ms; the first design's instruction bound "
                  f"{first_ms:.4f} ms ({100 * first_ms / ms:.1f}%); the "
                  f"recounted bound (int_ops) {new_ms:.4f} ms "
                  f"({100 * new_ms / ms:.1f}%)", flush=True)
        del x, w, xd, wd
    built = build.build([k12.SOURCE])[k12.SOURCE]
    print(f"[build] {k12.SOURCE}: {ptxas_summary(built.log)}", flush=True)
    for kern, spill, regs in re.findall(
            r"Compiling entry function '\w*olm_matmul_kernel(\w+)'.*?"
            r"(\d+) bytes spill stores.*?Used (\d+) registers", built.log,
            re.S):
        print(f"[build] olm_matmul_kernel{kern}: {regs} registers, {spill} "
              "bytes of spill stores", flush=True)
    print(smi_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
