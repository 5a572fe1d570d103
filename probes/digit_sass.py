#!/usr/bin/env python3
"""An instruction-level bound for K1 and K2 (`olm_matmul_fused`,
`olm_matmul_host`): the machine instructions one lane of the digit
recurrence and one online adder really issue on Hopper, counted in the
compiled code, and the two kernels timed against the bound they give.

Run from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit (nvcc, cuobjdump):

    python3 probes/digit_sass.py

It compiles small kernels around `csrc/olm_digits.cuh` for sm_90a with the
port's flags (a lane's `mul_digit_loop<N>` at N = 8, 16, 17, 24 and 32; a
chain of one, two and three `online_add`s; a baseline that loads and
stores the same words), and the same around K3's own device functions
(`csrc/online_dot.cu` up to its kernel: the recurrence `lane_loop<N>`
with the schedule's constants from the host, the 16-byte lane `pack`,
the 32-bit `online_add`), disassembles them with `cuobjdump -sass` and
counts their instructions. The recurrence is unrolled at compile time and
the adder has no branch, so a kernel's static count is what each of its
threads issues; differences between kernels isolate one lane's
recurrence and one adder. `matmul_kernel.int_ops` counts the same work
from the source (23 operations a step, 14 a digit, 78 an adder); this
script puts the measured counts in their place, keeps the source's counts
for quantization and decode, and divides by the 128 instructions an SM
issues a clock, as `chip_smoke.py` does. Then it times K1 and K2 at
`chip_smoke.py`'s two shapes with cold L2 and prints each as a share of
both bounds.
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
# K3's device functions: csrc/online_dot.cu up to its kernel template.
DOT_END = "template <int N, bool VEC, typename W>\n__global__"
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

// A chain of C online adders over C + 1 streams.
template <int C>
__device__ __forceinline__ void chain(const uint64_t* __restrict__ a,
                                      uint64_t* __restrict__ z) {
  const int t = threadIdx.x;
  uint64_t p = a[(2 * C + 2) * t], q = a[(2 * C + 2) * t + 1];
#pragma unroll
  for (int c = 1; c <= C; ++c) {
    uint64_t rp, rn;
    olm::online_add(p, q, a[(2 * C + 2) * t + 2 * c],
                    a[(2 * C + 2) * t + 2 * c + 1], rp, rn);
    p = rp;
    q = rn;
  }
  z[2 * t] = p;
  z[2 * t + 1] = q;
}
extern "C" __global__ void add1(const uint64_t* a, uint64_t* z) { chain<1>(a, z); }
extern "C" __global__ void add2(const uint64_t* a, uint64_t* z) { chain<2>(a, z); }
extern "C" __global__ void add3(const uint64_t* a, uint64_t* z) { chain<3>(a, z); }
"""

DOT_SOURCE = r"""
}  // namespace

#define DOT(NN)                                                              \
  extern "C" __global__ void dot##NN(const uint32_t* __restrict__ m,         \
                                     uint32_t* __restrict__ z, Steps st) {   \
    const int t = threadIdx.x;                                               \
    uint32_t zp, zn;                                                         \
    lane_loop<NN>(m[4 * t], m[4 * t + 1], m[4 * t + 2], m[4 * t + 3], st,    \
                  zp, zn);                                                   \
    z[2 * t] = zp;                                                           \
    z[2 * t + 1] = zn;                                                       \
  }                                                                          \
  extern "C" __global__ void pack##NN(const int* __restrict__ d,             \
                                      uint32_t* __restrict__ z) {            \
    const int t = threadIdx.x;                                               \
    uint32_t p = 0, q = 0;                                                   \
    pack<NN, true>(d + t * NN, 0, p, q);                                     \
    z[2 * t] = p;                                                            \
    z[2 * t + 1] = q;                                                        \
  }
DOT(8) DOT(16) DOT(32)

extern "C" __global__ void dot_base(const uint32_t* __restrict__ m,
                                    uint32_t* __restrict__ z, Steps st) {
  const int t = threadIdx.x;
  z[2 * t] = (m[4 * t] ^ m[4 * t + 2]) << (st.shift & 31);
  z[2 * t + 1] = (m[4 * t + 1] ^ m[4 * t + 3]) << st.keep[0];
}

template <int C>
__device__ __forceinline__ void chain32(const uint32_t* __restrict__ a,
                                        uint32_t* __restrict__ z) {
  const int t = threadIdx.x;
  uint32_t p = a[(2 * C + 2) * t], q = a[(2 * C + 2) * t + 1];
#pragma unroll
  for (int c = 1; c <= C; ++c) {
    uint32_t rp, rn;
    online_add<uint32_t>(p, q, a[(2 * C + 2) * t + 2 * c],
                         a[(2 * C + 2) * t + 2 * c + 1], rp, rn);
    p = rp;
    q = rn;
  }
  z[2 * t] = p;
  z[2 * t + 1] = q;
}
extern "C" __global__ void add32_1(const uint32_t* a, uint32_t* z) { chain32<1>(a, z); }
extern "C" __global__ void add32_3(const uint32_t* a, uint32_t* z) { chain32<3>(a, z); }
"""

MEMORY = ("LDG", "STG", "LDC", "ULDC", "LDS", "STS")


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
    dot = (build.CSRC / "online_dot.cu").read_text()
    src.write_text(SOURCE + dot[:dot.index(DOT_END)] + DOT_SOURCE)
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
                            cuda_ms, operands, smi)
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
    adder = (issued(counts["add3"], False) - issued(counts["add1"], False)) / 2
    for n in LANE_NS:
        src = (n + 3) * k12.OPS_STEP + n * k12.OPS_DIGIT
        print(f"[sass] one lane's mul_digit_loop<{n}> ({n + 3} steps): "
              f"{lane[n]} instructions; the source count says {src}",
              flush=True)
    print(f"[sass] a step and a digit more (N 16 -> 17): "
          f"{lane[17] - lane[16]} instructions; per step and digit from N 16 "
          f"-> 32: {(lane[32] - lane[16]) / 16:.2f}; the source count says "
          f"{k12.OPS_STEP + k12.OPS_DIGIT}", flush=True)
    print(f"[sass] one online_add: {adder:.1f} instructions (add3 - add1, "
          f"halved); the source count says {k12.OPS_ADDER}", flush=True)
    for n in DOT_NS:
        print(f"[sass] online_dot.cu: one lane's lane_loop<{n}>: "
              f"{issued(counts[f'dot{n}']) - issued(counts['dot_base'])} "
              f"instructions; pack<{n}> of one operand: "
              f"{issued(counts[f'pack{n}'])} in all", flush=True)
    add32 = (issued(counts["add32_3"], False)
             - issued(counts["add32_1"], False)) / 2
    print(f"[sass] online_dot.cu: one 32-bit online_add: {add32:.1f} "
          "instructions", flush=True)

    def sass_ops(M, N, K, n, quantize):
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
            src_ms = k12.int_ops(M, N, K, n=n, quantize=quantize) / rate * 1e3
            sass_ms = sass_ops(M, N, K, n, quantize) / rate * 1e3
            print(f"[bound] {name} olm16 {label} M={M} K={K} N={N}: "
                  f"{ms:.4f} ms; source-count bound {src_ms:.4f} ms "
                  f"({100 * src_ms / ms:.1f}%); instruction bound "
                  f"{sass_ms:.4f} ms ({100 * sass_ms / ms:.1f}%)", flush=True)
        del x, w, xd, wd
    print(smi_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
