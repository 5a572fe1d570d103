#!/usr/bin/env python3
"""Why K3 (`online_dot`) at n = 32 ran 5x slower than at n = 16 for the same
K: its load pattern alone, timed on the card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 probes/online_dot_loads.py

As first ported, K3 gave each multiplier lane one thread, and that thread read
its lane's n int32 digits of x and of y, n consecutive words, 4n bytes
from the next thread's. This script builds three kernels that do only K3's
reading and packing (no recurrence, no tree) and time them with cold L2 at
K3's timed shape, B = 4096 rows of K = 256 lanes (2^20 lanes), at n = 8,
16 and 32:

  strided - that pattern as it was: one thread a lane, reading its own
            words in an unrolled loop, 256 threads a block; timed at full
            residency, with the blocks an SM holds capped through unused
            dynamic shared memory (so fewer lanes' lines compete for L1),
            and with the L1/shared carveout pinned either way;
  staged  - the same packing after each block has copied its 128 lanes
            coalesced into shared memory (neighbouring threads on
            neighbouring words, an odd row stride), as K4 does;
  ballot  - the same packing straight from coalesced registers: each warp
            loads its 32 lanes' words neighbouring threads on neighbouring
            words, and warp ballots of the non-zero and the negative
            digits give every lane its masks (n dividing 32).

Each prints its median time, the bytes it must move (8n a lane in, 4 out)
over that time, and the resident threads an SM holds. If the strided
pattern is slow at n = 32 because its L1 footprint (resident threads x 8n
bytes) overflows the 256 KB an SM has for L1 and shared memory, capping
the residency speeds it up. If it is slow because one warp load touches
n different 128-byte lines, its time grows with n^2 whatever the
residency (the script prints what one line a clock an SM would take),
and the staged version does not show the cliff. The script also times
the current K3 at the same shapes. A second set of timings repeats the
strided and staged kernels on B = 512 (33.5 MB at n = 32, inside the
50 MB L2) with the L2 left warm: a pattern that is slow there is slow
between L2 and the SM, not in HBM.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <int N>
__device__ __forceinline__ unsigned pack(const int* xr, const int* yr,
                                         int stride_words) {
  uint32_t xp = 0, xn = 0, yp = 0, yn = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int xv = xr[i * stride_words], yv = yr[i * stride_words];
    xp |= (uint32_t)(xv > 0) << (N - 1 - i);
    xn |= (uint32_t)(xv < 0) << (N - 1 - i);
    yp |= (uint32_t)(yv > 0) << (N - 1 - i);
    yn |= (uint32_t)(yv < 0) << (N - 1 - i);
  }
  return xp ^ (xn * 3u) ^ (yp * 5u) ^ (yn * 7u);
}

// K3's reads as first ported: thread e reads lane e's N words of x and y.
template <int N>
__global__ void __launch_bounds__(256)
strided(const int* __restrict__ x, const int* __restrict__ y,
        unsigned* __restrict__ out, long long lanes) {
  extern __shared__ int unused[];          // caps the blocks an SM holds
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < lanes) out[e] = pack<N>(x + e * N, y + e * N, 1);
}

// The same packing from 128 lanes a block staged coalesced in shared
// memory with an odd row stride.
template <int N>
__global__ void __launch_bounds__(128)
staged(const int* __restrict__ x, const int* __restrict__ y,
       unsigned* __restrict__ out, long long lanes) {
  constexpr int kStride = N | 1;
  __shared__ int sx[128 * kStride], sy[128 * kStride];
  const long long e0 = (long long)blockIdx.x * 128;
  const int count = (int)min(128LL, lanes - e0) * N;
#pragma unroll 4
  for (int j = threadIdx.x; j < count; j += 128) {
    sx[(j / N) * kStride + j % N] = x[e0 * N + j];
    sy[(j / N) * kStride + j % N] = y[e0 * N + j];
  }
  __syncthreads();
  if (e0 + threadIdx.x < lanes)
    out[e0 + threadIdx.x] = pack<N>(sx + threadIdx.x * kStride,
                                    sy + threadIdx.x * kStride, 1);
}

// The same packing straight from coalesced registers (32 % N == 0): a
// warp's 32 lanes are 32N consecutive words, its load j the digits of
// lanes 32j/N .. 32j/N + 32/N - 1, and a ballot of non-zero and one of
// negative digits give those lanes' masks (digit d at bit N*k + d).
template <int N>
__global__ void __launch_bounds__(256)
ballot(const int* __restrict__ x, const int* __restrict__ y,
       unsigned* __restrict__ out, long long lanes) {
  constexpr int kPer = 32 / N;             // lanes one warp load holds
  const long long w0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) & ~31LL;
  const int t = threadIdx.x & 31;
  if (w0 >= lanes) return;                 // lanes is a multiple of 32
  uint32_t xz = 0, xg = 0, yz = 0, yg = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int xv = x[w0 * N + 32 * j + t], yv = y[w0 * N + 32 * j + t];
    const uint32_t a = __ballot_sync(~0u, xv != 0), b = __ballot_sync(~0u, xv < 0);
    const uint32_t c = __ballot_sync(~0u, yv != 0), d = __ballot_sync(~0u, yv < 0);
    if (t / kPer == j) {
      const int sh = N * (t % kPer);
      xz = a >> sh; xg = b >> sh; yz = c >> sh; yg = d >> sh;
    }
  }
  // digit i from bit i of the field to bit N-1-i of the mask
  const auto msb_first = [](uint32_t v) { return __brev(v) >> (32 - N); };
  const uint32_t xn = msb_first(xg), yn = msb_first(yg);
  const uint32_t xp = msb_first(xz) & ~xn, yp = msb_first(yz) & ~yn;
  out[w0 + t] = xp ^ (xn * 3u) ^ (yp * 5u) ^ (yn * 7u);
}

template <int N>
const void* kernel_of(int kind) {
  return kind == 0 ? (const void*)strided<N>
                   : kind == 1 ? (const void*)staged<N> : (const void*)ballot<N>;
}

template <int N>
int prepare(int kind, int smem, int carveout, int* resident) {
  const void* fn = kernel_of<N>(kind);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  const int threads = kind == 1 ? 128 : 256;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      smem);
  *resident = blocks * threads;
  return (int)err;
}

template <int N>
int run(int kind, const int* x, const int* y, unsigned* out, long long lanes,
        int smem, cudaStream_t st) {
  const int threads = kind == 1 ? 128 : 256;
  const unsigned grid = (unsigned)((lanes + threads - 1) / threads);
  if (kind == 0)
    strided<N><<<grid, threads, smem, st>>>(x, y, out, lanes);
  else if (kind == 1)
    staged<N><<<grid, threads, smem, st>>>(x, y, out, lanes);
  else
    ballot<N><<<grid, threads, smem, st>>>(x, y, out, lanes);
  return (int)cudaGetLastError();
}

// Set a kernel's shared memory and L1/shared carveout (-1: the default)
// and report the threads an SM then holds.
extern "C" int probe_prepare(int kind, int n, int smem, int carveout,
                             int* resident) {
  switch (n) {
    case 8: return prepare<8>(kind, smem, carveout, resident);
    case 16: return prepare<16>(kind, smem, carveout, resident);
    case 32: return prepare<32>(kind, smem, carveout, resident);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int probe(int kind, int n, const int* x, const int* y,
                     unsigned* out, long long lanes, int smem, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return run<8>(kind, x, y, out, lanes, smem, st);
    case 16: return run<16>(kind, x, y, out, lanes, smem, st);
    case 32: return run<32>(kind, x, y, out, lanes, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
"""

NS = (8, 16, 32)
B, K = 4096, 256
WARM_B = 512
# Dynamic shared memory that caps a 256-thread block at 8 (no cap), 4, 2
# and 1 blocks an SM (the SM has 228 KB; each block reserves 1 KB more).
CAPS = ((8, 0), (4, 50 << 10), (2, 100 << 10), (1, 200 << 10))


def compile_probe():
    from repro_torch.kernels import build
    out = build.BUILD_ROOT.parent / "probes"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "online_dot_loads.cu"
    src.write_text(SOURCE)
    lib = out / "libonline_dot_loads.so"
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"nvcc failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_prepare.argtypes = [i, i, i, i, p]
    lib.probe.argtypes = [i, i, p, p, p, ctypes.c_longlong, i, p]
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("online_dot_loads: no CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import HBM_BYTES_PER_S, SPIN_CYCLES, cuda_ms, digits, smi
    from repro_torch.core.precision import OnlinePrecision
    from repro_torch.kernels.online_dot import kernel as k3
    dev = torch.device("cuda", 0)
    print(f"[device] {torch.cuda.get_device_name(0)}; "
          f"{smi('name,power.limit')}", flush=True)
    lib = compile_probe()
    resident = ctypes.c_int()

    def launcher(kind, n, xd, yd, out, smem=0, carveout=-1):
        """A launch of one probe kernel, its attributes set first (not
        timed); `resident` then holds the threads an SM holds."""
        err = lib.probe_prepare(kind, n, smem, carveout,
                                ctypes.byref(resident))
        if err:
            raise RuntimeError(f"probe setup failed: cudaError {err}")
        lanes = xd.numel() // n

        def go():
            err = lib.probe(kind, n, xd.data_ptr(), yd.data_ptr(),
                            out.data_ptr(), lanes, smem,
                            torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe launch failed: cudaError {err}")
        return go

    def line(label, n, lanes, ms, threads=None):
        moved = lanes * (8 * n + 4)
        res = f", {threads} resident threads an SM" if threads else ""
        print(f"[loads] {label} n={n}: {ms:.4f} ms, "
              f"{moved / ms / 1e6:.0f} GB/s of the {moved / 1e6:.1f} MB it "
              f"must move (HBM bound {moved / HBM_BYTES_PER_S * 1e3:.4f} ms)"
              f"{res}", flush=True)

    for n in NS:
        xd, yd = digits((B, K, n), n, dev)
        lanes = B * K
        out = torch.empty(lanes, dtype=torch.int32, device=dev)
        want = None
        for blocks, smem in CAPS:
            go = launcher(0, n, xd, yd, out, smem)
            ms = cuda_ms(go, reps=21, warmup=2)
            line(f"strided, cap {blocks} blocks", n, lanes, ms,
                 resident.value)
            want = out.clone() if want is None else want
            if not torch.equal(out, want):
                raise SystemExit("the capped launch packed other masks")
        for carveout, name in ((0, "carveout max L1"),
                               (100, "carveout max shared")):
            ms = cuda_ms(launcher(0, n, xd, yd, out, 0, carveout), reps=21,
                         warmup=2)
            line(f"strided, {name}", n, lanes, ms, resident.value)
        ms = cuda_ms(launcher(1, n, xd, yd, out), reps=21, warmup=2)
        line("staged", n, lanes, ms, resident.value)
        if not torch.equal(out, want):
            raise SystemExit("staged and strided packed other masks")
        ms = cuda_ms(launcher(2, n, xd, yd, out), reps=21, warmup=2)
        line("ballot", n, lanes, ms, resident.value)
        # one strided warp load of a digit reaches 32 lanes 4n bytes apart,
        # n 128-byte lines; a lane's n loads of each operand make n^2 lines
        # a warp and operand, at one line a clock an SM:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        clock = float(smi("clocks.max.sm").split()[0]) * 1e6
        print(f"[loads] strided n={n}: {n} lines a warp load; at one line a "
              f"clock an SM the loads take "
              f"{lanes / 32 * 2 * n * n / (sms * clock) * 1e3:.4f} ms",
              flush=True)
        if not torch.equal(out, want):
            raise SystemExit("ballot and strided packed other masks")
        cfg = OnlinePrecision(n=n)
        ms = cuda_ms(lambda: k3.online_dot_kernel(xd, yd, cfg), reps=21,
                     warmup=2)
        line("online_dot kernel (as built from this checkout)", n, lanes, ms)
        del xd, yd, out

    # warm L2: B = 512 rows, every operand resident in the 50 MB L2 (the
    # same buffers each launch, no flush; the spin kernel hides the host)
    def warm_ms(fn, reps=21):
        fn()
        spans = []
        for _ in range(reps):
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            spans.append((start, stop))
        torch.cuda.synchronize()
        return sorted(a.elapsed_time(b) for a, b in spans)[reps // 2]

    for n in NS:
        xd, yd = digits((WARM_B, K, n), n, dev)
        lanes = WARM_B * K
        out = torch.empty(lanes, dtype=torch.int32, device=dev)
        for kind, label in ((0, "strided"), (1, "staged"), (2, "ballot")):
            ms = warm_ms(launcher(kind, n, xd, yd, out))
            line(f"{label}, warm L2, B={WARM_B}", n, lanes, ms,
                 resident.value)
    print(smi("name,power.limit"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
