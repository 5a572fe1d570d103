// Batched radix-2 online multiplier for Hopper (sm_90a):
//   z (B, n) int32 = MSDF product digits of x (B, n) and y (B, n), digits
//   in {-1, 0, 1}, MSD first.
//
// Replaces the TPU kernel `online_mul_pallas`
// (src/repro/kernels/online_mul/kernel.py). One thread runs one row's
// multiplication: it packs the row's operand digits into +1/-1 bit masks,
// runs the n + 3 steps of the Fig. 7 recurrence (olm_digits.cuh, the loop
// K1-K3 share) in registers at datapath scale 2^S under the schedule T(j),
// and writes the n product digits back. Every configuration whose
// schedule fits the int32 datapath (max T(j) + 3 <= 31) runs here:
// truncated n <= 32, full working precision n <= 24.
//
// What bounds it on an H100: bytes. A row reads 8n bytes of digits and
// writes 4n, against ~40 int32 operations a step, so the int32 issue
// bound sits below the HBM bound at every n. One thread still runs one
// row's whole recurrence in registers, but a row's digits are n
// consecutive int32 words, so a warp reading its own rows touches 32
// rows 4n bytes apart with every load. The design moves the digits
// coalesced instead: a block's 128 rows of x and y are one contiguous
// stretch of memory, which the block reads word by word, neighbouring
// threads on neighbouring words, into shared memory with an odd row
// stride (n, or n + 1 when n is even, so 32 threads reading one digit of
// 32 rows hit 32 banks). Each thread packs its row from there, runs the
// recurrence, writes its product digits back over its x row, and the
// block stores z the way it loaded x. A ragged last block masks its
// rows.
#include "olm_digits.cuh"

namespace {

using olm::Sched;

constexpr int kRows = 128;                 // rows (= threads) of a block

// Copy `rows` rows of n words from global memory into shared rows of
// `stride` words, neighbouring threads on neighbouring words.
template <int N, int kStride>
__device__ __forceinline__ void rows_in(const int* __restrict__ g, int* s,
                                        int rows) {
  const int count = rows * N;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int e = j * kRows + threadIdx.x;
    if (e < count) s[(e / N) * kStride + e % N] = g[e];
  }
}

template <int N>
__global__ void __launch_bounds__(kRows)
online_mul_kernel(const int* __restrict__ x, const int* __restrict__ y,
                  int* __restrict__ z, long long B, int S, Sched sc) {
  constexpr int kStride = N | 1;
  __shared__ int sx[kRows * kStride];
  __shared__ int sy[kRows * kStride];
  const long long b0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, B - b0);
  rows_in<N, kStride>(x + b0 * N, sx, rows);
  rows_in<N, kStride>(y + b0 * N, sy, rows);
  __syncthreads();
  const int r = threadIdx.x;
  int* row = sx + r * kStride;
  if (r < rows) {
    const int* yr = sy + r * kStride;
    uint32_t xp = 0, xn = 0, yp = 0, yn = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int xv = row[i], yv = yr[i];
      xp |= (uint32_t)(xv > 0) << (N - 1 - i);
      xn |= (uint32_t)(xv < 0) << (N - 1 - i);
      yp |= (uint32_t)(yv > 0) << (N - 1 - i);
      yn |= (uint32_t)(yv < 0) << (N - 1 - i);
    }
    uint64_t zp, zn;
    olm::mul_digit_loop<N>(xp, xn, yp, yn, sc, S, zp, zn);
#pragma unroll
    for (int j = 0; j < N; ++j)            // row r of sx is only this
      row[j] = (int)((zp >> j) & 1u) - (int)((zn >> j) & 1u);  // thread's
  }
  __syncthreads();
  int* zb = z + b0 * N;
  const int count = rows * N;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int e = j * kRows + threadIdx.x;
    if (e < count) zb[e] = sx[(e / N) * kStride + e % N];
  }
}

template <int N>
cudaError_t launch(const int* x, const int* y, int* z, long long B, int S,
                   const Sched& sc, cudaStream_t stream) {
  const long long blocks = (B + kRows - 1) / kRows;
  online_mul_kernel<N><<<(unsigned)blocks, kRows, 0, stream>>>(x, y, z, B, S,
                                                               sc);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). x, y, z are (B, n) int32
// row-major; sched holds the n + 3 values of T(j) and S their maximum.
// Returns a cudaError_t: 0 on a successful launch.
extern "C" int online_mul(const int* x, const int* y, int* z, long long B,
                          int n, int S, const int* sched, int nsteps,
                          void* stream) {
  if (B < 1 || B > (long long)kRows * 0x7FFFFFFFLL ||
      n <= olm::kDelta || n > olm::kMaxDigits ||
      nsteps != n + olm::kDelta || S + 3 > 31 || S < olm::kEst)
    return (int)cudaErrorInvalidValue;
  const Sched sc = olm::make_sched(sched, nsteps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OLM_CASE(NN) \
  case NN: return (int)launch<NN>(x, y, z, B, S, sc, st);
  switch (n) {
    OLM_CASE(4) OLM_CASE(5) OLM_CASE(6) OLM_CASE(7) OLM_CASE(8) OLM_CASE(9)
    OLM_CASE(10) OLM_CASE(11) OLM_CASE(12) OLM_CASE(13) OLM_CASE(14)
    OLM_CASE(15) OLM_CASE(16) OLM_CASE(17) OLM_CASE(18) OLM_CASE(19)
    OLM_CASE(20) OLM_CASE(21) OLM_CASE(22) OLM_CASE(23) OLM_CASE(24)
    OLM_CASE(25) OLM_CASE(26) OLM_CASE(27) OLM_CASE(28) OLM_CASE(29)
    OLM_CASE(30) OLM_CASE(31) OLM_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef OLM_CASE
}
