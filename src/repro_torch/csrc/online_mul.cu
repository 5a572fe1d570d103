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
// bound sits below the HBM bound at every n. The design reads each digit
// once and keeps the whole recurrence in registers; the digits move as
// int32 because that is the layout the reference hands over.
#include "olm_digits.cuh"

namespace {

using olm::Sched;

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads)
online_mul_kernel(const int* __restrict__ x, const int* __restrict__ y,
                  int* __restrict__ z, long long B, int S, Sched sc) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int* xr = x + b * N;
  const int* yr = y + b * N;
  uint32_t xp = 0, xn = 0, yp = 0, yn = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int xv = xr[i], yv = yr[i];
    xp |= (uint32_t)(xv > 0) << (N - 1 - i);
    xn |= (uint32_t)(xv < 0) << (N - 1 - i);
    yp |= (uint32_t)(yv > 0) << (N - 1 - i);
    yn |= (uint32_t)(yv < 0) << (N - 1 - i);
  }
  uint64_t zp, zn;
  olm::mul_digit_loop<N>(xp, xn, yp, yn, sc, S, zp, zn);
  int* zr = z + b * N;
#pragma unroll
  for (int j = 0; j < N; ++j)
    zr[j] = (int)((zp >> j) & 1u) - (int)((zn >> j) & 1u);
}

template <int N>
cudaError_t launch(const int* x, const int* y, int* z, long long B, int S,
                   const Sched& sc, cudaStream_t stream) {
  const long long blocks = (B + kThreads - 1) / kThreads;
  online_mul_kernel<N><<<(unsigned)blocks, kThreads, 0, stream>>>(x, y, z, B,
                                                                  S, sc);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). x, y, z are (B, n) int32
// row-major; sched holds the n + 3 values of T(j) and S their maximum.
// Returns a cudaError_t: 0 on a successful launch.
extern "C" int online_mul(const int* x, const int* y, int* z, long long B,
                          int n, int S, const int* sched, int nsteps,
                          void* stream) {
  if (B < 1 || B > (long long)kThreads * 0x7FFFFFFFLL ||
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
