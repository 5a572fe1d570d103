// Batched fused online inner product for Hopper (sm_90a):
//   z (B, n + 2L) int32 = MSDF digit stream of sum_i x_i y_i / 2^L over the
//   K digit pairs of each row of x, y (B, K, n), digits in {-1, 0, 1},
//   L = ceil(log2 K).
//
// Replaces the TPU kernel `online_dot_pallas`
// (src/repro/kernels/online_dot/kernel.py). Each row owns R = 2^L threads,
// one per multiplier lane (lanes >= K carry zero streams, which is the
// reference's zero padding of odd tree levels). A thread packs its lane's
// digits into +1/-1 bit masks and runs the Fig. 7 recurrence
// (olm_digits.cuh, the loop K1-K4 share) in registers. The online adder
// tree then runs in L rounds, each adder bit-parallel over the whole
// stream on 64-bit masks: rounds inside a warp exchange streams by
// register shuffles, and past 32 lanes each warp parks its partial stream
// in shared memory and the row's first warp finishes the tree. A block
// holds 256 threads (several rows when R < 256) or one row of R <= 1024.
// Streams stay packed in 64 bits, and K <= 1024 keeps n + 2L <= 52.
//
// What bounds it on an H100: bytes at small K, integer operations only as
// a near tie. Each lane reads 8n bytes of digits and runs ~40 int32
// operations a step; the tree adds ~80 operations per lane. The design
// reads each digit once and keeps every digit of the tree in registers.
#include "olm_digits.cuh"

namespace {

using olm::Sched;

constexpr int kThreads = 256;
constexpr int kMaxLanes = 1024;            // one row per block at most

template <int N>
__global__ void __launch_bounds__(kMaxLanes)
online_dot_kernel(const int* __restrict__ x, const int* __restrict__ y,
                  int* __restrict__ z, int B, int K, int L, int S, Sched sc) {
  __shared__ uint64_t s_p[kMaxLanes / 32], s_n[kMaxLanes / 32];
  const int R = 1 << L;                    // threads per row
  const int G = blockDim.x / R;            // rows per block
  const int r = threadIdx.x / R;
  const int k = threadIdx.x % R;
  const long long b = (long long)blockIdx.x * G + r;
  const bool row_ok = b < B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  uint64_t zp = 0, zn = 0;
  if (row_ok && k < K) {
    const int* xr = x + (b * K + k) * N;
    const int* yr = y + (b * K + k) * N;
    uint32_t xp = 0, xn = 0, yp = 0, yn = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int xv = xr[i], yv = yr[i];
      xp |= (uint32_t)(xv > 0) << (N - 1 - i);
      xn |= (uint32_t)(xv < 0) << (N - 1 - i);
      yp |= (uint32_t)(yv > 0) << (N - 1 - i);
      yn |= (uint32_t)(yv < 0) << (N - 1 - i);
    }
    olm::mul_digit_loop<N>(xp, xn, yp, yn, sc, S, zp, zn);
  }
  // Tree rounds inside a warp: node i of round l pairs lanes i and
  // i ^ 2^l, so after the round both hold the parent stream.
  const int width = R < 32 ? R : 32;
  const int warp_rounds = L < 5 ? L : 5;
  for (int lvl = 0; lvl < warp_rounds; ++lvl) {
    const uint64_t pp = __shfl_xor_sync(0xFFFFFFFFu, zp, 1 << lvl, width);
    const uint64_t pn = __shfl_xor_sync(0xFFFFFFFFu, zn, 1 << lvl, width);
    uint64_t rp, rn;
    olm::online_add(zp, zn, pp, pn, rp, rn);
    zp = rp;
    zn = rn;
  }
  const int m = N + 2 * L;
  if (L <= 5) {                            // every lane holds its row's stream
    if (row_ok)
      for (int j = k; j < m; j += R)
        z[b * m + j] = (int)((zp >> j) & 1u) - (int)((zn >> j) & 1u);
    return;
  }
  // Rounds across the W warps of a row: warp w's stream is node w of
  // round 5; the row's first warp pairs them on lanes 0 .. W-1.
  const int W = R >> 5;
  const int first = r * W;                 // the row's first warp
  if (lane == 0) {
    s_p[warp] = zp;
    s_n[warp] = zn;
  }
  __syncthreads();
  if (warp != first) return;
  zp = lane < W ? s_p[first + lane] : 0;
  zn = lane < W ? s_n[first + lane] : 0;
  for (int d = 1; d < W; d <<= 1) {
    const uint64_t pp = __shfl_xor_sync(0xFFFFFFFFu, zp, d);
    const uint64_t pn = __shfl_xor_sync(0xFFFFFFFFu, zn, d);
    uint64_t rp, rn;
    olm::online_add(zp, zn, pp, pn, rp, rn);
    zp = rp;
    zn = rn;
  }
  zp = __shfl_sync(0xFFFFFFFFu, zp, 0);
  zn = __shfl_sync(0xFFFFFFFFu, zn, 0);
  if (row_ok)
    for (int j = lane; j < m; j += 32)
      z[b * m + j] = (int)((zp >> j) & 1u) - (int)((zn >> j) & 1u);
}

template <int N>
cudaError_t launch(const int* x, const int* y, int* z, int B, int K, int L,
                   int S, const Sched& sc, cudaStream_t stream) {
  const int R = 1 << L;
  const int threads = R > kThreads ? R : kThreads;
  const int G = threads / R;
  const int blocks = (B + G - 1) / G;
  online_dot_kernel<N><<<blocks, threads, 0, stream>>>(x, y, z, B, K, L, S,
                                                       sc);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). x, y are (B, K, n) int32
// row-major, z is (B, n + 2L) int32 row-major with L = ceil(log2 K);
// sched holds the n + 3 values of T(j) and S their maximum. Returns a
// cudaError_t: 0 on a successful launch.
extern "C" int online_dot(const int* x, const int* y, int* z, int B, int K,
                          int L, int n, int S, const int* sched, int nsteps,
                          void* stream) {
  if (B < 1 || K < 1 || K > kMaxLanes || L < 0 || (1 << L) < K ||
      (L > 0 && (1 << (L - 1)) >= K) || n <= olm::kDelta ||
      n > olm::kMaxDigits || n + 2 * L > 64 || nsteps != n + olm::kDelta ||
      S + 3 > 31 || S < olm::kEst)
    return (int)cudaErrorInvalidValue;
  const Sched sc = olm::make_sched(sched, nsteps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OLM_CASE(NN) \
  case NN: return (int)launch<NN>(x, y, z, B, K, L, S, sc, st);
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
