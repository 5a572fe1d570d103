// Online inner-product array matmul for Hopper (sm_90a), two operand
// formats over one tile body:
//
//   olm_matmul_fused (K1): out (M, N) f32 = olm(x (M, K) f32, w (K, N) f32),
//     replacing the TPU kernel `olm_matmul_fused_pallas`
//     (src/repro/kernels/online_dot/matmul_kernel.py). The prologue of each
//     K tile quantizes the raw float row and column slices to n-digit
//     signed-digit grids with power-of-two scales.
//   olm_matmul_host (K2): the same product from operands quantized before
//     the call, replacing `olm_matmul_pallas` (same file): digit grids
//     xd (M, T, kt, n) and wd (N, T, kt, n) int32 in {-1, 0, 1} with scales
//     sx (M, T) and sw (N, T). The prologue packs the grids instead.
//
// Per K tile of kt <= 16 lanes both then run kt radix-2 online multipliers
// (the Fig. 7 truncated recurrence, n + 3 int32 steps), reduce their digit
// streams in the online adder tree, decode the (n + 2L)-digit stream
// exactly, fold in 2^L and sx * sw, and accumulate in float32 in K-tile
// order. Both results are bit-identical to the plain PyTorch version
// (`olm_matmul_ref`), to each other and to the JAX reference.
//
// What bounds them on an H100: integer operations. Each
// multiply-accumulate is a whole digit recurrence (~20 int32 operations a
// step, n + 3 steps) plus its share of the adder tree, so a GEMM does
// hundreds of int32 operations per float it reads. The design keeps every
// digit of the recurrence out of device memory: each block packs its row
// and column slices into digit masks in shared memory (one uint32 of +1
// digits and one of -1 digits per slice element: digits are in {-1, 0, 1}
// and n <= 32), and each thread keeps its lane's recurrence in registers.
// The 16 lanes of one output sit in 16 threads of a half-warp, so the
// adder tree is ceil(log2 kt) rounds of register shuffles, each adder
// computed bit-parallel over the whole stream on 64-bit masks. K2 reads
// n int32 digits per operand element where K1 reads one float: it moves
// n times the bytes, which stay far below the operation bound.
//
// Bit-identity rules this file keeps:
//  * round half to even (rintf), arithmetic right shifts on signed int32,
//    floors by masking, powers of two built by writing the exponent field;
//  * compiled without --use_fast_math and without FTZ; subnormal inputs
//    are flushed to zero explicitly, as the reference's substrates do;
//  * __fmul_rn / __fadd_rn / __fdiv_rn so nothing is contracted to an FMA,
//    in the reference's order: (decode * 2^L) * (sx * sw), then acc + inc;
//  * the decode sums the stream as an int64 integer, converts it to f32
//    once (round-to-nearest-even) and multiplies by the exact 2^-m: exact
//    inside the 24-digit window, and the reference's single rounding of the
//    exact value between 25 and 48 digits.
#include "olm_digits.cuh"

namespace {

using olm::Sched;

constexpr int kLanes = 16;                 // threads per output: one per lane
constexpr int kOuts = 16;                  // outputs per block
constexpr int kThreads = kLanes * kOuts;   // 256
constexpr int kMaxSlices = 2 * kOuts;      // bm + bn <= 17

// The prologue's two ways to one slice element's +1/-1 digit masks (digit
// i at bit N-1-i): K2 packs the element's N digits from its grid; K1
// quantizes the raw float v, the half-warp sharing the slice's max.
template <int N>
__device__ __forceinline__ void pack_digits(const int* __restrict__ d,
                                            uint32_t& pos, uint32_t& neg) {
  pos = neg = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int v = d[i];
    pos |= (uint32_t)(v > 0) << (N - 1 - i);
    neg |= (uint32_t)(v < 0) << (N - 1 - i);
  }
}

template <int N>
__device__ __forceinline__ void quantize(float v, unsigned hmask,
                                         uint32_t& pos, uint32_t& neg,
                                         float& scale) {
  if (fabsf(v) < 0x1p-126f) v = 0.0f;      // flush subnormals
  float amax = fabsf(v);
#pragma unroll
  for (int d = kLanes / 2; d > 0; d >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(hmask, amax, d, kLanes));
  scale = olm::pow2_scale_of(amax);
  const float r = rintf(__fmul_rn(__fdiv_rn(v, scale), olm::pow2f(N)));
  const uint32_t mag = (uint32_t)fabsf(r);   // <= 2^(N-1), 2^31 at N = 32
  pos = r > 0.0f ? mag : 0u;
  neg = r < 0.0f ? mag : 0u;
}

template <int N, bool HOST>
__global__ void __launch_bounds__(kThreads)
olm_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  long long w_sk, long long w_sn, const int* __restrict__ xd,
                  const float* __restrict__ sx, const int* __restrict__ wd,
                  const float* __restrict__ sw, float* __restrict__ out,
                  int M, int Ncols, int K, int n_tiles, int kt, int L, int S,
                  int bm, Sched sc) {
  __shared__ uint32_t s_pos[kMaxSlices][kLanes];
  __shared__ uint32_t s_neg[kMaxSlices][kLanes];
  __shared__ float s_scale[kMaxSlices];

  const int bn = kOuts / bm;
  const int nslices = bm + bn;
  const int lane = threadIdx.x & (kLanes - 1);
  const int o = threadIdx.x / kLanes;
  const int om = o / bn, on = o % bn;
  const int row = blockIdx.y * bm + om;
  const int col = blockIdx.x * bn + on;
  const unsigned hmask = 0xFFFFu << (threadIdx.x & 16);  // this half-warp
  const int mlen = N + 2 * L;
  const float two_mneg = olm::pow2f(-mlen), two_l = olm::pow2f(L);

  float acc = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();                       // previous tile's masks consumed
    // Prologue: bm row slices of x and bn column slices of w, one
    // half-warp per slice, one thread per element.
    for (int s = o; s < nslices; s += kOuts) {
      const bool is_row = s < bm;
      const int idx = is_row ? blockIdx.y * bm + s : blockIdx.x * bn + (s - bm);
      const bool idx_ok = idx < (is_row ? M : Ncols);
      uint32_t pos = 0u, neg = 0u;
      float scale = 1.0f;
      if (HOST) {
        const long long tile = (long long)idx * n_tiles + t;
        if (idx_ok && lane < kt)
          pack_digits<N>((is_row ? xd : wd) + (tile * kt + lane) * N, pos,
                         neg);
        if (idx_ok) scale = (is_row ? sx : sw)[tile];
      } else {
        const int k = t * kt + lane;
        float v = 0.0f;
        if (idx_ok && lane < kt && k < K)
          v = is_row ? x[(long long)idx * K + k]
                     : w[(long long)k * w_sk + (long long)idx * w_sn];
        quantize<N>(v, hmask, pos, neg, scale);
      }
      s_pos[s][lane] = pos;
      s_neg[s][lane] = neg;
      if (lane == 0) s_scale[s] = scale;
    }
    __syncthreads();
    uint64_t zp = 0, zn = 0;
    if (lane < kt)
      olm::mul_digit_loop<N>(s_pos[om][lane], s_neg[om][lane],
                             s_pos[bm + on][lane], s_neg[bm + on][lane], sc,
                             S, zp, zn);
    // Online adder tree over the kt lanes of this output (lanes >= kt carry
    // zero streams, which is the reference's zero padding of odd levels).
    for (int lvl = 0; lvl < L; ++lvl) {
      const uint64_t pp = __shfl_xor_sync(0xFFFFFFFFu, zp, 1 << lvl, kLanes);
      const uint64_t pn = __shfl_xor_sync(0xFFFFFFFFu, zn, 1 << lvl, kLanes);
      uint64_t rp, rn;
      olm::online_add(zp, zn, pp, pn, rp, rn);
      zp = rp;
      zn = rn;
    }
    // Exact decode of the mlen-digit stream, then the scale fold.
    const uint64_t ip = __brevll(zp) >> (64 - mlen);
    const uint64_t in = __brevll(zn) >> (64 - mlen);
    const float dec = __fmul_rn(__ll2float_rn((long long)ip - (long long)in),
                                two_mneg);
    const float val = __fmul_rn(dec, two_l);
    const float sxw = __fmul_rn(s_scale[om], s_scale[bm + on]);
    acc = __fadd_rn(acc, __fmul_rn(val, sxw));
  }
  if (lane == 0 && row < M && col < Ncols) out[(long long)row * Ncols + col] = acc;
}

struct Operands {
  const float* x;                          // K1: (M, K) row-major
  const float* w;                          // K1: w[k * w_sk + n * w_sn]
  long long w_sk, w_sn;
  const int* xd;                           // K2: (M, T, kt, n) digits
  const float* sx;                         // K2: (M, T) scales
  const int* wd;                           // K2: (N, T, kt, n) digits
  const float* sw;                         // K2: (N, T) scales
};

template <int N, bool HOST>
cudaError_t launch(const Operands& op, float* out, int M, int Ncols, int K,
                   int n_tiles, int kt, int L, int S, const Sched& sc,
                   cudaStream_t stream) {
  int bm = 1;
  while (bm < M && bm < 4) bm <<= 1;       // 1, 2 or 4 rows per block
  const int bn = kOuts / bm;
  const dim3 grid((Ncols + bn - 1) / bn, (M + bm - 1) / bm);
  olm_matmul_kernel<N, HOST><<<grid, kThreads, 0, stream>>>(
      op.x, op.w, op.w_sk, op.w_sn, op.xd, op.sx, op.wd, op.sw, out, M, Ncols,
      K, n_tiles, kt, L, S, bm, sc);
  return cudaGetLastError();
}

template <bool HOST>
int dispatch(const Operands& op, float* out, int M, int N, int K, int n_tiles,
             int n, int kt, int L, int S, const int* sched, int nsteps,
             void* stream) {
  if (M < 1 || N < 1 || K < 1 || n_tiles < 1 || kt < 1 || kt > kLanes ||
      nsteps != n + olm::kDelta || n > olm::kMaxDigits || S + 3 > 31 ||
      (1 << L) < kt || n + 2 * L > 48)
    return (int)cudaErrorInvalidValue;
  const Sched sc = olm::make_sched(sched, nsteps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OLM_CASE(NN)                                                          \
  case NN:                                                                    \
    return (int)launch<NN, HOST>(op, out, M, N, K, n_tiles, kt, L, S, sc, st);
  switch (n) {
    OLM_CASE(8) OLM_CASE(10) OLM_CASE(12) OLM_CASE(16) OLM_CASE(20)
    OLM_CASE(24) OLM_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef OLM_CASE
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns a cudaError_t:
// 0 on a successful launch. sched holds the n + 3 values of T(j); S is its
// maximum; out is (M, N) row-major.
//
// K1: x is (M, K) row-major; w is (K, N) addressed as
// w[k * w_sk + n * w_sn].
extern "C" int olm_matmul_fused(const float* x, const float* w, float* out,
                                int M, int N, int K, long long w_sk,
                                long long w_sn, int n, int kt, int L, int S,
                                const int* sched, int nsteps, void* stream) {
  Operands op{x, w, w_sk, w_sn, nullptr, nullptr, nullptr, nullptr};
  return dispatch<false>(op, out, M, N, K, (K + kt - 1) / kt, n, kt, L, S,
                         sched, nsteps, stream);
}

// K2: xd (M, T, kt, n) and wd (N, T, kt, n) int32 digit grids, row-major;
// sx (M, T) and sw (N, T) float32 scales.
extern "C" int olm_matmul_host(const int* xd, const float* sx, const int* wd,
                               const float* sw, float* out, int M, int N,
                               int T, int n, int kt, int L, int S,
                               const int* sched, int nsteps, void* stream) {
  Operands op{nullptr, nullptr, 0, 0, xd, sx, wd, sw};
  return dispatch<true>(op, out, M, N, T * kt, T, n, kt, L, S, sched, nsteps,
                        stream);
}
