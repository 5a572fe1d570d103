// Fused online inner-product array matmul for Hopper (sm_90a):
//   out (M, N) f32 = olm(x (M, K) f32, w (K, N) f32)
//
// Replaces the TPU kernel `olm_matmul_fused_pallas`
// (src/repro/kernels/online_dot/matmul_kernel.py). Per K tile of kt <= 16
// lanes it quantizes the raw float row and column slices to n-digit
// signed-digit grids with power-of-two scales, runs kt radix-2 online
// multipliers (the Fig. 7 truncated recurrence, n + 3 int32 steps), reduces
// their digit streams in the online adder tree, decodes the (n + 2L)-digit
// stream exactly, folds in 2^L and sx * sw, and accumulates in float32 in
// K-tile order. The result is bit-identical to the plain PyTorch version
// (`olm_matmul_ref`) and to the JAX reference.
//
// What bounds it on an H100: integer operations, not bytes. Each
// multiply-accumulate is a whole digit recurrence (~20 int32 operations a
// step, n + 3 steps) plus its share of the adder tree, so a GEMM does
// hundreds of int32 operations per float it reads. The design keeps every
// digit out of device memory: each block quantizes its row and column
// slices into packed digit masks in shared memory (one uint32 of +1 digits
// and one of -1 digits per slice element: digits are in {-1, 0, 1} and
// n <= 32), and each thread keeps its lane's recurrence in registers. The
// 16 lanes of one output sit in 16 threads of a half-warp, so the adder
// tree is ceil(log2 kt) rounds of register shuffles, each adder computed
// bit-parallel over the whole stream on 64-bit masks. A simple kernel
// that is right comes first; its time against the bound is in PERF.md.
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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;                 // threads per output: one per lane
constexpr int kOuts = 16;                  // outputs per block
constexpr int kThreads = kLanes * kOuts;   // 256
constexpr int kMaxSlices = 2 * kOuts;      // bm + bn <= 17
constexpr int kMaxSteps = 40;              // n + delta, n <= 32
constexpr int kDelta = 3;                  // online delay
constexpr int kEst = 2;                    // fractional MSDs of the estimate

struct Sched {
  int T[kMaxSteps];                        // working precision T(j) per step
};

__device__ __forceinline__ float pow2f(int e) {  // exact 2^e, -126 <= e <= 127
  return __int_as_float((e + 127) << 23);
}

// Power-of-two slice scale 2^(ceil(log2 amax) + 1), from the exponent bits.
__device__ __forceinline__ float pow2_scale_of(float amax) {
  if (!(amax > 0.0f)) return 1.0f;
  if (amax > 0x1p126f) return __int_as_float(0x7f800000);   // +inf
  const int bits = __float_as_int(fminf(fmaxf(amax, 0x1p-126f), 0x1p126f));
  const int e_floor = (bits >> 23) - 127;
  const int e_ceil = (bits & 0x7FFFFF) == 0 ? e_floor : e_floor + 1;
  return pow2f(e_ceil + 1);
}

// One lane of the radix-2 online multiplier at datapath scale 2^S: the
// Fig. 7 truncated recurrence, digits read MSD first from the packed masks
// (digit i at bit N-1-i). Output digit j lands at bit j of (zp, zn).
template <int N>
__device__ __forceinline__ void mul_digit_loop(uint32_t xp, uint32_t xn,
                                               uint32_t yp, uint32_t yn,
                                               const Sched& sc, int S,
                                               uint64_t& zp, uint64_t& zn) {
  int X = 0, Y = 0, W = 0;
  uint64_t op = 0, on = 0;
#pragma unroll
  for (int s = 0; s < N + kDelta; ++s) {
    const int j = s - kDelta;
    const int q = s + 1;                   // arriving digit position
    const int T = sc.T[s];
    int xd = 0, yd = 0;
    if (q <= N) {
      const int sh = N - q;
      xd = (int)((xp >> sh) & 1u) - (int)((xn >> sh) & 1u);
      yd = (int)((yp >> sh) & 1u) - (int)((yn >> sh) & 1u);
    }
    const int keep = (int)(0xFFFFFFFFu << max(S - T, 0));  // floor below 2^-T
    // the arriving digit's own bit is stored only while its slice is live
    const int wq = (q <= min(T, S)) ? (1 << max(S - q, 0)) : 0;
    const int Yf = Y + yd * wq;
    const int term = X * yd + Yf * xd;
    const int append = (term >> kDelta) & keep;
    X = (X + xd * wq) & keep;
    Y = Yf & keep;
    const int V = 2 * W + append;
    if (j >= 0) {
      const int vq = V >> (S - kEst);      // selection estimate, in quarters
      const int z = vq >= 2 ? 1 : (vq >= -2 ? 0 : -1);
      W = (V - z * (1 << S)) & keep;
      op |= (uint64_t)(z > 0) << j;
      on |= (uint64_t)(z < 0) << j;
    } else {
      W = V & keep;
    }
  }
  zp = op;
  zn = on;
}

// One online adder of the tree, position-parallel on packed streams (digit
// i at bit i). With e_k the digit sums (e_0 = 0, then the sums, then zeros):
//   t_k = +1 if e_k >= 2 or (e_k == 1 and e_{k+1} >= 0)
//   t_k = -1 if e_k <= -2 or (e_k == -1 and e_{k+1} < 0)
//   w_k = e_k - 2 t_k,  out_k = w_k + t_{k+1}  (in {-1, 0, 1})
// giving the stream of (a + b) / 2, two digits longer.
__device__ __forceinline__ void online_add(uint64_t ap, uint64_t an,
                                           uint64_t bp, uint64_t bn,
                                           uint64_t& op, uint64_t& on) {
  ap <<= 1; an <<= 1; bp <<= 1; bn <<= 1;  // digit i is e index i + 1
  const uint64_t a0 = ~(ap | an), b0 = ~(bp | bn);
  const uint64_t e2 = ap & bp, em2 = an & bn;
  const uint64_t e1 = (ap & b0) | (bp & a0);
  const uint64_t em1 = (an & b0) | (bn & a0);
  const uint64_t neg_next = (em1 | em2) >> 1;          // e_{k+1} < 0
  const uint64_t tp = e2 | (e1 & ~neg_next);
  const uint64_t tn = em2 | (em1 & neg_next);
  const uint64_t odd = e1 | em1;
  const uint64_t wp = odd & neg_next, wn = odd & ~neg_next;
  const uint64_t tpn = tp >> 1, tnn = tn >> 1;         // t_{k+1}
  const uint64_t wz = ~(wp | wn);
  op = (wp & ~tnn) | (wz & tpn);
  on = (wn & ~tpn) | (wz & tnn);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
olm_matmul_fused_kernel(const float* __restrict__ x,
                        const float* __restrict__ w, float* __restrict__ out,
                        int M, int Ncols, int K, long long w_sk,
                        long long w_sn, int kt, int L, int S, int bm,
                        Sched sc) {
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
  const int n_tiles = (K + kt - 1) / kt;
  const float two_n = pow2f(N);
  const int mlen = N + 2 * L;
  const float two_mneg = pow2f(-mlen), two_l = pow2f(L);

  float acc = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k = t * kt + lane;
    const bool k_ok = lane < kt && k < K;
    __syncthreads();                       // previous tile's masks consumed
    // Prologue: quantize bm row slices of x and bn column slices of w,
    // one half-warp per slice, one thread per element.
    for (int s = o; s < nslices; s += kOuts) {
      float v = 0.0f;
      if (s < bm) {
        const int xr = blockIdx.y * bm + s;
        if (k_ok && xr < M) v = x[(long long)xr * K + k];
      } else {
        const int wc = blockIdx.x * bn + (s - bm);
        if (k_ok && wc < Ncols) v = w[(long long)k * w_sk + (long long)wc * w_sn];
      }
      if (fabsf(v) < 0x1p-126f) v = 0.0f;  // flush subnormals
      float amax = fabsf(v);
#pragma unroll
      for (int d = kLanes / 2; d > 0; d >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(hmask, amax, d, kLanes));
      const float scale = pow2_scale_of(amax);
      const float r = rintf(__fmul_rn(__fdiv_rn(v, scale), two_n));
      const uint32_t mag = (uint32_t)fabsf(r);   // <= 2^(N-1), 2^31 at N = 32
      s_pos[s][lane] = r > 0.0f ? mag : 0u;
      s_neg[s][lane] = r < 0.0f ? mag : 0u;
      if (lane == 0) s_scale[s] = scale;
    }
    __syncthreads();
    uint64_t zp = 0, zn = 0;
    if (lane < kt)
      mul_digit_loop<N>(s_pos[om][lane], s_neg[om][lane], s_pos[bm + on][lane],
                        s_neg[bm + on][lane], sc, S, zp, zn);
    // Online adder tree over the kt lanes of this output (lanes >= kt carry
    // zero streams, which is the reference's zero padding of odd levels).
    for (int lvl = 0; lvl < L; ++lvl) {
      const uint64_t pp = __shfl_xor_sync(0xFFFFFFFFu, zp, 1 << lvl, kLanes);
      const uint64_t pn = __shfl_xor_sync(0xFFFFFFFFu, zn, 1 << lvl, kLanes);
      uint64_t rp, rn;
      online_add(zp, zn, pp, pn, rp, rn);
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

template <int N>
cudaError_t launch(const float* x, const float* w, float* out, int M, int Ncols,
                   int K, long long w_sk, long long w_sn, int kt, int L, int S,
                   const Sched& sc, cudaStream_t stream) {
  int bm = 1;
  while (bm < M && bm < 4) bm <<= 1;       // 1, 2 or 4 rows per block
  const int bn = kOuts / bm;
  const dim3 grid((Ncols + bn - 1) / bn, (M + bm - 1) / bm);
  olm_matmul_fused_kernel<N><<<grid, kThreads, 0, stream>>>(
      x, w, out, M, Ncols, K, w_sk, w_sn, kt, L, S, bm, sc);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). x is (M, K) row-major; w is
// (K, N) addressed as w[k * w_sk + n * w_sn]; out is (M, N) row-major.
// sched holds the n + 3 values of T(j); S is its maximum. Returns a
// cudaError_t: 0 on a successful launch.
extern "C" int olm_matmul_fused(const float* x, const float* w, float* out,
                                int M, int N, int K, long long w_sk,
                                long long w_sn, int n, int kt, int L, int S,
                                const int* sched, int nsteps, void* stream) {
  if (M < 1 || N < 1 || K < 1 || kt < 1 || kt > kLanes ||
      nsteps != n + kDelta || nsteps > kMaxSteps || S + 3 > 31 ||
      (1 << L) < kt || n + 2 * L > 48)
    return (int)cudaErrorInvalidValue;
  Sched sc;
  for (int i = 0; i < kMaxSteps; ++i) sc.T[i] = i < nsteps ? sched[i] : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8:  return (int)launch<8>(x, w, out, M, N, K, w_sk, w_sn, kt, L, S, sc, st);
    case 10: return (int)launch<10>(x, w, out, M, N, K, w_sk, w_sn, kt, L, S, sc, st);
    case 12: return (int)launch<12>(x, w, out, M, N, K, w_sk, w_sn, kt, L, S, sc, st);
    case 16: return (int)launch<16>(x, w, out, M, N, K, w_sk, w_sn, kt, L, S, sc, st);
    case 20: return (int)launch<20>(x, w, out, M, N, K, w_sk, w_sn, kt, L, S, sc, st);
    case 24: return (int)launch<24>(x, w, out, M, N, K, w_sk, w_sn, kt, L, S, sc, st);
    case 32: return (int)launch<32>(x, w, out, M, N, K, w_sk, w_sn, kt, L, S, sc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
