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
// What bounds them on an H100: integer instructions. Each
// multiply-accumulate is a whole digit recurrence (some 30 instructions a
// digit) plus its share of the adder tree, so a GEMM issues hundreds of
// instructions per float it reads. The design spends as few as it can on
// anything else:
//
//  * One thread per (output, K tile). A thread runs its tile's 2^L lanes
//    in series, two recurrences interleaved, and reduces their streams as
//    they complete: a stack of at most L - 1 pending nodes, the top two
//    paired whenever they sit at the same level (left the older, right
//    the newer), which is `adder_tree`'s pairing of children 2i and
//    2i + 1. Each adder and each decode is issued once; no shuffles. Lanes
//    past kt, and lanes past K in the ragged last tile, hold zero digits
//    and so zero streams: the reference's zero padding of an odd level.
//  * The recurrence takes the schedule's per-step constants from the host
//    (one `Steps` per launch, as K3's `lane_loop` does) and keeps the
//    integer ALU pipe, which bounds it, as short as the FMA pipe allows
//    (olm_lane.cuh's `lane_top`). Streams stay in 32-bit words wherever
//    n + 2L <= 32 (olm8 to olm24 at kt = 16); olm32 takes 64-bit words.
//  * A block covers bm x bn outputs x tb K tiles (the host's plan,
//    matmul_kernel.launch_plan) and walks K in chunks of tb tiles. Per
//    chunk it quantizes (K1) or packs (K2) its (bm + bn) x tb slices into
//    +1/-1 masks in shared memory, runs the chunk's output tiles, and one
//    thread per output adds the chunk's tile values to its f32 sum in
//    tile order. The next chunk's operands are copied (cp.async) into the
//    one stage as soon as this chunk's are packed, and arrive while it
//    computes. Copies put neighbouring threads on neighbouring addresses:
//    w's columns in its (K, N) layout, its k in the transposed one, and
//    K2's digit rows in 16-byte chunks swizzled as online_dot.cu's are.
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
#include "olm_lane.cuh"

namespace {

using olm::lane_top;
using olm::online_add;
using olm::Steps;

constexpr int kLanes = 16;                 // most lanes of a K tile
constexpr int kSlice = 17;                 // stride of a slice's 16 lanes
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;           // 227 KB, the most a block may ask
constexpr unsigned kMaxGridY = 65535;      // grid y's (and z's) limit

__host__ __device__ constexpr int round16(int b) { return (b + 15) & ~15; }

// Shared memory of a block, in bytes from its start: the stage of the
// next chunk's raw operands (K1: 17 floats a slice; K2: 16 digit rows and
// a scale a slice), the +1/-1 masks of the chunk's slices (17 a slice), their
// scales, and the chunk's tile values. matmul_kernel.launch_plan
// computes the same.
struct Layout {
  int sstage, mask, scale, inc, total;
};
__host__ __device__ inline Layout layout(int n, bool host, bool vec, int bm,
                                         int bn, int tb) {
  const int slices = (bm + bn) * tb;
  const int stage = host ? slices * kLanes * olm::row_words(n, vec) * 4
                         : slices * kSlice * 4;
  Layout l;
  l.sstage = round16(stage);
  l.mask = l.sstage + (host ? round16(slices * 4) : 0);
  l.scale = l.mask + round16(slices * kSlice * 8);
  l.inc = l.scale + round16(slices * 4);
  l.total = l.inc + round16(bm * bn * tb * 4);
  return l;
}

struct Args {
  const float* x;                          // K1: (M, K) row-major
  const float* w;                          // K1: w[k * w_sk + n * w_sn]
  long long w_sk, w_sn;
  const int* xd;                           // K2: (M, T, kt, n) digits
  const float* sx;                         // K2: (M, T) scales
  const int* wd;                           // K2: (N, T, kt, n) digits
  const float* sw;                         // K2: (N, T) scales
  float* out;                              // (M, N) row-major
  int M, N, K, T, kt, L;
  int bm, bn, tb;                          // the plan: powers of two
  Steps st;
};

// K1's quantizer of one slice element v: the half-warp holding the
// slice's 16 lanes shares its max; digit i of the result at bit N-1-i.
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

// The adder tree of one output tile, in one thread: lanes 2p and 2p + 1
// run together and their level-1 node is merged with the pending nodes
// s1, s2, s3 (one per level) as a binary counter would carry. After pair
// 2^(L-1) - 1 the last node made is the root, at level L.
template <int N, typename W>
__device__ __forceinline__ void tile_tree(const uint2* __restrict__ xm,
                                          const uint2* __restrict__ wm,
                                          const Steps& st, int L, W& rp,
                                          W& rn) {
  if (L == 0) {
    uint32_t p, q;
    lane_top<N>(xm[0].x, xm[0].y, wm[0].x, wm[0].y, st, p, q);
    rp = p;
    rn = q;
    return;
  }
  W s1p = 0, s1n = 0, s2p = 0, s2n = 0, s3p = 0, s3n = 0;
  const int pairs = 1 << (L - 1);
#pragma unroll
  for (int p = 0; p < kLanes / 2; ++p) {
    if (p < pairs) {
      const uint2 xa = xm[2 * p], xb = xm[2 * p + 1];
      const uint2 wa = wm[2 * p], wb = wm[2 * p + 1];
      uint32_t ap, an, bp, bq;
      lane_top<N>(xa.x, xa.y, wa.x, wa.y, st, ap, an);
      lane_top<N>(xb.x, xb.y, wb.x, wb.y, st, bp, bq);
      W np, nn;
      online_add<W>(ap, an, bp, bq, np, nn);                // level 1
      if (p & 1) {
        online_add<W>(s1p, s1n, np, nn, np, nn);            // level 2
        if (p & 2) {
          online_add<W>(s2p, s2n, np, nn, np, nn);          // level 3
          if (p & 4) {
            online_add<W>(s3p, s3n, np, nn, np, nn);        // level 4
          } else {
            s3p = np;
            s3n = nn;
          }
        } else {
          s2p = np;
          s2n = nn;
        }
      } else {
        s1p = np;
        s1n = nn;
      }
      rp = np;
      rn = nn;
    }
  }
}

// The exact value of an m-digit stream (digit i at bit i) times 2^m.
template <typename W>
__device__ __forceinline__ long long stream_int(W p, W q, int m) {
  if constexpr (sizeof(W) == 4)
    return (long long)(__brev(p) >> (32 - m)) - (long long)(__brev(q) >> (32 - m));
  else
    return (long long)(__brevll(p) >> (64 - m)) -
           (long long)(__brevll(q) >> (64 - m));
}

// Slices of a chunk: x row r, tile tt is slice r * tb + tt; w column c,
// tile tt is slice bm * tb + tt * bn + c (the tile-major order keeps a
// warp's columns on distinct banks). The stage holds its rows in
// slice-group order g: x's as their slices, w's column-major
// (g = bm * tb + c * tb + tt), so each operand row's run of tiles is one
// contiguous stretch.
__device__ __forceinline__ int slice_of_group(int g, int xs, int lg_tb,
                                              int bn) {
  if (g < xs) return g;
  const int u = g - xs;
  return xs + (u & ((1 << lg_tb) - 1)) * bn + (u >> lg_tb);
}

template <int N, bool HOST, bool VEC, typename W>
__global__ void __launch_bounds__(kMaxThreads)
olm_matmul_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(N, HOST, VEC, a.bm, a.bn, a.tb);
  int* stage = reinterpret_cast<int*>(smem);
  int* sstage = reinterpret_cast<int*>(smem + lay.sstage);   // K2's scales
  uint2* mask = reinterpret_cast<uint2*>(smem + lay.mask);
  float* scale = reinterpret_cast<float*>(smem + lay.scale);
  float* inc = reinterpret_cast<float*>(smem + lay.inc);
  constexpr int kRow = olm::row_words(N, VEC);   // K2's staged row

  const int bm = a.bm, bn = a.bn, tb = a.tb, kt = a.kt;
  const int lg_tb = __ffs(tb) - 1, lg_bn = __ffs(bn) - 1;
  const int P = bm * bn;                   // outputs of the block
  const int threads = P * tb;
  const int t = threadIdx.x;
  const int xs = bm * tb;                  // x slices, then w slices
  const int groups = (bm + bn) * tb;
  // Row blocks past 65,535 (grid y's limit) continue in grid z; the
  // z-slice's blocks past M return at once, the whole block together.
  const long long by = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  if (by * bm >= a.M) return;
  const int row0 = (int)by * bm, col0 = blockIdx.x * bn;
  const int chunks = (a.T + tb - 1) / tb;

  // Start copying chunk c's operands into the stage.
  auto request = [&](int c) {
    if (c >= chunks) return;
    const int t0 = c * tb;
    if constexpr (HOST) {
      // each operand row's tiles t0 .. t0 + cnt - 1 are cnt * kt digit
      // rows in a row, and its cnt scales too; one warp a slice row: digit
      // row d of the stretch is lane d % kt of tile d / kt, staged at row
      // (g * 16 + lane) of the stage, g the slice's group
      const int cnt = min(tb, a.T - t0);
      constexpr int Q = VEC ? N / 4 : N;   // copies a digit row
      const int per = cnt * kt * Q;
      const int lane = t & 31;
      for (int s = t >> 5; s < bm + bn; s += threads >> 5) {
        const bool is_x = s < bm;
        const int idx = is_x ? row0 + s : col0 + (s - bm);
        if (idx >= (is_x ? a.M : a.N)) continue;
        const long long tile = (long long)idx * a.T + t0;
        const int* src = (is_x ? a.xd : a.wd) + tile * kt * N;
        const int g0 = is_x ? s * tb : xs + (s - bm) * tb;
        for (int u = lane; u < cnt; u += 32)
          olm::cp_async4(sstage + g0 + u, (is_x ? a.sx : a.sw) + tile + u);
        for (int j = lane; j < per; j += 32) {
          const int d = j / Q, part = j - d * Q;
          const int tt = kt == kLanes ? d >> 4 : d / kt;
          const int e = (g0 + tt) * kLanes + (d - tt * kt);
          if constexpr (VEC)
            olm::cp_async16(stage + e * kRow + 4 * (part ^ olm::swizzle<N>(e)),
                            src + 4 * j);
          else
            olm::cp_async4(stage + e * kRow + part, src + j);
        }
      }
    } else {
      // x: lane fastest, so a row's K run is contiguous
      for (int j = t; j < xs * kLanes; j += threads) {
        const int i = j & (kLanes - 1), g = j >> 4;
        const int row = row0 + (g >> lg_tb);
        const int k = (t0 + (g & (tb - 1))) * kt + i;
        if (row < a.M && i < kt && k < a.K)
          olm::cp_async4(stage + g * kSlice + i, a.x + (long long)row * a.K + k);
      }
      // w: columns fastest in its (K, N) layout, k fastest transposed
      const bool by_col = a.w_sn == 1;
      for (int j = t; j < bn * tb * kLanes; j += threads) {
        int i, tt, c;
        if (by_col) {
          c = j & (bn - 1);
          i = (j >> lg_bn) & (kLanes - 1);
          tt = j >> (lg_bn + 4);
        } else {
          i = j & (kLanes - 1);
          tt = (j >> 4) & (tb - 1);
          c = j >> (4 + lg_tb);
        }
        const int col = col0 + c;
        const int k = (t0 + tt) * kt + i;
        if (col < a.N && i < kt && k < a.K)
          olm::cp_async4(stage + (xs + c * tb + tt) * kSlice + i,
                         a.w + (long long)k * a.w_sk + (long long)col * a.w_sn);
      }
    }
  };

  // This thread's output tile in every chunk: output o, tile tt of it.
  const int o = t % P, tt_o = t / P;
  const int om = o / bn, on = o - om * bn;
  const uint2* xm = mask + (om * tb + tt_o) * kSlice;
  const uint2* wm = mask + (xs + tt_o * bn + on) * kSlice;
  const int mlen = N + 2 * a.L;
  const float two_mneg = olm::pow2f(-mlen), two_l = olm::pow2f(a.L);
  float acc = 0.0f;

  // One thread per output adds chunk c's tile values in tile order.
  auto accumulate = [&](int c) {
    const int cnt = min(tb, a.T - c * tb);
    for (int u = 0; u < cnt; ++u) acc = __fadd_rn(acc, inc[u * P + t]);
  };

  request(0);
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * tb;
    olm::cp_async_wait_all();              // this thread's copies of c
    __syncthreads();                       // everyone's; inc of c - 1 ready
    if (c > 0 && t < P) accumulate(c - 1);
    // Prologue: every slice element of the chunk into its masks, one
    // thread an element, a slice's 16 lanes in one half-warp.
    for (int j = t; j < groups * kLanes; j += threads) {
      const int g = j >> 4, i = j & (kLanes - 1);
      const int s = slice_of_group(g, xs, lg_tb, bn);
      const bool is_x = g < xs;
      const int tt = is_x ? g & (tb - 1) : (g - xs) & (tb - 1);
      const int idx = is_x ? row0 + (g >> lg_tb) : col0 + ((g - xs) >> lg_tb);
      const bool slice_ok = idx < (is_x ? a.M : a.N) && t0 + tt < a.T;
      const bool ok = slice_ok && i < kt && (t0 + tt) * kt + i < a.K;
      uint32_t pos = 0u, neg = 0u;
      float sc;
      if constexpr (HOST) {
        if (ok) olm::pack<N, VEC>(stage + j * kRow, olm::swizzle<N>(j), pos, neg);
        sc = slice_ok ? __int_as_float(sstage[g]) : 1.0f;
      } else {
        const float v = ok ? __int_as_float(stage[g * kSlice + i]) : 0.0f;
        quantize<N>(v, 0xFFFFu << (t & 16), pos, neg, sc);
      }
      mask[s * kSlice + i] = make_uint2(pos << (32 - N), neg << (32 - N));
      if (i == 0) scale[s] = sc;
    }
    __syncthreads();                       // masks ready; the stage is free
    request(c + 1);
    if (t0 + tt_o < a.T) {
      W zp, zn;
      tile_tree<N, W>(xm, wm, a.st, a.L, zp, zn);
      const float dec = __fmul_rn(__ll2float_rn(stream_int<W>(zp, zn, mlen)),
                                  two_mneg);
      const float sxw = __fmul_rn(scale[om * tb + tt_o],
                                  scale[xs + tt_o * bn + on]);
      inc[tt_o * P + o] = __fmul_rn(__fmul_rn(dec, two_l), sxw);
    }
  }
  __syncthreads();
  if (t < P) {
    accumulate(chunks - 1);
    const int row = row0 + om, col = col0 + on;
    if (row < a.M && col < a.N) a.out[(long long)row * a.N + col] = acc;
  }
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

// One launch, or with `smem_out` set the geometry query: the plan's shared
// memory and the blocks an SM holds, and no launch.
template <int N, bool HOST, bool VEC, typename W>
cudaError_t launch(const Args& a, cudaStream_t stream, int* smem_out,
                   int* blocks_out) {
  auto kern = olm_matmul_kernel<N, HOST, VEC, W>;
  const int threads = a.bm * a.bn * a.tb;
  const int smem = layout(N, HOST, VEC, a.bm, a.bn, a.tb).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (smem_out) {
    *smem_out = smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_out, kern,
                                                         threads, smem);
  }
  const unsigned rows = (a.M + a.bm - 1) / a.bm;
  const dim3 grid((a.N + a.bn - 1) / a.bn, rows < kMaxGridY ? rows : kMaxGridY,
                  (rows + kMaxGridY - 1) / kMaxGridY);
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// 32-bit streams where n + 2L <= 32 (every width below 32 at kt <= 16).
template <int N, bool HOST, bool VEC>
cudaError_t by_width(const Args& a, cudaStream_t stream, int* smem_out,
                     int* blocks_out) {
  if constexpr (N + 2 * 4 > 32) {
    if (N + 2 * a.L > 32)
      return launch<N, HOST, VEC, uint64_t>(a, stream, smem_out, blocks_out);
  }
  return launch<N, HOST, VEC, uint32_t>(a, stream, smem_out, blocks_out);
}

template <bool HOST>
cudaError_t dispatch(int n, bool vec, const Args& a, cudaStream_t stream,
                     int* smem_out = nullptr, int* blocks_out = nullptr) {
  const int threads = a.bm * a.bn * a.tb;
  if (!pow2(a.bm) || !pow2(a.bn) || !pow2(a.tb) || threads % 32 != 0 ||
      threads > kMaxThreads || a.L < 0 || a.L > 4)
    return cudaErrorInvalidValue;
#define OLM_CASE(NN)                                                         \
  case NN:                                                                   \
    if constexpr (HOST && NN % 4 == 0) {                                     \
      if (vec) return by_width<NN, true, true>(a, stream, smem_out,          \
                                               blocks_out);                  \
    }                                                                        \
    if (vec) return cudaErrorInvalidValue;                                   \
    return by_width<NN, HOST, false>(a, stream, smem_out, blocks_out);
  switch (n) {
    OLM_CASE(8) OLM_CASE(10) OLM_CASE(12) OLM_CASE(16) OLM_CASE(20)
    OLM_CASE(24) OLM_CASE(32)
    default: return cudaErrorInvalidValue;
  }
#undef OLM_CASE
}

// The checks both entry points share: a tile of kt lanes reduced by an
// L-level tree, T tiles over K, n + 3 steps, an int32 datapath, and a
// stream inside the 48-digit decode window.
bool valid(int M, int N, int K, int T, int n, int kt, int L, int S,
           int nsteps) {
  return M >= 1 && N >= 1 && K >= 1 && kt >= 1 && kt <= kLanes &&
         T == (K + kt - 1) / kt && (1 << L) >= kt &&
         (L == 0 || (1 << (L - 1)) < kt) && nsteps == n + olm::kDelta &&
         n <= olm::kMaxDigits && S + 3 <= 31 && S >= olm::kEst &&
         n + 2 * L <= 48;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns a cudaError_t:
// 0 on a successful launch. sched holds the n + 3 values of T(j); S is its
// maximum; out is (M, N) row-major. (bm, bn, tb) is the host's plan
// (matmul_kernel.launch_plan): powers of two, bm * bn * tb threads a
// block, a multiple of 32 and at most 256.
//
// K1: x is (M, K) row-major; w is (K, N) addressed as
// w[k * w_sk + n * w_sn].
extern "C" int olm_matmul_fused(const float* x, const float* w, float* out,
                                int M, int N, int K, long long w_sk,
                                long long w_sn, int n, int kt, int L, int S,
                                const int* sched, int nsteps, int bm, int bn,
                                int tb, void* stream) {
  const int T = (K + kt - 1) / kt;
  if (!valid(M, N, K, T, n, kt, L, S, nsteps))
    return (int)cudaErrorInvalidValue;
  Args a{x, w, w_sk, w_sn, nullptr, nullptr, nullptr, nullptr, out,
         M, N, K, T, kt, L, bm, bn, tb, olm::make_steps(sched, nsteps, S)};
  return (int)dispatch<false>(n, false, a, static_cast<cudaStream_t>(stream));
}

// K2: xd (M, T, kt, n) and wd (N, T, kt, n) int32 digit grids, row-major;
// sx (M, T) and sw (N, T) float32 scales. vec: 16-byte copies (n a
// multiple of 4, xd and wd 16-byte aligned).
extern "C" int olm_matmul_host(const int* xd, const float* sx, const int* wd,
                               const float* sw, float* out, int M, int N,
                               int T, int n, int kt, int L, int S,
                               const int* sched, int nsteps, int bm, int bn,
                               int tb, int vec, void* stream) {
  if (T < 1 || !valid(M, N, T * kt, T, n, kt, L, S, nsteps) ||
      (vec && (n % 4 != 0 || ((uintptr_t)xd | (uintptr_t)wd) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  Args a{nullptr, nullptr, 0, 0, xd, sx, wd, sw, out,
         M, N, T * kt, T, kt, L, bm, bn, tb, olm::make_steps(sched, nsteps, S)};
  return (int)dispatch<true>(n, vec != 0, a, static_cast<cudaStream_t>(stream));
}

// olm_matmul_geometry: the shared memory a block of the plan (n, host,
// vec, bm, bn, tb) asks for at an L-level tree, and how many such blocks
// an SM holds. Launches nothing. Returns a cudaError_t.
extern "C" int olm_matmul_geometry(int n, int host, int vec, int bm, int bn,
                                   int tb, int L, int* smem, int* blocks) {
  Args a{};
  a.bm = bm;
  a.bn = bn;
  a.tb = tb;
  a.L = L;
  return host ? (int)dispatch<true>(n, vec != 0, a, nullptr, smem, blocks)
              : (int)dispatch<false>(n, vec != 0, a, nullptr, smem, blocks);
}
