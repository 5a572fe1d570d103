// Truncated digit-plane matmul for Hopper (sm_90a):
//   out (M, N) f32 = (sum_{L < lmax} 2^(-b(L+2)) * sum_{da+db=L} a[da] @ b[db])
//                    * sa * sb
// over D signed int8 digit planes a (D, M, K) and b (D, K, N), digits in
// [-2^(b-1), 2^(b-1)], with power-of-two row scales sa (M) and column
// scales sb (N).
//
// Replaces the TPU kernel `tpmm_pallas` (src/repro/kernels/tpmm/kernel.py).
// It follows the order of the reference's own engine path `tpmm_ref`, not
// the TPU kernel's per-block float accumulation: for each kept level L the
// plane-pair products with da + db = L are summed over the whole of K in
// int32 (exact: |sum| <= 2^(2b-2) * D * K < 2^31, which the wrapper
// checks), converted to float32 once, multiplied by the exact 2^(-b(L+2))
// and added in level order; the result is then multiplied by sa and by sb.
// So it is bit-identical to `tpmm_ref` and to the port's plain version.
//
// What bounds it on an H100: bytes. Every GEMM of the served model has a
// few rows (4 at decode, 64 at prefill) against a whole weight matrix of
// planes, D * K * N bytes, so the planes have to stream from HBM once and
// at full rate; the int8 tensor cores have ~100x the work's rate. The
// design:
//  - One read of each plane byte a call. A block tile walks K in steps
//    of 64 bytes; each step brings the fragments of every A plane and
//    every B plane of the tile into shared memory once, and each warp
//    issues every kept pair (da, db), da + db = L < levels, into one int32
//    accumulator per level: 10 pair products from 8 plane loads at
//    tpmm16, 3 from 4 at tpmm8. (Planes at or past `levels` are not used
//    by any pair and are not loaded.)
//  - int8 tensor cores: mma.sync m16n8k32 s8 x s8 -> s32. A stored (D, M,
//    K) is the `row` operand and B stored (D, N, K) the `col` operand as
//    they lie. Since a level sum is an integer sum, K may be visited in
//    any order as long as A and B follow the same one: lane (g, t) of a
//    warp loads 16 contiguous bytes of its row at byte 16t of the step,
//    words 4t..4t+3, and feeds words (4t + 2s, 4t + 2s + 1) to mma s of
//    the two the step needs. So every load is 16 bytes, neighbouring
//    lanes read neighbouring bytes, and shared memory is read without
//    bank conflicts and without any reshuffle. At M <= 16 (decode) the
//    one 16-row tile is padded with zero rows: the tensor cores' spare
//    rate costs nothing on a bytes-bound call.
//  - Loads in flight: a 3-stage cp.async ring (16-byte copies, zero-fill
//    past the edges; 2 stages where 3 do not fit, D > 14), so two K steps
//    are in flight while one computes, and 8 warps a block, two blocks an
//    SM at tpmm16. A step brings only 64 bytes of each row, so every copy
//    carries the .L2::256B hint: the first copy of a row's 256 bytes
//    brings the next three steps into L2. (Measured on the H100: 8 warps
//    and the hint took the M=4 LM head from 0.42 to 0.32 ms; 128-byte
//    steps, which halve the blocks an SM holds, and a split-major grid
//    order did not help.) Ragged M, N and K are masked in the kernel; a K
//    that is not a multiple of 16 or a plane base that is not 16-byte
//    aligned takes a byte-wise masked load into the same ring instead of
//    cp.async.
//  - Split K across blocks, on int32 only. The decode GEMMs have too few
//    output tiles to fill 132 SMs (16 at K=8192, N=2048), so the wrapper
//    splits K (kernel.split_plan) and every split adds its int32 level
//    partials into a zeroed (levels, M, N) int32 workspace with atomics.
//    That is exact and order-free: integer addition is associative and no
//    partial or total leaves int32. The last split of a tile to arrive
//    (an arrival counter per tile) then folds the tile in `tpmm_ref`'s
//    order. No float32 sum is ever split: the fold is the only float
//    arithmetic, and one thread does each output's whole fold.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 15;             // plane_bits * D <= 30, b >= 2
constexpr int kBK = 64;                    // K bytes of one pipeline step
constexpr int kChunks = kBK / 16;          // 16-byte copies a row a step
constexpr int kWarps = 8;
constexpr int kMaxSmem = 227 * 1024;       // dynamic shared memory a block
constexpr int kThreads = 32 * kWarps;
constexpr int kGemvRows = 16;              // M up to this: one 16-row tile

__device__ __forceinline__ float pow2f(int e) {  // exact 2^e, -126 <= e <= 127
  return __int_as_float((e + 127) << 23);
}

// Level accumulators an instance keeps: D at D <= 4 when at most D
// levels are kept (tpmm16 / tpmm8 "nbit", and "eq8"), else all 2D - 1.
constexpr int acc_levels(int D, int levels) {
  return D <= 4 && levels <= D ? D : 2 * D - 1;
}
// Block tile: WM x WN warps, each owning MT 16-row by NT 8-column mma
// tiles. The accumulators (LV * MT * NT * 4 registers a thread) bound the
// tile; rows are padded to 16 at decode (M <= 16), and 64 rows cover the
// prefill in one tile so the weight planes are read once.
constexpr int tile_wm(bool gemm) { return gemm ? 2 : 1; }
constexpr int tile_mt(int LV, bool gemm) { return gemm && LV <= 8 ? 2 : 1; }
constexpr int tile_nt(int LV, bool gemm) {
  return gemm ? (LV > 8 ? 1 : LV <= 2 ? 4 : LV <= 4 ? 2 : 1)
              : (LV <= 4 ? 2 : 1);
}

template <int D, int LV, bool GEMM>
struct Tile {
  static constexpr int WM = tile_wm(GEMM);
  static constexpr int WN = kWarps / WM;
  static constexpr int MT = tile_mt(LV, GEMM);
  static constexpr int NT = tile_nt(LV, GEMM);
  static constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  static constexpr int kRows = BM + BN;    // rows of one plane in a step
  static constexpr int kStageBytes = D * kRows * kBK;
  // a 3-slot ring (two steps in flight while one computes) where it fits
  static constexpr int kStages = 3 * kStageBytes <= kMaxSmem ? 3 : 2;
  static constexpr int kSmem = kStages * kStageBytes;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  // .L2::256B: the row's next steps (the same 256 bytes) wait in L2
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Copy one K step [k0, k0 + 64) of the tile's rows of the first `planes`
// planes into a ring slot: plane p's BM A rows, then its BN B rows, 64
// bytes each. Rows past M or N and bytes past kend read as zero.
template <class T, int D>
__device__ __forceinline__ void load_step(uint8_t* slot, const int8_t* a,
                                          const int8_t* bt, int M, int N,
                                          int K, int row0, int col0, int k0,
                                          int kend, int planes, bool vec) {
  const int chunks = planes * T::kRows * kChunks;
  for (int e = threadIdx.x; e < chunks; e += kThreads) {
    const int c = e % kChunks;
    const int r = (e / kChunks) % T::kRows;
    const int p = e / (kChunks * T::kRows);
    const bool is_a = r < T::BM;
    const int row = is_a ? row0 + r : col0 + (r - T::BM);
    const int8_t* base = is_a ? a + (long long)p * M * K
                              : bt + (long long)p * N * K;
    const bool in_row = row < (is_a ? M : N);
    const int k = k0 + 16 * c;
    uint8_t* dst = slot + (p * T::kRows + r) * kBK + 16 * c;
    if (vec) {                 // K % 16 == 0: a chunk is all in or all out
      const bool valid = in_row && k < kend;
      cp_async16(dst, valid ? base + (long long)row * K + k : base, valid);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (in_row) {
        const int8_t* src = base + (long long)row * K;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (k + i < kend)
            w[i / 4] |= (uint32_t)(uint8_t)__ldg(src + k + i) << (8 * (i % 4));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// One warp's share of a K step: every kept pair of every mma tile. Lane
// (g, t) reads 16 bytes at byte 16t of rows g and g + 8 of its tiles: a
// quarter warp covers two whole 64-byte rows, 32 distinct banks.
template <class T, int D, int LV>
__device__ __forceinline__ void compute_step(const uint8_t* slot,
                                             int (&acc)[LV][T::MT][T::NT][4],
                                             int levels, int wm, int wn,
                                             int g, int t) {
  uint4 bf[D][T::NT];
#pragma unroll
  for (int db = 0; db < D; ++db)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      const int r = T::BM + (wn * T::NT + nt) * 8 + g;
      if (db < levels)
        bf[db][nt] = *reinterpret_cast<const uint4*>(
            slot + (db * T::kRows + r) * kBK + 16 * t);
    }
#pragma unroll
  for (int da = 0; da < D; ++da) {
    if (da >= levels) continue;
    uint4 lo[T::MT], hi[T::MT];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      const int r = (wm * T::MT + mt) * 16 + g;
      lo[mt] = *reinterpret_cast<const uint4*>(
          slot + (da * T::kRows + r) * kBK + 16 * t);
      hi[mt] = *reinterpret_cast<const uint4*>(
          slot + (da * T::kRows + r + 8) * kBK + 16 * t);
    }
#pragma unroll
    for (int db = 0; db < D; ++db) {
      constexpr int kTop = LV - 1;
      const int L = da + db <= kTop ? da + db : kTop;
      if (da + db > kTop || da + db >= levels) continue;
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt) {
          const uint4 b = bf[db][nt];
          mma_s8(acc[L][mt][nt], lo[mt].x, hi[mt].x, lo[mt].y, hi[mt].y,
                 b.x, b.y);
          mma_s8(acc[L][mt][nt], lo[mt].z, hi[mt].z, lo[mt].w, hi[mt].w,
                 b.z, b.w);
        }
    }
  }
}

// tpmm_ref's fold of one output: one rounding of each level sum, the exact
// weight 2^(-b(L+2)), levels added in order, then (out * sa) * sb.
template <int LV>
__device__ __forceinline__ float fold(const int (&v)[LV], int levels,
                                      int plane_bits, float sa, float sb) {
  float f = 0.0f;
#pragma unroll
  for (int L = 0; L < LV; ++L) {
    if (L >= levels) break;
    const float term =
        __fmul_rn(__int2float_rn(v[L]), pow2f(-plane_bits * (L + 2)));
    f = L == 0 ? term : __fadd_rn(f, term);
  }
  return __fmul_rn(__fmul_rn(f, sa), sb);
}

template <int D, int LV, bool GEMM>
__global__ void __launch_bounds__(kThreads)
tpmm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
            const float* __restrict__ sa, const float* __restrict__ sb,
            float* __restrict__ out, int* __restrict__ ws, int M, int N,
            int K, int levels, int plane_bits, int k_split, bool vec) {
  using T = Tile<D, LV, GEMM>;
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ int last_split;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int split = blockIdx.z, tile_n = blockIdx.x, tile_m = blockIdx.y;
  const int splits = gridDim.z, tiles_n = gridDim.x;
  const int row0 = tile_m * T::BM, col0 = tile_n * T::BN;
  const int kbeg = split * k_split;
  const int kend = min(K, kbeg + k_split);
  const int steps = (kend - kbeg + kBK - 1) / kBK;
  const int planes = min(D, levels);

  int acc[LV][T::MT][T::NT][4];
#pragma unroll
  for (int L = 0; L < LV; ++L)
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[L][mt][nt][i] = 0;

#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < steps)
      load_step<T, D>(ring + s * T::kStageBytes, a, bt, M, N, K, row0, col0,
                      kbeg + s * kBK, kend, planes, vec);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<T::kStages - 2>();       // this step's copies landed
    __syncthreads();                       // ... for every thread; and the
                                           // slot refilled below is free
    const int next = step + T::kStages - 1;
    if (next < steps)
      load_step<T, D>(ring + (next % T::kStages) * T::kStageBytes, a, bt, M,
                      N, K, row0, col0, kbeg + next * kBK, kend, planes, vec);
    cp_async_commit();
    compute_step<T, D, LV>(ring + (step % T::kStages) * T::kStageBytes, acc,
                           levels, wm, wn, g, t);
  }
  cp_async_wait<0>();

  // Output (row, col) of accumulator element i of tile (mt, nt).
  auto row_of = [&](int mt, int i) {
    return row0 + (wm * T::MT + mt) * 16 + g + (i >= 2 ? 8 : 0);
  };
  auto col_of = [&](int nt, int i) {
    return col0 + (wn * T::NT + nt) * 8 + 2 * t + (i & 1);
  };
  if (splits == 1) {                       // K in one piece: fold here
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row_of(mt, i), col = col_of(nt, i);
          if (row >= M || col >= N) continue;
          int v[LV];
#pragma unroll
          for (int L = 0; L < LV; ++L) v[L] = acc[L][mt][nt][i];
          out[(long long)row * N + col] =
              fold<LV>(v, levels, plane_bits, sa[row], sb[col]);
        }
    return;
  }

  // Split K: add the int32 partials (exact in any order), then the last
  // split of this tile to arrive folds it from the workspace.
  const long long plane = (long long)M * N;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row_of(mt, i), col = col_of(nt, i);
        if (row >= M || col >= N) continue;
#pragma unroll
        for (int L = 0; L < LV; ++L)
          if (L < levels && acc[L][mt][nt][i] != 0)
            atomicAdd(ws + L * plane + (long long)row * N + col,
                      acc[L][mt][nt][i]);
      }
  __threadfence();                         // partials before the arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    int* arrivals = ws + levels * plane;
    const int seen = atomicAdd(arrivals + tile_m * tiles_n + tile_n, 1);
    last_split = seen == splits - 1;
  }
  __syncthreads();
  if (!last_split) return;
  __threadfence();                         // every split's partials now in L2
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row_of(mt, i), col = col_of(nt, i);
        if (row >= M || col >= N) continue;
        const long long at = (long long)row * N + col;
        int v[LV];
#pragma unroll
        for (int L = 0; L < LV; ++L)
          v[L] = L < levels ? __ldcg(ws + L * plane + at) : 0;
        out[at] = fold<LV>(v, levels, plane_bits, sa[row], sb[col]);
      }
}

struct Args {
  const int8_t* a;
  const int8_t* bt;
  const float* sa;
  const float* sb;
  float* out;
  int* ws;
  int M, N, K, levels, plane_bits, splits, k_split;
  bool vec;
  cudaStream_t stream;
};

template <int D, int LV, bool GEMM>
cudaError_t launch(const Args& x) {
  using T = Tile<D, LV, GEMM>;
  const long long tiles_m = (x.M + T::BM - 1) / T::BM;
  if (tiles_m > 65535) return cudaErrorInvalidValue;
  auto kern = tpmm_kernel<D, LV, GEMM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const unsigned tiles_n = (x.N + T::BN - 1) / T::BN;
  const dim3 grid(tiles_n, (unsigned)tiles_m, x.splits);
  kern<<<grid, kThreads, T::kSmem, x.stream>>>(
      x.a, x.bt, x.sa, x.sb, x.out, x.ws, x.M, x.N, x.K, x.levels,
      x.plane_bits, x.k_split, x.vec);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_levels(const Args& x) {
  if constexpr (D <= 4) {
    if (acc_levels(D, x.levels) == D)
      return x.M <= kGemvRows ? launch<D, D, false>(x) : launch<D, D, true>(x);
  }
  return x.M <= kGemvRows ? launch<D, 2 * D - 1, false>(x)
                          : launch<D, 2 * D - 1, true>(x);
}

}  // namespace

// Plain C entry point (loaded with ctypes). a is (D, M, K) int8 row-major;
// bt is the B operand stored K-contiguous, (D, N, K) int8 row-major; sa is
// (M) and sb (N) float32; out is (M, N) float32 row-major. levels is the
// number of significance levels kept (<= 2D - 1). K is cut into `splits`
// slices of k_split bytes (a multiple of 64; the last may be shorter);
// with splits > 1, ws holds levels * M * N + ceil(M/16) * ceil(N/8) int32
// zeros (level partials, then one arrival counter per output tile), else
// it may be null. Returns a cudaError_t: 0 on a successful launch.
extern "C" int tpmm(const int8_t* a, const int8_t* bt, const float* sa,
                    const float* sb, float* out, int* ws, int D, int M, int N,
                    int K, int levels, int plane_bits, int splits, int k_split,
                    void* stream) {
  if (D < 1 || D > kMaxPlanes || M < 1 || N < 1 || K < 1 || levels < 1 ||
      levels > 2 * D - 1 || plane_bits < 2 || plane_bits > 7 ||
      plane_bits * D > 30)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > 65535 || k_split < kBK || k_split % kBK != 0 ||
      (long long)(splits - 1) * k_split >= K ||
      (long long)splits * k_split < K || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies only where every row of every plane starts on a 16-byte
  // boundary; otherwise the masked byte-wise load.
  const bool vec = (K & 15) == 0 && ((uintptr_t)a & 15) == 0 &&
                   ((uintptr_t)bt & 15) == 0;
  const Args x{a, bt, sa, sb, out, ws, M, N, K, levels, plane_bits, splits,
               k_split, vec, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 1: return (int)by_levels<1>(x);
    case 2: return (int)by_levels<2>(x);
    case 3: return (int)by_levels<3>(x);
    case 4: return (int)by_levels<4>(x);
    case 5: return (int)by_levels<5>(x);
    case 6: return (int)by_levels<6>(x);
    case 7: return (int)by_levels<7>(x);
    case 8: return (int)by_levels<8>(x);
    case 9: return (int)by_levels<9>(x);
    case 10: return (int)by_levels<10>(x);
    case 11: return (int)by_levels<11>(x);
    case 12: return (int)by_levels<12>(x);
    case 13: return (int)by_levels<13>(x);
    case 14: return (int)by_levels<14>(x);
    case 15: return (int)by_levels<15>(x);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The output tile (rows, columns) a launch for D planes, M rows and
// `levels` levels uses, for the wrapper's split plan to be checked
// against (kernel.tile_shape).
extern "C" void tpmm_tile(int D, int M, int levels, int* rows, int* cols) {
  const bool gemm = M > kGemvRows;
  const int lv = acc_levels(D, levels);
  *rows = tile_wm(gemm) * tile_mt(lv, gemm) * 16;
  *cols = kWarps / tile_wm(gemm) * tile_nt(lv, gemm) * 8;
}
