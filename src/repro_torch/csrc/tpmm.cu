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
// int32 (exact: |sum| <= 2^(2b-2) * D * K), converted to float32 once,
// multiplied by the exact 2^(-b(L+2)) and added in level order; the result
// is then multiplied by sa and by sb. So it is bit-identical to `tpmm_ref`
// and to the port's plain version.
//
// What bounds it on an H100: bytes at the decode GEMV (a few rows against
// a whole weight matrix of planes), operations only at large M. This first
// version is the simple one: a 16 x 16 thread block owns a (16 TM) x (16 TN)
// output tile; per level and 32-byte K chunk it stages the level's A and
// B planes in shared memory and each thread accumulates its TM x TN
// outputs with __dp4a (four int8 products a step). It reads each plane
// once per level that uses it (10 plane reads per operand at D = 4, not
// 4), and leaves the int8 tensor cores (mma / wgmma s8) to a later
// version; PERF.md has its time against the bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                  // threads per block edge
constexpr int kChunkWords = 8;             // K chunk: 8 words of 4 int8
constexpr int kChunk = 4 * kChunkWords;
constexpr int kMaxPlanes = 15;             // plane_bits * D <= 30, b >= 2

__device__ __forceinline__ float pow2f(int e) {  // exact 2^e, -126 <= e <= 127
  return __int_as_float((e + 127) << 23);
}

// Four int8 digits of row `r` of a (rows, K) plane from column k, packed
// little-endian into one word (zero past the end of the row).
__device__ __forceinline__ int load_word(const int8_t* plane, int r, int k,
                                         int K, bool aligned) {
  const int8_t* p = plane + (long long)r * K + k;
  if (aligned && k + 3 < K) return *reinterpret_cast<const int*>(p);
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < K) w |= (uint32_t)(uint8_t)p[i] << (8 * i);
  return (int)w;
}

template <int TM, int TN>
__global__ void __launch_bounds__(kTile * kTile)
tpmm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bt,
            const float* __restrict__ sa, const float* __restrict__ sb,
            float* __restrict__ out, int D, int M, int N, int K, int levels,
            int plane_bits, bool aligned) {
  constexpr int BM = kTile * TM, BN = kTile * TN;
  __shared__ int s_a[kMaxPlanes][BM][kChunkWords + 1];
  __shared__ int s_b[kMaxPlanes][BN][kChunkWords + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const long long a_plane = (long long)M * K, b_plane = (long long)N * K;

  float acc[TM][TN] = {};
  for (int L = 0; L < levels; ++L) {
    const int da_lo = L - D + 1 > 0 ? L - D + 1 : 0;
    const int da_hi = L < D - 1 ? L : D - 1;
    const int pairs = da_hi - da_lo + 1;
    int iacc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) iacc[i][j] = 0;
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      __syncthreads();                     // previous chunk consumed
      // Stage pair p's A plane da_lo + p and B plane L - da_lo - p.
      for (int e = tid; e < pairs * BM * kChunkWords; e += kTile * kTile) {
        const int p = e / (BM * kChunkWords);
        const int r = (e / kChunkWords) % BM;
        const int w = e % kChunkWords;
        const int row = row0 + r;
        s_a[p][r][w] = row < M ? load_word(a + (da_lo + p) * a_plane, row,
                                           k0 + 4 * w, K, aligned) : 0;
      }
      for (int e = tid; e < pairs * BN * kChunkWords; e += kTile * kTile) {
        const int p = e / (BN * kChunkWords);
        const int c = (e / kChunkWords) % BN;
        const int w = e % kChunkWords;
        const int col = col0 + c;
        s_b[p][c][w] = col < N ? load_word(bt + (L - da_lo - p) * b_plane,
                                           col, k0 + 4 * w, K, aligned) : 0;
      }
      __syncthreads();
      for (int p = 0; p < pairs; ++p) {
#pragma unroll
        for (int w = 0; w < kChunkWords; ++w) {
          int av[TM], bv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) av[i] = s_a[p][ty + kTile * i][w];
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = s_b[p][tx + kTile * j][w];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              iacc[i][j] = __dp4a(av[i], bv[j], iacc[i][j]);
        }
      }
    }
    // Fold the level: one rounding to float32, an exact power-of-two
    // weight, and the running sum in level order.
    const float weight = pow2f(-plane_bits * (L + 2));
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float term = __fmul_rn(__int2float_rn(iacc[i][j]), weight);
        acc[i][j] = L == 0 ? term : __fadd_rn(acc[i][j], term);
      }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int row = row0 + ty + kTile * i, col = col0 + tx + kTile * j;
      if (row < M && col < N)
        out[(long long)row * N + col] =
            __fmul_rn(__fmul_rn(acc[i][j], sa[row]), sb[col]);
    }
}

template <int TM, int TN>
cudaError_t launch(const int8_t* a, const int8_t* bt, const float* sa,
                   const float* sb, float* out, int D, int M, int N, int K,
                   int levels, int plane_bits, bool aligned,
                   cudaStream_t stream) {
  const dim3 grid((N + kTile * TN - 1) / (kTile * TN),
                  (M + kTile * TM - 1) / (kTile * TM));
  tpmm_kernel<TM, TN><<<grid, dim3(kTile, kTile), 0, stream>>>(
      a, bt, sa, sb, out, D, M, N, K, levels, plane_bits, aligned);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). a is (D, M, K) int8 row-major;
// bt is the B operand stored K-contiguous, (D, N, K) int8 row-major; sa is
// (M) and sb (N) float32; out is (M, N) float32 row-major. levels is the
// number of significance levels kept (<= 2D - 1). Returns a cudaError_t:
// 0 on a successful launch.
extern "C" int tpmm(const int8_t* a, const int8_t* bt, const float* sa,
                    const float* sb, float* out, int D, int M, int N, int K,
                    int levels, int plane_bits, void* stream) {
  if (D < 1 || D > kMaxPlanes || M < 1 || N < 1 || K < 1 || levels < 1 ||
      levels > 2 * D - 1 || plane_bits < 2 || plane_bits > 7 ||
      plane_bits * D > 30)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Whole words are read only where every row starts on a 4-byte boundary.
  const bool aligned = (K & 3) == 0 && ((uintptr_t)a & 3) == 0 &&
                       ((uintptr_t)bt & 3) == 0;
  if (M <= kTile)
    return (int)launch<1, 1>(a, bt, sa, sb, out, D, M, N, K, levels,
                             plane_bits, aligned, st);
  return (int)launch<2, 2>(a, bt, sa, sb, out, D, M, N, K, levels,
                           plane_bits, aligned, st);
}
