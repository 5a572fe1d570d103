// Batched fused online inner product for Hopper (sm_90a):
//   z (B, n + 2L) int32 = MSDF digit stream of sum_i x_i y_i / 2^L over the
//   K digit pairs of each row of x, y (B, K, n), digits in {-1, 0, 1},
//   L = ceil(log2 K).
//
// Replaces the TPU kernel `online_dot_pallas`
// (src/repro/kernels/online_dot/kernel.py): K radix-2 online multiplier
// lanes a row (the Fig. 7 recurrence) reduced by the balanced online adder
// tree (olm_lane.cuh's `online_add`).
//
// What bounds it on an H100: bytes. A lane reads 8n bytes of digits and
// issues some 30-40 instructions a recurrence step (n + 3 steps), so the
// HBM bound sits above the issue bound at every n, but not by much: the
// design has to overlap the two. What kept the first port of this kernel
// far above its bound was how it read: one thread a lane, each thread
// reading its own n words, so one warp load touched n different 128-byte
// lines and the reads' cost grew with n^2 (probes/online_dot_loads.py;
// PERF.md). The design:
//
//  * A persistent grid. The host's plan (kernel.launch_plan) cuts the B
//    rows into groups of `rows` rows; block b runs groups b, b + grid, ...
//    A group's rows*K lanes are one contiguous stretch of x and of y,
//    moved in `subs` stages of at most 256 lanes, one lane a thread.
//  * cp.async staging: neighbouring threads copy neighbouring 16-byte
//    words into lane rows whose chunks are swizzled (or padded to an odd
//    count), so a thread reads its lane back with conflict-free 16-byte
//    loads and packs four digits with two byte permutes and two
//    multiplies; where n is not a multiple of 4 or an operand is not
//    16-byte aligned, 4-byte copies fill rows of an odd word stride. As
//    soon as the block has packed a stage's lanes into +1/-1 masks, the
//    stage is refilled with the block's next lanes, which arrive while it
//    runs this stage's recurrences and tree. A block holds one stage, so
//    at n = 32 three blocks share an SM (three stages in flight), where a
//    ring of two stages in one block left one block an SM and ran slower.
//  * The recurrence runs in registers with the schedule's per-step masks
//    and weights computed once on the host (`Steps`), the same integer
//    arithmetic as olm_digits.cuh's `mul_digit_loop` without recomputing
//    them in every lane. Each thread parks its lane's stream in shared
//    memory at node r * 2^L + k of its group.
//  * The adder tree issues each adder once: a warp takes 128 level-0
//    nodes, each thread runs two adders of the first level from shared
//    memory and their parent in registers, and the next five levels pair
//    streams by register shuffles inside the warp; past 128 lanes a row,
//    one warp finishes the last levels. Node i of a level pairs children
//    2i and 2i + 1, and a child past the level's ceil(K / 2^l) real nodes
//    reads as the zero stream (the reference's padding of an odd level).
//    Streams stay packed: in 32-bit words where n + 2L <= 32, else in 64
//    bits (K <= 1024 keeps n + 2L <= 52).
//  * The block stores its group's rows of z, neighbouring threads on
//    neighbouring words.
//
// That kernel runs the paper's online delay of 3 at 4 <= n <= 32 and
// K <= 1024, any estimate width the 32-bit datapath holds. Every other
// configuration a kernel holds (another delay or estimate width, n up to
// 64, any K) runs `online_dot_any`, which K4 (online_mul) also runs at
// K = 1 for its configurations past the paper's: a block of 256 threads
// takes whole rows where a row's padded width 2^L is at most 256 lanes,
// else one row in chunks of 256 lanes, each an aligned subtree of the
// reference's tree (node i of a level pairs children 2i and 2i + 1, so
// lanes [256c, 256c + 256) reduce to node c of level 8). It stages a
// chunk's digit rows coalesced, runs each lane's recurrence with
// olm_digits.cuh's `lane_any` (in int32, or in int64 where the selection
// does not bound the residual), reduces the chunk in shared memory (lanes
// past K are zero streams, which is the reference's padding of an odd
// level: the zero stream plus the zero stream is the zero stream), and
// merges the chunks' streams as a binary counter carries, which pairs
// level-8 nodes 2i and 2i + 1 as the reference does; what is left at the
// end pairs with zero streams up to level L. Its streams are 32, 64 or
// 128 bits wide, so a stream of n + 2L <= 128 digits covers every K a
// card's memory holds.
#include "olm_lane.cuh"

namespace {

using olm::cp_async16;
using olm::cp_async4;
using olm::cp_async_wait_all;
using olm::lane_loop;
using olm::make_steps;
using olm::online_add;
using olm::pack;
using olm::row_words;
using olm::Steps;
using olm::swizzle;

constexpr int kThreads = 256;              // threads = lanes of a stage
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 1024;
constexpr int kMaxSmem = 232448;           // 227 KB, the most a block may ask
constexpr int kWarpLevels = 7;             // tree levels inside a warp (128 nodes)

// Node arrays of the tree: level-0 streams (rows * 2^L nodes, +1 and -1
// masks), and half as many, rounded up to even, for the later levels.
__host__ __device__ constexpr long long half_nodes(long long nodes) {
  return (nodes / 2 + 1) & ~1LL;
}

// A stream of m = n + 2L digits lives in 32-bit words where it fits
// (the adder's result digit m - 1 at bit 31), else in 64-bit words.
constexpr bool narrow(int n, int L) { return n + 2 * L <= 32; }

// Shared memory of a block: the stage of x and y, then the node arrays.
// kernel.launch_plan computes the same.
long long smem_bytes(int n, bool vec, int rows, int L) {
  const long long nodes = (long long)rows << L;
  return 8LL * kThreads * row_words(n, vec) +
         (narrow(n, L) ? 8 : 16) * (nodes + half_nodes(nodes));
}

// One adder of tree level l, whose parent `a` (in level order of the whole
// group) is node `a & (2^(L-1-l) - 1)` of its row: the right child counts
// only if it is one of the level's real nodes.
template <typename W>
__device__ __forceinline__ void tree_add(W lp, W lq, W rp, W rq, int a,
                                         int l, int L, int K, W& op, W& oq) {
  const int i = a & ((1 << (L - 1 - l)) - 1);
  const bool right = 2 * i + 1 < ((K - 1) >> l) + 1;
  online_add<W>(lp, lq, right ? rp : 0, right ? rq : 0, op, oq);
}

// Two adjacent nodes (children 2i and 2i + 1) in one shared-memory load.
template <typename W> struct Pair;
template <> struct Pair<uint32_t> { using T = uint2; };
template <> struct Pair<uint64_t> { using T = ulonglong2; };

// Level l's pairs inside a warp: lane i takes the nodes of lanes 2i and
// 2i + 1 and holds parent `a`.
template <typename W>
__device__ __forceinline__ void shuffle_add(W& vp, W& vq, int lane, int a,
                                            int l, int L, int K) {
  const W lp = __shfl_sync(0xFFFFFFFFu, vp, 2 * lane);
  const W lq = __shfl_sync(0xFFFFFFFFu, vq, 2 * lane);
  const W rp = __shfl_sync(0xFFFFFFFFu, vp, 2 * lane + 1);
  const W rq = __shfl_sync(0xFFFFFFFFu, vq, 2 * lane + 1);
  tree_add<W>(lp, lq, rp, rq, a, l, L, K, vp, vq);
}

template <int N, bool VEC, typename W>
__global__ void __launch_bounds__(kThreads)
online_dot_kernel(const int* __restrict__ x, const int* __restrict__ y,
                  int* __restrict__ z, int B, int K, int L, int rows,
                  int subs, Steps st) {
  using P = typename Pair<W>::T;
  constexpr int kRow = row_words(N, VEC);
  constexpr int kStage = kThreads * kRow;  // words of one operand's stage
  extern __shared__ __align__(16) int smem[];  // x, y stage, then nodes
  const int nodes = rows << L;
  W* p0 = reinterpret_cast<W*>(smem + 2 * kStage);
  W* q0 = p0 + nodes;
  W* p1 = q0 + nodes;
  W* q1 = p1 + half_nodes(nodes);

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int groups = (B + rows - 1) / rows;
  const int items = ((int)blockIdx.x < groups)
                        ? ((groups - 1 - (int)blockIdx.x) / (int)gridDim.x + 1)
                              * subs
                        : 0;
  const int m = N + 2 * L;
  // A group of one stage holds whole rows (row t / K, lane t % K of it);
  // a group of several stages holds one row.
  const int row_t = subs == 1 ? t / K : 0;
  const int lane_t = t - row_t * K;

  // Item `it` of the block: group, stage of the group, and lanes
  // [first, first + count) of the flattened (B * K) lanes.
  auto item = [&](int it, int& group, int& sub, int& count,
                  long long& first) {
    const int gi = subs == 1 ? it : it / subs;
    sub = it - gi * subs;
    group = blockIdx.x + gi * gridDim.x;
    const int real = min(rows, B - group * rows);
    first = (long long)group * rows * K + (long long)sub * kThreads;
    count = max(0, min(kThreads, real * K - sub * kThreads));
  };

  // Start copying item `it`'s lanes into the stage.
  auto request = [&](int it) {
    if (it < items) {
      int group, sub, count;
      long long first;
      item(it, group, sub, count, first);
      int* sy = smem + kStage;
      const int* gx = x + first * N;
      const int* gy = y + first * N;
      if constexpr (VEC) {
        constexpr int Q = N / 4;             // 16-byte chunks a lane
        for (int j = t; j < count * Q; j += kThreads) {
          const int e = j / Q;
          const int at = e * kRow + 4 * ((j - e * Q) ^ swizzle<N>(e));
          cp_async16(smem + at, gx + 4 * j);
          cp_async16(sy + at, gy + 4 * j);
        }
      } else {
        for (int w = t; w < count * N; w += kThreads) {
          const int e = w / N;
          cp_async4(smem + e * kRow + (w - e * N), gx + w);
          cp_async4(sy + e * kRow + (w - e * N), gy + w);
        }
      }
    }
  };

  request(0);
  for (int it = 0; it < items; ++it) {
    cp_async_wait_all();                   // this thread's copies of `it`
    __syncthreads();                       // everyone's
    int group, sub, count;
    long long first;
    item(it, group, sub, count, first);
    const bool live = t < count;
    uint32_t xp = 0, xn = 0, yp = 0, yn = 0;
    if (live) {
      const int* row = smem + t * kRow;
      pack<N, VEC>(row, swizzle<N>(t), xp, xn);
      pack<N, VEC>(row + kStage, swizzle<N>(t), yp, yn);
    }
    __syncthreads();                       // the stage is free again
    request(it + 1);
    if (live) {
      uint32_t zp, zn;
      lane_loop<N>(xp, xn, yp, yn, st, zp, zn);
      const int slot = (row_t << L) + lane_t + sub * kThreads;
      p0[slot] = zp;
      q0[slot] = zn;
    }
    if (sub != subs - 1) continue;
    __syncthreads();                       // the group's streams are parked

    // Levels 0 .. lw-1 inside warps: a warp takes 128 level-0 nodes; each
    // thread runs two adders of level 0 from shared memory and their
    // parent in registers, then register shuffles pair level l's nodes
    // held by lanes 2i and 2i + 1.
    W* fp = p0;                            // row r's stream at fp[r], fq[r]
    W* fq = q0;
    if (L > 0) {
      const int lw = min(L, kWarpLevels);
      const int out = nodes >> lw;         // level-lw nodes of the group
      for (int c = warp; 128 * c < nodes; c += kWarps) {
        const int a = 64 * c + 2 * lane;   // the level-0 adders' parents a, a+1
        W vp = 0, vq = 0, wp = 0, wq = 0;
        if (2 * a < nodes) {
          const P p = *reinterpret_cast<const P*>(p0 + 2 * a);
          const P q = *reinterpret_cast<const P*>(q0 + 2 * a);
          tree_add<W>(p.x, q.x, p.y, q.y, a, 0, L, K, vp, vq);
        }
        if (2 * a + 2 < nodes) {
          const P p = *reinterpret_cast<const P*>(p0 + 2 * a + 2);
          const P q = *reinterpret_cast<const P*>(q0 + 2 * a + 2);
          tree_add<W>(p.x, q.x, p.y, q.y, a + 1, 0, L, K, wp, wq);
        }
        if (lw == 1) {                     // a and a + 1 are rows
          if (a < out) {
            p1[a] = vp;
            q1[a] = vq;
          }
          if (a + 1 < out) {
            p1[a + 1] = wp;
            q1[a + 1] = wq;
          }
          continue;
        }
        tree_add<W>(vp, vq, wp, wq, 32 * c + lane, 1, L, K, vp, vq);
        for (int l = 2; l < lw; ++l)       // lane i: node (128 >> l)c + i
          shuffle_add<W>(vp, vq, lane, (64 >> l) * c + lane, l, L, K);
        const int o = (128 >> lw) * c + lane;
        if (lane < (128 >> lw) && o < out) {
          p1[o] = vp;
          q1[o] = vq;
        }
      }
      __syncthreads();
      fp = p1;
      fq = q1;
      if (L > lw) {                        // one warp: levels lw .. L-1
        if (warp == 0) {
          W vp = lane < out ? p1[lane] : 0;
          W vq = lane < out ? q1[lane] : 0;
          for (int l = lw; l < L; ++l) shuffle_add<W>(vp, vq, lane, lane, l, L, K);
          if (lane < rows) {
            p0[lane] = vp;
            q0[lane] = vq;
          }
        }
        __syncthreads();
        fp = p0;
        fq = q0;
      }
    }
    const int real_rows = min(rows, B - group * rows);
    int* zg = z + (long long)group * rows * m;
    for (int e = t; e < real_rows * m; e += kThreads) {
      const int r = e / m, j = e - r * m;
      zg[e] = (int)((fp[r] >> j) & 1u) - (int)((fq[r] >> j) & 1u);
    }
  }
}


constexpr int kChunkLevels = 8;            // a chunk: 2^8 = kThreads lanes
constexpr int kMaxLevels = 62;             // K <= 2^62

// Shared memory of `online_dot_any`: a chunk of x and y (rows of n | 1
// words), the chunk's node arrays and the row's carry stack.
long long any_smem_bytes(int n, int word) {
  return 8LL * kThreads * (n | 1) + 2LL * word * (kThreads + kMaxLevels + 1);
}

// W: a stream's word (32, 64 or 128 bits); D: the lanes' datapath.
template <typename W, typename D>
__global__ void __launch_bounds__(kThreads)
online_dot_any(const int* __restrict__ x, const int* __restrict__ y,
               int* __restrict__ z, long long B, long long K, int L, int n,
               int delta, olm::StepsAny st, int lift) {
  extern __shared__ __align__(16) int smem[];
  const int stride = n | 1;
  int* sx = smem;
  int* sy = smem + kThreads * stride;
  // node arrays start 16-byte aligned: 8 * kThreads * stride bytes above
  W* np = reinterpret_cast<W*>(sy + kThreads * stride);  // chunk nodes
  W* nq = np + kThreads;
  W* cp = nq + kThreads;                   // carry stack, levels 8 .. L
  W* cq = cp + kMaxLevels + 1;

  const int t = threadIdx.x;
  // C lanes a row's unit: 2^L up to a chunk; R = kThreads / C rows a
  // block where a row is one unit, else one row of G chunks.
  const int lc = min(L, kChunkLevels);
  const int C = 1 << lc;
  const int R = kThreads / C;
  const long long row0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, B - row0);
  const long long chunks = L > kChunkLevels ? (K + kThreads - 1) / kThreads
                                            : 1;
  const int m = n + 2 * L;
  uint64_t occupied = 0;                   // carry stack levels in use
  for (long long c = 0; c < chunks; ++c) {
    const long long first = row0 * K + c * kThreads;
    const long long count = L > kChunkLevels ? min((long long)kThreads,
                                                   K - c * kThreads)
                                             : rows * K;
    auto slot = [&](int e) { return (int)(e / K) * C + (int)(e % K); };
    __syncthreads();                       // the last chunk's reads done
    olm::stage_rows(x + first * n, sx, count * n, n, stride, kThreads, slot);
    olm::stage_rows(y + first * n, sy, count * n, n, stride, kThreads, slot);
    __syncthreads();
    const int r = t / C, k = t - r * C;
    const bool live = r < rows && (L > kChunkLevels
                                       ? k < count
                                       : k < K);
    W p = 0, q = 0;
    if (live) {
      uint64_t zp, zn;
      olm::lane_any<D>(sx + t * stride, sy + t * stride, n, delta, st, lift,
                       zp, zn);
      p = (W)zp;
      q = (W)zn;
    }
    np[t] = p;
    nq[t] = q;
    for (int l = 0; l < lc; ++l) {         // node k of level l + 1 pairs
      __syncthreads();                     // children 2k and 2k + 1
      if ((k & ((2 << l) - 1)) == 0) {
        W op, oq;
        olm::online_add<W>(np[t], nq[t], np[t + (1 << l)],
                           nq[t + (1 << l)], op, oq);
        np[t] = op;
        nq[t] = oq;
      }
    }
    __syncthreads();
    if (L > kChunkLevels && t == 0) {      // chunk c is node c of level 8
      W vp = np[0], vq = nq[0];
      int lv = kChunkLevels;
      while (occupied >> lv & 1) {
        olm::online_add<W>(cp[lv], cq[lv], vp, vq, vp, vq);
        occupied &= ~(1ull << lv);
        ++lv;
      }
      cp[lv] = vp;
      cq[lv] = vq;
      occupied |= 1ull << lv;
    }
  }
  if (L > kChunkLevels) {
    if (t == 0) {                          // chunks past the last: zeros
      W vp = 0, vq = 0;
      bool have = false;
      for (int lv = kChunkLevels; lv < L; ++lv) {
        const bool occ = occupied >> lv & 1;
        if (have)
          olm::online_add<W>(occ ? cp[lv] : 0, occ ? cq[lv] : 0, vp, vq, vp,
                             vq);
        else if (occ)
          olm::online_add<W>(cp[lv], cq[lv], 0, 0, vp, vq);
        have = have || occ;
      }
      if (!have) {                         // every chunk was real
        vp = cp[L];
        vq = cq[L];
      }
      np[0] = vp;
      nq[0] = vq;
    }
    __syncthreads();
  }
  for (int e = t; e < rows * m; e += kThreads) {
    const int r = e / m, j = e - r * m;
    z[row0 * m + e] = (int)((np[r * C] >> j) & 1u) -
                      (int)((nq[r * C] >> j) & 1u);
  }
}

struct Args {
  const int* x;
  const int* y;
  int* z;
  int B, K, L, rows, subs, grid;
  bool vec;
  Steps st;
  cudaStream_t stream;
  int* smem_out;                           // geometry query: no launch
  int* blocks_out;
};

template <int N, bool VEC, typename W>
cudaError_t launch(const Args& a) {
  auto kern = online_dot_kernel<N, VEC, W>;
  const long long smem = smem_bytes(N, VEC, a.rows, a.L);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (a.blocks_out) {
    *a.smem_out = (int)smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.blocks_out, kern,
                                                         kThreads, smem);
  }
  kern<<<a.grid, kThreads, smem, a.stream>>>(a.x, a.y, a.z, a.B, a.K, a.L,
                                             a.rows, a.subs, a.st);
  return cudaGetLastError();
}

template <int N, bool VEC>
cudaError_t by_width(const Args& a) {
  return narrow(N, a.L) ? launch<N, VEC, uint32_t>(a)
                        : launch<N, VEC, uint64_t>(a);
}

template <int N>
cudaError_t by_vec(const Args& a) {
  if constexpr (N % 4 == 0) {
    if (a.vec) return by_width<N, true>(a);
  } else {
    if (a.vec) return cudaErrorInvalidValue;
  }
  return by_width<N, false>(a);
}

cudaError_t dispatch(int n, const Args& a) {
#define OLM_CASE(NN) \
  case NN: return by_vec<NN>(a);
  switch (n) {
    OLM_CASE(4) OLM_CASE(5) OLM_CASE(6) OLM_CASE(7) OLM_CASE(8) OLM_CASE(9)
    OLM_CASE(10) OLM_CASE(11) OLM_CASE(12) OLM_CASE(13) OLM_CASE(14)
    OLM_CASE(15) OLM_CASE(16) OLM_CASE(17) OLM_CASE(18) OLM_CASE(19)
    OLM_CASE(20) OLM_CASE(21) OLM_CASE(22) OLM_CASE(23) OLM_CASE(24)
    OLM_CASE(25) OLM_CASE(26) OLM_CASE(27) OLM_CASE(28) OLM_CASE(29)
    OLM_CASE(30) OLM_CASE(31) OLM_CASE(32)
    default: return cudaErrorInvalidValue;
  }
#undef OLM_CASE
}

}  // namespace

// Plain C entry points (loaded with ctypes).
//
// online_dot: x, y are (B, K, n) int32 row-major, z is (B, n + 2L) int32
// row-major with L = ceil(log2 K); sched holds the n + 3 values of T(j),
// S their maximum and t the estimate's fractional digits (0 <= t <= S).
// The plan (kernel.launch_plan): groups of `rows` rows in `subs` stages
// of at most 256 lanes, a grid of `grid` persistent blocks, 16-byte copies
// where vec (n a multiple of 4, x and y 16-byte aligned). Returns a
// cudaError_t: 0 on a successful launch.
extern "C" int online_dot(const int* x, const int* y, int* z, int B, int K,
                          int L, int n, int S, int t, const int* sched,
                          int nsteps, int rows, int subs, int grid, int vec,
                          void* stream) {
  if (B < 1 || K < 1 || K > kMaxLanes || L < 0 || (1 << L) < K ||
      (L > 0 && (1 << (L - 1)) >= K) || n <= olm::kDelta ||
      n > olm::kMaxDigits || n + 2 * L > 64 || nsteps != n + olm::kDelta ||
      S + 3 > 31 || t < 0 || S < t || rows < 1 || rows > B ||
      ((long long)rows << L) > 32LL * 64 || (subs > 1 && rows > 1) ||
      subs != (int)(((long long)rows * K + kThreads - 1) / kThreads) ||
      grid < 1 || grid > (B + rows - 1) / rows ||
      (vec && (n % 4 != 0 || ((uintptr_t)x | (uintptr_t)y) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  Args a{x, y, z, B, K, L, rows, subs, grid, vec != 0,
         make_steps(sched, nsteps, S, t), static_cast<cudaStream_t>(stream),
         nullptr, nullptr};
  return (int)dispatch(n, a);
}

template <typename W, typename D>
cudaError_t launch_any(const int* x, const int* y, int* z, long long B,
                       long long K, int L, int n, int delta,
                       const olm::StepsAny& st, int lift, long long blocks,
                       cudaStream_t s) {
  const long long smem = any_smem_bytes(n, (int)sizeof(W));
  const cudaError_t err = cudaFuncSetAttribute(
      online_dot_any<W, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  online_dot_any<W, D><<<(unsigned)blocks, kThreads, smem, s>>>(
      x, y, z, B, K, L, n, delta, st, lift);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch_any(bool wide_lane, const int* x, const int* y, int* z,
                       long long B, long long K, int L, int n, int delta,
                       const olm::StepsAny& st, int lift, long long blocks,
                       cudaStream_t s) {
  return wide_lane
             ? launch_any<W, long long>(x, y, z, B, K, L, n, delta, st, lift,
                                        blocks, s)
             : launch_any<W, int>(x, y, z, B, K, L, n, delta, st, lift,
                                  blocks, s);
}

// online_dot_any: the same function for any configuration a kernel holds
// (kernels/online_mul/kernel.py `check_config`): n <= 64 output digits,
// 1 <= n + delta <= 64 steps, the schedule of n + delta values, a stream
// of n + 2L <= 128 digits; `lift` is the estimate's factor where t > S
// (olm_digits.cuh `lane_any`), `wide_lane` runs the lanes in int64. One
// block of 256 threads per 256 >> min(L, 8) rows. Returns a cudaError_t.
extern "C" int online_dot_any(const int* x, const int* y, int* z,
                              long long B, long long K, int L, int n,
                              int delta, int S, int t, int lift,
                              int wide_lane, const int* sched, int nsteps,
                              void* stream) {
  if (B < 1 || K < 1 || L < 0 || L > kMaxLevels || (1LL << L) < K ||
      (L > 0 && (1LL << (L - 1)) >= K) || n < 1 || n > 64 ||
      n + 2 * L > 128 || delta > 30 || n + delta < 1 ||
      n + delta > olm::kAnySteps || nsteps != n + delta || S < 0 ||
      S + 3 > 31 || lift < 0 || lift > 4)
    return (int)cudaErrorInvalidValue;
  const int R = kThreads >> (L < kChunkLevels ? L : kChunkLevels);
  const long long blocks = (B + R - 1) / R;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const olm::StepsAny st = olm::step_consts<olm::kAnySteps>(sched, nsteps, S,
                                                             t);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wl = wide_lane != 0;
  const int m = n + 2 * L;
  const cudaError_t err =
      m <= 32   ? launch_any<uint32_t>(wl, x, y, z, B, K, L, n, delta, st,
                                       lift, blocks, s)
      : m <= 64 ? launch_any<uint64_t>(wl, x, y, z, B, K, L, n, delta, st,
                                       lift, blocks, s)
                : launch_any<unsigned __int128>(wl, x, y, z, B, K, L, n,
                                                delta, st, lift, blocks, s);
  return (int)err;
}

// online_dot_geometry: the shared memory a block of the plan (n, vec,
// rows, L) asks for, and how many such blocks an SM holds. Launches
// nothing. Returns a cudaError_t.
extern "C" int online_dot_geometry(int n, int vec, int rows, int L,
                                   int* smem, int* blocks) {
  if (rows < 1 || L < 0 || L > 10 || ((long long)rows << L) > 32LL * 64)
    return (int)cudaErrorInvalidValue;
  Args a{nullptr, nullptr, nullptr, 0, 0, L, rows, 0, 0, vec != 0, Steps{},
         nullptr, smem, blocks};
  return (int)dispatch(n, a);
}
