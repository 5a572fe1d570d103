// Batched fused online inner product for Hopper (sm_90a):
//   z (B, n + 2L) int32 = MSDF digit stream of sum_i x_i y_i / 2^L over the
//   K digit pairs of each row of x, y (B, K, n), digits in {-1, 0, 1},
//   L = ceil(log2 K).
//
// Replaces the TPU kernel `online_dot_pallas`
// (src/repro/kernels/online_dot/kernel.py): K radix-2 online multiplier
// lanes a row (the Fig. 7 recurrence) reduced by the balanced online adder
// tree (olm_lane.cuh's `online_add`). Its general route also runs K4
// (`online_mul_pallas`, src/repro/kernels/online_mul/kernel.py) at K = 1
// for the configurations past the paper's.
//
// What bounds it on an H100: bytes. A lane reads 8n bytes of digits and
// issues some 30-40 instructions a recurrence step (n + delta steps), so
// the HBM bound sits above the issue bound at every n, but not by much:
// the design has to overlap the two. What kept the first port of this
// kernel far above its bound was how it read: one thread a lane, each
// thread reading its own n words, so one warp load touched n different
// 128-byte lines and the reads' cost grew with n^2
// (probes/online_dot_loads.py; PERF.md). Two kernels share one block body
// (`dot_body`) and differ only in their lane:
//
//  * online_dot_kernel<N, VEC, W, LONG>: the paper's online delay of 3 at
//    4 <= n <= 32, any estimate width the 32-bit datapath holds, any K
//    whose stream fits 64 bits (n + 2L <= 64), the recurrence unrolled
//    (olm_lane.cuh `lane_loop`);
//  * online_dot_any<D, M, W, LONG>: every other configuration a kernel
//    holds (another delay or estimate width, n up to 64, the int64
//    residual of F6, streams up to 128 bits), the recurrence a loop over
//    n + delta steps (olm_lane.cuh `lane_gen`) with the host's constants
//    read from the kernel's parameters by uniform loads, operand digits as
//    2-bit fields read by one arithmetic shift a step, X, Y and the term
//    in int32, its residual in D (int, or long long where the selection
//    does not bound it in int32), output masks in M (32 bits to n = 32,
//    else 64).
//
// Each is compiled twice, for rows of at most 1024 lanes and (LONG) for
// longer ones, so a launch carries the subtree code only where it runs
// it; each in the stream words W its rows can need.
//
// The block body:
//
//  * A persistent grid. The host's plan (kernel.launch_plan) cuts the work
//    into groups: `rows` whole rows where a row holds at most 1024 lanes,
//    else one aligned subtree of 1024 lanes of one row, which is node c of
//    level 10 of the reference's tree (node i of a level pairs children 2i
//    and 2i + 1, so lanes [1024c, 1024c + 1024) reduce to node c). Block b
//    runs groups b, b + grid, ..., the grid being the SMs times the blocks
//    an SM runs: as many as it holds, unless fewer spread the groups more
//    evenly over the SMs (kernel.balanced_blocks; a subtree's group is 4
//    stages, so a last round half full costs). A group's lanes are one
//    contiguous stretch of x and of y, moved in `subs` stages of at most
//    256 lanes, one lane a thread.
//  * cp.async staging: neighbouring threads copy neighbouring 16-byte
//    words into lane rows whose chunks are swizzled (or padded to an odd
//    count), so a thread reads its lane back with conflict-free 16-byte
//    loads and packs four digits with two byte permutes and two
//    multiplies; where n is not a multiple of 4 or an operand is not
//    16-byte aligned, 4-byte copies fill rows of an odd word stride. A
//    thread walks its copies' lane and chunk by additions (the host gives
//    the step), with no division in the loop. As soon as the block has
//    packed a stage's lanes into registers, the stage is refilled with
//    the block's next lanes, which arrive while it runs this stage's
//    recurrences and tree. A block holds one stage, so several blocks
//    share an SM and their stages are in flight together.
//  * The recurrence runs in registers with the schedule's per-step masks
//    and weights computed once on the host, the same integer arithmetic as
//    olm_digits.cuh's `mul_digit_loop`. Each thread parks its lane's
//    stream in shared memory at node r * 2^l + k of its group, l the
//    levels of the group's tree.
//  * The adder tree issues each adder once: a warp takes 128 level-0
//    nodes, each thread runs two adders of the first level from shared
//    memory and their parent in registers, and the next five levels pair
//    streams by register shuffles inside the warp; past 128 lanes, one
//    warp finishes the group's last levels. Node i of a level pairs
//    children 2i and 2i + 1, and a child past the level's real nodes
//    reads as the zero stream (the reference's padding of an odd level).
//    Streams stay packed in words of 32, 64 or 128 bits: the warps' levels
//    in the narrowest that holds their n + 14 digits, the levels above
//    them as wide as the row's whole stream of n + 2L digits needs (at
//    n = 16 past 256 lanes a row, 32 bits below level 7 and 64 above).
//  * A group of whole rows stores its rows of z, neighbouring threads on
//    neighbouring words. A subtree's block writes its level-10 stream to
//    scratch and counts it in its row's counter (zeroed by the host); the
//    block that brings the count to the row's subtrees merges the row's
//    level-10 streams level by level, the whole block at once, pairing
//    nodes 2i and 2i + 1 with a zero stream for a missing right child, up
//    to level L, and stores the row. Every adder runs once, in the
//    reference's tree shape, so the bits are the reference's.
#include "olm_lane.cuh"

namespace {

using olm::AnySteps;
using olm::cp_async16;
using olm::cp_async4;
using olm::cp_async_wait_all;
using olm::lane_gen;
using olm::lane_loop;
using olm::make_steps;
using olm::online_add;
using olm::pack;
using olm::pack_fields;
using olm::row_words;
using olm::Steps;
using olm::swizzle;

constexpr int kThreads = 256;              // threads = lanes of a stage
constexpr int kWarps = kThreads / 32;
constexpr int kTreeLanes = 1024;           // most lanes of a group's tree
constexpr int kTreeLevels = 10;            // its levels: a level-10 subtree
constexpr int kMaxSmem = 232448;           // 227 KB, the most a block may ask
constexpr int kWarpLevels = 7;             // tree levels in a warp (128 nodes)
constexpr int kMaxLevels = 62;             // a stream of n + 2L <= 128 digits

// Bytes of a stream's word: a row's stream of m = n + 2L digits in 32,
// 64 or 128 bits (the adder's result digit m - 1 at the top bit).
constexpr int word_bytes(int m) { return m <= 32 ? 4 : m <= 64 ? 8 : 16; }

template <int Bytes> struct WordOf;
template <> struct WordOf<4> { using T = uint32_t; };
template <> struct WordOf<8> { using T = uint64_t; };
template <> struct WordOf<16> { using T = unsigned __int128; };

// The word the warps' levels (0 .. kWarpLevels - 1) add in: their streams
// end at n + 2 * kWarpLevels digits (`digits`), so a row whose whole stream
// needs W may run all but its last levels' adders in a narrower word.
template <typename W, int digits>
using WarpWord = typename WordOf<(word_bytes(digits) < (int)sizeof(W)
                                      ? word_bytes(digits)
                                      : (int)sizeof(W))>::T;

// Shared memory of a block: the stage of x and y (rows of `row` words),
// then the node arrays of a group's tree of l = min(L, 10) levels: the
// rows * 2^l level-0 streams (+1 and -1 masks; none where l = 0) in the
// lane's own word (n digits: 32 bits, or 64 past n = 32), then the
// nodes left after the warps' levels (rows * 2^l >> min(l, 7)) in the
// row's stream word, rounded up to 16 bytes. kernel.launch_plan computes
// the same.
long long smem_bytes(int row, int rows, int L, int n, int m) {
  const int tl = L < kTreeLevels ? L : kTreeLevels;
  const long long nodes = (long long)rows << tl;
  const long long zero = tl > 0 ? nodes : 0;
  const int lw = tl < kWarpLevels ? tl : kWarpLevels;
  const long long bytes = 8LL * kThreads * row +
                          2LL * (n <= 32 ? 4 : 8) * zero +
                          2LL * word_bytes(m) * (nodes >> lw);
  return (bytes + 15) & ~15LL;
}

// The launch's geometry, from the host's plan.
struct Geo {
  long long K;                             // lanes a row
  int B, L;                                // rows; levels of a row's tree
  int rows, subs;                          // rows a group; stages a group
  int trees;                               // level-10 subtrees a row (1: the
                                           // row is at most 1024 lanes)
  int groups, grid;                        // ceil(B / rows) * trees; blocks
  void* scratch;                           // trees > 1: each subtree's
                                           // stream, +1 masks then -1
  int* arrived;                            // trees > 1: a row's subtrees
                                           // done, zeroed by the host
};

// Two adjacent nodes (children 2i and 2i + 1) in one shared-memory load.
template <typename W>
struct alignas(2 * sizeof(W)) Pair {
  W x, y;
};

template <typename W>
__device__ __forceinline__ W shfl(W v, int src) {
  if constexpr (sizeof(W) <= 8) {
    return __shfl_sync(0xFFFFFFFFu, v, src);
  } else {
    const unsigned long long lo = __shfl_sync(0xFFFFFFFFu,
                                              (unsigned long long)v, src);
    const unsigned long long hi = __shfl_sync(
        0xFFFFFFFFu, (unsigned long long)(v >> 64), src);
    return ((W)hi << 64) | lo;
  }
}

// A word another block wrote, read from L2 (where its fence put it).
template <typename W>
__device__ __forceinline__ W load_l2(const W* p) {
  if constexpr (sizeof(W) == 4) {
    return __ldcg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (sizeof(W) == 8) {
    return __ldcg(reinterpret_cast<const unsigned long long*>(p));
  } else {
    const ulonglong2 v = __ldcg(reinterpret_cast<const ulonglong2*>(p));
    return ((W)v.y << 64) | v.x;
  }
}

// One adder of tree level l, whose parent `a` (in level order of the whole
// group) is node `a & (2^(L-1-l) - 1)` of its row: the right child counts
// only if it is one of the level's real nodes.
template <typename W>
__device__ __forceinline__ void tree_add(W lp, W lq, W rp, W rq, int a,
                                         int l, int L, int K, W& op, W& oq) {
  const int i = a & ((1 << (L - 1 - l)) - 1);
  const bool right = 2 * i + 1 < ((K - 1) >> l) + 1;
  online_add<W>(lp, lq, right ? rp : W(0), right ? rq : W(0), op, oq);
}

// Level l's pairs inside a warp: lane i takes the nodes of lanes 2i and
// 2i + 1 and holds parent `a`.
template <typename W>
__device__ __forceinline__ void shuffle_add(W& vp, W& vq, int lane, int a,
                                            int l, int L, int K) {
  const W lp = shfl<W>(vp, 2 * lane);
  const W lq = shfl<W>(vq, 2 * lane);
  const W rp = shfl<W>(vp, 2 * lane + 1);
  const W rq = shfl<W>(vq, 2 * lane + 1);
  tree_add<W>(lp, lq, rp, rq, a, l, L, K, vp, vq);
}

// A row's level-10 streams (sp, sq: its `trees` nodes) merged level by
// level up to level L in place, the whole block at once: node i of level
// l + 1 pairs nodes 2i and 2i + 1, a zero stream for a missing right child.
// The root lands at node 0.
template <typename W>
__device__ void merge_trees(W* sp, W* sq, long long K, int L) {
  for (int l = kTreeLevels; l < L; ++l) {
    const int k = (int)((K - 1) >> l) + 1;  // real nodes of level l
    const int half = (k + 1) >> 1;
    for (int base = 0; base < half; base += kThreads) {
      const int i = base + (int)threadIdx.x;
      W op = 0, oq = 0;
      if (i < half) {
        const bool right = 2 * i + 1 < k;
        online_add<W>(load_l2(sp + 2 * i), load_l2(sq + 2 * i),
                      right ? load_l2(sp + 2 * i + 1) : W(0),
                      right ? load_l2(sq + 2 * i + 1) : W(0), op, oq);
      }
      __syncthreads();                     // the pairs are read
      if (i < half) {
        sp[i] = op;
        sq[i] = oq;
      }
    }
    __syncthreads();                       // the level is written
  }
}

// A lane's +1 and -1 masks (the unrolled lane's operands).
struct Masks {
  uint32_t p, q;
};

// The paper's lane at N digits: rows of N words staged (16-byte chunks
// swizzled where VEC), packed into 32-bit masks, the unrolled recurrence.
template <int N, bool VEC>
struct Unrolled {
  using In = Masks;
  using Out = uint32_t;
  const Steps& st;
  static constexpr int kRow = row_words(N, VEC);
  static constexpr int kWarpDigits = N + 2 * kWarpLevels;
  __device__ int digits() const { return N; }
  __device__ int row() const { return kRow; }
  // Start copying `count` lanes from gx, gy into the stage sx, sy.
  __device__ void copy(int* sx, int* sy, const int* gx, const int* gy,
                       int count) const {
    const int t = threadIdx.x;
    if constexpr (VEC) {
      constexpr int Q = N / 4;             // 16-byte chunks a lane
      for (int j = t; j < count * Q; j += kThreads) {
        const int e = j / Q;
        const int at = e * kRow + 4 * ((j - e * Q) ^ swizzle<N>(e));
        cp_async16(sx + at, gx + 4 * j);
        cp_async16(sy + at, gy + 4 * j);
      }
    } else {
      for (int w = t; w < count * N; w += kThreads) {
        const int e = w / N;
        cp_async4(sx + e * kRow + (w - e * N), gx + w);
        cp_async4(sy + e * kRow + (w - e * N), gy + w);
      }
    }
  }
  __device__ In load(const int* r) const {
    In v{0, 0};
    pack<N, VEC>(r, swizzle<N>(threadIdx.x), v.p, v.q);
    return v;
  }
  __device__ void run(In x, In y, Out& zp, Out& zn) const {
    lane_loop<N>(x.p, x.q, y.p, y.q, st, zp, zn);
  }
};

// The general lane's launch arguments: the recurrence's constants and the
// staging geometry, from the host.
struct AnyArgs {
  AnySteps st;
  int vec;                                 // 16-byte copies
  int per;                                 // copy units a lane: n / 4 or n
  int row;                                 // words of a staged lane row
  int step_e, step_c;                      // kThreads units as (lanes, units)
  int sw_shift, sw_mask;                   // lane e's chunk swizzle:
                                           // (e >> sw_shift) & sw_mask
};

// Any configuration a kernel holds: rows of n words staged as the unrolled
// kernel stages them (16-byte chunks swizzled where a power of two, else
// padded to an odd count), packed into 2-bit digit fields, the recurrence
// a loop over n + delta steps with its residual in D and its output in M
// (32 bits to n = 32, else 64).
template <typename D, typename M>
struct General {
  using In = typename olm::Fields<M>::T;
  using Out = M;
  static constexpr int kWarpDigits = 8 * (int)sizeof(M) + 2 * kWarpLevels;
  const AnyArgs& a;
  int e0, c0;                              // this thread's first lane, unit
  __device__ explicit General(const AnyArgs& args)
      : a(args), e0((int)threadIdx.x / args.per),
        c0((int)threadIdx.x % args.per) {}
  __device__ int digits() const { return a.st.n; }
  __device__ int row() const { return a.row; }
  __device__ void copy(int* sx, int* sy, const int* gx, const int* gy,
                       int count) const {
    int e = e0, c = c0;                    // lane and unit of copy j
    const int units = count * a.per;
    for (int j = threadIdx.x; j < units; j += kThreads) {
      if (a.vec) {
        const int at = e * a.row + 4 * (c ^ ((e >> a.sw_shift) & a.sw_mask));
        cp_async16(sx + at, gx + 4 * j);
        cp_async16(sy + at, gy + 4 * j);
      } else {
        cp_async4(sx + e * a.row + c, gx + j);
        cp_async4(sy + e * a.row + c, gy + j);
      }
      e += a.step_e;
      c += a.step_c;
      if (c >= a.per) {
        c -= a.per;
        ++e;
      }
    }
  }
  __device__ In load(const int* r) const {
    const int e = threadIdx.x;
    return pack_fields<In>(r, a.st.n, a.vec != 0,
                           (e >> a.sw_shift) & a.sw_mask);
  }
  __device__ void run(In x, In y, Out& zp, Out& zn) const {
    lane_gen<D, M>(x, y, a.st, zp, zn);
  }
};

// The block body both kernels run (the header note above), streams in
// words W; LONG: rows past 1024 lanes, a group one row's level-10 subtree
// (compiled apart, so a launch of shorter rows carries none of it).
template <typename W, bool LONG, class Lane>
__device__ __forceinline__ void dot_body(const int* __restrict__ x,
                                         const int* __restrict__ y,
                                         int* __restrict__ z, const Geo& g,
                                         const Lane& ln) {
  using O = typename Lane::Out;             // a lane's stream
  using P = Pair<O>;
  using V = WarpWord<W, Lane::kWarpDigits>;  // the warps' levels' streams
  const int row = ln.row();
  const int stage = kThreads * row;        // words of one operand's stage
  extern __shared__ __align__(16) int smem[];  // x, y stage, then nodes
  const int tl = LONG ? kTreeLevels : g.L;  // a group's tree
  const int tk = LONG ? kTreeLanes : (int)g.K;
  const int lw = min(tl, kWarpLevels);     // its levels inside warps
  const int nodes = g.rows << tl;
  const int zero = tl > 0 ? nodes : 0;     // level-0 nodes parked
  O* p0 = reinterpret_cast<O*>(smem + 2 * stage);
  O* q0 = p0 + zero;
  W* p1 = reinterpret_cast<W*>(q0 + zero);  // nodes past level lw (level 0
  W* q1 = p1 + (nodes >> lw);               // itself where l = 0)

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int n = ln.digits();
  const int items = ((int)blockIdx.x < g.groups)
                        ? ((g.groups - 1 - (int)blockIdx.x) / g.grid + 1)
                              * g.subs
                        : 0;
  const int m = n + 2 * g.L;
  // A group of one stage holds whole rows (row t / K, lane t % K of it);
  // a group of several stages holds one row's lanes, or one subtree's.
  const int row_t = g.subs == 1 ? t / tk : 0;
  const int lane_t = t - row_t * tk;

  // Item `it` of the block: its group's first row and subtree, the lanes
  // of the group's tree in a row (`lanes`, the tree_add K), the group's
  // real rows, its stage, and lanes [first, first + count) of the
  // flattened (B * K) lanes.
  struct Item {
    int row0, tree, lanes, real, sub, count;
    long long first;
  };
  auto item = [&](int it) {
    Item i;
    const int gi = g.subs == 1 ? it : it / g.subs;
    i.sub = it - gi * g.subs;
    const int group = blockIdx.x + gi * g.grid;
    if constexpr (!LONG) {
      i.row0 = group * g.rows;
      i.tree = 0;
      i.lanes = tk;
      i.real = min(g.rows, g.B - i.row0);
      i.first = (long long)i.row0 * g.K + (long long)i.sub * kThreads;
      i.count = max(0, min(kThreads, i.real * tk - i.sub * kThreads));
    } else {
      i.row0 = group / g.trees;
      i.tree = group - i.row0 * g.trees;
      const long long base = (long long)i.tree * kTreeLanes;
      i.lanes = (int)min((long long)kTreeLanes, g.K - base);
      i.real = 1;
      i.first = (long long)i.row0 * g.K + base + (long long)i.sub * kThreads;
      i.count = max(0, min(kThreads, i.lanes - i.sub * kThreads));
    }
    return i;
  };

  // Start copying item `it`'s lanes into the stage.
  auto request = [&](int it) {
    if (it < items) {
      const Item i = item(it);
      ln.copy(smem, smem + stage, x + i.first * n, y + i.first * n, i.count);
    }
  };

  request(0);
  for (int it = 0; it < items; ++it) {
    cp_async_wait_all();                   // this thread's copies of `it`
    __syncthreads();                       // everyone's
    const Item i = item(it);
    const bool live = t < i.count;
    typename Lane::In xv{}, yv{};
    if (live) {
      xv = ln.load(smem + t * row);
      yv = ln.load(smem + stage + t * row);
    }
    __syncthreads();                       // the stage is free again
    request(it + 1);
    if (live) {
      typename Lane::Out zp, zn;
      ln.run(xv, yv, zp, zn);
      const int slot = (row_t << tl) + lane_t + i.sub * kThreads;
      if (tl > 0) {
        p0[slot] = zp;
        q0[slot] = zn;
      } else {                             // a lane a row: its stream
        p1[slot] = (W)zp;
        q1[slot] = (W)zn;
      }
    }
    if (i.sub != g.subs - 1) continue;
    __syncthreads();                       // the group's streams are parked

    // Levels 0 .. lw-1 inside warps: a warp takes 128 level-0 nodes; each
    // thread runs two adders of level 0 from shared memory and their
    // parent in registers, then register shuffles pair level l's nodes
    // held by lanes 2i and 2i + 1.
    const int K = i.lanes;                 // row r's stream at p1[r], q1[r]
    if (tl > 0) {
      const int out = nodes >> lw;         // level-lw nodes of the group
      for (int c = warp; 128 * c < nodes; c += kWarps) {
        const int a = 64 * c + 2 * lane;   // the level-0 adders' parents a, a+1
        V vp = 0, vq = 0, wp = 0, wq = 0;
        if (2 * a < nodes) {
          const P p = *reinterpret_cast<const P*>(p0 + 2 * a);
          const P q = *reinterpret_cast<const P*>(q0 + 2 * a);
          tree_add<V>(p.x, q.x, p.y, q.y, a, 0, tl, K, vp, vq);
        }
        if (2 * a + 2 < nodes) {
          const P p = *reinterpret_cast<const P*>(p0 + 2 * a + 2);
          const P q = *reinterpret_cast<const P*>(q0 + 2 * a + 2);
          tree_add<V>(p.x, q.x, p.y, q.y, a + 1, 0, tl, K, wp, wq);
        }
        if (lw == 1) {                     // a and a + 1 are rows
          if (a < out) {
            p1[a] = (W)vp;
            q1[a] = (W)vq;
          }
          if (a + 1 < out) {
            p1[a + 1] = (W)wp;
            q1[a + 1] = (W)wq;
          }
          continue;
        }
        tree_add<V>(vp, vq, wp, wq, 32 * c + lane, 1, tl, K, vp, vq);
        for (int l = 2; l < lw; ++l)       // lane i: node (128 >> l)c + i
          shuffle_add<V>(vp, vq, lane, (64 >> l) * c + lane, l, tl, K);
        const int o = (128 >> lw) * c + lane;
        if (lane < (128 >> lw) && o < out) {
          p1[o] = (W)vp;
          q1[o] = (W)vq;
        }
      }
      __syncthreads();
      if (tl > lw) {                       // one warp: levels lw .. tl-1
        if (warp == 0) {
          W vp = lane < out ? p1[lane] : W(0);
          W vq = lane < out ? q1[lane] : W(0);
          for (int l = lw; l < tl; ++l)
            shuffle_add<W>(vp, vq, lane, lane, l, tl, K);
          if (lane < g.rows) {             // after every lane's read
            p1[lane] = vp;
            q1[lane] = vq;
          }
        }
        __syncthreads();
      }
    }
    if constexpr (!LONG) {                 // the group's rows of z
      int* zg = z + (long long)i.row0 * m;
      const int dr = kThreads / m, dj = kThreads - dr * m;
      for (int e = t, r = t / m, j = t % m; e < i.real * m; e += kThreads) {
        zg[e] = (int)((p1[r] >> j) & 1u) - (int)((q1[r] >> j) & 1u);
        r += dr;
        j += dj;
        if (j >= m) {
          j -= m;
          ++r;
        }
      }
    } else {
      // A subtree: park its level-10 stream; the row's last one merges.
      W* sp = static_cast<W*>(g.scratch) + (long long)i.row0 * g.trees;
      W* sq = sp + (long long)g.B * g.trees;
      bool last = false;
      if (t == 0) {
        sp[i.tree] = p1[0];
        sq[i.tree] = q1[0];
        __threadfence();                   // the stream before the count
        last = atomicAdd(g.arrived + i.row0, 1) == g.trees - 1;
        if (last) __threadfence();         // the count before the reads
      }
      if (!__syncthreads_or(last)) continue;
      merge_trees<W>(sp, sq, g.K, g.L);
      const W rp = load_l2(sp), rq = load_l2(sq);
      int* zr = z + (long long)i.row0 * m;
      for (int e = t; e < m; e += kThreads)
        zr[e] = (int)((rp >> e) & 1u) - (int)((rq >> e) & 1u);
    }
  }
}

template <int N, bool VEC, typename W, bool LONG>
__global__ void __launch_bounds__(kThreads)
online_dot_kernel(const int* __restrict__ x, const int* __restrict__ y,
                  int* __restrict__ z, const __grid_constant__ Geo g,
                  const __grid_constant__ Steps st) {
  dot_body<W, LONG>(x, y, z, g, Unrolled<N, VEC>{st});
}

template <typename D, typename M, typename W, bool LONG>
__global__ void __launch_bounds__(kThreads)
online_dot_any(const int* __restrict__ x, const int* __restrict__ y,
               int* __restrict__ z, const __grid_constant__ Geo g,
               const __grid_constant__ AnyArgs a) {
  dot_body<W, LONG>(x, y, z, g, General<D, M>(a));
}

// Ask for `smem` bytes of dynamic shared memory for `kern`, then report
// the geometry (smem_out, blocks_out) or launch `grid` blocks.
template <typename Kern, typename... Args>
cudaError_t start(Kern kern, long long smem, int grid, cudaStream_t stream,
                  int* smem_out, int* blocks_out, Args... args) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (blocks_out) {
    *smem_out = (int)smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_out, kern,
                                                         kThreads, smem);
  }
  kern<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// What a launch (or a geometry query, where blocks_out is set) needs.
struct Args {
  const int* x;
  const int* y;
  int* z;
  Geo g;
  int n;
  bool vec;
  cudaStream_t stream;
  int* smem_out;
  int* blocks_out;
};

template <int N, bool VEC, typename W, bool LONG>
cudaError_t launch(const Args& a, const Steps& st) {
  return start(online_dot_kernel<N, VEC, W, LONG>,
               smem_bytes(row_words(N, VEC), a.g.rows, a.g.L, N,
                          N + 2 * a.g.L),
               a.g.grid, a.stream, a.smem_out, a.blocks_out, a.x, a.y, a.z,
               a.g, st);
}

// The instances in use: rows of at most 1024 lanes (L <= 10) in streams
// of 32 bits, or of 64 where N + 2L passes 32 (N > 12); longer rows
// (L >= 11) in streams of 64 bits, or of 32 where N + 2L fits (N <= 10).
template <int N, bool VEC>
cudaError_t by_width(const Args& a, const Steps& st) {
  const bool narrow = N + 2 * a.g.L <= 32;
  if (a.g.trees > 1) {
    if constexpr (N + 2 * (kTreeLevels + 1) <= 32) {
      if (narrow) return launch<N, VEC, uint32_t, true>(a, st);
    }
    return launch<N, VEC, uint64_t, true>(a, st);
  }
  if constexpr (N + 2 * kTreeLevels > 32) {
    if (!narrow) return launch<N, VEC, uint64_t, false>(a, st);
  }
  return launch<N, VEC, uint32_t, false>(a, st);
}

template <int N>
cudaError_t by_vec(const Args& a, const Steps& st) {
  if constexpr (N % 4 == 0) {
    if (a.vec) return by_width<N, true>(a, st);
  } else {
    if (a.vec) return cudaErrorInvalidValue;
  }
  return by_width<N, false>(a, st);
}

cudaError_t dispatch(const Args& a, const Steps& st) {
#define OLM_CASE(NN) \
  case NN: return by_vec<NN>(a, st);
  switch (a.n) {
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

template <typename D, typename M, typename W, bool LONG>
cudaError_t launch_any(const Args& a, const AnyArgs& aa) {
  return start(online_dot_any<D, M, W, LONG>,
               smem_bytes(row_words(a.n, a.vec), a.g.rows, a.g.L, a.n,
                          a.n + 2 * a.g.L),
               a.g.grid, a.stream, a.smem_out, a.blocks_out, a.x, a.y, a.z,
               a.g, aa);
}

// The instances in use: masks of 32 bits with streams of 32 or 64 bits
// (and 128 past 1024 lanes, where n + 2L may pass 64), masks of 64 bits
// (n > 32) with streams of 64 or 128.
template <typename D, bool LONG>
cudaError_t any_by_width(const Args& a, const AnyArgs& aa) {
  using U128 = unsigned __int128;
  const int m = a.n + 2 * a.g.L;
  if (a.n <= 32) {
    if (m <= 32) return launch_any<D, uint32_t, uint32_t, LONG>(a, aa);
    if constexpr (LONG) {
      if (m > 64) return launch_any<D, uint32_t, U128, LONG>(a, aa);
    }
    return launch_any<D, uint32_t, uint64_t, LONG>(a, aa);
  }
  return m <= 64 ? launch_any<D, uint64_t, uint64_t, LONG>(a, aa)
                 : launch_any<D, uint64_t, U128, LONG>(a, aa);
}

cudaError_t dispatch_any(bool wide, const Args& a, const AnyArgs& aa) {
  if (a.g.trees > 1)
    return wide ? any_by_width<long long, true>(a, aa)
                : any_by_width<int, true>(a, aa);
  return wide ? any_by_width<long long, false>(a, aa)
              : any_by_width<int, false>(a, aa);
}

// The selection on V (olm_lane.cuh `lane_gen`): z = +1 where V > hi, -1
// where V < lo, the plain version's estimate compared with +-2 in each of
// its cases. Where t <= S the estimate is V >> (S - t), which is >= 2 for
// V >= 2^(S-t+1) and < -2 for V < -2^(S-t+1); a shift past the word's top
// bit but one leaves the estimate in [-2, 1], so nothing selects. Where
// t > S the estimate is clamp(V, -2, 2) * lift: lift 2 selects +1 for
// V >= 1 and -1 for V <= -2, lift 4 +1 for V >= 1 and -1 for V <= -1,
// lift 0 (t > n + delta) nothing.
void select_bounds(int S, int t, int lift, bool wide, long long& hi,
                   long long& lo) {
  const int top = wide ? 63 : 31;
  hi = wide ? 0x7FFFFFFFFFFFFFFFLL : 0x7FFFFFFFLL;
  lo = -hi - 1;                            // nothing selects
  const int shift = S - t;
  if (shift >= 0) {
    if (shift + 1 < top) {
      hi = (1LL << (shift + 1)) - 1;
      lo = -(1LL << (shift + 1));
    }
  } else if (lift == 2) {
    hi = 0;
    lo = -1;
  } else if (lift == 4) {
    hi = 0;
    lo = 0;
  }
}

// Levels L = ceil(log2 K), checked.
bool levels_of(long long K, int L) {
  return K >= 1 && L >= 0 && L <= kMaxLevels && (1LL << L) >= K &&
         (L == 0 || (1LL << (L - 1)) < K);
}

// The plan's geometry, checked: a group of whole rows (at most 1024 lanes
// a row, at most 2048 tree nodes) or one row's level-10 subtree; the
// stages that cover a group; a grid of at most one block a group; scratch
// and counters where a row has several subtrees.
bool geometry_ok(const Geo& g) {
  if (g.B < 1 || g.rows < 1 || g.rows > g.B || g.grid < 1) return false;
  const long long trees = (g.K + kTreeLanes - 1) / kTreeLanes;
  if (g.trees != trees || (trees > 1 && g.rows != 1)) return false;
  const long long tk = trees > 1 ? kTreeLanes : g.K;
  const int tl = trees > 1 ? kTreeLevels : g.L;
  if (((long long)g.rows << tl) > 32LL * 64) return false;
  if (g.subs != (int)((g.rows * tk + kThreads - 1) / kThreads)) return false;
  const long long groups = (g.B + g.rows - 1) / g.rows * trees;
  if (groups > 0x7FFFFFFFLL / 4 || g.groups != groups || g.grid > groups)
    return false;
  return trees == 1 || (g.scratch != nullptr && g.arrived != nullptr);
}

}  // namespace

// Plain C entry points (loaded with ctypes).
//
// online_dot: x, y are (B, K, n) int32 row-major, z is (B, n + 2L) int32
// row-major with L = ceil(log2 K), n + 2L <= 64; sched holds the n + 3
// values of T(j), S their maximum and t the estimate's fractional digits
// (0 <= t <= S). The plan (kernel.launch_plan): groups of `rows` rows (or,
// past 1024 lanes, one row's level-10 subtree: `trees` of them a row) in
// `subs` stages of at most 256 lanes, a grid of `grid` persistent blocks,
// 16-byte copies where vec (n a multiple of 4, x and y 16-byte aligned);
// where trees > 1, `scratch` holds 2 * B * trees stream words and
// `arrived` B int32 zeros. Returns a cudaError_t: 0 on a successful
// launch.
extern "C" int online_dot(const int* x, const int* y, int* z, int B,
                          long long K, int L, int n, int S, int t,
                          const int* sched, int nsteps, int rows, int subs,
                          int trees, int grid, int vec, void* scratch,
                          int* arrived, void* stream) {
  const long long groups = rows < 1 ? 0 : (B + rows - 1LL) / rows * trees;
  const Geo g{K, B, L, rows, subs, trees, (int)groups, grid, scratch,
              arrived};
  if (!levels_of(K, L) || !geometry_ok(g) || n <= olm::kDelta ||
      n > olm::kMaxDigits || n + 2 * L > 64 || nsteps != n + olm::kDelta ||
      S + 3 > 31 || t < 0 || S < t ||
      (vec && (n % 4 != 0 || ((uintptr_t)x | (uintptr_t)y) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, y, z, g, n, vec != 0, static_cast<cudaStream_t>(stream),
               nullptr, nullptr};
  return (int)dispatch(a, make_steps(sched, nsteps, S, t));
}

// online_dot_any: the same function for any configuration a kernel holds
// (kernels/online_mul/kernel.py `check_config`): n <= 64 output digits,
// 1 <= n + delta <= 64 steps, the schedule of n + delta values, a stream
// of n + 2L <= 128 digits; `lift` is the estimate's factor where t > S
// (`select_bounds`), `wide` runs the residual in int64. The plan is
// online_dot's, its rows of n words (16-byte chunks where vec) padded to
// an odd count. Returns a cudaError_t.
extern "C" int online_dot_any(const int* x, const int* y, int* z, int B,
                              long long K, int L, int n, int delta, int S,
                              int t, int lift, int wide, const int* sched,
                              int nsteps, int rows, int subs, int trees,
                              int grid, int vec, void* scratch, int* arrived,
                              void* stream) {
  const long long groups = rows < 1 ? 0 : (B + rows - 1LL) / rows * trees;
  const Geo g{K, B, L, rows, subs, trees, (int)groups, grid, scratch,
              arrived};
  if (!levels_of(K, L) || !geometry_ok(g) || n < 1 || n > 64 ||
      n + 2 * L > 128 || delta > 30 || n + delta < 1 ||
      n + delta > olm::kAnySteps || nsteps != n + delta || S < 0 ||
      S + 3 > 31 || lift < 0 || lift > 4 ||
      (vec && (n % 4 != 0 || ((uintptr_t)x | (uintptr_t)y) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  AnyArgs aa{};
  const olm::StepConsts<olm::kAnySteps> c =
      olm::step_consts<olm::kAnySteps>(sched, nsteps, S, t);
  for (int s = 0; s < nsteps; ++s) aa.st.kw[s] = make_int2(c.keep[s], c.wq[s]);
  select_bounds(S, t, lift, wide != 0, aa.st.hi, aa.st.lo);
  aa.st.unit = 1LL << S;
  aa.st.n = n;
  aa.st.delta = delta;
  aa.st.shift = delta >= 0 ? delta : 31;
  aa.vec = vec != 0;
  aa.per = vec ? n / 4 : n;
  aa.row = row_words(n, vec != 0);
  aa.step_e = kThreads / aa.per;
  aa.step_c = kThreads - aa.step_e * aa.per;
  // the unrolled kernel's swizzle (olm_lane.cuh `swizzle`) where the
  // chunks are a power of two, 8 rows reading one chunk on 8 bank groups
  const int q = n / 4;
  if (vec && q > 1 && (q & (q - 1)) == 0) {
    aa.sw_mask = (q < 8 ? q : 8) - 1;
    aa.sw_shift = q < 8 ? __builtin_ctz(8 / q) : 0;
  }
  const Args a{x, y, z, g, n, vec != 0, static_cast<cudaStream_t>(stream),
               nullptr, nullptr};
  return (int)dispatch_any(wide != 0, a, aa);
}

// online_dot_geometry: the shared memory a block of the plan (n, vec,
// rows, L) asks for, and how many such blocks an SM holds, for the
// unrolled kernel or (general) online_dot_any with an int32 or (wide)
// int64 residual. Launches nothing. Returns a cudaError_t.
extern "C" int online_dot_geometry(int n, int vec, int rows, int L,
                                   int general, int wide, int* smem,
                                   int* blocks) {
  const int tl = L < kTreeLevels ? L : kTreeLevels;
  if (rows < 1 || L < 0 || L > kMaxLevels ||
      ((long long)rows << tl) > 32LL * 64 ||
      n + 2 * L > (general ? 128 : 64) || n < 1 || n > 64)
    return (int)cudaErrorInvalidValue;
  Geo g{};
  g.L = L;
  g.rows = rows;
  g.trees = L > kTreeLevels ? 2 : 1;       // the instance past 1024 lanes
  const Args a{nullptr, nullptr, nullptr, g, n, vec != 0, nullptr, smem,
               blocks};
  if (!general) return (int)dispatch(a, Steps{});
  if (vec && n % 4 != 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch_any(wide != 0, a, AnyArgs{});
}
