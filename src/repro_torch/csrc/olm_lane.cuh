// What the port's array kernels share beyond olm_digits.cuh: the
// recurrence with the schedule's constants computed once on the host (K3's
// `lane_loop`, K1/K2's `lane_top`, which issues fewer integer-ALU
// instructions, and `lane_gen`, the general lane of any delay, estimate
// width and n <= 64, in an int32 or int64 residual), the online adder on
// 32-, 64- or 128-bit streams, cp.async copies, and the packing of staged
// digit rows into +1/-1 masks. online_dot.cu (K3, and K4's general route)
// and olm_matmul.cu (K1, K2) include this one copy.
//
// Bit-identity rules: the same integer arithmetic as olm_digits.cuh's
// `mul_digit_loop`, step for step and bit for bit.
#pragma once

#include "olm_digits.cuh"

namespace olm {

// The schedule's per-step constants for the unrolled lanes (K1/K2 run
// t = 2, K3 the estimate width it is given).
using Steps = StepConsts<kMaxSteps>;

inline Steps make_steps(const int* sched, int nsteps, int S, int t = kEst) {
  return step_consts<kMaxSteps>(sched, nsteps, S, t);
}

// One lane of the radix-2 online multiplier: `mul_digit_loop`'s Fig. 7
// recurrence, step for step, with the schedule's constants from `st`.
// Digit i of an operand at bit N-1-i of its masks; output digit j lands
// at bit j of (zp, zn).
template <int N>
__device__ __forceinline__ void lane_loop(uint32_t xp, uint32_t xn,
                                          uint32_t yp, uint32_t yn,
                                          const Steps& st, uint32_t& zp,
                                          uint32_t& zn) {
  int X = 0, Y = 0, W = 0;
  uint32_t op = 0, on = 0;
#pragma unroll
  for (int s = 0; s < N + kDelta; ++s) {
    const int j = s - kDelta;
    const int q = s + 1;                   // arriving digit position
    int xd = 0, yd = 0;
    if (q <= N) {
      const int sh = N - q;
      xd = (int)((xp >> sh) & 1u) - (int)((xn >> sh) & 1u);
      yd = (int)((yp >> sh) & 1u) - (int)((yn >> sh) & 1u);
    }
    const int keep = st.keep[s], wq = st.wq[s];
    const int Yf = Y + yd * wq;
    const int term = X * yd + Yf * xd;
    const int append = (term >> kDelta) & keep;
    X = (X + xd * wq) & keep;
    Y = Yf & keep;
    const int V = 2 * W + append;
    if (j >= 0) {
      const int vq = V >> st.shift;        // selection estimate
      const int z = vq >= 2 ? 1 : (vq >= -2 ? 0 : -1);
      W = (V - z * st.unit) & keep;
      op |= (uint32_t)(z > 0) << j;
      on |= (uint32_t)(z < 0) << j;
    } else {
      W = V & keep;
    }
  }
  zp = op;
  zn = on;
}

// One lane of the radix-2 online multiplier: `lane_loop` step for step
// and bit for bit, with its work moved off the integer ALU pipe where an
// IMAD on the FMA pipe does the same: an H100 SM issues
// four instructions a clock, but LOP3, SHF, ISETP and SEL share a pipe
// that takes a warp instruction every other clock. So:
//  * digit i of an operand sits at bit 31 - i of its masks, and step s
//    reads it as the sign of the mask shifted left by s (a left shift by
//    a constant issues as IMAD.SHL);
//  * the selection z of {-1, 0, 1} from vq = V >> (S - t) (1 if vq >= 2,
//    -1 if vq <= -3) is clamp((V + 2^(S-t+1)) >> (S-t+2), -1, 1), the
//    same floor taken once;
//  * the output digits accumulate as S = sum z_j 2^j = P - Q and
//    B = sum |z_j| 2^j = P + Q, one IMAD each, and the +1 and -1 masks are
//    P = (B + S) / 2 and Q = (B - S) / 2 at the end, exact in int32 for
//    n <= 30; olm32 sets the mask bits one by one.
// Output digit j lands at bit j of (zp, zn).
template <int N>
__device__ __forceinline__ void lane_top(uint32_t xp, uint32_t xn,
                                         uint32_t yp, uint32_t yn,
                                         const Steps& st, uint32_t& zp,
                                         uint32_t& zn) {
  int X = 0, Y = 0, W = 0;
  int sum = 0, mag = 0;                    // S and B above
  uint32_t op = 0, on = 0;
  const int half = 2 << st.shift, sel = st.shift + 2;
#pragma unroll
  for (int s = 0; s < N + kDelta; ++s) {
    const int j = s - kDelta;
    const int keep = st.keep[s], wq = st.wq[s];
    int Yf = Y, Xf = X, term = 0;
    if (s < N) {                           // digit s arrives
      const int xd = ((int)(xn << s) >> 31) - ((int)(xp << s) >> 31);
      const int yd = ((int)(yn << s) >> 31) - ((int)(yp << s) >> 31);
      Yf = Y + yd * wq;
      term = X * yd + Yf * xd;
      Xf = X + xd * wq;
    }
    const int append = (term >> kDelta) & keep;
    X = Xf & keep;
    Y = Yf & keep;
    const int V = 2 * W + append;
    if (j >= 0) {
      const int z = min(1, max(-1, (V + half) >> sel));
      W = (V - z * st.unit) & keep;
      if constexpr (N <= 30) {
        sum += z * (1 << j);
        mag += (z * z) * (1 << j);
      } else {
        op |= (uint32_t)(z > 0) << j;
        on |= (uint32_t)(z < 0) << j;
      }
    } else {
      W = V & keep;
    }
  }
  if constexpr (N <= 30) {
    op = (uint32_t)(mag + sum) >> 1;
    on = (uint32_t)(mag - sum) >> 1;
  }
  zp = op;
  zn = on;
}

// The general lane's per-step constants and selection, computed once on
// the host (online_dot.cu `any_steps`).
struct AnySteps {
  int2 kw[kAnySteps];      // per step: floor mask below 2^-T(j), and the
                           // arriving digit's bit (or 0)
  long long hi, lo;        // the selection: +1 where V > hi, -1 where V < lo
  long long unit;          // 2^S
  int n, delta;            // operand digits, online delay
  int shift;               // the append's shift: delta, or 31 (the term's
                           // sign) where delta < 0
};

// The general lane's operand digits: digit i of a lane in bits
// [w-1-2i, w-2-2i] of a word of w = 64 (n <= 32) or 128 bits, as its two's
// complement (01 for +1, 11 for -1, 00 for 0), so a step reads its digit
// as the word's top two bits, shifted arithmetically, and moves the word
// on by 2. The word for 32-bit output masks M is 64 bits, for 64-bit ones
// 128.
template <typename M> struct Fields;
template <> struct Fields<uint32_t> { using T = uint64_t; };
template <> struct Fields<uint64_t> { using T = unsigned __int128; };

template <typename F>
__device__ __forceinline__ int top_digit(F f) {
  if constexpr (sizeof(F) == 8) {
    return (int)((long long)f >> 62);
  } else {
    return (int)((long long)(uint64_t)(f >> 64) >> 62);
  }
}

// A floor mask below 2^-T(j) (int32, negative: bits 31 .. dead set) in the
// residual's datapath: sign-extended, so an int64 AND keeps the high word.
template <typename D>
__device__ __forceinline__ D keep_as(int keep) {
  if constexpr (sizeof(D) == 4) {
    return keep;
  } else {
    return ~(D)(uint32_t)~keep;
  }
}

// One lane of the radix-2 online multiplier for any configuration a
// kernel holds: olm_digits.cuh's `mul_digit_loop` recurrence step for
// step, with n, the online delay and the estimate given at run time and
// the digits read from their fields (`Fields`); past digit n the fields
// are zero. The partial operands X and Y and the term stay in int32
// (|X|, |Y| < 3 * 2^S and |term| < 2^31 at S <= 28); the residual W and
// V = 2W + append run in D: int where the selection bounds the residual,
// long long where it may not (kernels/online_mul `lane_bits` decides
// which). The selection compares V with the host's (hi, lo), which equals
// the plain version's estimate compared with +-2 in each of its cases:
// V >> (S - t) where t <= S; the estimate wider than the datapath (t > S),
// exact in the plain version as V * 2^(t - S) and so a threshold at +-1 or
// 0; and an estimate shifted past the word, which never selects. The
// output bits gather most significant first and are reversed once at the
// end: output digit j lands at bit j of (zp, zn), n <= width of M.
template <typename D, typename M>
__device__ __forceinline__ void lane_gen(typename Fields<M>::T xf,
                                         typename Fields<M>::T yf,
                                         const AnySteps& a, M& zp, M& zn) {
  int X = 0, Y = 0;
  D W = 0;
  M op = 0, on = 0;
  const int steps = a.n + a.delta;
  const int lead = min(max(a.delta, 0), steps);  // steps before digit 0
  // step s's operand half: the arriving digits, X, Y and the append
  auto operands = [&](int s, int& keep) {
    const int2 c = a.kw[s];
    const int xd = top_digit(xf), yd = top_digit(yf);
    xf <<= 2;
    yf <<= 2;
    const int Yf = Y + yd * c.y;
    const int term = X * yd + Yf * xd;
    X = (X + xd * c.y) & c.x;
    Y = Yf & c.x;
    keep = c.x;
    return (term >> a.shift) & c.x;
  };
  for (int s = 0; s < lead; ++s) {
    int keep;
    const int append = operands(s, keep);
    W = (2 * W + append) & keep_as<D>(keep);
  }
  for (int s = lead; s < steps; ++s) {
    int keep;
    const int append = operands(s, keep);
    const D V = 2 * W + append;
    const int up = V > (D)a.hi, down = V < (D)a.lo;
    W = (V - (up - down) * (D)a.unit) & keep_as<D>(keep);
    op = (op << 1) | (M)up;                 // digit s - delta at bit
    on = (on << 1) | (M)down;               // steps - 1 - s
  }
  constexpr int kBits = 8 * (int)sizeof(M);
  if constexpr (sizeof(M) == 4) {
    zp = __brev(op) >> (kBits - a.n);
    zn = __brev(on) >> (kBits - a.n);
  } else {
    zp = __brevll(op) >> (kBits - a.n);
    zn = __brevll(on) >> (kBits - a.n);
  }
}

// One online adder of the tree, position-parallel on packed streams (digit
// i at bit i) held in words of type W: uint32_t for streams of up to 30
// digits, uint64_t for up to 62, unsigned __int128 for up to 126 (the
// result's last digit lands at the top bit). With e_k the digit sums
// (e_0 = 0, then the sums, then zeros):
//   t_k = +1 if e_k >= 2 or (e_k == 1 and e_{k+1} >= 0)
//   t_k = -1 if e_k <= -2 or (e_k == -1 and e_{k+1} < 0)
//   w_k = e_k - 2 t_k,  out_k = w_k + t_{k+1}  (in {-1, 0, 1})
// giving the stream of (a + b) / 2, two digits longer.
template <typename W>
__device__ __forceinline__ void online_add(W ap, W an, W bp, W bn, W& op,
                                           W& on) {
  ap <<= 1; an <<= 1; bp <<= 1; bn <<= 1;  // digit i is e index i + 1
  const W a0 = ~(ap | an), b0 = ~(bp | bn);
  const W e2 = ap & bp, em2 = an & bn;
  const W e1 = (ap & b0) | (bp & a0);
  const W em1 = (an & b0) | (bn & a0);
  const W neg_next = (em1 | em2) >> 1;     // e_{k+1} < 0
  const W tp = e2 | (e1 & ~neg_next);
  const W tn = em2 | (em1 & neg_next);
  const W odd = e1 | em1;
  const W wp = odd & neg_next, wn = odd & ~neg_next;
  const W tpn = tp >> 1, tnn = tn >> 1;    // t_{k+1}
  const W wz = ~(wp | wn);
  op = (wp & ~tnn) | (wz & tpn);
  on = (wn & ~tpn) | (wz & tnn);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem));
}
// Wait for every copy this thread has started.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// 16-byte chunks of one staged digit row of n words: n/4, swizzled when
// a power of two, else padded to an odd count.
__host__ __device__ constexpr int row_chunks(int n) {
  return ((n / 4) & (n / 4 - 1)) ? ((n / 4) | 1) : n / 4;
}
// Words of one staged row: 16-byte chunks (vec), or n padded to odd.
__host__ __device__ constexpr int row_words(int n, bool vec) {
  return vec ? 4 * row_chunks(n) : (n | 1);
}

// The chunk swizzle of row e: 8 consecutive rows reading chunk c hit 8
// different 16-byte bank groups.
template <int N>
__device__ __forceinline__ int swizzle(int e) {
  constexpr int Q = N / 4;
  if constexpr (Q > 1 && (Q & (Q - 1)) == 0) return (e / (8 / Q)) & (Q - 1);
  return 0;
}

// Digit i of a lane at bit N-1-i: +1 digits in p, -1 digits in q.
template <int N>
__device__ __forceinline__ void put(int v, int i, uint32_t& p, uint32_t& q) {
  p |= (uint32_t)(v > 0) << (N - 1 - i);
  q |= (uint32_t)(v < 0) << (N - 1 - i);
}

// Four digits d0..d3 (one 16-byte chunk) as a nibble each of non-zero and
// of negative digits, d0 at bit 3: the words' low bytes (0x01, 0x00 or
// 0xFF for a digit in {-1, 0, 1}) gathered into one word, then each
// byte's bit 0 (non-zero) or bit 1 (negative) moved into bits 24..27 by
// one multiply (byte i times 2^(9j) lands at bit 8i + 9j, and only
// i + j = 3 lands in 24..31).
__device__ __forceinline__ void nibbles(int4 v, uint32_t& nz, uint32_t& ng) {
  const uint32_t g = __byte_perm(__byte_perm(v.x, v.y, 0x0040),
                                 __byte_perm(v.z, v.w, 0x0040), 0x5410);
  nz = ((g & 0x01010101u) * 0x08040201u) >> 24;
  ng = (((g >> 1) & 0x01010101u) * 0x08040201u) >> 24;
}

// A staged row of N digits (chunks swizzled by `sw` where VEC) into its
// +1 and -1 masks; p and q start at 0.
template <int N, bool VEC>
__device__ __forceinline__ void pack(const int* row, int sw, uint32_t& p,
                                     uint32_t& q) {
  if constexpr (VEC) {
    uint32_t nz = 0;
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      uint32_t a, b;
      nibbles(*reinterpret_cast<const int4*>(row + 4 * (c ^ sw)), a, b);
      nz |= a << (N - 4 - 4 * c);
      q |= b << (N - 4 - 4 * c);
    }
    p = nz & ~q;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) put<N>(row[i], i, p, q);
  }
}

// A staged row of n digits into `lane_gen`'s fields F (`Fields`): where
// vec, n / 4 16-byte chunks, chunk c at position c ^ sw, each chunk's four
// words gathered into one (their low bytes), whose low two bits a byte
// are the digits' two's complement, moved into one byte, digit 0 on top,
// by one multiply (byte i times 2^(30 - 10j) lands at bit 30 - 2i where
// i = j, and nowhere in bits 22 .. 31 otherwise, with no carries); else n
// words.
template <typename F>
__device__ __forceinline__ F pack_fields(const int* row, int n, bool vec,
                                         int sw) {
  constexpr int kBits = 8 * (int)sizeof(F);
  F f = 0;
  if (vec) {
    for (int c = 0; c < n / 4; ++c) {
      const int4 v = *reinterpret_cast<const int4*>(row + 4 * (c ^ sw));
      const uint32_t g = __byte_perm(__byte_perm(v.x, v.y, 0x0040),
                                     __byte_perm(v.z, v.w, 0x0040), 0x5410);
      const uint32_t b = ((g & 0x03030303u) * 0x40100401u) >> 24;
      f |= (F)b << (kBits - 8 - 8 * c);
    }
  } else {
    for (int i = 0; i < n; ++i)
      f |= (F)(uint32_t)(row[i] & 3) << (kBits - 2 - 2 * i);
  }
  return f;
}

}  // namespace olm
