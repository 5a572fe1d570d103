// Digit arithmetic shared by the port's digit-serial kernels: the radix-2
// online multiplier recurrence (Fig. 7, truncated or full working
// precision) with the schedule T(j) read in every step, as online_mul.cu
// (K4) runs it, the same recurrence with n, the online delay and the
// estimate width all given at run time (`lane_any`, K3's and K4's kernels
// for every other configuration), the schedule's per-step constants, and
// the exact powers of two the scales are built from.
// olm_lane.cuh builds the array kernels' recurrence and online adder on
// these constants and rules; online_mul.cu includes this file, and
// olm_matmul.cu (K1, K2) and online_dot.cu (K3) include it through
// olm_lane.cuh.
//
// Bit-identity rules this file keeps: arithmetic right shifts on signed
// int32, floors by masking, powers of two built by writing the exponent
// field, and no float arithmetic that a compiler could contract.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace olm {

constexpr int kDelta = 3;                  // online delay
constexpr int kEst = 2;                    // fractional MSDs of the estimate
constexpr int kMaxDigits = 32;             // operand digits n
constexpr int kMaxSteps = kMaxDigits + kDelta;
// `lane_any`'s limits: n + delta steps and n output digits of at most 64.
// Every configuration whose schedule fits the datapath (max T(j) + 3 <=
// 31) with a delay of at least 0 stays inside them: delta <= 27, n <= 55,
// n + delta <= 55; the host checks the rest.
constexpr int kAnySteps = 64;

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
// Fig. 7 recurrence under the schedule T(j), digits read MSD first from
// the packed masks (digit i at bit N-1-i, +1 digits in *p, -1 digits in
// *n). Output digit j lands at bit j of (zp, zn). S = max T(j) is the
// truncated working precision p, or n + delta in full mode.
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

// Copy a host schedule of nsteps values into the by-value launch argument.
inline Sched make_sched(const int* sched, int nsteps) {
  Sched sc;
  for (int i = 0; i < kMaxSteps; ++i) sc.T[i] = i < nsteps ? sched[i] : 0;
  return sc;
}

// The schedule's per-step constants at datapath scale 2^S, for up to M
// steps (`mul_digit_loop` derives the same from T(j) in every lane and
// step).
template <int M>
struct StepConsts {
  int keep[M];                             // floor mask below 2^-T(j)
  int wq[M];                               // the arriving digit's bit, or 0
  int shift;                               // S - t: the estimate's shift
  int unit;                                // 2^S
};

template <int M>
inline StepConsts<M> step_consts(const int* sched, int nsteps, int S,
                                 int t) {
  StepConsts<M> st{};
  for (int s = 0; s < nsteps && s < M; ++s) {
    const int T = sched[s], q = s + 1;
    const int dead = S - T > 0 ? S - T : 0;
    st.keep[s] = (int)(0xFFFFFFFFu << dead);
    const int live = T < S ? T : S;
    st.wq[s] = q <= live ? (1 << (S - q > 0 ? S - q : 0)) : 0;
  }
  st.shift = S - t;
  st.unit = 1 << S;
  return st;
}

using StepsAny = StepConsts<kAnySteps>;

// One lane of the radix-2 online multiplier for any configuration a
// kernel holds: `mul_digit_loop`'s recurrence step for step, with n
// digits, the online delay and the estimate all given at run time and the
// operand digits read from rows xr, yr (digit i at xr[i], MSD first,
// values used as they are, as the reference's kernel uses them). The loop
// runs n + delta steps that the compiler cannot unroll, so this is the
// general path; the paper's delay of 3 runs the unrolled lanes. Output
// digit j lands at bit j of (zp, zn).
//
// D is the datapath's integer: int where the selection bounds the
// residual, long long where it may not (kernels/common.py `lane_bits`
// decides which from the configuration). The cases the plain version
// (kernels/online_mul/ref.py) meets with shifts past the word, and which
// a C++ shift leaves undefined, are spelt out so that both agree:
//  * a negative delay: `term >> delta` fills with the term's sign;
//  * an estimate wider than the datapath (t > S, st.shift < 0): the plain
//    version's estimate at scale 2^(n + delta) is V * 2^(t - S), exact,
//    and is only compared with +-2, so clamp(V, -2, 2) * lift, lift =
//    2^min(t - S, 2); where t > n + delta even the plain version's shift
//    is negative and fills with V's sign, which never selects (lift = 0);
//  * a shift past the word (a negative t) fills with V's sign.
template <typename D>
__device__ __forceinline__ void lane_any(const int* xr, const int* yr, int n,
                                         int delta, const StepsAny& st,
                                         int lift, uint64_t& zp,
                                         uint64_t& zn) {
  constexpr int kTop = 8 * (int)sizeof(D) - 1;
  const int shift = min(st.shift, kTop);
  D X = 0, Y = 0, W = 0;
  uint64_t op = 0, on = 0;
  for (int s = 0; s < n + delta; ++s) {
    const int j = s - delta;
    const int xd = s < n ? xr[s] : 0;     // digit q = s + 1 arrives
    const int yd = s < n ? yr[s] : 0;
    const D keep = st.keep[s], wq = st.wq[s];  // keep sign-extends
    const D Yf = Y + yd * wq;
    const D term = X * yd + Yf * xd;
    const D append = (delta >= 0 ? term >> delta : term >> kTop) & keep;
    X = (X + xd * wq) & keep;
    Y = Yf & keep;
    const D V = 2 * W + append;
    if (j >= 0) {
      const D vq = shift >= 0 ? V >> shift
                              : (V < -2 ? -2 : (V > 2 ? 2 : V)) * lift;
      const int z = vq >= 2 ? 1 : (vq >= -2 ? 0 : -1);
      W = (V - z * (D)st.unit) & keep;
      op |= (uint64_t)(z > 0) << j;
      on |= (uint64_t)(z < 0) << j;
    } else {
      W = V & keep;
    }
  }
  zp = op;
  zn = on;
}

// Stage rows of n words: `count` words from global memory, neighbouring
// threads on neighbouring words, into shared rows of `stride` words; word
// e of lane `lane(e / n)` goes to slot lane(e / n) * stride + e % n.
template <typename Slot>
__device__ __forceinline__ void stage_rows(const int* __restrict__ g,
                                           int* s, long long count, int n,
                                           int stride, int threads,
                                           Slot slot) {
  for (long long e = threadIdx.x; e < count; e += threads) {
    const int r = (int)(e / n);
    s[(long long)slot(r) * stride + (e - (long long)r * n)] = g[e];
  }
}

}  // namespace olm
