// Kernels 4 and 5: a^e for a static exponent e, in Fp and in Fp2, as one
// launch each.
//
// Replaces lighthouse_tpu/crypto/bls/jax_backend/pallas_fp.py:
//   kernel 4: _make_megachain_kernel / _megachain_call / pow_chain_limbs
//   kernel 5: _make_fp2_megachain_kernel / _fp2_megachain_call / fp2_pow_chain
//
// The exponent arrives as an MSB-first tape of base-16 digits (one int32
// each, in device memory; every thread reads the same word, so the loads
// broadcast).  Each lane builds the 16-entry power table (powers[0] = the
// Montgomery one, powers[1] = the base, powers[k] = powers[k-1] * base),
// starts from powers[tape[0]], and for every later digit squares four times
// and multiplies by powers[digit].  A 0 digit multiplies by the one:
// value-preserving, but it rewrites the limbs, so it is never skipped (byte
// identity with the reference).
//
// The 15-bit chains (fp_chain_group_kernel, fp2_chain_group_kernel) run in
// kernel 1's group form (group.cuh, mont_coop.cuh): 16 threads per lane in
// blocks of L lanes, every product and square cut into tiles, one per rank,
// in five barrier phases.  The lane's state stays in shared memory: the
// power table (16 x 28 words; a digit's entry is a shared-memory offset),
// the accumulator, the Fp2 chain's Karatsuba temporaries and one product's
// column sums.  The Fp chain squares with the group triangle square
// (mont_group_sqr_core, the twin of pallas_fp._mont_sqr_core); the Fp2
// chain squares and multiplies through its own cores (_fp2_sqr_core: 2
// products; _fp2_mul_core: 3, Karatsuba), which use fixed 16P / 2P
// subtraction biases and only the full product.  Their products run one
// after another on all 16 ranks; the linear ops (one carry pass over 26
// limbs) are dealt to the ranks limb by limb, inside a product's first or
// last phase where they touch nothing it reads or writes.
//
// The MXU variants (fp_chain_mxu_kernel, fp2_chain_mxu_kernel; the
// reference's chain kernels built with mxu=True) run every product on the
// 13-bit plane (kernel 7's core, mxu.cuh), the Fp chain's square as the full
// product mont(a, a) (pallas_fp._core_pair), one thread per lane.  The core
// is warp-cooperative: the digit tape is the same for every lane, so every
// call is warp-uniform, and the tail threads run lane n - 1's operands
// again and store nothing.
//
// What bounds it on the card: integer multiplies.  One Fp lane of the p-2
// chain does 14 + 95 * 5 products (about 0.75M 32-bit multiplies) against
// 208 bytes of traffic.  A lane's chain is a serial sequence of products, so
// the group form puts 16 threads on each product (16 times the warps of one
// thread per lane, each thread forming a tile of it) and keeps every operand
// in shared memory; what is left is the five barrier phases per product.
// The MXU variants, one thread per lane, run about one warp per SM at 4,096
// lanes.
#include "mont_coop.cuh"
#include "mxu.cuh"

namespace {

using lh::NL;

constexpr int kBlock = 32;  // the MXU variants: 4,096 lanes -> 128 blocks, one per SM
constexpr int kWindow = 4;  // pallas_fp.CHAIN_WINDOW
constexpr int kPowers = 1 << kWindow;
constexpr int kBias2 = 0;   // row of 2P in lh::kBias (fp.BIAS_KS order)
constexpr int kBias16 = 3;  // row of 16P

// o = a * b * R^-1 on the 13-bit plane (warp-cooperative); o may alias.
__device__ __noinline__ void c_mul_mxu(uint32_t* o, const uint32_t* a, const uint32_t* b,
                                       const lh::MxuCtx& mx) {
  uint32_t x[NL], y[NL], r[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    x[i] = a[i];
    y[i] = b[i];
  }
  lh::mont_core_mxu(x, y, r, mx);
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = r[i];
}

struct Mxu {
  lh::MxuCtx mx;
  __device__ __forceinline__ void mul(uint32_t* o, const uint32_t* a, const uint32_t* b) const {
    c_mul_mxu(o, a, b, mx);
  }
  __device__ __forceinline__ void sqr(uint32_t* o, const uint32_t* a) const {
    c_mul_mxu(o, a, a, mx);
  }
};

__device__ __forceinline__ void carry_store(uint32_t* o, uint32_t (&c)[NL]) {
  lh::compress1(c);
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = c[i];
}

// a + b, one carry pass
__device__ __forceinline__ void c_add(uint32_t* o, const uint32_t* a, const uint32_t* b) {
  uint32_t c[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = a[i] + b[i];
  carry_store(o, c);
}

// a + kP - b, one carry pass (pallas_fp._sub_biased)
__device__ __forceinline__ void c_sub(uint32_t* o, const uint32_t* a, const uint32_t* b,
                                      int kidx) {
  uint32_t c[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = a[i] + lh::kBias[kidx][i] - b[i];
  carry_store(o, c);
}

// (r0, r1) = (a0 + a1 u)(b0 + b1 u), Karatsuba (pallas_fp._fp2_mul_core).
// The outputs are written after every read of the inputs, so they may alias.
template <class Core>
__device__ __noinline__ void fp2_mul_core(const Core& core, uint32_t* r0, uint32_t* r1,
                                          const uint32_t* a0, const uint32_t* a1,
                                          const uint32_t* b0, const uint32_t* b1) {
  uint32_t v0[NL], v1[NL], sa[NL], sb[NL], m[NL], t[NL];
  core.mul(v0, a0, b0);
  core.mul(v1, a1, b1);
  c_add(sa, a0, a1);
  c_add(sb, b0, b1);
  core.mul(m, sa, sb);
  c_sub(r0, v0, v1, kBias2);
  c_sub(t, m, v0, kBias2);
  c_sub(r1, t, v1, kBias2);
}

// (r0, r1) = (a0 + a1 u)^2: (a0 + a1)(a0 - a1 + 16P), 2 a0 a1
// (pallas_fp._fp2_sqr_core).  May alias.
template <class Core>
__device__ __noinline__ void fp2_sqr_core(const Core& core, uint32_t* r0, uint32_t* r1,
                                          const uint32_t* a0, const uint32_t* a1) {
  uint32_t s[NL], d[NL], x0[NL], t[NL];
  c_add(s, a0, a1);
  c_sub(d, a0, a1, kBias16);
  core.mul(x0, s, d);
  core.mul(t, a0, a1);
  c_add(r1, t, t);
#pragma unroll
  for (int i = 0; i < NL; ++i) r0[i] = x0[i];
}

__device__ __forceinline__ void load(uint32_t* o, const uint32_t* plane, int n, int lane) {
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = plane[static_cast<size_t>(i) * n + lane];
}

__device__ __forceinline__ void store(uint32_t* plane, int n, int lane, const uint32_t* v) {
#pragma unroll
  for (int i = 0; i < NL; ++i) plane[static_cast<size_t>(i) * n + lane] = v[i];
}

__device__ __forceinline__ void copy(uint32_t* o, const uint32_t* a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = a[i];
}

// base^e of one lane into acc (the Fp chain's body, on either core).
template <class Core>
__device__ __forceinline__ void fp_chain_body(const Core& core, const int32_t* tape,
                                              int n_digits, const uint32_t* base, int n,
                                              int lane, uint32_t* acc) {
  uint32_t pw[kPowers][NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) pw[0][i] = lh::kOne[i];
  load(pw[1], base, n, lane);
#pragma unroll 1
  for (int k = 2; k < kPowers; ++k) core.mul(pw[k], pw[k - 1], pw[1]);
  copy(acc, pw[tape[0]]);
#pragma unroll 1
  for (int d = 1; d < n_digits; ++d) {
#pragma unroll 1
    for (int s = 0; s < kWindow; ++s) core.sqr(acc, acc);
    core.mul(acc, acc, pw[tape[d]]);
  }
}

// (a0 + a1 u)^e of one lane into (c0, c1) (the Fp2 chain's body).
template <class Core>
__device__ __forceinline__ void fp2_chain_body(const Core& core, const int32_t* tape,
                                               int n_digits, const uint32_t* a0,
                                               const uint32_t* a1, int n, int lane, uint32_t* c0,
                                               uint32_t* c1) {
  uint32_t pw0[kPowers][NL], pw1[kPowers][NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    pw0[0][i] = lh::kOne[i];
    pw1[0][i] = 0;
  }
  load(pw0[1], a0, n, lane);
  load(pw1[1], a1, n, lane);
#pragma unroll 1
  for (int k = 2; k < kPowers; ++k)
    fp2_mul_core(core, pw0[k], pw1[k], pw0[k - 1], pw1[k - 1], pw0[1], pw1[1]);
  const int first = tape[0];
  copy(c0, pw0[first]);
  copy(c1, pw1[first]);
#pragma unroll 1
  for (int d = 1; d < n_digits; ++d) {
#pragma unroll 1
    for (int s = 0; s < kWindow; ++s) fp2_sqr_core(core, c0, c1, c0, c1);
    const int digit = tape[d];
    fp2_mul_core(core, c0, c1, c0, c1, pw0[digit], pw1[digit]);
  }
}

__global__ void __launch_bounds__(kBlock)
fp_chain_mxu_kernel(const int32_t* __restrict__ tape, int n_digits,
                    const uint32_t* __restrict__ base, uint32_t* __restrict__ out, int n) {
  __shared__ lh::MxuShared<kBlock / 32> sm;
  const Mxu core{lh::mxu_setup(sm)};
  const int gl = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = gl < n ? gl : n - 1;
  uint32_t acc[NL];
  fp_chain_body(core, tape, n_digits, base, n, lane, acc);
  if (gl < n) store(out, n, lane, acc);
}

__global__ void __launch_bounds__(kBlock)
fp2_chain_mxu_kernel(const int32_t* __restrict__ tape, int n_digits,
                     const uint32_t* __restrict__ a0, const uint32_t* __restrict__ a1,
                     uint32_t* __restrict__ o0, uint32_t* __restrict__ o1, int n) {
  __shared__ lh::MxuShared<kBlock / 32> sm;
  const Mxu core{lh::mxu_setup(sm)};
  const int gl = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = gl < n ? gl : n - 1;
  uint32_t c0[NL], c1[NL];
  fp2_chain_body(core, tape, n_digits, a0, a1, n, lane, c0, c1);
  if (gl < n) {
    store(o0, n, lane, c0);
    store(o1, n, lane, c1);
  }
}

// -- the 15-bit chains in the group form ------------------------------------

using lh::coop::Lane;
using lh::coop::NC;
using lh::coop::NP;
using lh::coop::NW;
using lh::coop::Work;

constexpr int kG = 16;  // threads per lane (Shape<16>; the square's tiles need 16)
// Shared words per lane of one product's work: three column sums, the carry
// maps, s = t + u
constexpr int kWorkWords = 3 * NC + kG + NW;

// A lane's words in its block's shared memory ([word][L lanes] layout): word
// k at base[k * L]; array j (NP words) starts at word j * NP.
template <int L>
struct Arena {
  uint32_t* base;  // the block's array + the lane's slot
  __device__ __forceinline__ Lane at(int word) const {
    return Lane{base + word * lh::kLanes<L>, lh::kLanes<L>};
  }
  __device__ __forceinline__ Lane arr(int j) const { return at(j * NP); }
  __device__ __forceinline__ Work work(int word) const {
    return Work{at(word), at(word + NC), at(word + 2 * NC), at(word + 3 * NC),
                at(word + 3 * NC + kG)};
  }
};

// o = compress1(col) over 26 limbs, where col(k) is the column before the
// pass (c_add, c_sub): limb k reads columns k and k - 1 only, so rank r
// writes limbs r, r + G, ...; o must not be an array that col reads.
template <class Col>
__device__ __forceinline__ void g_pass(int r, Lane o, Col col) {
  for (int k = r; k < NL; k += kG) o(k) = (col(k) & lh::MASK) + (k ? col(k - 1) >> 15 : 0u);
}

// a + b, one carry pass
__device__ __forceinline__ void g_add(int r, Lane o, Lane a, Lane b) {
  g_pass(r, o, [&](int k) { return a(k) + b(k); });
}

// a + kP - b, one carry pass (pallas_fp._sub_biased)
__device__ __forceinline__ void g_sub(int r, Lane o, Lane a, Lane b, int kidx) {
  g_pass(r, o, [&](int k) { return a(k) + lh::kBias[kidx][k] - b(k); });
}

__device__ __forceinline__ void g_copy(int r, Lane o, Lane a) {
  for (int k = r; k < NL; k += kG) o(k) = a(k);
}

// A lane's group in a block of L lanes: its shared arrays and one product's
// work; every thread of the block runs every phase.
template <int L>
struct Group {
  Arena<L> ar;
  Work w;
  uint32_t* pp;  // the block's P' and P, 28 words each
  uint32_t* pl;

  // the first phase: zero the pads (limbs 26, 27) of arrays [0, arrays) (the
  // operands' tiles read them), clear the column sums, fill P' and P, and
  // `load(r)`, which writes limbs below 26 only
  template <class Load>
  __device__ __forceinline__ void setup(int arrays, Load load) const {
    LH_RANKS_OF(kG, L, for (int j = r; j < arrays; j += kG) ar.arr(j)(NL) = ar.arr(j)(NL + 1) = 0;
                lh::coop::clear_sums<kG>(r, w);
                lh::coop::fill_constants<kG, L>(r, pp, pl); load(r))
  }

  // o = a * b * R^-1; o may alias a or b.  `first(r)` runs in the t phase,
  // `last(r)` in the last, beside clearing the sums for the next product.
  template <class First, class Last>
  __device__ __forceinline__ void mul(Lane o, Lane a, Lane b, First first, Last last) const {
    lh::coop::mont_group_core<kG, L>(a, b, w, pp, pl, o, true, first,
                                     [&](int r) { lh::coop::clear_sums<kG>(r, w); last(r); });
  }
  __device__ __forceinline__ void mul(Lane o, Lane a, Lane b) const {
    mul(o, a, b, [](int) {}, [](int) {});
  }

  // o = a * a * R^-1 by the triangle square; o may alias a
  __device__ __forceinline__ void sqr(Lane o, Lane a) const {
    lh::coop::mont_group_sqr_core<kG, L>(a, w, pp, pl, o, true, [](int) {},
                                         [&](int r) { lh::coop::clear_sums<kG>(r, w); });
  }

  // out = a (26, n) limb plane, live lanes only
  __device__ __forceinline__ void store(uint32_t* out, int n, int lane, bool live, Lane a) const {
    LH_RANKS_OF(kG, L, for (int k = r; k < NL; k += kG) {
      if (live) out[static_cast<size_t>(k) * n + lane] = a(k);
    })
  }
};

// Per-lane arrays of the Fp chain: powers[0..15], the accumulator; then one
// product's work.
constexpr int kFpAcc = kPowers;
constexpr int kFpArrays = kPowers + 1;
constexpr int kFpChainWords = kFpArrays * NP + kWorkWords;
template <int L>
constexpr int kFpChainShared = kFpChainWords * lh::kLanes<L> + 2 * NP;

// base^e for lane `lane`, by the 16 threads of its group in a block of L
// lanes.
template <int L>
__global__ void __launch_bounds__(kG * L)
fp_chain_group_kernel(const int32_t* __restrict__ tape, int n_digits,
                      const uint32_t* __restrict__ base, uint32_t* __restrict__ out, int n) {
  LH_GROUP_SHARED(uint32_t, sm, kFpChainShared<L>);
  const int gl = lh::group_lane<L>();
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
  const Arena<L> ar{sm + lh::group_slot<L>()};
  uint32_t* const pp = sm + kFpChainWords * lh::kLanes<L>;
  const Group<L> g{ar, ar.work(kFpArrays * NP), pp, pp + NP};
  const Lane acc = ar.arr(kFpAcc);
  // powers[0] = the one, powers[1] = the base
  g.setup(kFpArrays, [&](int r) {
    for (int i = r; i < NL; i += kG) {
      ar.arr(0)(i) = lh::kOne[i];
      ar.arr(1)(i) = base[static_cast<size_t>(i) * n + lane];
    }
  });
#pragma unroll 1
  for (int k = 2; k < kPowers; ++k) g.mul(ar.arr(k), ar.arr(k - 1), ar.arr(1));
  const int first = tape[0];
  LH_RANKS_OF(kG, L, g_copy(r, acc, ar.arr(first)))
#pragma unroll 1
  for (int d = 1; d < n_digits; ++d) {
#pragma unroll 1
    for (int s = 0; s < kWindow; ++s) g.sqr(acc, acc);
    g.mul(acc, acc, ar.arr(tape[d]));
  }
  g.store(out, n, lane, live, acc);
}

// Per-lane arrays of the Fp2 chain: powers[0..15] of c0, of c1, the
// accumulator (c0, c1), five temporaries; then one product's work.
constexpr int kFp2Pw1 = kPowers;
constexpr int kFp2C0 = 2 * kPowers, kFp2C1 = kFp2C0 + 1;
constexpr int kFp2Tmp = kFp2C1 + 1;
constexpr int kFp2Arrays = kFp2Tmp + 5;
constexpr int kFp2ChainWords = kFp2Arrays * NP + kWorkWords;
template <int L>
constexpr int kFp2ChainShared = kFp2ChainWords * lh::kLanes<L> + 2 * NP;
// Lanes per block of the one Fp2 form (chain_kernel.FP2_FORM).  The path
// launches the Fp2 chain at 4,096 lanes only, where blocks of 16 lanes beat
// blocks of 8 (PERF.md).
constexpr int kFp2Lanes = 16;

// (r0, r1) = (a0 + a1 u)(b0 + b1 u), Karatsuba (pallas_fp._fp2_mul_core):
// v0 = a0 b0 beside sa = a0 + a1, sb = b0 + b1; m = sa sb; v1 = a1 b1 beside
// tm = m - v0 + 2P; then r0 = v0 - v1 + 2P, r1 = tm - v1 + 2P.  16 phases;
// (r0, r1) may alias (a0, a1), not (b0, b1).
template <int L>
__device__ __forceinline__ void fp2_mul_group(const Group<L>& g, Lane r0, Lane r1, Lane a0,
                                              Lane a1, Lane b0, Lane b1) {
  const Lane sa = g.ar.arr(kFp2Tmp), sb = g.ar.arr(kFp2Tmp + 1), v0 = g.ar.arr(kFp2Tmp + 2),
             m = g.ar.arr(kFp2Tmp + 3), tm = g.ar.arr(kFp2Tmp + 4);
  const Lane v1 = sa;  // sa is dead once m's tiles are formed
  g.mul(v0, a0, b0, [&](int r) {
    g_add(r, sa, a0, a1);
    g_add(r, sb, b0, b1);
  }, [](int) {});
  g.mul(m, sa, sb);
  g.mul(v1, a1, b1, [&](int r) { g_sub(r, tm, m, v0, kBias2); }, [](int) {});
  LH_RANKS_OF(kG, L, g_sub(r, r0, v0, v1, kBias2); g_sub(r, r1, tm, v1, kBias2))
}

// (r0, r1) = (a0 + a1 u)^2 = ((a0 + a1)(a0 - a1 + 16P), 2 a0 a1)
// (pallas_fp._fp2_sqr_core): t = a0 a1 beside s = a0 + a1 and
// d = a0 - a1 + 16P; then r0 = s d, beside r1 = t + t.  10 phases; may alias.
template <int L>
__device__ __forceinline__ void fp2_sqr_group(const Group<L>& g, Lane r0, Lane r1, Lane a0,
                                              Lane a1) {
  const Lane s = g.ar.arr(kFp2Tmp), d = g.ar.arr(kFp2Tmp + 1), t = g.ar.arr(kFp2Tmp + 2);
  g.mul(t, a0, a1, [&](int r) {
    g_add(r, s, a0, a1);
    g_sub(r, d, a0, a1, kBias16);
  }, [](int) {});
  g.mul(r0, s, d, [](int) {}, [&](int r) { g_add(r, r1, t, t); });
}

// (a0 + a1 u)^e for lane `lane`, by the 16 threads of its group in a block
// of L lanes (built for L = kFp2Lanes).
template <int L>
__global__ void __launch_bounds__(kG * L)
fp2_chain_group_kernel(const int32_t* __restrict__ tape, int n_digits,
                       const uint32_t* __restrict__ a0, const uint32_t* __restrict__ a1,
                       uint32_t* __restrict__ o0, uint32_t* __restrict__ o1, int n) {
  LH_GROUP_SHARED(uint32_t, sm, kFp2ChainShared<L>);
  const int gl = lh::group_lane<L>();
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
  const Arena<L> ar{sm + lh::group_slot<L>()};
  uint32_t* const pp = sm + kFp2ChainWords * lh::kLanes<L>;
  const Group<L> g{ar, ar.work(kFp2Arrays * NP), pp, pp + NP};
  const auto pw0 = [&](int k) { return ar.arr(k); };
  const auto pw1 = [&](int k) { return ar.arr(kFp2Pw1 + k); };
  const Lane c0 = ar.arr(kFp2C0), c1 = ar.arr(kFp2C1);
  // powers[0] = (the one, 0), powers[1] = (a0, a1)
  g.setup(kFp2Arrays, [&](int r) {
    for (int i = r; i < NL; i += kG) {
      pw0(0)(i) = lh::kOne[i];
      pw1(0)(i) = 0;
      pw0(1)(i) = a0[static_cast<size_t>(i) * n + lane];
      pw1(1)(i) = a1[static_cast<size_t>(i) * n + lane];
    }
  });
#pragma unroll 1
  for (int k = 2; k < kPowers; ++k)
    fp2_mul_group(g, pw0(k), pw1(k), pw0(k - 1), pw1(k - 1), pw0(1), pw1(1));
  const int first = tape[0];
  LH_RANKS_OF(kG, L, g_copy(r, c0, pw0(first)); g_copy(r, c1, pw1(first)))
#pragma unroll 1
  for (int d = 1; d < n_digits; ++d) {
#pragma unroll 1
    for (int s = 0; s < kWindow; ++s) fp2_sqr_group(g, c0, c1, c0, c1);
    const int digit = tape[d];
    fp2_mul_group(g, c0, c1, c0, c1, pw0(digit), pw1(digit));
  }
  g.store(o0, n, lane, live, c0);
  g.store(o1, n, lane, live, c1);
}

#ifdef __CUDACC__
// Launch a group chain kernel with `words` of dynamic shared memory per
// block (the attribute set once per kernel).
template <int L, int Words, class Kernel, class... Args>
int launch_group(Kernel kernel, int n, cudaStream_t stream, Args... args) {
  constexpr int kShared = Words * 4;
  static_assert(kShared <= 232448, "one block's shared memory on sm_90");
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<(n + L - 1) / L, kG * L, kShared, stream>>>(args..., n);
  return static_cast<int>(cudaGetLastError());
}
#endif

}  // namespace

// tape: (n_digits,) int32 base-16 digits, MSB first, each in [0, 16);
// base, out: (26, n) int32 limb planes, contiguous, on the current device.
// The form: `group` threads per lane (16) in blocks of `lanes` lanes (8 or
// 16; chain_kernel.FP_FORMS).  Returns cudaGetLastError().
extern "C" int lh_fp_chain(const void* tape, int n_digits, const void* base, void* out, int n,
                           int group, int lanes, void* stream) {
  const auto* tp = static_cast<const int32_t*>(tape);
  const auto* b = static_cast<const uint32_t*>(base);
  auto* o = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (group != kG) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  switch (lanes) {
    case 8:
      return launch_group<8, kFpChainShared<8>>(fp_chain_group_kernel<8>, n, s, tp, n_digits, b, o);
    case 16:
      return launch_group<16, kFpChainShared<16>>(fp_chain_group_kernel<16>, n, s, tp, n_digits, b,
                                                  o);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As lh_fp_chain, for the Fp2 element a0 + a1 u; writes o0, o1.  One form:
// 16 threads per lane in blocks of kFp2Lanes lanes.
extern "C" int lh_fp2_chain(const void* tape, int n_digits, const void* a0, const void* a1,
                            void* o0, void* o1, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch_group<kFp2Lanes, kFp2ChainShared<kFp2Lanes>>(
      fp2_chain_group_kernel<kFp2Lanes>, n, static_cast<cudaStream_t>(stream),
      static_cast<const int32_t*>(tape), n_digits, static_cast<const uint32_t*>(a0),
      static_cast<const uint32_t*>(a1), static_cast<uint32_t*>(o0), static_cast<uint32_t*>(o1));
}

// As lh_fp_chain, on the 13-bit plane.
extern "C" int lh_fp_chain_mxu(const void* tape, int n_digits, const void* base, void* out,
                               int n, void* stream) {
  if (n > 0) {
    fp_chain_mxu_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tape), n_digits, static_cast<const uint32_t*>(base),
        static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// As lh_fp2_chain, on the 13-bit plane.
extern "C" int lh_fp2_chain_mxu(const void* tape, int n_digits, const void* a0, const void* a1,
                                void* o0, void* o1, int n, void* stream) {
  if (n > 0) {
    fp2_chain_mxu_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tape), n_digits, static_cast<const uint32_t*>(a0),
        static_cast<const uint32_t*>(a1), static_cast<uint32_t*>(o0),
        static_cast<uint32_t*>(o1), n);
  }
  return static_cast<int>(cudaGetLastError());
}
