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
// The MXU variants (the reference's chain kernels built with mxu=True) run
// the 15-bit chains' group forms with every product on the 13-bit plane:
// mxu_coop.cuh's mont_group_mxu_core, G ranks per lane, one rank per warp,
// in blocks of 32 lanes, so every mma.sync is warp-uniform (the digit tape is
// the same for every lane, and the tail lanes run lane n - 1's operands
// again and store nothing).  The Fp chain (fp_chain_mxu_group_kernel) squares
// with the full product mont(a, a), as the reference does under MXU
// (pallas_fp._core_pair); the Fp2 chain (fp2_chain_mxu_group_kernel) keeps
// its cores.  Both call the core through one __noinline__ mul13<G>, so the
// code holds one copy of it.  One chain body per field serves both planes
// (fp_chain_group, fp2_chain_group over Group<L> or GroupMxu<G>).
//
// What bounds it on the card: integer multiplies.  One Fp lane of the p-2
// chain does 14 + 95 * 5 products (about 0.75M 32-bit multiplies) against
// 208 bytes of traffic.  A lane's chain is a serial sequence of products, so
// the group form puts G threads on each product (G times the warps of one
// thread per lane, each thread forming a tile of it) and keeps every operand
// in shared memory; what is left is the five barrier phases per product
// (eight on the 13-bit plane).
#include "mont_coop.cuh"
#include "mxu_coop.cuh"

namespace {

using lh::NL;

constexpr int kWindow = 4;  // pallas_fp.CHAIN_WINDOW
constexpr int kPowers = 1 << kWindow;
constexpr int kBias2 = 0;   // row of 2P in lh::kBias (fp.BIAS_KS order)
constexpr int kBias16 = 3;  // row of 16P

// -- the chains in the group form ----------------------------------------

using lh::coop::Arena;
using lh::coop::Lane;
using lh::coop::NC;
using lh::coop::NP;
using lh::coop::NW;
using lh::coop::Work;

constexpr int kG = 16;  // threads per lane (Shape<16>; the square's tiles need 16)
// Shared words per lane of one product's work
constexpr int kWorkWords = lh::coop::kWorkWords<kG>;

// a + b, one carry pass
template <int G>
__device__ __forceinline__ void g_add(int r, Lane o, Lane a, Lane b) {
  lh::coop::pass<G>(r, o, [&](int k) { return a(k) + b(k); });
}

// a + kP - b, one carry pass (pallas_fp._sub_biased)
template <int G>
__device__ __forceinline__ void g_sub(int r, Lane o, Lane a, Lane b, int kidx) {
  lh::coop::pass<G>(r, o, [&](int k) { return a(k) + lh::kBias[kidx][k] - b(k); });
}

template <int G>
__device__ __forceinline__ void g_copy(int r, Lane o, Lane a) {
  for (int k = r; k < NL; k += G) o(k) = a(k);
}

// out = a (26, n) limb plane, live lanes only: rank r of G stores limbs r,
// r + G, ...
template <int G, int L>
__device__ __forceinline__ void g_store(uint32_t* out, int n, int lane, bool live, Lane a) {
  LH_RANKS_OF(G, L, for (int k = r; k < NL; k += G) {
    if (live) out[static_cast<size_t>(k) * n + lane] = a(k);
  })
}

// A linear op beside a product (the Fp2 cores' sums and biased differences),
// packed in 32 bits so that it passes as a value: bits 0-1 the kind (0 none,
// 1 add: o = a + b, 2 sub: o = a + kBias[bias] - b, one carry pass), bits
// 2-3 the bias row, bits 8-15, 16-23, 24-31 the arrays o, a, b by index.
__device__ __forceinline__ uint32_t lin_add(int o, int a, int b) {
  return 1u | static_cast<uint32_t>(o) << 8 | static_cast<uint32_t>(a) << 16 |
         static_cast<uint32_t>(b) << 24;
}
__device__ __forceinline__ uint32_t lin_sub(int o, int a, int b, int bias) {
  return 2u | static_cast<uint32_t>(bias) << 2 | static_cast<uint32_t>(o) << 8 |
         static_cast<uint32_t>(a) << 16 | static_cast<uint32_t>(b) << 24;
}

// Rank r of G's share of the linear op `op` on a lane's arrays.
template <int G, int L>
__device__ __forceinline__ void run_lin(int r, const Arena<L>& ar, uint32_t op) {
  const uint32_t kind = op & 3u;
  if (kind == 0) return;
  const Lane o = ar.arr((op >> 8) & 255u), a = ar.arr((op >> 16) & 255u), b = ar.arr(op >> 24);
  if (kind == 1) {
    g_add<G>(r, o, a, b);
  } else {
    g_sub<G>(r, o, a, b, (op >> 2) & 3u);
  }
}

// A lane's group of kG ranks in a block of L lanes on the 15-bit plane: its
// shared arrays and one product's work; every thread of the block runs every
// phase.
template <int L>
struct Group {
  static constexpr int kRanks = kG, kL = L;
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
  // The same on arrays by index, the linear ops f0, f1 in the t phase and l0,
  // l1 in the last (packed, lin_add / lin_sub; 0 for none).
  __device__ __forceinline__ void mul(int o, int a, int b, uint32_t f0 = 0, uint32_t f1 = 0,
                                      uint32_t l0 = 0, uint32_t l1 = 0) const {
    mul(ar.arr(o), ar.arr(a), ar.arr(b), [&](int r) {
      run_lin<kG>(r, ar, f0);
      run_lin<kG>(r, ar, f1);
    }, [&](int r) {
      run_lin<kG>(r, ar, l0);
      run_lin<kG>(r, ar, l1);
    });
  }

  // o = a * a * R^-1 by the triangle square; o may alias a
  __device__ __forceinline__ void sqr(Lane o, Lane a) const {
    lh::coop::mont_group_sqr_core<kG, L>(a, w, pp, pl, o, true, [](int) {},
                                         [&](int r) { lh::coop::clear_sums<kG>(r, w); });
  }
  // The same on arrays by index
  __device__ __forceinline__ void sqr(int o, int a) const { sqr(ar.arr(o), ar.arr(a)); }
};

// Array o = array a * array b * R^-1 on the 13-bit plane for a lane whose
// arrays start at `base` (an Arena<32>), with the block's work rows and
// tables: mont_group_mxu_core, the linear ops f0, f1 in its to13 phase and
// l0, l1 in its to15 phase.  Not inlined: the Fp2 chain's five products per
// Karatsuba multiplication and square share one copy of the core's code.
template <int G>
__device__ __noinline__ void mul13(uint32_t* base, uint32_t* work, double* tab, int o, int a,
                                   int b, uint32_t f0, uint32_t f1, uint32_t l0, uint32_t l1) {
  const Arena<32> ar{base};
  lh::coop13::mont_group_mxu_core<G>(ar.arr(a), ar.arr(b), lh::coop13::Work{work}, tab,
                                     ar.arr(o), true, [&](int r) {
    run_lin<G>(r, ar, f0);
    run_lin<G>(r, ar, f1);
  }, [&](int r) {
    run_lin<G>(r, ar, l0);
    run_lin<G>(r, ar, l1);
  });
}

// A lane's group of G ranks (one per warp) in a block of 32 lanes on the
// 13-bit plane: its shared arrays, the block's work rows and Toeplitz tables
// (mxu_coop.cuh).
template <int G>
struct GroupMxu {
  static constexpr int kRanks = G, kL = 32;
  Arena<32> ar;
  lh::coop13::Work w;
  double* tab;

  // the first phase: clear the column sums, fill the tables, and `load(r)`
  template <class Load>
  __device__ __forceinline__ void setup(int, Load load) const {
    LH_RANKS(G, lh::coop13::clear_sums<G>(r, w); lh::coop13::fill_tables<G>(r, tab); load(r))
  }

  // array o = array a * array b * R^-1 on the 13-bit plane; o may alias a
  // or b.  The linear ops f0, f1 run in the to13 phase, l0, l1 in the to15
  // phase.
  __device__ __forceinline__ void mul(int o, int a, int b, uint32_t f0 = 0, uint32_t f1 = 0,
                                      uint32_t l0 = 0, uint32_t l1 = 0) const {
    mul13<G>(ar.base, w.p, tab, o, a, b, f0, f1, l0, l1);
  }
  // array o = array a squared, as the full product (pallas_fp._core_pair
  // under MXU squares with mont(a, a)); o may alias a
  __device__ __forceinline__ void sqr(int o, int a) const { mul(o, a, a); }
};

// Per-lane arrays of the Fp chain: powers[0..15], the accumulator; then one
// product's work.
constexpr int kFpAcc = kPowers;
constexpr int kFpArrays = kPowers + 1;
constexpr int kFpChainWords = kFpArrays * NP + kWorkWords;
template <int L>
constexpr int kFpChainShared = kFpChainWords * lh::kLanes<L> + 2 * NP;

// base^e for lane `lane` by its group g (either plane): the power table,
// then four squares and a multiply per digit.
template <class Grp>
__device__ __forceinline__ void fp_chain_group(const Grp& g, const int32_t* tape, int n_digits,
                                               const uint32_t* base, uint32_t* out, int n,
                                               int lane, bool live) {
  constexpr int G = Grp::kRanks, L = Grp::kL;
  const auto& ar = g.ar;
  // powers[0] = the one, powers[1] = the base
  g.setup(kFpArrays, [&](int r) {
    for (int i = r; i < NL; i += G) {
      ar.arr(0)(i) = lh::kOne[i];
      ar.arr(1)(i) = base[static_cast<size_t>(i) * n + lane];
    }
  });
#pragma unroll 1
  for (int k = 2; k < kPowers; ++k) g.mul(k, k - 1, 1);
  const int first = tape[0];
  LH_RANKS_OF(G, L, g_copy<G>(r, ar.arr(kFpAcc), ar.arr(first)))
#pragma unroll 1
  for (int d = 1; d < n_digits; ++d) {
#pragma unroll 1
    for (int s = 0; s < kWindow; ++s) g.sqr(kFpAcc, kFpAcc);
    g.mul(kFpAcc, kFpAcc, tape[d]);
  }
  g_store<G, L>(out, n, lane, live, ar.arr(kFpAcc));
}

// base^e for lane `lane`, by the 16 threads of its group in a block of L
// lanes.
template <int L>
__global__ void __launch_bounds__(kG * L)
fp_chain_group_kernel(const int32_t* __restrict__ tape, int n_digits,
                      const uint32_t* __restrict__ base, uint32_t* __restrict__ out, int n) {
  LH_GROUP_SHARED(uint32_t, sm, kFpChainShared<L>);
  const int gl = lh::group_lane<L>();
  const bool live = gl < n;
  const Arena<L> ar{sm + lh::group_slot<L>()};
  uint32_t* const pp = sm + kFpChainWords * lh::kLanes<L>;
  const Group<L> g{ar, ar.work(kFpArrays * NP), pp, pp + NP};
  fp_chain_group(g, tape, n_digits, base, out, n, live ? gl : n - 1, live);
}

// Ranks per lane of the MXU Fp chain's one form (chain_kernel.FP_MXU_FORM,
// blocks of 32 lanes), the faster of G = 8 and G = 16 at 4,096 lanes
// (PERF.md).
constexpr int kFpMxuGroup = 8;
// The MXU Fp chain's shared words per block: the Toeplitz tables, the work
// rows, the arrays
template <int G>
constexpr int kFpMxuShared =
    lh::coop13::kTabWords + lh::coop13::kWorkWords<G> + kFpArrays * NP * lh::kGroupLanes;

// The same on the 13-bit plane, by the G ranks (warps) of its group in a
// block of 32 lanes; shared memory: the Toeplitz tables, the work rows, the
// arrays.
template <int G>
__global__ void __launch_bounds__(G * 32)
fp_chain_mxu_group_kernel(const int32_t* __restrict__ tape, int n_digits,
                          const uint32_t* __restrict__ base, uint32_t* __restrict__ out, int n) {
  LH_COOP13_SHARED(sm, kFpMxuShared<G>);
  const int gl = lh::group_lane();
  const bool live = gl < n;
  uint32_t* const work = sm + lh::coop13::kTabWords;
  const Arena<32> ar{work + lh::coop13::kWorkWords<G> + lh::group_slot()};
  const GroupMxu<G> g{ar, {work}, reinterpret_cast<double*>(sm)};
  fp_chain_group(g, tape, n_digits, base, out, n, live ? gl : n - 1, live);
}

// Per-lane arrays of the Fp2 chain: powers[0..15] of c0, of c1, the
// accumulator (c0, c1), five temporaries; then (15-bit plane) one product's
// work.
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
// Ranks per lane of the MXU Fp2 chain's one form (chain_kernel.FP2_MXU_FORM,
// blocks of 32 lanes), the faster of G = 8 and G = 16 at 4,096 lanes
// (PERF.md).
constexpr int kFp2MxuGroup = 8;
// The MXU Fp2 chain's shared words per block: the Toeplitz tables, the work
// rows, the arrays
template <int G>
constexpr int kFp2MxuShared =
    lh::coop13::kTabWords + lh::coop13::kWorkWords<G> + kFp2Arrays * NP * lh::kGroupLanes;

// (r0, r1) = (a0 + a1 u)(b0 + b1 u), Karatsuba (pallas_fp._fp2_mul_core), on
// arrays by index: v0 = a0 b0 beside sa = a0 + a1, sb = b0 + b1; m = sa sb;
// v1 = a1 b1 beside tm = m - v0 + 2P; then r0 = v0 - v1 + 2P, r1 = tm - v1 +
// 2P.  Three products and one phase (16 phases on the 15-bit plane, 25 on
// the 13-bit); (r0, r1) may alias (a0, a1), not (b0, b1).
template <class Grp>
__device__ __forceinline__ void fp2_mul_group(const Grp& g, int r0, int r1, int a0, int a1,
                                              int b0, int b1) {
  constexpr int G = Grp::kRanks;
  constexpr int sa = kFp2Tmp, sb = kFp2Tmp + 1, v0 = kFp2Tmp + 2, m = kFp2Tmp + 3,
                tm = kFp2Tmp + 4;
  constexpr int v1 = sa;  // sa is dead once m's product has read it
  g.mul(v0, a0, b0, lin_add(sa, a0, a1), lin_add(sb, b0, b1));
  g.mul(m, sa, sb);
  g.mul(v1, a1, b1, lin_sub(tm, m, v0, kBias2));
  const auto& ar = g.ar;
  LH_RANKS_OF(G, Grp::kL, g_sub<G>(r, ar.arr(r0), ar.arr(v0), ar.arr(v1), kBias2);
              g_sub<G>(r, ar.arr(r1), ar.arr(tm), ar.arr(v1), kBias2))
}

// (r0, r1) = (a0 + a1 u)^2 = ((a0 + a1)(a0 - a1 + 16P), 2 a0 a1)
// (pallas_fp._fp2_sqr_core), on arrays by index: t = a0 a1 beside s = a0 +
// a1 and d = a0 - a1 + 16P; then r0 = s d, beside r1 = t + t.  Two products
// (10 phases on the 15-bit plane, 16 on the 13-bit); may alias.
template <class Grp>
__device__ __forceinline__ void fp2_sqr_group(const Grp& g, int r0, int r1, int a0, int a1) {
  constexpr int s = kFp2Tmp, d = kFp2Tmp + 1, t = kFp2Tmp + 2;
  g.mul(t, a0, a1, lin_add(s, a0, a1), lin_sub(d, a0, a1, kBias16));
  g.mul(r0, s, d, 0, 0, lin_add(r1, t, t));
}

// (a0 + a1 u)^e for lane `lane` by its group g (either plane): the power
// table, then four squares and a multiply per digit.
template <class Grp>
__device__ __forceinline__ void fp2_chain_group(const Grp& g, const int32_t* tape, int n_digits,
                                                const uint32_t* a0, const uint32_t* a1,
                                                uint32_t* o0, uint32_t* o1, int n, int lane,
                                                bool live) {
  constexpr int G = Grp::kRanks, L = Grp::kL;
  const auto& ar = g.ar;
  // powers[k] = (array k, array kFp2Pw1 + k): [0] = (the one, 0), [1] = (a0, a1)
  g.setup(kFp2Arrays, [&](int r) {
    for (int i = r; i < NL; i += G) {
      ar.arr(0)(i) = lh::kOne[i];
      ar.arr(kFp2Pw1)(i) = 0;
      ar.arr(1)(i) = a0[static_cast<size_t>(i) * n + lane];
      ar.arr(kFp2Pw1 + 1)(i) = a1[static_cast<size_t>(i) * n + lane];
    }
  });
#pragma unroll 1
  for (int k = 2; k < kPowers; ++k)
    fp2_mul_group(g, k, kFp2Pw1 + k, k - 1, kFp2Pw1 + k - 1, 1, kFp2Pw1 + 1);
  const int first = tape[0];
  LH_RANKS_OF(G, L, g_copy<G>(r, ar.arr(kFp2C0), ar.arr(first));
              g_copy<G>(r, ar.arr(kFp2C1), ar.arr(kFp2Pw1 + first)))
#pragma unroll 1
  for (int d = 1; d < n_digits; ++d) {
#pragma unroll 1
    for (int s = 0; s < kWindow; ++s) fp2_sqr_group(g, kFp2C0, kFp2C1, kFp2C0, kFp2C1);
    const int digit = tape[d];
    fp2_mul_group(g, kFp2C0, kFp2C1, kFp2C0, kFp2C1, digit, kFp2Pw1 + digit);
  }
  g_store<G, L>(o0, n, lane, live, ar.arr(kFp2C0));
  g_store<G, L>(o1, n, lane, live, ar.arr(kFp2C1));
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
  const Arena<L> ar{sm + lh::group_slot<L>()};
  uint32_t* const pp = sm + kFp2ChainWords * lh::kLanes<L>;
  const Group<L> g{ar, ar.work(kFp2Arrays * NP), pp, pp + NP};
  fp2_chain_group(g, tape, n_digits, a0, a1, o0, o1, n, live ? gl : n - 1, live);
}

// The same on the 13-bit plane, by the G ranks (warps) of its group in a
// block of 32 lanes; shared memory: the Toeplitz tables, the work rows, the
// arrays.
template <int G>
__global__ void __launch_bounds__(G * 32)
fp2_chain_mxu_group_kernel(const int32_t* __restrict__ tape, int n_digits,
                           const uint32_t* __restrict__ a0, const uint32_t* __restrict__ a1,
                           uint32_t* __restrict__ o0, uint32_t* __restrict__ o1, int n) {
  LH_COOP13_SHARED(sm, kFp2MxuShared<G>);
  const int gl = lh::group_lane();
  const bool live = gl < n;
  uint32_t* const work = sm + lh::coop13::kTabWords;
  const Arena<32> ar{work + lh::coop13::kWorkWords<G> + lh::group_slot()};
  const GroupMxu<G> g{ar, {work}, reinterpret_cast<double*>(sm)};
  fp2_chain_group(g, tape, n_digits, a0, a1, o0, o1, n, live ? gl : n - 1, live);
}

#ifdef __CUDACC__
// Launch a group chain kernel of G threads per lane in blocks of L lanes with
// `words` of dynamic shared memory per block (the attribute set once per
// kernel and device, lh::set_shared_limit).
template <int G, int L, int Words, class Kernel, class... Args>
int launch_group(Kernel kernel, int n, cudaStream_t stream, Args... args) {
  constexpr int kShared = Words * 4;
  static_assert(kShared <= 232448, "one block's shared memory on sm_90");
  const cudaError_t attr = lh::set_shared_limit(kernel, kShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<(n + L - 1) / L, G * L, kShared, stream>>>(args..., n);
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
      return launch_group<kG, 8, kFpChainShared<8>>(fp_chain_group_kernel<8>, n, s, tp, n_digits,
                                                     b, o);
    case 16:
      return launch_group<kG, 16, kFpChainShared<16>>(fp_chain_group_kernel<16>, n, s, tp,
                                                       n_digits, b, o);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As lh_fp_chain, for the Fp2 element a0 + a1 u; writes o0, o1.  One form:
// 16 threads per lane in blocks of kFp2Lanes lanes.
extern "C" int lh_fp2_chain(const void* tape, int n_digits, const void* a0, const void* a1,
                            void* o0, void* o1, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch_group<kG, kFp2Lanes, kFp2ChainShared<kFp2Lanes>>(
      fp2_chain_group_kernel<kFp2Lanes>, n, static_cast<cudaStream_t>(stream),
      static_cast<const int32_t*>(tape), n_digits, static_cast<const uint32_t*>(a0),
      static_cast<const uint32_t*>(a1), static_cast<uint32_t*>(o0), static_cast<uint32_t*>(o1));
}

// As lh_fp_chain, on the 13-bit plane.  One form: kFpMxuGroup ranks per
// lane (one per warp) in blocks of 32 lanes.
extern "C" int lh_fp_chain_mxu(const void* tape, int n_digits, const void* base, void* out,
                               int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch_group<kFpMxuGroup, 32, kFpMxuShared<kFpMxuGroup>>(
      fp_chain_mxu_group_kernel<kFpMxuGroup>, n, static_cast<cudaStream_t>(stream),
      static_cast<const int32_t*>(tape), n_digits, static_cast<const uint32_t*>(base),
      static_cast<uint32_t*>(out));
}

// As lh_fp2_chain, on the 13-bit plane.  One form: kFp2MxuGroup ranks per
// lane (one per warp) in blocks of 32 lanes.
extern "C" int lh_fp2_chain_mxu(const void* tape, int n_digits, const void* a0, const void* a1,
                                void* o0, void* o1, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch_group<kFp2MxuGroup, 32, kFp2MxuShared<kFp2MxuGroup>>(
      fp2_chain_mxu_group_kernel<kFp2MxuGroup>, n, static_cast<cudaStream_t>(stream),
      static_cast<const int32_t*>(tape), n_digits, static_cast<const uint32_t*>(a0),
      static_cast<const uint32_t*>(a1), static_cast<uint32_t*>(o0), static_cast<uint32_t*>(o1));
}
