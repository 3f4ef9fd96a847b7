// Generated by lighthouse_tpu_torch/crypto/bls/torch_backend/codegen.py; do not edit.
// Kernel 6: one double-and-always-add bit of the 64-bit weight scalar
// multiplication, for G1 and for G2, replacing
// lighthouse_tpu/crypto/bls/jax_backend/pallas_wsm.py:_make_step_kernel
// (_step_call).  Printed from the step programs that
// torch_backend/wsm_kernel.py records from the formulas of pallas_wsm.py
// (Jacobian double, mixed add of the affine base, the bit and infinity-flag
// selects); the plain PyTorch version runs the same programs.  Flags are
// (1, n) planes of 0/1 words, kept per lane in uint32 values.
//
// One thread per lane ran a step's products one after another, each a
// 1,703-multiply chain of one thread (1,378 for a square), with under one
// warp per SM at the path's 4,096 lanes.  Each curve now has the form that
// was the faster at that width (wsm_kernel.FORMS, PERF.md):
// * G2 (68 products) in the group form of miller_step.cu: G = 16 threads per
//   lane in blocks of 32 lanes run the products of a dependency level side
//   by side, 10 rounds of at most 16 products, each the unchanged
//   lh::mont_core of one thread; the linear ops between them are dealt to
//   the ranks, the values in 16-bit shared-memory slots (group_schedule).
// * G1 (17 products and 8 squares, in 8 rounds of at most 4: too few to
//   keep a group busy) in the cooperative form of kernel 4: 16 threads per
//   lane in blocks of 8 lanes make each product together, one after another
//   (csrc/mont_coop.cuh's tiles; the squares by the group triangle square,
//   as the reference squares G1 with _wide_square), the linear ops riding in
//   the products' phases (coop_schedule).
//
// Planes are (planes, 26, n) limb-major, so limb i of neighbouring lanes are
// neighbouring words and every load and store coalesces; each input plane
// is read once and each output plane written once.
#include "group.cuh"
#include "mont_coop.cuh"

namespace {

using lh::NL;


// The group form (csrc/group.cuh): G threads per lane, the lane's values in
// shared memory, slot k limb i of the lane at s[(k * NL + i) * kGroupLanes].
// A slot holds 16 bits: every value is quasi limbs (inputs, <= QMAX), strict
// limbs (products) or limbs after one carry pass (add, sub, neg: below
// 2^15 + 8), all below 2^16.
using lh::kGroupLanes;

__device__ __forceinline__ uint16_t* g_at(uint16_t* s, int k) { return s + k * NL * kGroupLanes; }

__device__ __forceinline__ void g_put(uint16_t* s, int k, const uint32_t (&c)[NL]) {
  uint16_t* o = g_at(s, k);
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i * kGroupLanes] = static_cast<uint16_t>(c[i]);
}

__device__ __forceinline__ void g_get(uint16_t* s, int k, uint32_t (&c)[NL]) {
  const uint16_t* a = g_at(s, k);
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = a[i * kGroupLanes];
}

// a + b, one carry pass
__device__ __noinline__ void g_add(uint16_t* s, int o, int a, int b) {
  uint32_t x[NL], y[NL];
  g_get(s, a, x);
  g_get(s, b, y);
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] += y[i];
  lh::compress1(x);
  g_put(s, o, x);
}

// a + kP - b, one carry pass (the bias dominates b limb by limb)
__device__ __noinline__ void g_sub(uint16_t* s, int o, int a, int b, int kidx) {
  uint32_t x[NL], y[NL];
  g_get(s, a, x);
  g_get(s, b, y);
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = x[i] + lh::kBias[kidx][i] - y[i];
  lh::compress1(x);
  g_put(s, o, x);
}

// kP - a, one carry pass
__device__ __noinline__ void g_neg(uint16_t* s, int o, int a, int kidx) {
  uint32_t x[NL];
  g_get(s, a, x);
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = lh::kBias[kidx][i] - x[i];
  lh::compress1(x);
  g_put(s, o, x);
}

__device__ __forceinline__ void g_sel(uint16_t* s, int o, bool take, int a, int b) {
  uint16_t* d = g_at(s, o);
  const uint16_t* x = g_at(s, take ? a : b);
#pragma unroll
  for (int i = 0; i < NL; ++i) d[i * kGroupLanes] = x[i * kGroupLanes];
}

__device__ __forceinline__ void g_one(uint16_t* s, int o) {
  uint16_t* d = g_at(s, o);
#pragma unroll
  for (int i = 0; i < NL; ++i) d[i * kGroupLanes] = static_cast<uint16_t>(lh::kOne[i]);
}

__device__ __forceinline__ void g_zero(uint16_t* s, int o) {
  uint16_t* d = g_at(s, o);
#pragma unroll
  for (int i = 0; i < NL; ++i) d[i * kGroupLanes] = 0;
}

__device__ __forceinline__ void g_load(uint16_t* s, int o, const uint32_t* base, int plane,
                                       int n, int lane) {
  uint16_t* d = g_at(s, o);
#pragma unroll
  for (int i = 0; i < NL; ++i)
    d[i * kGroupLanes] = static_cast<uint16_t>(base[(static_cast<size_t>(plane) * NL + i) * n + lane]);
}

__device__ __forceinline__ void g_store(uint32_t* base, int plane, int n, int lane, uint16_t* s,
                                        int k) {
  const uint16_t* v = g_at(s, k);
#pragma unroll
  for (int i = 0; i < NL; ++i) base[(static_cast<size_t>(plane) * NL + i) * n + lane] = v[i * kGroupLanes];
}

__device__ __noinline__ void g_mul(uint16_t* s, int o, int a, int b) {
  uint32_t x[NL], y[NL], r[NL];
  g_get(s, a, x);
  g_get(s, b, y);
  lh::mont_core(x, y, r);
  g_put(s, o, r);
}


// The cooperative form (kernel 4's group, csrc/mont_coop.cuh): kCoopRanks
// threads per lane in blocks of kCoopLanes lanes make each product together,
// one after another, in five phases (t = a * b, or the triangle square; m;
// u = m * P; the tail's sums; its carry into the output), every operand a
// shared-memory array of 28 words (limbs 26 and 27 zero).  A step is a table
// of phases (codegen.coop_schedule): row p holds the product's stage and its
// arrays, then the linear ops that ride in the phase, each packed in 32 bits
// (coop_lin).  One loop over the rows runs the step, so the code holds one
// copy of each tile.
using lh::coop::Arena;
using lh::coop::Lane;
using lh::coop::NP;
using lh::coop::Work;

constexpr int kCoopRanks = 16;  // Shape<16>; the square's tiles need 16
constexpr int kCoopLanes = 8;  // lanes per block
// Shared words per block for `Arrays` arrays a lane: the lanes' arrays and
// one product's work after them, then P' and P (28 words each).
template <int Arrays>
constexpr int kCoopShared =
    (Arrays * NP + lh::coop::kWorkWords<kCoopRanks>) * lh::kLanes<kCoopLanes> + 2 * NP;

// A phase's product stage (word 0 of a row): bits 0-2 the stage, bits 8-15,
// 16-23, 24-31 the arrays o, a, b.
enum : uint32_t { kStageNone, kStageT, kStageSqr, kStageM, kStageU, kStageSums, kStageCarry };
// A linear op: bits 0-2 the kind, bits 3-5 the bias row of lh::kBias (sub,
// neg) or the flag bit (sel), bits 8-15, 16-23, 24-31 the arrays o, a, b; a
// store writes array o to the output plane a.  0 ends a row.
enum : uint32_t { kLinNone, kLinAdd, kLinSub, kLinNeg, kLinSel, kLinOne, kLinZero, kLinStore };

// A lane's group: its arrays, one product's work, the block's P' and P.
struct Coop {
  Arena<kCoopLanes> ar;
  Work w;
  uint32_t* pp;
  __device__ __forceinline__ Lane arr(uint32_t j) const { return ar.arr(static_cast<int>(j)); }
};

// Rank r's share of the linear op `op`; `flags` holds the lane's flag bits.
__device__ __forceinline__ void coop_lin(int r, const Coop& c, uint32_t op, uint32_t flags,
                                         uint32_t* out, int n, int lane, bool live) {
  const Lane o = c.arr(op >> 8 & 255u), a = c.arr(op >> 16 & 255u), b = c.arr(op >> 24);
  const uint32_t q = op >> 3 & 7u;
  switch (op & 7u) {
    case kLinAdd:
      lh::coop::pass<kCoopRanks>(r, o, [&](int k) { return a(k) + b(k); });
      break;
    case kLinSub:  // a + kP - b (the bias dominates b limb by limb)
      lh::coop::pass<kCoopRanks>(r, o, [&](int k) { return a(k) + lh::kBias[q][k] - b(k); });
      break;
    case kLinNeg:  // kP - a
      lh::coop::pass<kCoopRanks>(r, o, [&](int k) { return lh::kBias[q][k] - a(k); });
      break;
    case kLinSel: {
      const Lane x = (flags >> q & 1u) ? a : b;
      for (int k = r; k < NL; k += kCoopRanks) o(k) = x(k);
      break;
    }
    case kLinOne:
      for (int k = r; k < NL; k += kCoopRanks) o(k) = lh::kOne[k];
      break;
    case kLinZero:
      for (int k = r; k < NL; k += kCoopRanks) o(k) = 0;
      break;
    case kLinStore:
      for (int k = r; k < NL; k += kCoopRanks)
        if (live) out[(static_cast<size_t>(op >> 16 & 255u) * NL + k) * n + lane] = o(k);
      break;
    default:
      break;
  }
}

// The setup phase, rank r's share: zero every array's pads, clear the column
// sums, fill P' and P.
__device__ __forceinline__ void coop_setup(int r, const Coop& c, int arrays) {
  for (int j = r; j < arrays; j += kCoopRanks) c.ar.arr(j)(NL) = c.ar.arr(j)(NL + 1) = 0;
  lh::coop::clear_sums<kCoopRanks>(r, c.w);
  lh::coop::fill_constants<kCoopRanks, kCoopLanes>(r, c.pp, c.pp + NP);
}

// Limbs r, r + 16 of plane `plane` of a (planes, 26, n) input into array j.
__device__ __forceinline__ void coop_load(int r, const Coop& c, int j, const uint32_t* in,
                                          int plane, int n, int lane) {
  for (int k = r; k < NL; k += kCoopRanks)
    c.ar.arr(j)(k) = in[(static_cast<size_t>(plane) * NL + k) * n + lane];
}

// Rank r's share of one phase (row: the product's stage, then up to K
// linear ops).
template <int K>
__device__ __forceinline__ void coop_phase(int r, const Coop& c, const uint32_t* row,
                                           uint32_t flags, uint32_t* out, int n, int lane,
                                           bool live) {
  const uint32_t pw = row[0];
  const Lane o = c.arr(pw >> 8 & 255u), a = c.arr(pw >> 16 & 255u), b = c.arr(pw >> 24);
  const Work& w = c.w;
  switch (pw & 7u) {
    case kStageT:
      lh::coop::t_tile<kCoopRanks>(r, a, b, w.tsums);
      break;
    case kStageSqr:
      lh::coop::sq_tile<kCoopRanks>(r, a, w.tsums);
      break;
    case kStageM:
      lh::coop::m_tile<kCoopRanks>(r, w.tsums, c.pp, w.msums);
      break;
    case kStageU:
      lh::coop::u_tile<kCoopRanks>(r, w.msums, c.pp + NP, w.usums);
      break;
    case kStageSums:
      lh::coop::tail_sums<kCoopRanks>(r, w.tsums, w.usums, w.s, w.cmap);
      break;
    case kStageCarry:  // the sums cleared for the next product beside the carry
      lh::coop::tail_carry<kCoopRanks>(r, w.s, w.cmap, o, true);
      lh::coop::clear_sums<kCoopRanks>(r, w);
      break;
    default:
      break;
  }
  for (int i = 1; i <= K && row[i]; ++i) coop_lin(r, c, row[i], flags, out, n, lane, live);
}

}  // namespace

// wsm_step_g2_g16: 227 limb ops, 68 Montgomery products;
// 16 threads per lane, 10 rounds of products in 48 phases, 35 slots
// (58,240 bytes of shared memory per block of 32 lanes).
static __global__ void __launch_bounds__(16 * lh::kGroupLanes)
wsm_step_g2_g16_kernel(const uint32_t* __restrict__ acc, const uint32_t* __restrict__ inf_acc, const uint32_t* __restrict__ base, const uint32_t* __restrict__ inf_base, const uint32_t* __restrict__ bit, uint32_t* __restrict__ acc_out, uint32_t* __restrict__ inf_out, int n) {
  LH_GROUP_SHARED(uint16_t, slots, 910);
  const int gl = lh::group_lane();
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
  uint16_t* const s = slots + lh::group_slot();
  const uint32_t f7 = inf_acc[lane];
  const uint32_t f12 = inf_base[lane];
  const uint32_t f13 = bit[lane];
  const uint32_t f219 = f7 & f12;
  const uint32_t f226 = f13 != 0 ? f219 : f7;
  if (live && lh::group_rank() == 0) inf_out[lane] = f226;
  // phase 1: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_load(s, 0, acc, 0, n, lane);
      break;
    case 1:
      g_load(s, 1, acc, 1, n, lane);
      break;
    case 2:
      g_load(s, 2, acc, 2, n, lane);
      break;
    case 3:
      g_load(s, 3, acc, 3, n, lane);
      break;
    case 4:
      g_load(s, 4, acc, 4, n, lane);
      break;
    case 5:
      g_load(s, 5, acc, 5, n, lane);
      break;
    default:
      break;
  })
  // phase 2: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 6, 0, 1, 1);  // k=4
      break;
    case 1:
      g_add(s, 7, 0, 1);
      break;
    case 2:
      g_sub(s, 8, 2, 3, 1);  // k=4
      break;
    case 3:
      g_add(s, 9, 2, 3);
      break;
    case 4:
      g_add(s, 10, 2, 3);
      break;
    case 5:
      g_add(s, 11, 4, 5);
      break;
    default:
      break;
  })
  // phase 3: round 1 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 12, 6, 7);
      break;
    case 1:
      g_mul(s, 13, 0, 1);
      break;
    case 2:
      g_mul(s, 14, 8, 9);
      break;
    case 3:
      g_mul(s, 15, 2, 3);
      break;
    case 4:
      g_mul(s, 16, 2, 4);
      break;
    case 5:
      g_mul(s, 17, 3, 5);
      break;
    case 6:
      g_mul(s, 18, 10, 11);
      break;
    default:
      break;
  })
  // phase 4: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_one(s, 2);
      break;
    case 1:
      g_add(s, 3, 13, 13);
      break;
    case 2:
      g_add(s, 4, 15, 15);
      break;
    case 3:
      g_sub(s, 5, 16, 17, 0);  // k=2
      break;
    case 4:
      g_add(s, 6, 16, 17);
      break;
    case 5:
      g_add(s, 7, 12, 12);
      break;
    case 6:
      g_add(s, 8, 0, 14);
      break;
    default:
      break;
  })
  // phase 5: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 0, 18, 6, 1);  // k=4
      break;
    case 1:
      g_add(s, 13, 3, 3);
      break;
    case 2:
      g_add(s, 15, 7, 12);
      break;
    case 3:
      g_add(s, 16, 1, 4);
      break;
    case 4:
      g_sub(s, 17, 14, 4, 1);  // k=4
      break;
    case 5:
      g_add(s, 9, 14, 4);
      break;
    case 6:
      g_add(s, 10, 5, 5);
      break;
    default:
      break;
  })
  // phase 6: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 1, 13, 3);
      break;
    case 1:
      g_sub(s, 5, 8, 16, 2);  // k=8
      break;
    case 2:
      g_add(s, 6, 8, 16);
      break;
    case 3:
      g_add(s, 7, 0, 0);
      break;
    default:
      break;
  })
  // phase 7: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 0, 15, 1, 2);  // k=8
      break;
    case 1:
      g_add(s, 13, 15, 1);
      break;
    default:
      break;
  })
  // phase 8: round 2 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 18, 17, 9);
      break;
    case 1:
      g_mul(s, 11, 14, 4);
      break;
    case 2:
      g_mul(s, 19, 5, 6);
      break;
    case 3:
      g_mul(s, 20, 8, 16);
      break;
    case 4:
      g_mul(s, 21, 0, 13);
      break;
    case 5:
      g_mul(s, 22, 15, 1);
      break;
    case 6:
      g_mul(s, 23, 10, 2);
      break;
    case 7:
      g_mul(s, 24, 7, 2);
      break;
    default:
      break;
  })
  // phase 9: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 0, 11, 11);
      break;
    case 1:
      g_add(s, 4, 20, 20);
      break;
    case 2:
      g_add(s, 5, 22, 22);
      break;
    case 3:
      g_sub(s, 6, 19, 12, 0);  // k=2
      break;
    case 4:
      g_sub(s, 7, 23, 24, 1);  // k=4
      break;
    case 5:
      g_add(s, 8, 23, 24);
      break;
    default:
      break;
  })
  // phase 10: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 11, 4, 3, 1);  // k=4
      break;
    case 1:
      g_sub(s, 12, 6, 18, 0);  // k=2
      break;
    default:
      break;
  })
  // phase 11: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 3, 11, 0, 1);  // k=4
      break;
    case 1:
      g_add(s, 4, 12, 12);
      break;
    default:
      break;
  })
  // phase 12: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 11, 3, 3);
      break;
    case 1:
      g_add(s, 12, 4, 4);
      break;
    default:
      break;
  })
  // phase 13: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 3, 11, 11);
      break;
    case 1:
      g_sub(s, 6, 21, 12, 4);  // k=32
      break;
    default:
      break;
  })
  // phase 14: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 12, 5, 3, 5);  // k=64
      break;
    case 1:
      g_sub(s, 21, 4, 6, 5);  // k=64
      break;
    default:
      break;
  })
  // phase 15: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 3, 11, 12, 6);  // k=128
      break;
    default:
      break;
  })
  // phase 16: round 3 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 11, 21, 2);
      break;
    case 1:
      g_mul(s, 4, 3, 2);
      break;
    case 2:
      g_mul(s, 5, 6, 2);
      break;
    case 3:
      g_mul(s, 19, 12, 2);
      break;
    case 4:
      g_mul(s, 20, 7, 8);
      break;
    case 5:
      g_mul(s, 22, 23, 24);
      break;
    default:
      break;
  })
  // phase 17: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_load(s, 3, base, 0, n, lane);
      break;
    case 1:
      g_load(s, 6, base, 1, n, lane);
      break;
    case 2:
      g_add(s, 7, 15, 1);
      break;
    case 3:
      g_add(s, 8, 11, 4);
      break;
    case 4:
      g_add(s, 12, 22, 22);
      break;
    case 5:
      g_add(s, 21, 23, 24);
      break;
    default:
      break;
  })
  // phase 18: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 22, 3, 6);
      break;
    case 1:
      g_add(s, 9, 20, 12);
      break;
    case 2:
      g_add(s, 10, 20, 12);
      break;
    default:
      break;
  })
  // phase 19: round 4 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 13, 15, 11);
      break;
    case 1:
      g_mul(s, 14, 1, 4);
      break;
    case 2:
      g_mul(s, 16, 7, 8);
      break;
    case 3:
      g_mul(s, 17, 3, 20);
      break;
    case 4:
      g_mul(s, 25, 6, 12);
      break;
    case 5:
      g_mul(s, 26, 22, 9);
      break;
    case 6:
      g_mul(s, 27, 23, 20);
      break;
    case 7:
      g_mul(s, 28, 24, 12);
      break;
    case 8:
      g_mul(s, 29, 21, 10);
      break;
    default:
      break;
  })
  // phase 20: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_load(s, 1, base, 2, n, lane);
      break;
    case 1:
      g_load(s, 4, base, 3, n, lane);
      break;
    case 2:
      g_sub(s, 7, 13, 14, 0);  // k=2
      break;
    case 3:
      g_add(s, 8, 13, 14);
      break;
    case 4:
      g_add(s, 9, 18, 18);
      break;
    case 5:
      g_add(s, 10, 0, 0);
      break;
    case 6:
      g_sub(s, 11, 17, 25, 0);  // k=2
      break;
    case 7:
      g_add(s, 12, 17, 25);
      break;
    case 8:
      g_sub(s, 15, 27, 28, 0);  // k=2
      break;
    case 9:
      g_add(s, 20, 27, 28);
      break;
    case 10:
      g_add(s, 21, 23, 23);
      break;
    case 11:
      g_add(s, 22, 24, 24);
      break;
    default:
      break;
  })
  // phase 21: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 0, 16, 8, 1);  // k=4
      break;
    case 1:
      g_add(s, 13, 9, 9);
      break;
    case 2:
      g_add(s, 14, 10, 10);
      break;
    case 3:
      g_sub(s, 17, 26, 12, 1);  // k=4
      break;
    case 4:
      g_sub(s, 18, 29, 20, 1);  // k=4
      break;
    case 5:
      g_add(s, 25, 1, 4);
      break;
    case 6:
      g_sub(s, 27, 11, 5, 1);  // k=4
      break;
    case 7:
      g_add(s, 28, 21, 22);
      break;
    default:
      break;
  })
  // phase 22: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 8, 13, 13);
      break;
    case 1:
      g_add(s, 9, 14, 14);
      break;
    case 2:
      g_add(s, 10, 15, 18);
      break;
    case 3:
      g_sub(s, 11, 17, 19, 1);  // k=4
      break;
    case 4:
      g_add(s, 12, 27, 27);
      break;
    default:
      break;
  })
  // phase 23: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 13, 7, 8, 3);  // k=16
      break;
    case 1:
      g_sub(s, 14, 0, 9, 4);  // k=32
      break;
    case 2:
      g_add(s, 17, 11, 11);
      break;
    case 3:
      g_add(s, 16, 27, 11);
      break;
    default:
      break;
  })
  // phase 24: round 5 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 0, 13, 2);
      break;
    case 1:
      g_mul(s, 7, 14, 2);
      break;
    case 2:
      g_mul(s, 8, 1, 15);
      break;
    case 3:
      g_mul(s, 9, 4, 18);
      break;
    case 4:
      g_mul(s, 20, 25, 10);
      break;
    case 5:
      g_mul(s, 26, 12, 2);
      break;
    case 6:
      g_mul(s, 29, 17, 2);
      break;
    case 7:
      g_mul(s, 30, 21, 27);
      break;
    case 8:
      g_mul(s, 31, 22, 11);
      break;
    case 9:
      g_mul(s, 32, 28, 16);
      break;
    default:
      break;
  })
  // phase 25: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 10, 8, 9, 0);  // k=2
      break;
    case 1:
      g_add(s, 12, 8, 9);
      break;
    case 2:
      g_sub(s, 13, 26, 29, 1);  // k=4
      break;
    case 3:
      g_add(s, 14, 26, 29);
      break;
    case 4:
      g_sub(s, 15, 30, 31, 0);  // k=2
      break;
    case 5:
      g_add(s, 16, 30, 31);
      break;
    default:
      break;
  })
  // phase 26: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 8, 20, 12, 1);  // k=4
      break;
    case 1:
      g_sub(s, 9, 10, 0, 1);  // k=4
      break;
    case 2:
      g_sub(s, 30, 32, 16, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 27: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 10, 8, 7, 1);  // k=4
      break;
    case 1:
      g_add(s, 12, 9, 9);
      break;
    default:
      break;
  })
  // phase 28: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 8, 10, 10);
      break;
    default:
      break;
  })
  // phase 29: round 6 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 10, 13, 14);
      break;
    case 1:
      g_mul(s, 9, 26, 29);
      break;
    case 2:
      g_mul(s, 16, 12, 2);
      break;
    case 3:
      g_mul(s, 20, 8, 2);
      break;
    case 4:
      g_mul(s, 32, 12, 2);
      break;
    case 5:
      g_mul(s, 31, 8, 2);
      break;
    case 6:
      g_mul(s, 17, 15, 2);
      break;
    case 7:
      g_mul(s, 18, 30, 2);
      break;
    default:
      break;
  })
  // phase 30: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 8, 9, 9);
      break;
    case 1:
      g_add(s, 12, 27, 11);
      break;
    case 2:
      g_add(s, 13, 5, 19);
      break;
    case 3:
      g_sub(s, 14, 16, 20, 1);  // k=4
      break;
    case 4:
      g_add(s, 15, 16, 20);
      break;
    default:
      break;
  })
  // phase 31: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 9, 10, 8);
      break;
    case 1:
      g_add(s, 26, 10, 8);
      break;
    default:
      break;
  })
  // phase 32: round 7 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 29, 27, 10);
      break;
    case 1:
      g_mul(s, 30, 11, 8);
      break;
    case 2:
      g_mul(s, 21, 12, 9);
      break;
    case 3:
      g_mul(s, 22, 5, 10);
      break;
    case 4:
      g_mul(s, 25, 19, 8);
      break;
    case 5:
      g_mul(s, 28, 13, 26);
      break;
    case 6:
      g_mul(s, 33, 14, 15);
      break;
    case 7:
      g_mul(s, 34, 16, 20);
      break;
    default:
      break;
  })
  // phase 33: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 8, 29, 30, 0);  // k=2
      break;
    case 1:
      g_add(s, 9, 29, 30);
      break;
    case 2:
      g_sub(s, 10, 22, 25, 0);  // k=2
      break;
    case 3:
      g_add(s, 11, 22, 25);
      break;
    case 4:
      g_add(s, 12, 34, 34);
      break;
    case 5:
      g_add(s, 13, 0, 7);
      break;
    default:
      break;
  })
  // phase 34: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 22, 21, 9, 1);  // k=4
      break;
    case 1:
      g_sub(s, 25, 28, 11, 1);  // k=4
      break;
    case 2:
      g_sub(s, 29, 33, 8, 1);  // k=4
      break;
    case 3:
      g_add(s, 30, 10, 10);
      break;
    default:
      break;
  })
  // phase 35: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 9, 12, 22, 2);  // k=8
      break;
    case 1:
      g_add(s, 11, 25, 25);
      break;
    case 2:
      g_sub(s, 21, 29, 30, 2);  // k=8
      break;
    case 3:
      g_add(s, 28, 8, 22);
      break;
    default:
      break;
  })
  // phase 36: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 12, 9, 11, 3);  // k=16
      break;
    case 1:
      g_sub(s, 29, 10, 21, 3);  // k=16
      break;
    default:
      break;
  })
  // phase 37: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 9, 25, 12, 4);  // k=32
      break;
    default:
      break;
  })
  // phase 38: round 8 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 25, 29, 2);
      break;
    case 1:
      g_mul(s, 10, 9, 2);
      break;
    case 2:
      g_mul(s, 11, 0, 8);
      break;
    case 3:
      g_mul(s, 30, 7, 22);
      break;
    case 4:
      g_mul(s, 33, 13, 28);
      break;
    case 5:
      g_mul(s, 34, 21, 2);
      break;
    case 6:
      g_mul(s, 14, 12, 2);
      break;
    default:
      break;
  })
  // phase 39: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 8, 32, 31);
      break;
    case 1:
      g_add(s, 9, 25, 10);
      break;
    default:
      break;
  })
  // phase 40: round 9 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 12, 32, 25);
      break;
    case 1:
      g_mul(s, 13, 31, 10);
      break;
    case 2:
      g_mul(s, 21, 8, 9);
      break;
    default:
      break;
  })
  // phase 41: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 8, 12, 13, 0);  // k=2
      break;
    case 1:
      g_add(s, 9, 12, 13);
      break;
    case 2:
      g_sub(s, 10, 11, 30, 0);  // k=2
      break;
    case 3:
      g_add(s, 25, 11, 30);
      break;
    default:
      break;
  })
  // phase 42: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 11, 21, 9, 1);  // k=4
      break;
    case 1:
      g_sub(s, 12, 33, 25, 1);  // k=4
      break;
    case 2:
      g_add(s, 13, 10, 10);
      break;
    default:
      break;
  })
  // phase 43: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 9, 12, 12);
      break;
    case 1:
      g_sub(s, 10, 8, 13, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 44: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 8, 11, 9, 3);  // k=16
      break;
    default:
      break;
  })
  // phase 45: round 10 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 9, 10, 2);
      break;
    case 1:
      g_mul(s, 11, 8, 2);
      break;
    default:
      break;
  })
  // phase 46: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sel(s, 8, f12 != 0, 5, 34);
      break;
    case 1:
      g_sel(s, 10, f12 != 0, 19, 14);
      break;
    case 2:
      g_sel(s, 12, f12 != 0, 0, 9);
      break;
    case 3:
      g_sel(s, 13, f12 != 0, 7, 11);
      break;
    case 4:
      g_sel(s, 21, f12 != 0, 23, 17);
      break;
    case 5:
      g_sel(s, 25, f12 != 0, 24, 18);
      break;
    case 6:
      g_zero(s, 33);
      break;
    default:
      break;
  })
  // phase 47: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sel(s, 9, f7 != 0, 3, 8);
      break;
    case 1:
      g_sel(s, 11, f7 != 0, 6, 10);
      break;
    case 2:
      g_sel(s, 14, f7 != 0, 1, 12);
      break;
    case 3:
      g_sel(s, 17, f7 != 0, 4, 13);
      break;
    case 4:
      g_sel(s, 18, f7 != 0, 2, 21);
      break;
    case 5:
      g_sel(s, 34, f7 != 0, 33, 25);
      break;
    default:
      break;
  })
  // phase 48: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sel(s, 1, f13 != 0, 9, 5);
      if (live) g_store(acc_out, 0, n, lane, s, 1);
      break;
    case 1:
      g_sel(s, 2, f13 != 0, 11, 19);
      if (live) g_store(acc_out, 1, n, lane, s, 2);
      break;
    case 2:
      g_sel(s, 3, f13 != 0, 14, 0);
      if (live) g_store(acc_out, 2, n, lane, s, 3);
      break;
    case 3:
      g_sel(s, 4, f13 != 0, 17, 7);
      if (live) g_store(acc_out, 3, n, lane, s, 4);
      break;
    case 4:
      g_sel(s, 6, f13 != 0, 18, 23);
      if (live) g_store(acc_out, 4, n, lane, s, 6);
      break;
    case 5:
      g_sel(s, 8, f13 != 0, 34, 24);
      if (live) g_store(acc_out, 5, n, lane, s, 8);
      break;
    default:
      break;
  })
}

extern "C" int lh_wsm_step_g2_g16(const void* acc, const void* inf_acc, const void* base, const void* inf_base, const void* bit, void* acc_out, void* inf_out, int n,
                              void* stream) {
  constexpr int kShared = 910 * 2 * lh::kGroupLanes;
  static_assert(kShared <= 232448, "one block's shared memory on sm_90");
  const cudaError_t attr = lh::set_shared_limit(wsm_step_g2_g16_kernel, kShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n > 0) {
    wsm_step_g2_g16_kernel<<<(n + lh::kGroupLanes - 1) / lh::kGroupLanes, 16 * lh::kGroupLanes,
                          kShared, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(acc), static_cast<const uint32_t*>(inf_acc), static_cast<const uint32_t*>(base), static_cast<const uint32_t*>(inf_base), static_cast<const uint32_t*>(bit),
        static_cast<uint32_t*>(acc_out), static_cast<uint32_t*>(inf_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// wsm_step_g1_coop: 70 limb ops, 17 Montgomery products, 8 squares;
// 16 threads per lane in blocks of 8 lanes, the products one after
// another in 129 phases (the setup, 25 x 5, 3 more for the
// outputs' tails), 13 arrays (20,192 bytes of shared
// memory per block).
__constant__ uint32_t kWsmStepG1Coop[128][7] = {
    {1282, 0, 0, 0, 0, 0, 0},
    {1283, 0, 0, 0, 0, 0, 0},
    {1284, 0, 0, 0, 0, 0, 0},
    {1285, 0, 0, 0, 0, 0, 0},
    {1286, 0, 0, 0, 0, 0, 0},
    {16844290, 0, 0, 0, 0, 0, 0},
    {16844291, 0, 0, 0, 0, 0, 0},
    {16844292, 0, 0, 0, 0, 0, 0},
    {16844293, 0, 0, 0, 0, 0, 0},
    {16844294, 0, 0, 0, 0, 0, 0},
    {33620225, 0, 0, 0, 0, 0, 0},
    {33620227, 0, 0, 0, 0, 0, 0},
    {33620228, 0, 0, 0, 0, 0, 0},
    {33620229, 0, 0, 0, 0, 0, 0},
    {33620230, 0, 0, 0, 0, 0, 0},
    {101058306, 0, 0, 0, 0, 0, 0},
    {101058307, 0, 0, 0, 0, 0, 0},
    {101058308, 0, 0, 0, 0, 0, 0},
    {101058309, 0, 0, 0, 0, 0, 0},
    {101058310, 100663809, 0, 0, 0, 0, 0},
    {33687042, 0, 0, 0, 0, 0, 0},
    {33687043, 0, 0, 0, 0, 0, 0},
    {33687044, 0, 0, 0, 0, 0, 0},
    {33687045, 84214273, 0, 0, 0, 0, 0},
    {33687046, 84017153, 0, 0, 0, 0, 0},
    {2050, 0, 0, 0, 0, 0, 0},
    {2051, 0, 0, 0, 0, 0, 0},
    {2052, 0, 0, 0, 0, 0, 0},
    {2053, 0, 0, 0, 0, 0, 0},
    {2054, 517, 84281602, 16845313, 0, 0, 0},
    {34211841, 118030594, 0, 0, 0, 0, 0},
    {34211843, 16845057, 0, 0, 0, 0, 0},
    {34211844, 151585025, 0, 0, 0, 0, 0},
    {34211845, 17304098, 0, 0, 0, 0, 0},
    {34211846, 168362282, 0, 0, 0, 0, 0},
    {33620225, 0, 0, 0, 0, 0, 0},
    {33620227, 0, 0, 0, 0, 0, 0},
    {33620228, 0, 0, 0, 0, 0, 0},
    {33620229, 0, 0, 0, 0, 0, 0},
    {33620230, 0, 0, 0, 0, 0, 0},
    {134744322, 0, 0, 0, 0, 0, 0},
    {134744323, 0, 0, 0, 0, 0, 0},
    {134744324, 0, 0, 0, 0, 0, 0},
    {134744325, 0, 0, 0, 0, 0, 0},
    {134744326, 0, 0, 0, 0, 0, 0},
    {16777217, 0, 0, 0, 0, 0, 0},
    {16777219, 0, 0, 0, 0, 0, 0},
    {16777220, 0, 0, 0, 0, 0, 0},
    {16777221, 0, 0, 0, 0, 0, 0},
    {16777222, 0, 0, 0, 0, 0, 0},
    {34212353, 0, 0, 0, 0, 0, 0},
    {34212355, 0, 0, 0, 0, 0, 0},
    {34212356, 0, 0, 0, 0, 0, 0},
    {34212357, 0, 0, 0, 0, 0, 0},
    {34212358, 0, 0, 0, 0, 0, 0},
    {151191809, 0, 0, 0, 0, 0, 0},
    {151191811, 0, 0, 0, 0, 0, 0},
    {151191812, 0, 0, 0, 0, 0, 0},
    {151191813, 0, 0, 0, 0, 0, 0},
    {151191814, 0, 0, 0, 0, 0, 0},
    {151520513, 0, 0, 0, 0, 0, 0},
    {151520515, 117901569, 0, 0, 0, 0, 0},
    {151520516, 151586561, 0, 0, 0, 0, 0},
    {151520517, 117901569, 0, 0, 0, 0, 0},
    {151520518, 150996762, 0, 0, 0, 0, 0},
    {34014977, 0, 0, 0, 0, 0, 0},
    {34014979, 0, 0, 0, 0, 0, 0},
    {34014980, 0, 0, 0, 0, 0, 0},
    {34014981, 0, 0, 0, 0, 0, 0},
    {34014982, 0, 0, 0, 0, 0, 0},
    {84148481, 0, 0, 0, 0, 0, 0},
    {84148483, 0, 0, 0, 0, 0, 0},
    {84148484, 0, 0, 0, 0, 0, 0},
    {84148485, 167838986, 0, 0, 0, 0, 0},
    {84148486, 84213761, 0, 0, 0, 0, 0},
    {2, 0, 0, 0, 0, 0, 0},
    {3, 0, 0, 0, 0, 0, 0},
    {4, 0, 0, 0, 0, 0, 0},
    {5, 0, 0, 0, 0, 0, 0},
    {6, 0, 0, 0, 0, 0, 0},
    {329985, 0, 0, 0, 0, 0, 0},
    {329987, 0, 0, 0, 0, 0, 0},
    {329988, 0, 0, 0, 0, 0, 0},
    {329989, 0, 0, 0, 0, 0, 0},
    {329990, 0, 0, 0, 0, 0, 0},
    {656897, 0, 0, 0, 0, 0, 0},
    {656899, 0, 0, 0, 0, 0, 0},
    {656900, 0, 0, 0, 0, 0, 0},
    {656901, 117506058, 0, 0, 0, 0, 0},
    {656902, 257, 0, 0, 0, 0, 0},
    {16842754, 0, 0, 0, 0, 0, 0},
    {16842755, 0, 0, 0, 0, 0, 0},
    {16842756, 0, 0, 0, 0, 0, 0},
    {16842757, 0, 0, 0, 0, 0, 0},
    {16842758, 0, 0, 0, 0, 0, 0},
    {151456769, 0, 0, 0, 0, 0, 0},
    {151456771, 0, 0, 0, 0, 0, 0},
    {151456772, 150997762, 101059585, 0, 0, 0, 0},
    {151456773, 202047498, 0, 0, 0, 0, 0},
    {151456774, 396050, 0, 0, 0, 0, 0},
    {184615169, 0, 0, 0, 0, 0, 0},
    {184615171, 0, 0, 0, 0, 0, 0},
    {184615172, 0, 0, 0, 0, 0, 0},
    {184615173, 0, 0, 0, 0, 0, 0},
    {184615174, 134744833, 0, 0, 0, 0, 0},
    {84608257, 0, 0, 0, 0, 0, 0},
    {84608259, 0, 0, 0, 0, 0, 0},
    {84608260, 0, 0, 0, 0, 0, 0},
    {84608261, 0, 0, 0, 0, 0, 0},
    {84608262, 0, 0, 0, 0, 0, 0},
    {33557249, 0, 0, 0, 0, 0, 0},
    {33557251, 0, 0, 0, 0, 0, 0},
    {33557252, 0, 0, 0, 0, 0, 0},
    {33557253, 202113025, 0, 0, 0, 0, 0},
    {33557254, 68618, 0, 0, 0, 0, 0},
    {34343937, 0, 0, 0, 0, 0, 0},
    {34343939, 0, 0, 0, 0, 0, 0},
    {34343940, 0, 0, 0, 0, 0, 0},
    {34343941, 0, 0, 0, 0, 0, 0},
    {34343942, 0, 0, 0, 0, 0, 0},
    {33883393, 0, 0, 0, 0, 0, 0},
    {33883395, 0, 0, 0, 0, 0, 0},
    {33883396, 0, 0, 0, 0, 0, 0},
    {33883397, 0, 0, 0, 0, 0, 0},
    {33883398, 0, 0, 0, 0, 0, 0},
    {0, 185204748, 201785612, 84411916, 0, 0, 0},
    {0, 197892, 17042180, 100797444, 0, 0, 0},
    {0, 168099860, 7, 118161684, 65799, 135004692, 131591}};

static __global__ void __launch_bounds__(kCoopRanks * kCoopLanes)
wsm_step_g1_coop_kernel(const uint32_t* __restrict__ acc, const uint32_t* __restrict__ inf_acc, const uint32_t* __restrict__ base, const uint32_t* __restrict__ inf_base, const uint32_t* __restrict__ bit, uint32_t* __restrict__ acc_out, uint32_t* __restrict__ inf_out, int n) {
  LH_GROUP_SHARED(uint32_t, sm, kCoopShared<13>);
  const int gl = lh::group_lane<kCoopLanes>();
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
  const Arena<kCoopLanes> ar{sm + lh::group_slot<kCoopLanes>()};
  const Coop c{ar, ar.work<kCoopRanks>(13 * NP),
               sm + kCoopShared<13> - 2 * NP};
  const uint32_t f4 = inf_acc[lane];
  const uint32_t f7 = inf_base[lane];
  const uint32_t f8 = bit[lane];
  const uint32_t f65 = f4 & f7;
  const uint32_t f69 = f8 != 0 ? f65 : f4;
  if (live && lh::group_rank<kCoopLanes>() == 0) inf_out[lane] = f69;
  const uint32_t flags = (f4 != 0u) << 0 | (f7 != 0u) << 1 | (f8 != 0u) << 2 | (f65 != 0u) << 3 | (f69 != 0u) << 4;
  LH_RANKS_OF(kCoopRanks, kCoopLanes, coop_setup(r, c, 13);
        coop_load(r, c, 0, acc, 0, n, lane);
        coop_load(r, c, 1, acc, 1, n, lane);
        coop_load(r, c, 2, acc, 2, n, lane);
        coop_load(r, c, 3, base, 0, n, lane);
        coop_load(r, c, 4, base, 1, n, lane);)
#pragma unroll 1
  for (int p = 0; p < 128; ++p) {
    LH_RANKS_OF(kCoopRanks, kCoopLanes,
                coop_phase<6>(r, c, kWsmStepG1Coop[p], flags, acc_out, n, lane, live))
  }
}

extern "C" int lh_wsm_step_g1_coop(const void* acc, const void* inf_acc, const void* base, const void* inf_base, const void* bit, void* acc_out, void* inf_out, int n,
                              void* stream) {
  constexpr int kShared = kCoopShared<13> * 4;
  static_assert(kShared <= 232448, "one block's shared memory on sm_90");
  const cudaError_t attr = lh::set_shared_limit(wsm_step_g1_coop_kernel, kShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n > 0) {
    wsm_step_g1_coop_kernel<<<(n + kCoopLanes - 1) / kCoopLanes, kCoopRanks * kCoopLanes, kShared,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(acc), static_cast<const uint32_t*>(inf_acc), static_cast<const uint32_t*>(base), static_cast<const uint32_t*>(inf_base), static_cast<const uint32_t*>(bit),
        static_cast<uint32_t*>(acc_out), static_cast<uint32_t*>(inf_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
