// Generated by lighthouse_tpu_torch/crypto/bls/torch_backend/codegen.py; do not edit.
// Kernels 2 and 3: the fused Miller doubling and addition steps, replacing
// lighthouse_tpu/crypto/bls/jax_backend/pallas_miller.py:_step_dbl_kernel and
// _step_add_kernel.  Printed from the step programs that
// torch_backend/miller_kernel.py records from the formulas of
// pallas_miller.py; the plain PyTorch version runs the same programs.
//
// Both steps run in the group form: G = 16 threads per lane
// (csrc/group.cuh; miller_kernel.DBL_GROUP, ADD_GROUP).  One thread per lane
// ran a step's 169 (dbl) or 111 (add) products one after another, each a
// 1,703-multiply chain of one thread, with one warp per SM at the Miller
// loop's 4,097 lanes: the card waited on that thread's issue rate and
// latency.  The products of one dependency level are independent, so the
// group runs them side by side: rounds of at most G products (one per
// thread, the unchanged lh::mont_core, so the bytes are the same by
// construction) and the linear ops between them dealt to the ranks, a
// barrier after each phase.  The serial chain falls from 169 products to 11
// rounds (dbl) and from 111 to 10 (add), and the card gets G times the
// warps.  The lane's values live in shared memory, 16 bits a limb, in
// slots reassigned by the phase schedule (codegen.group_schedule).
// The addition step's bit is read by every thread; its selects are linear
// ops like the others.
//
// Planes are (planes, 26, n) limb-major, so limb i of neighbouring lanes are
// neighbouring words and every load and store coalesces; each input plane
// is read once and each output plane written once.
#include "group.cuh"
#include "mont.cuh"

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


}  // namespace

// miller_step_dbl_g16: 565 limb ops, 169 Montgomery products;
// 16 threads per lane, 11 rounds of products in 51 phases, 92 slots
// (153,088 bytes of shared memory per block of 32 lanes).
static __global__ void __launch_bounds__(16 * lh::kGroupLanes)
miller_step_dbl_g16_kernel(const uint32_t* __restrict__ f, const uint32_t* __restrict__ t, const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp, uint32_t* __restrict__ f_out, uint32_t* __restrict__ t_out, int n) {
  LH_GROUP_SHARED(uint16_t, slots, 2392);
  const int gl = lh::group_lane();
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
  uint16_t* const s = slots + lh::group_slot();
  // phase 1: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_one(s, 0);
      g_load(s, 16, t, 3, n, lane);
      break;
    case 1:
      g_load(s, 1, f, 0, n, lane);
      g_load(s, 17, t, 4, n, lane);
      break;
    case 2:
      g_load(s, 2, f, 1, n, lane);
      g_load(s, 18, t, 5, n, lane);
      break;
    case 3:
      g_load(s, 3, f, 2, n, lane);
      break;
    case 4:
      g_load(s, 4, f, 3, n, lane);
      break;
    case 5:
      g_load(s, 5, f, 4, n, lane);
      break;
    case 6:
      g_load(s, 6, f, 5, n, lane);
      break;
    case 7:
      g_load(s, 7, f, 6, n, lane);
      break;
    case 8:
      g_load(s, 8, f, 7, n, lane);
      break;
    case 9:
      g_load(s, 9, f, 8, n, lane);
      break;
    case 10:
      g_load(s, 10, f, 9, n, lane);
      break;
    case 11:
      g_load(s, 11, f, 10, n, lane);
      break;
    case 12:
      g_load(s, 12, f, 11, n, lane);
      break;
    case 13:
      g_load(s, 13, t, 0, n, lane);
      break;
    case 14:
      g_load(s, 14, t, 1, n, lane);
      break;
    case 15:
      g_load(s, 15, t, 2, n, lane);
      break;
    default:
      break;
  })
  // phase 2: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 19, 13, 14, 1);  // k=4
      break;
    case 1:
      g_add(s, 20, 13, 14);
      break;
    case 2:
      g_sub(s, 21, 15, 16, 1);  // k=4
      break;
    case 3:
      g_add(s, 22, 15, 16);
      break;
    case 4:
      g_sub(s, 23, 17, 18, 1);  // k=4
      break;
    case 5:
      g_add(s, 24, 17, 18);
      break;
    case 6:
      g_add(s, 25, 1, 2);
      break;
    case 7:
      g_add(s, 26, 7, 8);
      break;
    case 8:
      g_add(s, 27, 3, 4);
      break;
    case 9:
      g_add(s, 28, 9, 10);
      break;
    case 10:
      g_sub(s, 29, 11, 12, 1);  // k=4
      break;
    case 11:
      g_add(s, 30, 11, 12);
      break;
    case 12:
      g_add(s, 31, 3, 7);
      break;
    case 13:
      g_add(s, 32, 4, 8);
      break;
    case 14:
      g_add(s, 33, 5, 9);
      break;
    case 15:
      g_add(s, 34, 6, 10);
      break;
    default:
      break;
  })
  // phase 3: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 35, 1, 29);
      break;
    case 1:
      g_add(s, 36, 2, 30);
      break;
    default:
      break;
  })
  // phase 4: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 29, 35, 31);
      break;
    case 1:
      g_add(s, 30, 36, 32);
      break;
    case 2:
      g_add(s, 37, 35, 33);
      break;
    case 3:
      g_add(s, 38, 36, 34);
      break;
    default:
      break;
  })
  // phase 5: round 1 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 39, 19, 20);
      break;
    case 1:
      g_mul(s, 40, 13, 14);
      break;
    case 2:
      g_mul(s, 41, 21, 22);
      break;
    case 3:
      g_mul(s, 42, 15, 16);
      break;
    case 4:
      g_mul(s, 43, 23, 24);
      break;
    case 5:
      g_mul(s, 44, 17, 18);
      break;
    case 6:
      g_mul(s, 45, 1, 7);
      break;
    case 7:
      g_mul(s, 46, 2, 8);
      break;
    case 8:
      g_mul(s, 47, 25, 26);
      break;
    case 9:
      g_mul(s, 48, 3, 9);
      break;
    case 10:
      g_mul(s, 49, 4, 10);
      break;
    case 11:
      g_mul(s, 50, 27, 28);
      break;
    case 12:
      g_mul(s, 51, 29, 0);
      break;
    case 13:
      g_mul(s, 52, 30, 0);
      break;
    case 14:
      g_mul(s, 53, 37, 0);
      break;
    case 15:
      g_mul(s, 54, 38, 0);
      break;
    default:
      break;
  })
  // phase 6: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 19, 40, 40);
      break;
    case 1:
      g_add(s, 20, 44, 44);
      break;
    case 2:
      g_add(s, 21, 17, 18);
      break;
    case 3:
      g_add(s, 22, 5, 6);
      break;
    case 4:
      g_add(s, 23, 11, 12);
      break;
    case 5:
      g_add(s, 24, 3, 5);
      break;
    case 6:
      g_add(s, 25, 4, 6);
      break;
    case 7:
      g_add(s, 26, 9, 11);
      break;
    case 8:
      g_add(s, 27, 10, 12);
      break;
    case 9:
      g_add(s, 28, 1, 3);
      break;
    case 10:
      g_add(s, 29, 2, 4);
      break;
    case 11:
      g_add(s, 30, 7, 9);
      break;
    case 12:
      g_add(s, 37, 8, 10);
      break;
    case 13:
      g_add(s, 38, 1, 5);
      break;
    case 14:
      g_add(s, 55, 7, 11);
      break;
    default:
      break;
  })
  // phase 7: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 40, 43, 20);
      break;
    case 1:
      g_add(s, 44, 39, 19);
      break;
    case 2:
      g_add(s, 56, 43, 20);
      break;
    case 3:
      g_add(s, 57, 24, 25);
      break;
    case 4:
      g_add(s, 58, 26, 27);
      break;
    case 5:
      g_add(s, 59, 28, 29);
      break;
    case 6:
      g_add(s, 60, 30, 37);
      break;
    default:
      break;
  })
  // phase 8: round 2 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 61, 43, 17);
      break;
    case 1:
      g_mul(s, 62, 20, 18);
      break;
    case 2:
      g_mul(s, 63, 40, 21);
      break;
    case 3:
      g_mul(s, 64, 39, 43);
      break;
    case 4:
      g_mul(s, 65, 19, 20);
      break;
    case 5:
      g_mul(s, 66, 44, 56);
      break;
    case 6:
      g_mul(s, 67, 5, 11);
      break;
    case 7:
      g_mul(s, 68, 6, 12);
      break;
    case 8:
      g_mul(s, 69, 22, 23);
      break;
    case 9:
      g_mul(s, 70, 24, 26);
      break;
    case 10:
      g_mul(s, 71, 25, 27);
      break;
    case 11:
      g_mul(s, 72, 57, 58);
      break;
    case 12:
      g_mul(s, 73, 28, 30);
      break;
    case 13:
      g_mul(s, 74, 29, 37);
      break;
    case 14:
      g_mul(s, 75, 59, 60);
      break;
    case 15:
      g_mul(s, 76, 38, 55);
      break;
    default:
      break;
  })
  // phase 9: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 20, 61, 62, 0);  // k=2
      break;
    case 1:
      g_add(s, 21, 61, 62);
      break;
    case 2:
      g_add(s, 22, 15, 16);
      break;
    case 3:
      g_add(s, 23, 2, 6);
      break;
    case 4:
      g_add(s, 24, 8, 12);
      break;
    case 5:
      g_add(s, 25, 1, 7);
      break;
    case 6:
      g_add(s, 26, 2, 8);
      break;
    case 7:
      g_add(s, 27, 3, 9);
      break;
    case 8:
      g_add(s, 28, 4, 10);
      break;
    case 9:
      g_add(s, 29, 5, 11);
      break;
    case 10:
      g_add(s, 30, 6, 12);
      break;
    case 11:
      g_add(s, 37, 35, 36);
      break;
    case 12:
      g_add(s, 40, 31, 32);
      break;
    case 13:
      g_add(s, 43, 33, 34);
      break;
    case 14:
      g_add(s, 44, 31, 33);
      break;
    case 15:
      g_add(s, 56, 32, 34);
      break;
    default:
      break;
  })
  // phase 10: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 1, 63, 21, 1);  // k=4
      break;
    case 1:
      g_add(s, 2, 38, 23);
      break;
    case 2:
      g_add(s, 3, 55, 24);
      break;
    case 3:
      g_add(s, 4, 25, 26);
      break;
    case 4:
      g_add(s, 5, 27, 28);
      break;
    case 5:
      g_add(s, 6, 29, 30);
      break;
    case 6:
      g_add(s, 7, 27, 29);
      break;
    case 7:
      g_add(s, 8, 28, 30);
      break;
    default:
      break;
  })
  // phase 11: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 21, 20, 1);
      break;
    default:
      break;
  })
  // phase 12: round 3 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 38, 15, 20);
      break;
    case 1:
      g_mul(s, 55, 16, 1);
      break;
    case 2:
      g_mul(s, 63, 22, 21);
      break;
    case 3:
      g_mul(s, 9, 23, 24);
      break;
    case 4:
      g_mul(s, 10, 2, 3);
      break;
    case 5:
      g_mul(s, 11, 25, 35);
      break;
    case 6:
      g_mul(s, 12, 26, 36);
      break;
    case 7:
      g_mul(s, 61, 4, 37);
      break;
    case 8:
      g_mul(s, 62, 27, 31);
      break;
    case 9:
      g_mul(s, 57, 28, 32);
      break;
    case 10:
      g_mul(s, 58, 5, 40);
      break;
    case 11:
      g_mul(s, 59, 29, 33);
      break;
    case 12:
      g_mul(s, 60, 30, 34);
      break;
    case 13:
      g_mul(s, 77, 6, 43);
      break;
    case 14:
      g_mul(s, 78, 7, 44);
      break;
    case 15:
      g_mul(s, 79, 8, 56);
      break;
    default:
      break;
  })
  // phase 13: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 1, 42, 42);
      break;
    case 1:
      g_add(s, 2, 39, 39);
      break;
    case 2:
      g_add(s, 3, 19, 19);
      break;
    case 3:
      g_add(s, 4, 13, 41);
      break;
    case 4:
      g_add(s, 5, 39, 19);
      break;
    case 5:
      g_add(s, 6, 13, 14);
      break;
    case 6:
      g_add(s, 20, 7, 8);
      break;
    case 7:
      g_add(s, 21, 44, 56);
      break;
    case 8:
      g_add(s, 22, 25, 27);
      break;
    case 9:
      g_add(s, 23, 26, 28);
      break;
    case 10:
      g_add(s, 24, 51, 52);
      break;
    case 11:
      g_add(s, 31, 25, 29);
      break;
    case 12:
      g_add(s, 32, 26, 30);
      break;
    case 13:
      g_add(s, 33, 53, 54);
      break;
    default:
      break;
  })
  // phase 14: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 7, 2, 39);
      break;
    case 1:
      g_add(s, 8, 3, 19);
      break;
    case 2:
      g_add(s, 25, 14, 1);
      break;
    case 3:
      g_sub(s, 26, 41, 1, 1);  // k=4
      break;
    case 4:
      g_add(s, 27, 41, 1);
      break;
    case 5:
      g_add(s, 28, 22, 23);
      break;
    case 6:
      g_add(s, 29, 31, 32);
      break;
    default:
      break;
  })
  // phase 15: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 2, 4, 25, 2);  // k=8
      break;
    case 1:
      g_add(s, 3, 4, 25);
      break;
    case 2:
      g_sub(s, 30, 7, 8, 2);  // k=8
      break;
    case 3:
      g_add(s, 42, 7, 8);
      break;
    default:
      break;
  })
  // phase 16: round 4 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 44, 39, 13);
      break;
    case 1:
      g_mul(s, 56, 19, 14);
      break;
    case 2:
      g_mul(s, 34, 5, 6);
      break;
    case 3:
      g_mul(s, 35, 26, 27);
      break;
    case 4:
      g_mul(s, 36, 41, 1);
      break;
    case 5:
      g_mul(s, 37, 2, 3);
      break;
    case 6:
      g_mul(s, 40, 4, 25);
      break;
    case 7:
      g_mul(s, 43, 30, 42);
      break;
    case 8:
      g_mul(s, 80, 7, 8);
      break;
    case 9:
      g_mul(s, 81, 20, 21);
      break;
    case 10:
      g_mul(s, 82, 22, 51);
      break;
    case 11:
      g_mul(s, 83, 23, 52);
      break;
    case 12:
      g_mul(s, 84, 28, 24);
      break;
    case 13:
      g_mul(s, 85, 31, 53);
      break;
    case 14:
      g_mul(s, 86, 32, 54);
      break;
    case 15:
      g_mul(s, 87, 29, 33);
      break;
    default:
      break;
  })
  // phase 17: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_load(s, 2, xp, 0, n, lane);
      g_sub(s, 29, 76, 9, 0);  // k=2
      break;
    case 1:
      g_load(s, 3, yp, 0, n, lane);
      g_add(s, 30, 76, 9);
      break;
    case 2:
      g_sub(s, 4, 64, 65, 0);  // k=2
      g_sub(s, 31, 11, 12, 0);  // k=2
      break;
    case 3:
      g_add(s, 5, 64, 65);
      g_add(s, 32, 11, 12);
      break;
    case 4:
      g_sub(s, 6, 38, 55, 0);  // k=2
      g_sub(s, 33, 62, 57, 0);  // k=2
      break;
    case 5:
      g_add(s, 13, 38, 55);
      g_add(s, 42, 62, 57);
      break;
    case 6:
      g_sub(s, 14, 45, 46, 0);  // k=2
      g_sub(s, 51, 59, 60, 0);  // k=2
      break;
    case 7:
      g_add(s, 20, 45, 46);
      g_add(s, 52, 59, 60);
      break;
    case 8:
      g_sub(s, 21, 48, 49, 0);  // k=2
      g_sub(s, 53, 78, 79, 0);  // k=2
      break;
    case 9:
      g_add(s, 22, 48, 49);
      g_add(s, 54, 78, 79);
      break;
    case 10:
      g_sub(s, 23, 67, 68, 0);  // k=2
      g_sub(s, 88, 82, 83, 0);  // k=2
      break;
    case 11:
      g_add(s, 24, 67, 68);
      g_add(s, 89, 82, 83);
      break;
    case 12:
      g_sub(s, 25, 70, 71, 0);  // k=2
      g_sub(s, 90, 85, 86, 0);  // k=2
      break;
    case 13:
      g_add(s, 26, 70, 71);
      g_add(s, 91, 85, 86);
      break;
    case 14:
      g_sub(s, 27, 73, 74, 0);  // k=2
      break;
    case 15:
      g_add(s, 28, 73, 74);
      break;
    default:
      break;
  })
  // phase 18: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 9, 66, 5, 1);  // k=4
      g_sub(s, 68, 81, 54, 1);  // k=4
      break;
    case 1:
      g_sub(s, 11, 63, 13, 1);  // k=4
      g_sub(s, 70, 84, 89, 1);  // k=4
      break;
    case 2:
      g_add(s, 12, 6, 6);
      g_sub(s, 71, 87, 91, 1);  // k=4
      break;
    case 3:
      g_add(s, 38, 4, 4);
      g_sub(s, 73, 53, 33, 1);  // k=4
      break;
    case 4:
      g_sub(s, 45, 47, 20, 1);  // k=4
      g_sub(s, 74, 88, 31, 1);  // k=4
      break;
    case 5:
      g_sub(s, 46, 50, 22, 1);  // k=4
      g_sub(s, 76, 90, 31, 1);  // k=4
      break;
    case 6:
      g_sub(s, 48, 69, 24, 1);  // k=4
      break;
    case 7:
      g_sub(s, 49, 72, 26, 1);  // k=4
      break;
    case 8:
      g_sub(s, 55, 75, 28, 1);  // k=4
      break;
    case 9:
      g_sub(s, 57, 10, 30, 1);  // k=4
      break;
    case 10:
      g_sub(s, 59, 25, 21, 1);  // k=4
      break;
    case 11:
      g_sub(s, 60, 27, 14, 1);  // k=4
      break;
    case 12:
      g_sub(s, 62, 29, 14, 1);  // k=4
      break;
    case 13:
      g_sub(s, 64, 61, 32, 1);  // k=4
      break;
    case 14:
      g_sub(s, 65, 58, 42, 1);  // k=4
      break;
    case 15:
      g_sub(s, 67, 77, 52, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 19: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 5, 11, 11);
      g_sub(s, 50, 76, 51, 1);  // k=4
      break;
    case 1:
      g_add(s, 6, 9, 9);
      g_sub(s, 52, 51, 67, 2);  // k=8
      break;
    case 2:
      g_add(s, 10, 38, 4);
      g_add(s, 53, 51, 67);
      break;
    case 3:
      g_sub(s, 13, 49, 46, 2);  // k=8
      break;
    case 4:
      g_sub(s, 20, 59, 23, 1);  // k=4
      break;
    case 5:
      g_sub(s, 22, 55, 45, 2);  // k=8
      break;
    case 6:
      g_sub(s, 24, 60, 21, 1);  // k=4
      break;
    case 7:
      g_sub(s, 25, 57, 45, 2);  // k=8
      break;
    case 8:
      g_sub(s, 26, 62, 23, 1);  // k=4
      break;
    case 9:
      g_sub(s, 27, 23, 48, 2);  // k=8
      break;
    case 10:
      g_add(s, 28, 23, 48);
      break;
    case 11:
      g_sub(s, 29, 68, 65, 2);  // k=8
      break;
    case 12:
      g_sub(s, 30, 73, 51, 1);  // k=4
      break;
    case 13:
      g_sub(s, 32, 70, 64, 2);  // k=8
      break;
    case 14:
      g_sub(s, 42, 74, 33, 1);  // k=4
      break;
    case 15:
      g_sub(s, 47, 71, 64, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 20: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 4, 6, 9);
      break;
    case 1:
      g_neg(s, 11, 10, 3);  // k=16
      break;
    case 2:
      g_sub(s, 23, 13, 48, 2);  // k=8
      break;
    case 3:
      g_sub(s, 38, 22, 46, 2);  // k=8
      break;
    case 4:
      g_sub(s, 49, 25, 48, 2);  // k=8
      break;
    case 5:
      g_add(s, 51, 24, 27);
      break;
    case 6:
      g_add(s, 55, 26, 21);
      break;
    case 7:
      g_sub(s, 57, 29, 67, 2);  // k=8
      break;
    case 8:
      g_sub(s, 59, 32, 65, 2);  // k=8
      break;
    case 9:
      g_sub(s, 60, 47, 67, 2);  // k=8
      break;
    case 10:
      g_add(s, 62, 42, 52);
      break;
    case 11:
      g_add(s, 68, 50, 33);
      break;
    default:
      break;
  })
  // phase 21: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_neg(s, 6, 4, 3);  // k=16
      break;
    case 1:
      g_sub(s, 9, 20, 23, 4);  // k=32
      break;
    case 2:
      g_add(s, 10, 20, 23);
      break;
    case 3:
      g_add(s, 13, 38, 28);
      break;
    case 4:
      g_add(s, 21, 49, 46);
      break;
    case 5:
      g_sub(s, 22, 30, 57, 4);  // k=32
      break;
    case 6:
      g_add(s, 24, 30, 57);
      break;
    case 7:
      g_add(s, 25, 59, 53);
      break;
    case 8:
      g_add(s, 26, 60, 65);
      break;
    default:
      break;
  })
  // phase 22: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 4, 9, 14);
      break;
    case 1:
      g_add(s, 20, 10, 45);
      break;
    case 2:
      g_add(s, 23, 22, 31);
      break;
    case 3:
      g_add(s, 28, 24, 64);
      break;
    default:
      break;
  })
  // phase 23: round 5 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 9, 11, 2);
      break;
    case 1:
      g_mul(s, 10, 6, 2);
      break;
    case 2:
      g_mul(s, 14, 12, 3);
      break;
    case 3:
      g_mul(s, 22, 5, 3);
      break;
    case 4:
      g_mul(s, 24, 4, 0);
      break;
    case 5:
      g_mul(s, 31, 20, 0);
      break;
    case 6:
      g_mul(s, 45, 51, 0);
      break;
    case 7:
      g_mul(s, 64, 13, 0);
      break;
    case 8:
      g_mul(s, 30, 55, 0);
      break;
    case 9:
      g_mul(s, 38, 21, 0);
      break;
    case 10:
      g_mul(s, 46, 23, 0);
      break;
    case 11:
      g_mul(s, 49, 28, 0);
      break;
    case 12:
      g_mul(s, 53, 62, 0);
      break;
    case 13:
      g_mul(s, 57, 25, 0);
      break;
    case 14:
      g_mul(s, 59, 68, 0);
      break;
    case 15:
      g_mul(s, 60, 26, 0);
      break;
    default:
      break;
  })
  // phase 24: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 2, 44, 56, 0);  // k=2
      g_add(s, 62, 24, 24);
      break;
    case 1:
      g_add(s, 3, 44, 56);
      g_add(s, 68, 31, 31);
      break;
    case 2:
      g_add(s, 4, 36, 36);
      break;
    case 3:
      g_add(s, 5, 40, 40);
      break;
    case 4:
      g_add(s, 6, 80, 80);
      break;
    case 5:
      g_add(s, 11, 41, 41);
      break;
    case 6:
      g_add(s, 12, 1, 1);
      break;
    case 7:
      g_sub(s, 13, 37, 39, 0);  // k=2
      break;
    case 8:
      g_sub(s, 20, 46, 24, 1);  // k=4
      break;
    case 9:
      g_sub(s, 21, 49, 31, 1);  // k=4
      break;
    case 10:
      g_sub(s, 23, 53, 45, 1);  // k=4
      break;
    case 11:
      g_sub(s, 25, 57, 64, 1);  // k=4
      break;
    case 12:
      g_sub(s, 26, 59, 30, 1);  // k=4
      break;
    case 13:
      g_sub(s, 28, 60, 38, 1);  // k=4
      break;
    case 14:
      g_sub(s, 51, 30, 38, 1);  // k=4
      break;
    case 15:
      g_add(s, 55, 30, 38);
      break;
    default:
      break;
  })
  // phase 25: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 1, 34, 3, 1);  // k=4
      break;
    case 1:
      g_add(s, 36, 2, 2);
      break;
    case 2:
      g_sub(s, 37, 5, 19, 1);  // k=4
      break;
    case 3:
      g_sub(s, 39, 13, 35, 0);  // k=2
      break;
    case 4:
      g_sub(s, 40, 20, 51, 2);  // k=8
      break;
    case 5:
      g_sub(s, 41, 21, 55, 2);  // k=8
      break;
    case 6:
      g_sub(s, 44, 23, 24, 1);  // k=4
      break;
    case 7:
      g_sub(s, 46, 25, 31, 1);  // k=4
      break;
    case 8:
      g_sub(s, 49, 26, 45, 1);  // k=4
      break;
    case 9:
      g_sub(s, 53, 28, 64, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 26: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 3, 1, 1);
      break;
    case 1:
      g_add(s, 5, 36, 2);
      break;
    case 2:
      g_sub(s, 13, 37, 4, 1);  // k=4
      break;
    case 3:
      g_add(s, 19, 39, 39);
      break;
    default:
      break;
  })
  // phase 27: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 2, 3, 1);
      break;
    case 1:
      g_sub(s, 36, 5, 11, 1);  // k=4
      break;
    case 2:
      g_add(s, 37, 13, 13);
      break;
    case 3:
      g_add(s, 39, 19, 19);
      break;
    default:
      break;
  })
  // phase 28: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 1, 2, 12, 2);  // k=8
      break;
    case 1:
      g_add(s, 3, 37, 37);
      break;
    case 2:
      g_sub(s, 5, 43, 39, 4);  // k=32
      break;
    default:
      break;
  })
  // phase 29: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 2, 6, 3, 5);  // k=64
      break;
    case 1:
      g_sub(s, 12, 19, 5, 5);  // k=64
      break;
    default:
      break;
  })
  // phase 30: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 3, 37, 2, 6);  // k=128
      break;
    default:
      break;
  })
  // phase 31: round 6 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 37, 12, 0);
      break;
    case 1:
      g_mul(s, 6, 3, 0);
      break;
    case 2:
      g_mul(s, 19, 36, 0);
      break;
    case 3:
      g_mul(s, 39, 1, 0);
      break;
    case 4:
      g_mul(s, 43, 9, 0);
      break;
    case 5:
      g_mul(s, 11, 10, 0);
      break;
    case 6:
      g_mul(s, 13, 14, 0);
      break;
    case 7:
      g_mul(s, 20, 22, 0);
      break;
    case 8:
      g_mul(s, 21, 40, 0);
      break;
    case 9:
      g_mul(s, 23, 41, 0);
      break;
    case 10:
      g_mul(s, 24, 44, 0);
      break;
    case 11:
      g_mul(s, 25, 46, 0);
      break;
    case 12:
      g_mul(s, 26, 49, 0);
      break;
    case 13:
      g_mul(s, 28, 53, 0);
      break;
    case 14:
      g_mul(s, 31, 62, 0);
      break;
    case 15:
      g_mul(s, 34, 68, 0);
      break;
    default:
      break;
  })
  // phase 32: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 1, 15, 16);
      break;
    case 1:
      g_add(s, 3, 17, 18);
      break;
    case 2:
      g_add(s, 9, 7, 8);
      break;
    case 3:
      g_add(s, 10, 37, 6);
      break;
    case 4:
      g_add(s, 12, 45, 45);
      break;
    case 5:
      g_add(s, 14, 64, 64);
      break;
    case 6:
      g_add(s, 22, 30, 30);
      break;
    case 7:
      g_add(s, 36, 38, 38);
      break;
    case 8:
      g_add(s, 40, 21, 23);
      break;
    case 9:
      g_add(s, 41, 19, 39);
      break;
    case 10:
      g_add(s, 44, 26, 28);
      break;
    case 11:
      g_add(s, 46, 43, 11);
      break;
    default:
      break;
  })
  // phase 33: round 7 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 30, 15, 17);
      break;
    case 1:
      g_mul(s, 38, 16, 18);
      break;
    case 2:
      g_mul(s, 45, 1, 3);
      break;
    case 3:
      g_mul(s, 64, 7, 37);
      break;
    case 4:
      g_mul(s, 49, 8, 6);
      break;
    case 5:
      g_mul(s, 53, 9, 10);
      break;
    case 6:
      g_mul(s, 62, 12, 0);
      break;
    case 7:
      g_mul(s, 68, 14, 0);
      break;
    case 8:
      g_mul(s, 51, 22, 0);
      break;
    case 9:
      g_mul(s, 55, 36, 0);
      break;
    case 10:
      g_mul(s, 56, 21, 19);
      break;
    case 11:
      g_mul(s, 57, 23, 39);
      break;
    case 12:
      g_mul(s, 59, 40, 41);
      break;
    case 13:
      g_mul(s, 60, 26, 43);
      break;
    case 14:
      g_mul(s, 80, 28, 11);
      break;
    case 15:
      g_mul(s, 65, 44, 46);
      break;
    default:
      break;
  })
  // phase 34: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 1, 21, 23);
      break;
    case 1:
      g_add(s, 3, 43, 11);
      break;
    case 2:
      g_add(s, 6, 24, 25);
      break;
    case 3:
      g_add(s, 7, 19, 39);
      break;
    case 4:
      g_add(s, 8, 24, 25);
      break;
    case 5:
      g_add(s, 9, 43, 11);
      break;
    case 6:
      g_add(s, 10, 26, 28);
      break;
    case 7:
      g_add(s, 12, 19, 39);
      break;
    case 8:
      g_add(s, 14, 51, 55);
      break;
    case 9:
      g_add(s, 15, 13, 20);
      break;
    default:
      break;
  })
  // phase 35: round 8 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 16, 21, 43);
      break;
    case 1:
      g_mul(s, 17, 23, 11);
      break;
    case 2:
      g_mul(s, 18, 1, 3);
      break;
    case 3:
      g_mul(s, 22, 24, 19);
      break;
    case 4:
      g_mul(s, 36, 25, 39);
      break;
    case 5:
      g_mul(s, 37, 6, 7);
      break;
    case 6:
      g_mul(s, 40, 24, 43);
      break;
    case 7:
      g_mul(s, 41, 25, 11);
      break;
    case 8:
      g_mul(s, 44, 8, 9);
      break;
    case 9:
      g_mul(s, 46, 26, 19);
      break;
    case 10:
      g_mul(s, 27, 28, 39);
      break;
    case 11:
      g_mul(s, 29, 10, 12);
      break;
    case 12:
      g_mul(s, 32, 51, 13);
      break;
    case 13:
      g_mul(s, 33, 55, 20);
      break;
    case 14:
      g_mul(s, 42, 14, 15);
      break;
    case 15:
      g_mul(s, 47, 31, 13);
      break;
    default:
      break;
  })
  // phase 36: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 1, 21, 31);
      break;
    case 1:
      g_add(s, 3, 23, 34);
      break;
    case 2:
      g_add(s, 6, 24, 62);
      break;
    case 3:
      g_add(s, 7, 25, 68);
      break;
    case 4:
      g_add(s, 8, 26, 51);
      break;
    case 5:
      g_add(s, 9, 28, 55);
      break;
    case 6:
      g_add(s, 10, 43, 13);
      break;
    case 7:
      g_add(s, 12, 11, 20);
      break;
    case 8:
      g_add(s, 14, 31, 34);
      break;
    case 9:
      g_add(s, 15, 13, 20);
      break;
    case 10:
      g_add(s, 48, 62, 68);
      break;
    case 11:
      g_add(s, 50, 13, 20);
      break;
    case 12:
      g_add(s, 52, 19, 39);
      break;
    default:
      break;
  })
  // phase 37: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 11, 1, 3);
      break;
    case 1:
      g_add(s, 21, 8, 9);
      break;
    case 2:
      g_add(s, 23, 10, 12);
      break;
    case 3:
      g_add(s, 24, 1, 3);
      break;
    case 4:
      g_add(s, 25, 10, 12);
      break;
    default:
      break;
  })
  // phase 38: round 9 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 26, 34, 20);
      break;
    case 1:
      g_mul(s, 28, 14, 15);
      break;
    case 2:
      g_mul(s, 31, 62, 13);
      break;
    case 3:
      g_mul(s, 43, 68, 20);
      break;
    case 4:
      g_mul(s, 51, 48, 50);
      break;
    case 5:
      g_mul(s, 55, 1, 19);
      break;
    case 6:
      g_mul(s, 67, 3, 39);
      break;
    case 7:
      g_mul(s, 70, 11, 52);
      break;
    case 8:
      g_mul(s, 71, 8, 10);
      break;
    case 9:
      g_mul(s, 73, 9, 12);
      break;
    case 10:
      g_mul(s, 74, 21, 23);
      break;
    case 11:
      g_mul(s, 76, 1, 10);
      break;
    case 12:
      g_mul(s, 54, 3, 12);
      break;
    case 13:
      g_mul(s, 58, 24, 25);
      break;
    case 14:
      g_mul(s, 61, 6, 19);
      break;
    case 15:
      g_mul(s, 63, 7, 39);
      break;
    default:
      break;
  })
  // phase 39: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 1, 30, 38, 0);  // k=2
      g_add(s, 68, 6, 7);
      break;
    case 1:
      g_add(s, 3, 30, 38);
      g_add(s, 66, 19, 39);
      break;
    case 2:
      g_sub(s, 11, 64, 49, 0);  // k=2
      g_add(s, 69, 6, 7);
      break;
    case 3:
      g_add(s, 13, 64, 49);
      g_add(s, 72, 10, 12);
      break;
    case 4:
      g_add(s, 14, 35, 35);
      g_add(s, 75, 8, 9);
      break;
    case 5:
      g_add(s, 15, 4, 4);
      g_add(s, 77, 19, 39);
      break;
    case 6:
      g_sub(s, 20, 56, 57, 0);  // k=2
      break;
    case 7:
      g_add(s, 21, 56, 57);
      break;
    case 8:
      g_sub(s, 23, 60, 80, 0);  // k=2
      break;
    case 9:
      g_add(s, 24, 60, 80);
      break;
    case 10:
      g_sub(s, 25, 16, 17, 0);  // k=2
      break;
    case 11:
      g_sub(s, 34, 22, 36, 0);  // k=2
      break;
    case 12:
      g_sub(s, 48, 32, 33, 0);  // k=2
      break;
    case 13:
      g_add(s, 50, 32, 33);
      break;
    case 14:
      g_sub(s, 52, 31, 43, 0);  // k=2
      break;
    case 15:
      g_add(s, 62, 31, 43);
      break;
    default:
      break;
  })
  // phase 40: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 4, 45, 3, 1);  // k=4
      break;
    case 1:
      g_sub(s, 30, 53, 13, 1);  // k=4
      break;
    case 2:
      g_add(s, 31, 14, 14);
      break;
    case 3:
      g_add(s, 32, 15, 15);
      break;
    case 4:
      g_add(s, 33, 1, 1);
      break;
    case 5:
      g_sub(s, 35, 59, 21, 1);  // k=4
      break;
    case 6:
      g_sub(s, 38, 65, 24, 1);  // k=4
      break;
    case 7:
      g_sub(s, 43, 42, 50, 1);  // k=4
      break;
    case 8:
      g_sub(s, 49, 51, 62, 1);  // k=4
      break;
    case 9:
      g_add(s, 56, 25, 34);
      break;
    default:
      break;
  })
  // phase 41: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 1, 31, 31);
      break;
    case 1:
      g_add(s, 3, 32, 32);
      break;
    case 2:
      g_add(s, 13, 4, 4);
      break;
    case 3:
      g_sub(s, 14, 23, 38, 2);  // k=8
      break;
    case 4:
      g_add(s, 15, 23, 38);
      break;
    case 5:
      g_sub(s, 21, 48, 43, 2);  // k=8
      break;
    case 6:
      g_sub(s, 24, 52, 49, 2);  // k=8
      break;
    case 7:
      g_add(s, 25, 52, 49);
      break;
    default:
      break;
  })
  // phase 42: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 4, 11, 1, 3);  // k=16
      break;
    case 1:
      g_sub(s, 23, 30, 3, 4);  // k=32
      break;
    case 2:
      g_add(s, 31, 20, 14);
      break;
    case 3:
      g_add(s, 32, 35, 15);
      break;
    case 4:
      g_add(s, 38, 56, 21);
      break;
    default:
      break;
  })
  // phase 43: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 1, 31, 24);
      break;
    case 1:
      g_add(s, 3, 32, 25);
      break;
    default:
      break;
  })
  // phase 44: round 10 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 24, 5, 0);
      if (live) g_store(t_out, 0, n, lane, s, 24);
      break;
    case 1:
      g_mul(s, 25, 2, 0);
      if (live) g_store(t_out, 1, n, lane, s, 25);
      break;
    case 2:
      g_mul(s, 11, 4, 0);
      if (live) g_store(t_out, 2, n, lane, s, 11);
      break;
    case 3:
      g_mul(s, 14, 23, 0);
      if (live) g_store(t_out, 3, n, lane, s, 14);
      break;
    case 4:
      g_mul(s, 15, 33, 0);
      if (live) g_store(t_out, 4, n, lane, s, 15);
      break;
    case 5:
      g_mul(s, 20, 13, 0);
      if (live) g_store(t_out, 5, n, lane, s, 20);
      break;
    case 6:
      g_mul(s, 30, 68, 66);
      break;
    case 7:
      g_mul(s, 35, 6, 10);
      break;
    case 8:
      g_mul(s, 34, 7, 12);
      break;
    case 9:
      g_mul(s, 42, 69, 72);
      break;
    case 10:
      g_mul(s, 45, 8, 19);
      break;
    case 11:
      g_mul(s, 50, 9, 39);
      break;
    case 12:
      g_mul(s, 51, 75, 77);
      break;
    case 13:
      g_mul(s, 53, 1, 0);
      if (live) g_store(f_out, 0, n, lane, s, 53);
      break;
    case 14:
      g_mul(s, 59, 3, 0);
      if (live) g_store(f_out, 1, n, lane, s, 59);
      break;
    case 15:
      g_mul(s, 62, 38, 0);
      if (live) g_store(f_out, 2, n, lane, s, 62);
      break;
    default:
      break;
  })
  // phase 45: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 1, 16, 17);
      g_sub(s, 20, 35, 34, 0);  // k=2
      break;
    case 1:
      g_add(s, 2, 22, 36);
      g_add(s, 23, 35, 34);
      break;
    case 2:
      g_sub(s, 3, 40, 41, 0);  // k=2
      g_sub(s, 24, 45, 50, 0);  // k=2
      break;
    case 3:
      g_add(s, 4, 40, 41);
      g_add(s, 25, 45, 50);
      break;
    case 4:
      g_sub(s, 5, 46, 27, 0);  // k=2
      g_add(s, 33, 48, 43);
      break;
    case 5:
      g_add(s, 6, 46, 27);
      break;
    case 6:
      g_sub(s, 7, 47, 26, 0);  // k=2
      break;
    case 7:
      g_add(s, 8, 47, 26);
      break;
    case 8:
      g_sub(s, 9, 55, 67, 0);  // k=2
      break;
    case 9:
      g_add(s, 10, 55, 67);
      break;
    case 10:
      g_sub(s, 11, 71, 73, 0);  // k=2
      break;
    case 11:
      g_add(s, 12, 71, 73);
      break;
    case 12:
      g_sub(s, 13, 76, 54, 0);  // k=2
      break;
    case 13:
      g_add(s, 14, 76, 54);
      break;
    case 14:
      g_sub(s, 15, 61, 63, 0);  // k=2
      break;
    case 15:
      g_add(s, 19, 61, 63);
      break;
    default:
      break;
  })
  // phase 46: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 16, 18, 1, 1);  // k=4
      break;
    case 1:
      g_sub(s, 17, 37, 2, 1);  // k=4
      break;
    case 2:
      g_sub(s, 22, 44, 4, 1);  // k=4
      break;
    case 3:
      g_sub(s, 26, 29, 6, 1);  // k=4
      break;
    case 4:
      g_sub(s, 27, 28, 8, 1);  // k=4
      break;
    case 5:
      g_sub(s, 34, 70, 10, 1);  // k=4
      break;
    case 6:
      g_sub(s, 35, 74, 12, 1);  // k=4
      break;
    case 7:
      g_sub(s, 36, 58, 14, 1);  // k=4
      break;
    case 8:
      g_sub(s, 40, 30, 19, 1);  // k=4
      break;
    case 9:
      g_sub(s, 41, 42, 23, 1);  // k=4
      break;
    case 10:
      g_sub(s, 43, 51, 25, 1);  // k=4
      break;
    case 11:
      g_add(s, 45, 3, 5);
      break;
    case 12:
      g_add(s, 46, 13, 15);
      break;
    case 13:
      g_add(s, 47, 20, 24);
      break;
    default:
      break;
  })
  // phase 47: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 1, 16, 17);
      break;
    case 1:
      g_add(s, 2, 22, 26);
      break;
    case 2:
      g_sub(s, 3, 11, 35, 2);  // k=8
      break;
    case 3:
      g_add(s, 4, 11, 35);
      break;
    case 4:
      g_add(s, 5, 36, 40);
      break;
    case 5:
      g_add(s, 6, 41, 43);
      break;
    case 6:
      g_add(s, 8, 45, 7);
      break;
    case 7:
      g_sub(s, 10, 46, 56, 2);  // k=8
      break;
    case 8:
      g_sub(s, 12, 47, 45, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 48: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 11, 9, 3);
      break;
    case 1:
      g_add(s, 16, 34, 4);
      break;
    case 2:
      g_add(s, 17, 1, 33);
      break;
    case 3:
      g_add(s, 22, 2, 27);
      break;
    case 4:
      g_sub(s, 26, 5, 1, 3);  // k=16
      break;
    case 5:
      g_sub(s, 35, 6, 2, 3);  // k=16
      break;
    case 6:
      g_sub(s, 36, 10, 7, 1);  // k=4
      break;
    case 7:
      g_sub(s, 40, 12, 52, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 49: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 1, 11, 31, 3);  // k=16
      break;
    case 1:
      g_sub(s, 2, 16, 32, 3);  // k=16
      break;
    case 2:
      g_sub(s, 3, 26, 27, 2);  // k=8
      break;
    case 3:
      g_sub(s, 4, 35, 49, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 50: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 11, 1, 21, 3);  // k=16
      break;
    case 1:
      g_sub(s, 16, 2, 33, 3);  // k=16
      break;
    default:
      break;
  })
  // phase 51: round 11 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 1, 17, 0);
      if (live) g_store(f_out, 3, n, lane, s, 1);
      break;
    case 1:
      g_mul(s, 2, 8, 0);
      if (live) g_store(f_out, 4, n, lane, s, 2);
      break;
    case 2:
      g_mul(s, 21, 22, 0);
      if (live) g_store(f_out, 5, n, lane, s, 21);
      break;
    case 3:
      g_mul(s, 33, 11, 0);
      if (live) g_store(f_out, 6, n, lane, s, 33);
      break;
    case 4:
      g_mul(s, 26, 16, 0);
      if (live) g_store(f_out, 7, n, lane, s, 26);
      break;
    case 5:
      g_mul(s, 27, 36, 0);
      if (live) g_store(f_out, 8, n, lane, s, 27);
      break;
    case 6:
      g_mul(s, 31, 3, 0);
      if (live) g_store(f_out, 9, n, lane, s, 31);
      break;
    case 7:
      g_mul(s, 32, 40, 0);
      if (live) g_store(f_out, 10, n, lane, s, 32);
      break;
    case 8:
      g_mul(s, 35, 4, 0);
      if (live) g_store(f_out, 11, n, lane, s, 35);
      break;
    default:
      break;
  })
}

extern "C" int lh_miller_step_dbl_g16(const void* f, const void* t, const void* xp, const void* yp, void* f_out, void* t_out, int n,
                              void* stream) {
  constexpr int kShared = 2392 * 2 * lh::kGroupLanes;
  static_assert(kShared <= 232448, "one block's shared memory on sm_90");
  const cudaError_t attr = lh::set_shared_limit(miller_step_dbl_g16_kernel, kShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n > 0) {
    miller_step_dbl_g16_kernel<<<(n + lh::kGroupLanes - 1) / lh::kGroupLanes, 16 * lh::kGroupLanes,
                          kShared, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(f), static_cast<const uint32_t*>(t), static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(yp),
        static_cast<uint32_t*>(f_out), static_cast<uint32_t*>(t_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// miller_step_add_g16: 353 limb ops, 111 Montgomery products;
// 16 threads per lane, 10 rounds of products in 45 phases, 108 slots
// (179,712 bytes of shared memory per block of 32 lanes).
static __global__ void __launch_bounds__(16 * lh::kGroupLanes)
miller_step_add_g16_kernel(const uint32_t* __restrict__ f, const uint32_t* __restrict__ t, const uint32_t* __restrict__ q, const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp, const int32_t* __restrict__ bit, uint32_t* __restrict__ f_out, uint32_t* __restrict__ t_out, int n) {
  LH_GROUP_SHARED(uint16_t, slots, 2808);
  const int gl = lh::group_lane();
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
  uint16_t* const s = slots + lh::group_slot();
  const bool take = bit[lane] != 0;
  // phase 1: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_load(s, 0, t, 4, n, lane);
      break;
    case 1:
      g_load(s, 1, t, 5, n, lane);
      break;
    default:
      break;
  })
  // phase 2: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 2, 0, 1, 1);  // k=4
      break;
    case 1:
      g_add(s, 3, 0, 1);
      break;
    default:
      break;
  })
  // phase 3: round 1 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 4, 2, 3);
      break;
    case 1:
      g_mul(s, 5, 0, 1);
      break;
    default:
      break;
  })
  // phase 4: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_load(s, 2, q, 0, n, lane);
      break;
    case 1:
      g_load(s, 3, q, 1, n, lane);
      break;
    case 2:
      g_add(s, 6, 5, 5);
      break;
    case 3:
      g_add(s, 7, 0, 1);
      break;
    default:
      break;
  })
  // phase 5: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 5, 4, 6);
      break;
    case 1:
      g_add(s, 8, 2, 3);
      break;
    case 2:
      g_add(s, 9, 4, 6);
      break;
    default:
      break;
  })
  // phase 6: round 2 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 10, 4, 0);
      break;
    case 1:
      g_mul(s, 11, 6, 1);
      break;
    case 2:
      g_mul(s, 12, 5, 7);
      break;
    case 3:
      g_mul(s, 13, 2, 4);
      break;
    case 4:
      g_mul(s, 14, 3, 6);
      break;
    case 5:
      g_mul(s, 15, 8, 9);
      break;
    default:
      break;
  })
  // phase 7: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_load(s, 4, t, 0, n, lane);
      break;
    case 1:
      g_load(s, 5, t, 1, n, lane);
      break;
    case 2:
      g_load(s, 6, q, 2, n, lane);
      break;
    case 3:
      g_load(s, 7, q, 3, n, lane);
      break;
    case 4:
      g_sub(s, 8, 10, 11, 0);  // k=2
      break;
    case 5:
      g_add(s, 9, 10, 11);
      break;
    case 6:
      g_sub(s, 16, 13, 14, 0);  // k=2
      break;
    case 7:
      g_add(s, 17, 13, 14);
      break;
    case 8:
      g_add(s, 18, 0, 1);
      break;
    default:
      break;
  })
  // phase 8: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 10, 12, 9, 1);  // k=4
      break;
    case 1:
      g_sub(s, 11, 15, 17, 1);  // k=4
      break;
    case 2:
      g_sub(s, 13, 16, 4, 1);  // k=4
      break;
    case 3:
      g_add(s, 14, 6, 7);
      break;
    default:
      break;
  })
  // phase 9: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 9, 11, 5, 1);  // k=4
      break;
    case 1:
      g_add(s, 12, 8, 10);
      break;
    default:
      break;
  })
  // phase 10: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 11, 13, 9);
      break;
    case 1:
      g_sub(s, 15, 13, 9, 3);  // k=16
      break;
    case 2:
      g_add(s, 16, 13, 9);
      break;
    default:
      break;
  })
  // phase 11: round 3 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 17, 6, 8);
      break;
    case 1:
      g_mul(s, 19, 7, 10);
      break;
    case 2:
      g_mul(s, 20, 14, 12);
      break;
    case 3:
      g_mul(s, 21, 0, 13);
      break;
    case 4:
      g_mul(s, 22, 1, 9);
      break;
    case 5:
      g_mul(s, 23, 18, 11);
      break;
    case 6:
      g_mul(s, 24, 15, 16);
      break;
    case 7:
      g_mul(s, 25, 13, 9);
      break;
    default:
      break;
  })
  // phase 12: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_load(s, 8, t, 2, n, lane);
      break;
    case 1:
      g_load(s, 10, t, 3, n, lane);
      break;
    case 2:
      g_load(s, 11, xp, 0, n, lane);
      break;
    case 3:
      g_sub(s, 12, 17, 19, 0);  // k=2
      break;
    case 4:
      g_add(s, 14, 17, 19);
      break;
    case 5:
      g_sub(s, 15, 21, 22, 0);  // k=2
      break;
    case 6:
      g_add(s, 16, 21, 22);
      break;
    case 7:
      g_add(s, 18, 25, 25);
      break;
    case 8:
      g_add(s, 26, 2, 3);
      break;
    case 9:
      g_add(s, 27, 6, 7);
      break;
    case 10:
      g_add(s, 28, 13, 9);
      break;
    case 11:
      g_add(s, 29, 4, 5);
      break;
    default:
      break;
  })
  // phase 13: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 17, 20, 14, 1);  // k=4
      break;
    case 1:
      g_sub(s, 19, 23, 16, 1);  // k=4
      break;
    case 2:
      g_sub(s, 21, 12, 8, 1);  // k=4
      break;
    case 3:
      g_add(s, 22, 24, 18);
      break;
    case 4:
      g_add(s, 25, 24, 18);
      break;
    default:
      break;
  })
  // phase 14: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 12, 17, 10, 1);  // k=4
      break;
    case 1:
      g_add(s, 14, 15, 19);
      break;
    case 2:
      g_neg(s, 16, 21, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 15: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 17, 21, 12);
      break;
    case 1:
      g_sub(s, 20, 21, 12, 3);  // k=16
      break;
    case 2:
      g_add(s, 23, 21, 12);
      break;
    case 3:
      g_neg(s, 30, 12, 3);  // k=16
      break;
    default:
      break;
  })
  // phase 16: round 4 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 31, 21, 2);
      break;
    case 1:
      g_mul(s, 32, 12, 3);
      break;
    case 2:
      g_mul(s, 33, 17, 26);
      break;
    case 3:
      g_mul(s, 34, 6, 15);
      break;
    case 4:
      g_mul(s, 35, 7, 19);
      break;
    case 5:
      g_mul(s, 36, 27, 14);
      break;
    case 6:
      g_mul(s, 37, 20, 23);
      break;
    case 7:
      g_mul(s, 38, 21, 12);
      break;
    case 8:
      g_mul(s, 39, 13, 24);
      break;
    case 9:
      g_mul(s, 40, 9, 18);
      break;
    case 10:
      g_mul(s, 41, 28, 22);
      break;
    case 11:
      g_mul(s, 42, 4, 24);
      break;
    case 12:
      g_mul(s, 43, 5, 18);
      break;
    case 13:
      g_mul(s, 44, 29, 25);
      break;
    case 14:
      g_mul(s, 45, 16, 11);
      break;
    case 15:
      g_mul(s, 46, 30, 11);
      break;
    default:
      break;
  })
  // phase 17: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_one(s, 2);
      break;
    case 1:
      g_load(s, 3, yp, 0, n, lane);
      break;
    case 2:
      g_sub(s, 6, 31, 32, 0);  // k=2
      break;
    case 3:
      g_add(s, 7, 31, 32);
      break;
    case 4:
      g_sub(s, 9, 34, 35, 0);  // k=2
      break;
    case 5:
      g_add(s, 11, 34, 35);
      break;
    case 6:
      g_add(s, 13, 38, 38);
      break;
    case 7:
      g_sub(s, 14, 39, 40, 0);  // k=2
      break;
    case 8:
      g_add(s, 16, 39, 40);
      break;
    case 9:
      g_sub(s, 17, 42, 43, 0);  // k=2
      break;
    case 10:
      g_add(s, 18, 42, 43);
      break;
    case 11:
      g_add(s, 20, 8, 10);
      break;
    default:
      break;
  })
  // phase 18: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 31, 33, 7, 1);  // k=4
      break;
    case 1:
      g_sub(s, 32, 36, 11, 1);  // k=4
      break;
    case 2:
      g_sub(s, 34, 41, 16, 1);  // k=4
      break;
    case 3:
      g_sub(s, 35, 44, 18, 1);  // k=4
      break;
    case 4:
      g_sub(s, 38, 6, 9, 1);  // k=4
      break;
    case 5:
      g_sub(s, 39, 37, 14, 1);  // k=4
      break;
    case 6:
      g_add(s, 40, 17, 17);
      break;
    default:
      break;
  })
  // phase 19: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 6, 31, 32, 2);  // k=8
      break;
    case 1:
      g_sub(s, 7, 13, 34, 2);  // k=8
      break;
    case 2:
      g_add(s, 9, 35, 35);
      break;
    case 3:
      g_sub(s, 11, 39, 40, 2);  // k=8
      break;
    case 4:
      g_add(s, 16, 14, 34);
      break;
    default:
      break;
  })
  // phase 20: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 13, 7, 9, 3);  // k=16
      break;
    case 1:
      g_sub(s, 31, 17, 11, 3);  // k=16
      break;
    default:
      break;
  })
  // phase 21: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 7, 35, 13, 4);  // k=32
      break;
    default:
      break;
  })
  // phase 22: round 5 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 35, 31, 2);
      break;
    case 1:
      g_mul(s, 9, 7, 2);
      break;
    case 2:
      g_mul(s, 17, 8, 14);
      break;
    case 3:
      g_mul(s, 32, 10, 34);
      break;
    case 4:
      g_mul(s, 39, 20, 16);
      break;
    case 5:
      g_mul(s, 40, 15, 3);
      break;
    case 6:
      g_mul(s, 18, 19, 3);
      break;
    case 7:
      g_mul(s, 33, 38, 2);
      break;
    case 8:
      g_mul(s, 36, 6, 2);
      break;
    case 9:
      g_mul(s, 37, 45, 2);
      break;
    case 10:
      g_mul(s, 41, 46, 2);
      break;
    case 11:
      g_mul(s, 44, 11, 2);
      break;
    case 12:
      g_mul(s, 42, 13, 2);
      break;
    case 13:
      g_mul(s, 43, 15, 2);
      break;
    case 14:
      g_mul(s, 22, 19, 2);
      break;
    default:
      break;
  })
  // phase 23: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_load(s, 3, f, 0, n, lane);
      break;
    case 1:
      g_load(s, 6, f, 1, n, lane);
      break;
    case 2:
      g_load(s, 7, f, 2, n, lane);
      break;
    case 3:
      g_load(s, 11, f, 3, n, lane);
      break;
    case 4:
      g_load(s, 13, f, 4, n, lane);
      break;
    case 5:
      g_load(s, 14, f, 5, n, lane);
      break;
    case 6:
      g_add(s, 15, 21, 12);
      break;
    case 7:
      g_add(s, 16, 35, 9);
      break;
    case 8:
      g_add(s, 19, 33, 36);
      break;
    case 9:
      g_add(s, 20, 37, 41);
      break;
    case 10:
      g_add(s, 31, 37, 41);
      break;
    default:
      break;
  })
  // phase 24: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 34, 3, 6);
      break;
    case 1:
      g_add(s, 38, 13, 14);
      break;
    case 2:
      g_add(s, 45, 3, 6);
      break;
    default:
      break;
  })
  // phase 25: round 6 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 46, 21, 35);
      break;
    case 1:
      g_mul(s, 23, 12, 9);
      break;
    case 2:
      g_mul(s, 24, 15, 16);
      break;
    case 3:
      g_mul(s, 25, 40, 2);
      break;
    case 4:
      g_mul(s, 26, 18, 2);
      break;
    case 5:
      g_mul(s, 27, 3, 33);
      break;
    case 6:
      g_mul(s, 28, 6, 36);
      break;
    case 7:
      g_mul(s, 29, 34, 19);
      break;
    case 8:
      g_mul(s, 30, 13, 37);
      break;
    case 9:
      g_mul(s, 47, 14, 41);
      break;
    case 10:
      g_mul(s, 48, 38, 20);
      break;
    case 11:
      g_mul(s, 49, 3, 37);
      break;
    case 12:
      g_mul(s, 50, 6, 41);
      break;
    case 13:
      g_mul(s, 51, 45, 31);
      break;
    case 14:
      g_mul(s, 52, 7, 33);
      break;
    case 15:
      g_mul(s, 53, 11, 36);
      break;
    default:
      break;
  })
  // phase 26: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_load(s, 9, f, 6, n, lane);
      break;
    case 1:
      g_load(s, 12, f, 7, n, lane);
      break;
    case 2:
      g_load(s, 15, f, 8, n, lane);
      break;
    case 3:
      g_load(s, 16, f, 9, n, lane);
      break;
    case 4:
      g_load(s, 18, f, 10, n, lane);
      break;
    case 5:
      g_load(s, 19, f, 11, n, lane);
      break;
    case 6:
      g_add(s, 20, 7, 11);
      break;
    case 7:
      g_add(s, 21, 33, 36);
      break;
    case 8:
      g_add(s, 31, 7, 11);
      break;
    case 9:
      g_add(s, 34, 37, 41);
      break;
    case 10:
      g_add(s, 35, 13, 14);
      break;
    case 11:
      g_add(s, 38, 33, 36);
      break;
    case 12:
      g_add(s, 40, 25, 26);
      break;
    case 13:
      g_add(s, 45, 25, 26);
      break;
    case 14:
      g_add(s, 54, 25, 26);
      break;
    default:
      break;
  })
  // phase 27: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 55, 18, 19);
      break;
    case 1:
      g_add(s, 56, 9, 12);
      break;
    case 2:
      g_add(s, 57, 15, 16);
      break;
    default:
      break;
  })
  // phase 28: round 7 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 58, 20, 21);
      break;
    case 1:
      g_mul(s, 59, 7, 37);
      break;
    case 2:
      g_mul(s, 60, 11, 41);
      break;
    case 3:
      g_mul(s, 61, 31, 34);
      break;
    case 4:
      g_mul(s, 62, 13, 33);
      break;
    case 5:
      g_mul(s, 63, 14, 36);
      break;
    case 6:
      g_mul(s, 64, 35, 38);
      break;
    case 7:
      g_mul(s, 65, 18, 25);
      break;
    case 8:
      g_mul(s, 66, 19, 26);
      break;
    case 9:
      g_mul(s, 67, 55, 40);
      break;
    case 10:
      g_mul(s, 68, 9, 25);
      break;
    case 11:
      g_mul(s, 69, 12, 26);
      break;
    case 12:
      g_mul(s, 70, 56, 45);
      break;
    case 13:
      g_mul(s, 71, 15, 25);
      break;
    case 14:
      g_mul(s, 72, 16, 26);
      break;
    case 15:
      g_mul(s, 73, 57, 54);
      break;
    default:
      break;
  })
  // phase 29: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 20, 3, 9);
      break;
    case 1:
      g_add(s, 21, 6, 12);
      break;
    case 2:
      g_add(s, 31, 7, 15);
      break;
    case 3:
      g_add(s, 34, 11, 16);
      break;
    case 4:
      g_add(s, 35, 13, 18);
      break;
    case 5:
      g_add(s, 38, 14, 19);
      break;
    case 6:
      g_add(s, 40, 37, 25);
      break;
    case 7:
      g_add(s, 45, 41, 26);
      break;
    case 8:
      g_add(s, 54, 33, 36);
      break;
    case 9:
      g_add(s, 55, 33, 36);
      break;
    default:
      break;
  })
  // phase 30: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 25, 20, 21);
      break;
    case 1:
      g_add(s, 26, 35, 38);
      break;
    case 2:
      g_add(s, 37, 40, 45);
      break;
    case 3:
      g_add(s, 41, 20, 21);
      break;
    case 4:
      g_add(s, 56, 40, 45);
      break;
    case 5:
      g_add(s, 57, 31, 34);
      break;
    case 6:
      g_add(s, 74, 31, 34);
      break;
    case 7:
      g_add(s, 75, 40, 45);
      break;
    default:
      break;
  })
  // phase 31: round 8 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 76, 20, 33);
      break;
    case 1:
      g_mul(s, 77, 21, 36);
      break;
    case 2:
      g_mul(s, 78, 25, 54);
      break;
    case 3:
      g_mul(s, 79, 35, 40);
      break;
    case 4:
      g_mul(s, 80, 38, 45);
      break;
    case 5:
      g_mul(s, 81, 26, 37);
      break;
    case 6:
      g_mul(s, 82, 20, 40);
      break;
    case 7:
      g_mul(s, 83, 21, 45);
      break;
    case 8:
      g_mul(s, 84, 41, 56);
      break;
    case 9:
      g_mul(s, 85, 31, 33);
      break;
    case 10:
      g_mul(s, 86, 34, 36);
      break;
    case 11:
      g_mul(s, 87, 57, 55);
      break;
    case 12:
      g_mul(s, 88, 31, 40);
      break;
    case 13:
      g_mul(s, 89, 34, 45);
      break;
    case 14:
      g_mul(s, 90, 74, 75);
      break;
    case 15:
      g_mul(s, 91, 35, 33);
      break;
    default:
      break;
  })
  // phase 32: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 20, 46, 23, 0);  // k=2
      g_sub(s, 92, 65, 66, 0);  // k=2
      break;
    case 1:
      g_add(s, 21, 46, 23);
      g_add(s, 93, 65, 66);
      break;
    case 2:
      g_sub(s, 25, 17, 32, 0);  // k=2
      g_sub(s, 94, 68, 69, 0);  // k=2
      break;
    case 3:
      g_add(s, 26, 17, 32);
      g_add(s, 95, 68, 69);
      break;
    case 4:
      g_sub(s, 31, 27, 28, 0);  // k=2
      g_sub(s, 96, 71, 72, 0);  // k=2
      break;
    case 5:
      g_add(s, 34, 27, 28);
      g_add(s, 97, 71, 72);
      break;
    case 6:
      g_sub(s, 37, 30, 47, 0);  // k=2
      g_sub(s, 98, 76, 77, 0);  // k=2
      break;
    case 7:
      g_add(s, 40, 30, 47);
      g_add(s, 99, 76, 77);
      break;
    case 8:
      g_sub(s, 41, 49, 50, 0);  // k=2
      g_sub(s, 100, 79, 80, 0);  // k=2
      break;
    case 9:
      g_add(s, 45, 49, 50);
      g_add(s, 101, 79, 80);
      break;
    case 10:
      g_sub(s, 54, 52, 53, 0);  // k=2
      g_sub(s, 102, 82, 83, 0);  // k=2
      break;
    case 11:
      g_add(s, 55, 52, 53);
      g_add(s, 103, 82, 83);
      break;
    case 12:
      g_sub(s, 56, 59, 60, 0);  // k=2
      g_sub(s, 104, 85, 86, 0);  // k=2
      break;
    case 13:
      g_add(s, 57, 59, 60);
      g_add(s, 105, 85, 86);
      break;
    case 14:
      g_sub(s, 74, 62, 63, 0);  // k=2
      g_add(s, 106, 35, 38);
      break;
    case 15:
      g_add(s, 75, 62, 63);
      g_add(s, 107, 33, 36);
      break;
    default:
      break;
  })
  // phase 33: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 17, 24, 21, 1);  // k=4
      g_add(s, 62, 41, 54);
      break;
    case 1:
      g_sub(s, 23, 39, 26, 1);  // k=4
      g_add(s, 63, 56, 74);
      break;
    case 2:
      g_sub(s, 27, 20, 25, 1);  // k=4
      g_add(s, 65, 102, 104);
      break;
    case 3:
      g_sub(s, 28, 29, 34, 1);  // k=4
      break;
    case 4:
      g_sub(s, 30, 48, 40, 1);  // k=4
      break;
    case 5:
      g_sub(s, 32, 51, 45, 1);  // k=4
      break;
    case 6:
      g_sub(s, 33, 58, 55, 1);  // k=4
      break;
    case 7:
      g_sub(s, 35, 61, 57, 1);  // k=4
      break;
    case 8:
      g_sub(s, 46, 64, 75, 1);  // k=4
      break;
    case 9:
      g_sub(s, 47, 67, 93, 1);  // k=4
      break;
    case 10:
      g_sub(s, 49, 70, 95, 1);  // k=4
      break;
    case 11:
      g_sub(s, 50, 73, 97, 1);  // k=4
      break;
    case 12:
      g_sub(s, 52, 78, 99, 1);  // k=4
      break;
    case 13:
      g_sub(s, 53, 81, 101, 1);  // k=4
      break;
    case 14:
      g_sub(s, 59, 84, 103, 1);  // k=4
      break;
    case 15:
      g_sub(s, 60, 87, 105, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 34: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 20, 17, 23, 2);  // k=8
      break;
    case 1:
      g_sub(s, 21, 37, 30, 2);  // k=8
      break;
    case 2:
      g_add(s, 24, 37, 30);
      break;
    case 3:
      g_add(s, 25, 32, 33);
      break;
    case 4:
      g_add(s, 26, 35, 46);
      break;
    case 5:
      g_sub(s, 29, 92, 47, 2);  // k=8
      break;
    case 6:
      g_add(s, 34, 92, 47);
      break;
    case 7:
      g_sub(s, 39, 100, 53, 2);  // k=8
      break;
    case 8:
      g_add(s, 40, 100, 53);
      break;
    case 9:
      g_add(s, 41, 59, 60);
      break;
    case 10:
      g_sub(s, 45, 96, 50, 2);  // k=8
      break;
    case 11:
      g_add(s, 48, 96, 50);
      break;
    case 12:
      g_add(s, 51, 63, 94);
      break;
    case 13:
      g_sub(s, 54, 65, 62, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 35: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 17, 31, 21);
      break;
    case 1:
      g_add(s, 23, 28, 24);
      break;
    case 2:
      g_add(s, 30, 98, 39);
      break;
    case 3:
      g_add(s, 32, 52, 40);
      break;
    case 4:
      g_add(s, 33, 62, 29);
      break;
    case 5:
      g_add(s, 35, 25, 34);
      break;
    case 6:
      g_add(s, 37, 26, 49);
      break;
    case 7:
      g_sub(s, 46, 41, 25, 3);  // k=16
      break;
    case 8:
      g_sub(s, 47, 54, 94, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 36: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 21, 17, 45);
      break;
    case 1:
      g_add(s, 24, 23, 48);
      break;
    case 2:
      g_sub(s, 25, 30, 17, 3);  // k=16
      break;
    case 3:
      g_sub(s, 28, 32, 23, 3);  // k=16
      break;
    case 4:
      g_sub(s, 31, 46, 49, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 37: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 17, 25, 29, 3);  // k=16
      break;
    case 1:
      g_sub(s, 23, 28, 34, 3);  // k=16
      break;
    default:
      break;
  })
  // phase 38: round 9 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 25, 27, 2);
      break;
    case 1:
      g_mul(s, 28, 20, 2);
      break;
    case 2:
      g_mul(s, 29, 38, 36);
      break;
    case 3:
      g_mul(s, 34, 106, 107);
      break;
    case 4:
      g_mul(s, 30, 21, 2);
      break;
    case 5:
      g_mul(s, 32, 24, 2);
      break;
    case 6:
      g_mul(s, 45, 33, 2);
      break;
    case 7:
      g_mul(s, 46, 35, 2);
      break;
    case 8:
      g_mul(s, 48, 51, 2);
      break;
    case 9:
      g_mul(s, 49, 37, 2);
      break;
    case 10:
      g_mul(s, 39, 17, 2);
      break;
    case 11:
      g_mul(s, 40, 23, 2);
      break;
    case 12:
      g_mul(s, 41, 47, 2);
      break;
    case 13:
      g_mul(s, 52, 31, 2);
      break;
    default:
      break;
  })
  // phase 39: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 17, 88, 89, 0);  // k=2
      break;
    case 1:
      g_add(s, 20, 88, 89);
      break;
    case 2:
      g_sub(s, 21, 91, 29, 0);  // k=2
      break;
    case 3:
      g_add(s, 23, 91, 29);
      break;
    default:
      break;
  })
  // phase 40: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 29, 90, 20, 1);  // k=4
      break;
    case 1:
      g_sub(s, 88, 34, 23, 1);  // k=4
      break;
    case 2:
      g_add(s, 89, 17, 21);
      break;
    default:
      break;
  })
  // phase 41: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_add(s, 17, 29, 88);
      break;
    case 1:
      g_sub(s, 20, 89, 63, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 42: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 29, 17, 26, 3);  // k=16
      break;
    case 1:
      g_sub(s, 63, 20, 96, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 43: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sub(s, 17, 29, 50, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 44: round 10 of products
  LH_RANKS(16, switch (r) {
    case 0:
      g_mul(s, 29, 63, 2);
      break;
    case 1:
      g_mul(s, 50, 17, 2);
      break;
    default:
      break;
  })
  // phase 45: linear ops
  LH_RANKS(16, switch (r) {
    case 0:
      g_sel(s, 2, take, 30, 3);
      if (live) g_store(f_out, 0, n, lane, s, 2);
      g_sel(s, 33, take, 43, 0);
      if (live) g_store(t_out, 4, n, lane, s, 33);
      break;
    case 1:
      g_sel(s, 17, take, 32, 6);
      if (live) g_store(f_out, 1, n, lane, s, 17);
      g_sel(s, 35, take, 22, 1);
      if (live) g_store(t_out, 5, n, lane, s, 35);
      break;
    case 2:
      g_sel(s, 63, take, 45, 7);
      if (live) g_store(f_out, 2, n, lane, s, 63);
      break;
    case 3:
      g_sel(s, 20, take, 46, 11);
      if (live) g_store(f_out, 3, n, lane, s, 20);
      break;
    case 4:
      g_sel(s, 26, take, 48, 13);
      if (live) g_store(f_out, 4, n, lane, s, 26);
      break;
    case 5:
      g_sel(s, 96, take, 49, 14);
      if (live) g_store(f_out, 5, n, lane, s, 96);
      break;
    case 6:
      g_sel(s, 88, take, 39, 9);
      if (live) g_store(f_out, 6, n, lane, s, 88);
      break;
    case 7:
      g_sel(s, 89, take, 40, 12);
      if (live) g_store(f_out, 7, n, lane, s, 89);
      break;
    case 8:
      g_sel(s, 21, take, 41, 15);
      if (live) g_store(f_out, 8, n, lane, s, 21);
      break;
    case 9:
      g_sel(s, 23, take, 52, 16);
      if (live) g_store(f_out, 9, n, lane, s, 23);
      break;
    case 10:
      g_sel(s, 34, take, 29, 18);
      if (live) g_store(f_out, 10, n, lane, s, 34);
      break;
    case 11:
      g_sel(s, 90, take, 50, 19);
      if (live) g_store(f_out, 11, n, lane, s, 90);
      break;
    case 12:
      g_sel(s, 91, take, 44, 4);
      if (live) g_store(t_out, 0, n, lane, s, 91);
      break;
    case 13:
      g_sel(s, 24, take, 42, 5);
      if (live) g_store(t_out, 1, n, lane, s, 24);
      break;
    case 14:
      g_sel(s, 27, take, 25, 8);
      if (live) g_store(t_out, 2, n, lane, s, 27);
      break;
    case 15:
      g_sel(s, 31, take, 28, 10);
      if (live) g_store(t_out, 3, n, lane, s, 31);
      break;
    default:
      break;
  })
}

extern "C" int lh_miller_step_add_g16(const void* f, const void* t, const void* q, const void* xp, const void* yp, const void* bit, void* f_out, void* t_out, int n,
                              void* stream) {
  constexpr int kShared = 2808 * 2 * lh::kGroupLanes;
  static_assert(kShared <= 232448, "one block's shared memory on sm_90");
  const cudaError_t attr = lh::set_shared_limit(miller_step_add_g16_kernel, kShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n > 0) {
    miller_step_add_g16_kernel<<<(n + lh::kGroupLanes - 1) / lh::kGroupLanes, 16 * lh::kGroupLanes,
                          kShared, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(f), static_cast<const uint32_t*>(t), static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(yp), static_cast<const int32_t*>(bit),
        static_cast<uint32_t*>(f_out), static_cast<uint32_t*>(t_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
