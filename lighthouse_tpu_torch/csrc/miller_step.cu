// Generated by lighthouse_tpu_torch/crypto/bls/torch_backend/codegen.py; do not edit.
// Kernels 2 and 3: the fused Miller doubling and addition steps, replacing
// lighthouse_tpu/crypto/bls/jax_backend/pallas_miller.py:_step_dbl_kernel and
// _step_add_kernel.  Printed from the step programs that
// torch_backend/miller_kernel.py records from the formulas of
// pallas_miller.py; the plain PyTorch version runs the same programs.
//
// Kernel 2 (the doubling step) runs in the group form: G = 16 threads per
// lane (csrc/group.cuh).  One thread per lane ran its 169 products one after
// another, each a 1,703-multiply chain of one thread, with one warp per SM
// at the Miller loop's 4,097 lanes: the card waited on that thread's issue
// rate and latency.  The products of one dependency level are independent,
// so the group runs them side by side: rounds of at most G products (one
// per thread, the unchanged lh::mont_core, so the bytes are the same by
// construction) and the linear ops between them dealt to the ranks, a
// barrier after each phase.  The serial chain falls from 169 products to 11
// rounds, and the card gets G times the warps.  The lane's values live in
// shared memory, 16 bits a limb, in slots reassigned by the phase schedule
// (codegen.group_schedule).
//
// Kernel 3 (the addition step) keeps the first design: one thread per lane,
// its values in the slot array s (registers spilling to local memory),
// every Montgomery product one call of the non-inlined k_mul.
//
// Planes are (planes, 26, n) limb-major, so limb i of neighbouring lanes are
// neighbouring words and every load and store coalesces; both forms read
// each input plane once and write each output plane once.
#include "group.cuh"
#include "mont.cuh"

namespace {

using lh::NL;

constexpr int kBlock = 32;  // kernel 3: 4,097 lanes -> 129 blocks, one per SM

__device__ __noinline__ void k_mul(uint32_t* o, const uint32_t* a, const uint32_t* b) {
  uint32_t x[NL], y[NL], r[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    x[i] = a[i];
    y[i] = b[i];
  }
  lh::mont_core(x, y, r);
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = r[i];
}

__device__ __forceinline__ void carry_store(uint32_t* o, uint32_t (&c)[NL]) {
  lh::compress1(c);
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = c[i];
}

// a + b, one carry pass
__device__ __noinline__ void k_add(uint32_t* o, const uint32_t* a, const uint32_t* b) {
  uint32_t c[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = a[i] + b[i];
  carry_store(o, c);
}

// a + kP - b, one carry pass (the bias dominates b limb by limb)
__device__ __noinline__ void k_sub(uint32_t* o, const uint32_t* a, const uint32_t* b, int kidx) {
  uint32_t c[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = a[i] + lh::kBias[kidx][i] - b[i];
  carry_store(o, c);
}

// kP - a, one carry pass
__device__ __noinline__ void k_neg(uint32_t* o, const uint32_t* a, int kidx) {
  uint32_t c[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = lh::kBias[kidx][i] - a[i];
  carry_store(o, c);
}

__device__ __forceinline__ void k_sel(uint32_t* o, bool take, const uint32_t* a,
                                      const uint32_t* b) {
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = take ? a[i] : b[i];
}

__device__ __forceinline__ void k_one(uint32_t* o) {
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = lh::kOne[i];
}

__device__ __forceinline__ void k_load(uint32_t* o, const uint32_t* base, int plane, int n,
                                       int lane) {
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = base[(static_cast<size_t>(plane) * NL + i) * n + lane];
}

__device__ __forceinline__ void k_store(uint32_t* base, int plane, int n, int lane,
                                        const uint32_t* v) {
#pragma unroll
  for (int i = 0; i < NL; ++i) base[(static_cast<size_t>(plane) * NL + i) * n + lane] = v[i];
}

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

__device__ __noinline__ void g_mul(uint16_t* s, int o, int a, int b) {
  uint32_t x[NL], y[NL], r[NL];
  g_get(s, a, x);
  g_get(s, b, y);
  lh::mont_core(x, y, r);
  g_put(s, o, r);
}

__device__ __noinline__ void g_sqr(uint16_t* s, int o, int a) {
  uint32_t x[NL], r[NL];
  g_get(s, a, x);
  lh::mont_sqr_core(x, r);
  g_put(s, o, r);
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

}  // namespace

// miller_step_dbl_g16: 565 limb ops, 169 Montgomery products; 16 threads per lane,
// 11 rounds of products in 51 phases, 92 slots
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
  static const cudaError_t attr = cudaFuncSetAttribute(
      miller_step_dbl_g16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n > 0) {
    miller_step_dbl_g16_kernel<<<(n + lh::kGroupLanes - 1) / lh::kGroupLanes, 16 * lh::kGroupLanes,
                          kShared, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(f), static_cast<const uint32_t*>(t), static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(yp),
        static_cast<uint32_t*>(f_out), static_cast<uint32_t*>(t_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// miller_step_add: 353 limb ops, 111 Montgomery products, 62 slots.
static __global__ void __launch_bounds__(kBlock)
miller_step_add_kernel(const uint32_t* __restrict__ f, const uint32_t* __restrict__ t, const uint32_t* __restrict__ q, const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp, const int32_t* __restrict__ bit, uint32_t* __restrict__ f_out, uint32_t* __restrict__ t_out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t s[62][NL];
  k_one(s[0]);
  k_load(s[1], f, 0, n, lane);
  k_load(s[2], f, 1, n, lane);
  k_load(s[3], f, 2, n, lane);
  k_load(s[4], f, 3, n, lane);
  k_load(s[5], f, 4, n, lane);
  k_load(s[6], f, 5, n, lane);
  k_load(s[7], f, 6, n, lane);
  k_load(s[8], f, 7, n, lane);
  k_load(s[9], f, 8, n, lane);
  k_load(s[10], f, 9, n, lane);
  k_load(s[11], f, 10, n, lane);
  k_load(s[12], f, 11, n, lane);
  k_load(s[13], t, 0, n, lane);
  k_load(s[14], t, 1, n, lane);
  k_load(s[15], t, 2, n, lane);
  k_load(s[16], t, 3, n, lane);
  k_load(s[17], t, 4, n, lane);
  k_load(s[18], t, 5, n, lane);
  k_load(s[19], q, 0, n, lane);
  k_load(s[20], q, 1, n, lane);
  k_load(s[21], q, 2, n, lane);
  k_load(s[22], q, 3, n, lane);
  k_load(s[23], xp, 0, n, lane);
  k_load(s[24], yp, 0, n, lane);
  const bool take = bit[lane] != 0;
  k_sub(s[25], s[17], s[18], 1);  // k=4
  k_add(s[26], s[17], s[18]);
  k_mul(s[27], s[25], s[26]);
  k_mul(s[26], s[17], s[18]);
  k_add(s[25], s[26], s[26]);
  k_add(s[26], s[27], s[25]);
  k_add(s[28], s[17], s[18]);
  k_mul(s[29], s[27], s[17]);
  k_mul(s[30], s[25], s[18]);
  k_mul(s[31], s[26], s[28]);
  k_sub(s[28], s[29], s[30], 0);  // k=2
  k_add(s[26], s[29], s[30]);
  k_sub(s[30], s[31], s[26], 1);  // k=4
  k_add(s[31], s[19], s[20]);
  k_add(s[26], s[27], s[25]);
  k_mul(s[29], s[19], s[27]);
  k_mul(s[27], s[20], s[25]);
  k_mul(s[25], s[31], s[26]);
  k_sub(s[31], s[29], s[27], 0);  // k=2
  k_add(s[26], s[29], s[27]);
  k_sub(s[29], s[25], s[26], 1);  // k=4
  k_sub(s[26], s[31], s[13], 1);  // k=4
  k_sub(s[31], s[29], s[14], 1);  // k=4
  k_add(s[29], s[21], s[22]);
  k_add(s[25], s[28], s[30]);
  k_mul(s[27], s[21], s[28]);
  k_mul(s[28], s[22], s[30]);
  k_mul(s[30], s[29], s[25]);
  k_sub(s[29], s[27], s[28], 0);  // k=2
  k_add(s[25], s[27], s[28]);
  k_sub(s[28], s[30], s[25], 1);  // k=4
  k_add(s[30], s[17], s[18]);
  k_add(s[25], s[26], s[31]);
  k_mul(s[27], s[17], s[26]);
  k_mul(s[32], s[18], s[31]);
  k_mul(s[33], s[30], s[25]);
  k_sub(s[30], s[27], s[32], 0);  // k=2
  k_add(s[25], s[27], s[32]);
  k_sub(s[32], s[33], s[25], 1);  // k=4
  k_sub(s[33], s[26], s[31], 3);  // k=16
  k_add(s[25], s[26], s[31]);
  k_mul(s[27], s[33], s[25]);
  k_mul(s[33], s[26], s[31]);
  k_add(s[25], s[33], s[33]);
  k_sub(s[33], s[29], s[15], 1);  // k=4
  k_sub(s[29], s[28], s[16], 1);  // k=4
  k_add(s[28], s[33], s[29]);
  k_add(s[34], s[19], s[20]);
  k_mul(s[35], s[33], s[19]);
  k_mul(s[19], s[29], s[20]);
  k_mul(s[20], s[28], s[34]);
  k_sub(s[34], s[35], s[19], 0);  // k=2
  k_add(s[28], s[35], s[19]);
  k_sub(s[35], s[20], s[28], 1);  // k=4
  k_add(s[28], s[21], s[22]);
  k_add(s[20], s[30], s[32]);
  k_mul(s[19], s[21], s[30]);
  k_mul(s[21], s[22], s[32]);
  k_mul(s[22], s[28], s[20]);
  k_sub(s[28], s[19], s[21], 0);  // k=2
  k_add(s[20], s[19], s[21]);
  k_sub(s[21], s[22], s[20], 1);  // k=4
  k_sub(s[22], s[33], s[29], 3);  // k=16
  k_add(s[20], s[33], s[29]);
  k_mul(s[19], s[22], s[20]);
  k_mul(s[22], s[33], s[29]);
  k_add(s[20], s[22], s[22]);
  k_add(s[22], s[26], s[31]);
  k_add(s[36], s[27], s[25]);
  k_mul(s[37], s[26], s[27]);
  k_mul(s[26], s[31], s[25]);
  k_mul(s[31], s[22], s[36]);
  k_sub(s[36], s[37], s[26], 0);  // k=2
  k_add(s[22], s[37], s[26]);
  k_sub(s[37], s[31], s[22], 1);  // k=4
  k_add(s[31], s[13], s[14]);
  k_add(s[22], s[27], s[25]);
  k_mul(s[26], s[13], s[27]);
  k_mul(s[27], s[14], s[25]);
  k_mul(s[25], s[31], s[22]);
  k_sub(s[31], s[26], s[27], 0);  // k=2
  k_add(s[22], s[26], s[27]);
  k_sub(s[27], s[25], s[22], 1);  // k=4
  k_sub(s[25], s[34], s[28], 1);  // k=4
  k_sub(s[34], s[35], s[21], 2);  // k=8
  k_sub(s[35], s[19], s[36], 1);  // k=4
  k_sub(s[19], s[20], s[37], 2);  // k=8
  k_add(s[20], s[31], s[31]);
  k_add(s[21], s[27], s[27]);
  k_sub(s[28], s[35], s[20], 2);  // k=8
  k_sub(s[35], s[19], s[21], 3);  // k=16
  k_sub(s[21], s[31], s[28], 3);  // k=16
  k_sub(s[31], s[27], s[35], 4);  // k=32
  k_mul(s[27], s[21], s[0]);
  k_mul(s[21], s[31], s[0]);
  k_add(s[31], s[33], s[29]);
  k_add(s[19], s[27], s[21]);
  k_mul(s[20], s[33], s[27]);
  k_mul(s[27], s[29], s[21]);
  k_mul(s[21], s[31], s[19]);
  k_sub(s[31], s[20], s[27], 0);  // k=2
  k_add(s[19], s[20], s[27]);
  k_sub(s[27], s[21], s[19], 1);  // k=4
  k_add(s[21], s[15], s[16]);
  k_add(s[19], s[36], s[37]);
  k_mul(s[20], s[15], s[36]);
  k_mul(s[36], s[16], s[37]);
  k_mul(s[37], s[21], s[19]);
  k_sub(s[21], s[20], s[36], 0);  // k=2
  k_add(s[19], s[20], s[36]);
  k_sub(s[36], s[37], s[19], 1);  // k=4
  k_sub(s[37], s[31], s[21], 1);  // k=4
  k_sub(s[31], s[27], s[36], 2);  // k=8
  k_neg(s[36], s[33], 2);  // k=8
  k_neg(s[33], s[29], 3);  // k=16
  k_mul(s[29], s[36], s[23]);
  k_mul(s[36], s[33], s[23]);
  k_mul(s[33], s[30], s[24]);
  k_mul(s[23], s[32], s[24]);
  k_mul(s[24], s[25], s[0]);
  k_mul(s[25], s[34], s[0]);
  k_mul(s[34], s[29], s[0]);
  k_mul(s[29], s[36], s[0]);
  k_mul(s[36], s[33], s[0]);
  k_mul(s[33], s[23], s[0]);
  k_mul(s[23], s[28], s[0]);
  k_mul(s[28], s[35], s[0]);
  k_mul(s[35], s[37], s[0]);
  k_mul(s[37], s[31], s[0]);
  k_mul(s[31], s[30], s[0]);
  k_mul(s[30], s[32], s[0]);
  k_add(s[32], s[1], s[7]);
  k_add(s[27], s[2], s[8]);
  k_add(s[21], s[3], s[9]);
  k_add(s[19], s[4], s[10]);
  k_add(s[20], s[5], s[11]);
  k_add(s[22], s[6], s[12]);
  k_add(s[26], s[34], s[36]);
  k_add(s[38], s[29], s[33]);
  k_add(s[39], s[1], s[2]);
  k_add(s[40], s[24], s[25]);
  k_mul(s[41], s[1], s[24]);
  k_mul(s[42], s[2], s[25]);
  k_mul(s[43], s[39], s[40]);
  k_sub(s[40], s[41], s[42], 0);  // k=2
  k_add(s[39], s[41], s[42]);
  k_sub(s[42], s[43], s[39], 1);  // k=4
  k_add(s[43], s[5], s[6]);
  k_add(s[39], s[34], s[29]);
  k_mul(s[41], s[5], s[34]);
  k_mul(s[44], s[6], s[29]);
  k_mul(s[45], s[43], s[39]);
  k_sub(s[43], s[41], s[44], 0);  // k=2
  k_add(s[39], s[41], s[44]);
  k_sub(s[44], s[45], s[39], 1);  // k=4
  k_add(s[45], s[1], s[2]);
  k_add(s[39], s[34], s[29]);
  k_mul(s[41], s[1], s[34]);
  k_mul(s[46], s[2], s[29]);
  k_mul(s[47], s[45], s[39]);
  k_sub(s[45], s[41], s[46], 0);  // k=2
  k_add(s[39], s[41], s[46]);
  k_sub(s[46], s[47], s[39], 1);  // k=4
  k_add(s[47], s[3], s[4]);
  k_add(s[39], s[24], s[25]);
  k_mul(s[41], s[3], s[24]);
  k_mul(s[48], s[4], s[25]);
  k_mul(s[49], s[47], s[39]);
  k_sub(s[47], s[41], s[48], 0);  // k=2
  k_add(s[39], s[41], s[48]);
  k_sub(s[48], s[49], s[39], 1);  // k=4
  k_add(s[49], s[3], s[4]);
  k_add(s[39], s[34], s[29]);
  k_mul(s[41], s[3], s[34]);
  k_mul(s[34], s[4], s[29]);
  k_mul(s[29], s[49], s[39]);
  k_sub(s[49], s[41], s[34], 0);  // k=2
  k_add(s[39], s[41], s[34]);
  k_sub(s[41], s[29], s[39], 1);  // k=4
  k_add(s[39], s[5], s[6]);
  k_add(s[29], s[24], s[25]);
  k_mul(s[34], s[5], s[24]);
  k_mul(s[50], s[6], s[25]);
  k_mul(s[51], s[39], s[29]);
  k_sub(s[39], s[34], s[50], 0);  // k=2
  k_add(s[29], s[34], s[50]);
  k_sub(s[50], s[51], s[29], 1);  // k=4
  k_add(s[51], s[11], s[12]);
  k_add(s[29], s[36], s[33]);
  k_mul(s[34], s[11], s[36]);
  k_mul(s[52], s[12], s[33]);
  k_mul(s[53], s[51], s[29]);
  k_sub(s[51], s[34], s[52], 0);  // k=2
  k_add(s[29], s[34], s[52]);
  k_sub(s[52], s[53], s[29], 1);  // k=4
  k_add(s[53], s[7], s[8]);
  k_add(s[29], s[36], s[33]);
  k_mul(s[34], s[7], s[36]);
  k_mul(s[54], s[8], s[33]);
  k_mul(s[55], s[53], s[29]);
  k_sub(s[53], s[34], s[54], 0);  // k=2
  k_add(s[29], s[34], s[54]);
  k_sub(s[54], s[55], s[29], 1);  // k=4
  k_add(s[55], s[9], s[10]);
  k_add(s[29], s[36], s[33]);
  k_mul(s[34], s[9], s[36]);
  k_mul(s[36], s[10], s[33]);
  k_mul(s[33], s[55], s[29]);
  k_sub(s[55], s[34], s[36], 0);  // k=2
  k_add(s[29], s[34], s[36]);
  k_sub(s[36], s[33], s[29], 1);  // k=4
  k_add(s[33], s[32], s[27]);
  k_add(s[29], s[24], s[25]);
  k_mul(s[34], s[32], s[24]);
  k_mul(s[56], s[27], s[25]);
  k_mul(s[57], s[33], s[29]);
  k_sub(s[33], s[34], s[56], 0);  // k=2
  k_add(s[29], s[34], s[56]);
  k_sub(s[56], s[57], s[29], 1);  // k=4
  k_add(s[57], s[20], s[22]);
  k_add(s[29], s[26], s[38]);
  k_mul(s[34], s[20], s[26]);
  k_mul(s[58], s[22], s[38]);
  k_mul(s[59], s[57], s[29]);
  k_sub(s[57], s[34], s[58], 0);  // k=2
  k_add(s[29], s[34], s[58]);
  k_sub(s[58], s[59], s[29], 1);  // k=4
  k_add(s[59], s[32], s[27]);
  k_add(s[29], s[26], s[38]);
  k_mul(s[34], s[32], s[26]);
  k_mul(s[32], s[27], s[38]);
  k_mul(s[27], s[59], s[29]);
  k_sub(s[59], s[34], s[32], 0);  // k=2
  k_add(s[29], s[34], s[32]);
  k_sub(s[34], s[27], s[29], 1);  // k=4
  k_add(s[29], s[21], s[19]);
  k_add(s[27], s[24], s[25]);
  k_mul(s[32], s[21], s[24]);
  k_mul(s[60], s[19], s[25]);
  k_mul(s[61], s[29], s[27]);
  k_sub(s[29], s[32], s[60], 0);  // k=2
  k_add(s[27], s[32], s[60]);
  k_sub(s[60], s[61], s[27], 1);  // k=4
  k_add(s[61], s[21], s[19]);
  k_add(s[27], s[26], s[38]);
  k_mul(s[32], s[21], s[26]);
  k_mul(s[26], s[19], s[38]);
  k_mul(s[38], s[61], s[27]);
  k_sub(s[61], s[32], s[26], 0);  // k=2
  k_add(s[27], s[32], s[26]);
  k_sub(s[32], s[38], s[27], 1);  // k=4
  k_add(s[38], s[20], s[22]);
  k_add(s[27], s[24], s[25]);
  k_mul(s[26], s[20], s[24]);
  k_mul(s[24], s[22], s[25]);
  k_mul(s[25], s[38], s[27]);
  k_sub(s[38], s[26], s[24], 0);  // k=2
  k_add(s[27], s[26], s[24]);
  k_sub(s[26], s[25], s[27], 1);  // k=4
  k_sub(s[27], s[43], s[44], 2);  // k=8
  k_add(s[25], s[43], s[44]);
  k_add(s[44], s[40], s[27]);
  k_add(s[40], s[42], s[25]);
  k_add(s[42], s[45], s[47]);
  k_add(s[47], s[46], s[48]);
  k_add(s[48], s[49], s[39]);
  k_add(s[49], s[41], s[50]);
  k_sub(s[50], s[51], s[52], 2);  // k=8
  k_add(s[41], s[51], s[52]);
  k_sub(s[52], s[57], s[58], 2);  // k=8
  k_add(s[51], s[57], s[58]);
  k_add(s[58], s[33], s[52]);
  k_add(s[52], s[56], s[51]);
  k_add(s[56], s[59], s[29]);
  k_add(s[59], s[34], s[60]);
  k_add(s[60], s[61], s[38]);
  k_add(s[61], s[32], s[26]);
  k_sub(s[32], s[55], s[36], 2);  // k=8
  k_add(s[26], s[55], s[36]);
  k_add(s[38], s[44], s[32]);
  k_add(s[32], s[40], s[26]);
  k_add(s[26], s[42], s[50]);
  k_add(s[34], s[47], s[41]);
  k_add(s[29], s[48], s[53]);
  k_add(s[51], s[49], s[54]);
  k_sub(s[33], s[58], s[44], 3);  // k=16
  k_sub(s[58], s[52], s[40], 3);  // k=16
  k_sub(s[52], s[56], s[42], 2);  // k=8
  k_sub(s[56], s[59], s[47], 3);  // k=16
  k_sub(s[59], s[60], s[48], 2);  // k=8
  k_sub(s[60], s[61], s[49], 3);  // k=16
  k_sub(s[61], s[33], s[50], 3);  // k=16
  k_sub(s[50], s[58], s[41], 3);  // k=16
  k_sub(s[58], s[52], s[53], 1);  // k=4
  k_sub(s[53], s[56], s[54], 2);  // k=8
  k_sub(s[56], s[59], s[55], 1);  // k=4
  k_sub(s[59], s[60], s[36], 2);  // k=8
  k_mul(s[60], s[38], s[0]);
  k_mul(s[38], s[32], s[0]);
  k_mul(s[32], s[26], s[0]);
  k_mul(s[26], s[34], s[0]);
  k_mul(s[34], s[29], s[0]);
  k_mul(s[29], s[51], s[0]);
  k_mul(s[51], s[61], s[0]);
  k_mul(s[61], s[50], s[0]);
  k_mul(s[50], s[58], s[0]);
  k_mul(s[58], s[53], s[0]);
  k_mul(s[53], s[56], s[0]);
  k_mul(s[56], s[59], s[0]);
  k_sel(s[59], take, s[60], s[1]);
  k_store(f_out, 0, n, lane, s[59]);
  k_sel(s[60], take, s[38], s[2]);
  k_store(f_out, 1, n, lane, s[60]);
  k_sel(s[60], take, s[32], s[3]);
  k_store(f_out, 2, n, lane, s[60]);
  k_sel(s[60], take, s[26], s[4]);
  k_store(f_out, 3, n, lane, s[60]);
  k_sel(s[60], take, s[34], s[5]);
  k_store(f_out, 4, n, lane, s[60]);
  k_sel(s[60], take, s[29], s[6]);
  k_store(f_out, 5, n, lane, s[60]);
  k_sel(s[60], take, s[51], s[7]);
  k_store(f_out, 6, n, lane, s[60]);
  k_sel(s[60], take, s[61], s[8]);
  k_store(f_out, 7, n, lane, s[60]);
  k_sel(s[61], take, s[50], s[9]);
  k_store(f_out, 8, n, lane, s[61]);
  k_sel(s[61], take, s[58], s[10]);
  k_store(f_out, 9, n, lane, s[61]);
  k_sel(s[61], take, s[53], s[11]);
  k_store(f_out, 10, n, lane, s[61]);
  k_sel(s[61], take, s[56], s[12]);
  k_store(f_out, 11, n, lane, s[61]);
  k_sel(s[61], take, s[23], s[13]);
  k_store(t_out, 0, n, lane, s[61]);
  k_sel(s[61], take, s[28], s[14]);
  k_store(t_out, 1, n, lane, s[61]);
  k_sel(s[61], take, s[35], s[15]);
  k_store(t_out, 2, n, lane, s[61]);
  k_sel(s[61], take, s[37], s[16]);
  k_store(t_out, 3, n, lane, s[61]);
  k_sel(s[61], take, s[31], s[17]);
  k_store(t_out, 4, n, lane, s[61]);
  k_sel(s[61], take, s[30], s[18]);
  k_store(t_out, 5, n, lane, s[61]);
}

extern "C" int lh_miller_step_add(const void* f, const void* t, const void* q, const void* xp, const void* yp, const void* bit, void* f_out, void* t_out, int n,
                              void* stream) {
  if (n > 0) {
    miller_step_add_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(f), static_cast<const uint32_t*>(t), static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(yp), static_cast<const int32_t*>(bit),
        static_cast<uint32_t*>(f_out), static_cast<uint32_t*>(t_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
