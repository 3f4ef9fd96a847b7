// Generated by lighthouse_tpu_torch/crypto/bls/torch_backend/codegen.py; do not edit.
// The MXU variants of kernels 2 and 3: the same fused Miller steps with
// every Montgomery product on the 31 x 13-bit plane (kernel 7's core,
// csrc/mxu.cuh), as pallas_miller.py builds _step_dbl_kernel and
// _step_add_kernel with mxu=True (_Ctx -> pallas_fp._core_pair).  Printed
// from the same step programs as miller_step.cu; the plain PyTorch version
// runs them over mxu_kernel.mont_mul_mxu_plain.
//
// Kernel 2m (the doubling step) runs in the group form of miller_step.cu
// (csrc/group.cuh) with G = 8 threads per lane in blocks of 32 lanes, so
// each warp is the 32 lanes of one rank: a phase's switch on the rank is
// warp-uniform and every product's mma.sync (csrc/mxu.cuh) is made by a
// whole warp, its N dimension the warp's 32 lanes as in the one-thread
// form; the tail threads run lane n - 1 again and store nothing.  Each
// warp stages its DMMA products in shared memory beside the block's slots:
// the 64 rows of m * P in two passes of 32 (kMxuRows), so that 8 warps'
// staging and the slots fit in one block (its launcher asserts the bytes).
//
// Kernel 3m (the addition step) runs one thread per lane, one warp per
// block.  Its intermediates live in the slot array s (registers spilling to
// local memory); every Montgomery product is one call of the non-inlined
// k_mul on the 13-bit plane, which the whole warp makes together: the
// program is straight-line, and the tail threads run lane n - 1's operands
// again and store nothing.
//
// Planes are (planes, 26, n) limb-major, so limb i of neighbouring lanes are
// neighbouring words and every load and store coalesces.
#include "group.cuh"
#include "mxu.cuh"

namespace {

using lh::NL;

constexpr int kBlock = 32;  // kernel 3m: 4,097 lanes -> 129 blocks, one per SM
constexpr int kMxuRows = 32;  // kernel 2m: rows of C staged per pass

__device__ __noinline__ void k_mul(uint32_t* o, const uint32_t* a, const uint32_t* b,
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

__device__ __noinline__ void g_mul_mxu(uint16_t* s, int o, int a, int b, const lh::MxuCtx& mx) {
  uint32_t x[NL], y[NL], r[NL];
  g_get(s, a, x);
  g_get(s, b, y);
  lh::mont_core_mxu<kMxuRows>(x, y, r, mx);
  g_put(s, o, r);
}

}  // namespace

// miller_step_dbl_mxu_g8: 565 limb ops, 169 Montgomery products on the 13-bit plane;
// 8 threads per lane, 22 rounds of products in 88 phases, 78 slots
// (129,792 bytes of shared memory per block of 32 lanes, and
// sizeof(lh::MxuShared<8, kMxuRows>) of DMMA staging for its 8 warps).
static __global__ void __launch_bounds__(8 * lh::kGroupLanes)
miller_step_dbl_mxu_g8_kernel(const uint32_t* __restrict__ f, const uint32_t* __restrict__ t, const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp, uint32_t* __restrict__ f_out, uint32_t* __restrict__ t_out, int n) {
  LH_MXU_GROUP_SHARED(8, kMxuRows, mxu_sm, uint16_t, slots, 2028);
  const lh::MxuCtx mx = lh::mxu_setup(mxu_sm);
  const int gl = lh::group_lane();
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
  uint16_t* const s = slots + lh::group_slot();
  // phase 1: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_one(s, 0);
      g_load(s, 8, f, 7, n, lane);
      g_load(s, 16, t, 5, n, lane);
      break;
    case 1:
      g_load(s, 1, f, 0, n, lane);
      g_load(s, 9, f, 8, n, lane);
      break;
    case 2:
      g_load(s, 2, f, 1, n, lane);
      g_load(s, 10, f, 9, n, lane);
      break;
    case 3:
      g_load(s, 3, f, 2, n, lane);
      g_load(s, 11, f, 10, n, lane);
      break;
    case 4:
      g_load(s, 4, f, 3, n, lane);
      g_load(s, 12, f, 11, n, lane);
      break;
    case 5:
      g_load(s, 5, f, 4, n, lane);
      g_load(s, 13, t, 0, n, lane);
      break;
    case 6:
      g_load(s, 6, f, 5, n, lane);
      g_load(s, 14, t, 1, n, lane);
      break;
    case 7:
      g_load(s, 7, f, 6, n, lane);
      g_load(s, 15, t, 4, n, lane);
      break;
    default:
      break;
  })
  // phase 2: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 17, 13, 14, 1);  // k=4
      g_add(s, 25, 5, 9);
      break;
    case 1:
      g_add(s, 18, 13, 14);
      g_add(s, 26, 6, 10);
      break;
    case 2:
      g_sub(s, 19, 15, 16, 1);  // k=4
      break;
    case 3:
      g_add(s, 20, 15, 16);
      break;
    case 4:
      g_sub(s, 21, 11, 12, 1);  // k=4
      break;
    case 5:
      g_add(s, 22, 11, 12);
      break;
    case 6:
      g_add(s, 23, 3, 7);
      break;
    case 7:
      g_add(s, 24, 4, 8);
      break;
    default:
      break;
  })
  // phase 3: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 27, 1, 21);
      break;
    case 1:
      g_add(s, 28, 2, 22);
      break;
    default:
      break;
  })
  // phase 4: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 21, 27, 23);
      break;
    case 1:
      g_add(s, 22, 28, 24);
      break;
    case 2:
      g_add(s, 29, 27, 25);
      break;
    case 3:
      g_add(s, 30, 28, 26);
      break;
    default:
      break;
  })
  // phase 5: round 1 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 31, 17, 18, mx);
      break;
    case 1:
      g_mul_mxu(s, 32, 13, 14, mx);
      break;
    case 2:
      g_mul_mxu(s, 33, 19, 20, mx);
      break;
    case 3:
      g_mul_mxu(s, 34, 15, 16, mx);
      break;
    case 4:
      g_mul_mxu(s, 35, 21, 0, mx);
      break;
    case 5:
      g_mul_mxu(s, 36, 22, 0, mx);
      break;
    case 6:
      g_mul_mxu(s, 37, 29, 0, mx);
      break;
    case 7:
      g_mul_mxu(s, 38, 30, 0, mx);
      break;
    default:
      break;
  })
  // phase 6: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_load(s, 17, t, 2, n, lane);
      break;
    case 1:
      g_load(s, 18, t, 3, n, lane);
      break;
    case 2:
      g_add(s, 19, 32, 32);
      break;
    case 3:
      g_add(s, 20, 34, 34);
      break;
    case 4:
      g_add(s, 21, 15, 16);
      break;
    default:
      break;
  })
  // phase 7: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 32, 17, 18, 1);  // k=4
      break;
    case 1:
      g_add(s, 34, 17, 18);
      break;
    case 2:
      g_add(s, 22, 33, 20);
      break;
    case 3:
      g_add(s, 29, 31, 19);
      break;
    case 4:
      g_add(s, 30, 33, 20);
      break;
    default:
      break;
  })
  // phase 8: round 2 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 39, 32, 34, mx);
      break;
    case 1:
      g_mul_mxu(s, 40, 17, 18, mx);
      break;
    case 2:
      g_mul_mxu(s, 41, 33, 15, mx);
      break;
    case 3:
      g_mul_mxu(s, 42, 20, 16, mx);
      break;
    case 4:
      g_mul_mxu(s, 43, 22, 21, mx);
      break;
    case 5:
      g_mul_mxu(s, 44, 31, 33, mx);
      break;
    case 6:
      g_mul_mxu(s, 45, 19, 20, mx);
      break;
    case 7:
      g_mul_mxu(s, 46, 29, 30, mx);
      break;
    default:
      break;
  })
  // phase 9: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 20, 41, 42, 0);  // k=2
      break;
    case 1:
      g_add(s, 21, 41, 42);
      break;
    case 2:
      g_add(s, 22, 17, 18);
      break;
    case 3:
      g_add(s, 29, 1, 2);
      break;
    case 4:
      g_add(s, 30, 7, 8);
      break;
    default:
      break;
  })
  // phase 10: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 41, 43, 21, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 11: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 21, 20, 41);
      break;
    default:
      break;
  })
  // phase 12: round 3 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 43, 17, 20, mx);
      break;
    case 1:
      g_mul_mxu(s, 42, 18, 41, mx);
      break;
    case 2:
      g_mul_mxu(s, 32, 22, 21, mx);
      break;
    case 3:
      g_mul_mxu(s, 33, 1, 7, mx);
      break;
    case 4:
      g_mul_mxu(s, 34, 2, 8, mx);
      break;
    case 5:
      g_mul_mxu(s, 47, 29, 30, mx);
      break;
    case 6:
      g_mul_mxu(s, 48, 3, 9, mx);
      break;
    case 7:
      g_mul_mxu(s, 49, 4, 10, mx);
      break;
    default:
      break;
  })
  // phase 13: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 20, 3, 4);
      g_add(s, 52, 1, 3);
      break;
    case 1:
      g_add(s, 21, 9, 10);
      g_add(s, 53, 7, 9);
      break;
    case 2:
      g_add(s, 22, 5, 6);
      break;
    case 3:
      g_add(s, 29, 11, 12);
      break;
    case 4:
      g_add(s, 30, 3, 5);
      break;
    case 5:
      g_add(s, 41, 4, 6);
      break;
    case 6:
      g_add(s, 50, 9, 11);
      break;
    case 7:
      g_add(s, 51, 10, 12);
      break;
    default:
      break;
  })
  // phase 14: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 54, 30, 41);
      break;
    case 1:
      g_add(s, 55, 50, 51);
      break;
    default:
      break;
  })
  // phase 15: round 4 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 56, 20, 21, mx);
      break;
    case 1:
      g_mul_mxu(s, 57, 5, 11, mx);
      break;
    case 2:
      g_mul_mxu(s, 58, 6, 12, mx);
      break;
    case 3:
      g_mul_mxu(s, 59, 22, 29, mx);
      break;
    case 4:
      g_mul_mxu(s, 60, 30, 50, mx);
      break;
    case 5:
      g_mul_mxu(s, 61, 41, 51, mx);
      break;
    case 6:
      g_mul_mxu(s, 62, 54, 55, mx);
      break;
    case 7:
      g_mul_mxu(s, 63, 52, 53, mx);
      break;
    default:
      break;
  })
  // phase 16: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 20, 2, 4);
      g_add(s, 54, 27, 28);
      break;
    case 1:
      g_add(s, 21, 8, 10);
      break;
    case 2:
      g_add(s, 22, 1, 5);
      break;
    case 3:
      g_add(s, 29, 2, 6);
      break;
    case 4:
      g_add(s, 30, 7, 11);
      break;
    case 5:
      g_add(s, 41, 8, 12);
      break;
    case 6:
      g_add(s, 50, 1, 7);
      break;
    case 7:
      g_add(s, 51, 2, 8);
      break;
    default:
      break;
  })
  // phase 17: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 1, 52, 20);
      break;
    case 1:
      g_add(s, 2, 53, 21);
      break;
    case 2:
      g_add(s, 7, 22, 29);
      break;
    case 3:
      g_add(s, 8, 30, 41);
      break;
    case 4:
      g_add(s, 55, 50, 51);
      break;
    default:
      break;
  })
  // phase 18: round 5 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 52, 20, 21, mx);
      break;
    case 1:
      g_mul_mxu(s, 53, 1, 2, mx);
      break;
    case 2:
      g_mul_mxu(s, 64, 22, 30, mx);
      break;
    case 3:
      g_mul_mxu(s, 65, 29, 41, mx);
      break;
    case 4:
      g_mul_mxu(s, 66, 7, 8, mx);
      break;
    case 5:
      g_mul_mxu(s, 67, 50, 27, mx);
      break;
    case 6:
      g_mul_mxu(s, 68, 51, 28, mx);
      break;
    case 7:
      g_mul_mxu(s, 69, 55, 54, mx);
      break;
    default:
      break;
  })
  // phase 19: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 1, 3, 9);
      break;
    case 1:
      g_add(s, 2, 4, 10);
      break;
    case 2:
      g_add(s, 7, 5, 11);
      break;
    case 3:
      g_add(s, 8, 6, 12);
      break;
    case 4:
      g_add(s, 20, 23, 24);
      break;
    case 5:
      g_add(s, 21, 25, 26);
      break;
    case 6:
      g_add(s, 22, 23, 25);
      break;
    case 7:
      g_add(s, 27, 24, 26);
      break;
    default:
      break;
  })
  // phase 20: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 3, 1, 2);
      break;
    case 1:
      g_add(s, 4, 7, 8);
      break;
    case 2:
      g_add(s, 5, 1, 7);
      break;
    case 3:
      g_add(s, 6, 2, 8);
      break;
    default:
      break;
  })
  // phase 21: round 6 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 9, 1, 23, mx);
      break;
    case 1:
      g_mul_mxu(s, 10, 2, 24, mx);
      break;
    case 2:
      g_mul_mxu(s, 11, 3, 20, mx);
      break;
    case 3:
      g_mul_mxu(s, 12, 7, 25, mx);
      break;
    case 4:
      g_mul_mxu(s, 28, 8, 26, mx);
      break;
    case 5:
      g_mul_mxu(s, 29, 4, 21, mx);
      break;
    case 6:
      g_mul_mxu(s, 30, 5, 22, mx);
      break;
    case 7:
      g_mul_mxu(s, 41, 6, 27, mx);
      break;
    default:
      break;
  })
  // phase 22: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 3, 5, 6);
      break;
    case 1:
      g_add(s, 4, 22, 27);
      break;
    case 2:
      g_add(s, 20, 50, 1);
      break;
    case 3:
      g_add(s, 21, 51, 2);
      break;
    case 4:
      g_add(s, 23, 35, 36);
      break;
    case 5:
      g_add(s, 24, 50, 7);
      break;
    case 6:
      g_add(s, 25, 51, 8);
      break;
    case 7:
      g_add(s, 26, 37, 38);
      break;
    default:
      break;
  })
  // phase 23: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 1, 20, 21);
      break;
    case 1:
      g_add(s, 2, 24, 25);
      break;
    default:
      break;
  })
  // phase 24: round 7 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 5, 31, 13, mx);
      break;
    case 1:
      g_mul_mxu(s, 6, 3, 4, mx);
      break;
    case 2:
      g_mul_mxu(s, 7, 20, 35, mx);
      break;
    case 3:
      g_mul_mxu(s, 8, 21, 36, mx);
      break;
    case 4:
      g_mul_mxu(s, 22, 1, 23, mx);
      break;
    case 5:
      g_mul_mxu(s, 27, 24, 37, mx);
      break;
    case 6:
      g_mul_mxu(s, 50, 25, 38, mx);
      break;
    case 7:
      g_mul_mxu(s, 51, 2, 26, mx);
      break;
    default:
      break;
  })
  // phase 25: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 1, 40, 40);
      break;
    case 1:
      g_add(s, 2, 31, 31);
      break;
    case 2:
      g_add(s, 3, 19, 19);
      break;
    case 3:
      g_add(s, 4, 13, 39);
      break;
    case 4:
      g_add(s, 20, 31, 19);
      break;
    case 5:
      g_add(s, 21, 13, 14);
      break;
    default:
      break;
  })
  // phase 26: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 13, 2, 31);
      break;
    case 1:
      g_add(s, 40, 3, 19);
      break;
    case 2:
      g_add(s, 23, 14, 1);
      break;
    case 3:
      g_sub(s, 24, 39, 1, 1);  // k=4
      break;
    case 4:
      g_add(s, 25, 39, 1);
      break;
    default:
      break;
  })
  // phase 27: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 2, 4, 23, 2);  // k=8
      break;
    case 1:
      g_add(s, 3, 4, 23);
      break;
    case 2:
      g_sub(s, 26, 13, 40, 2);  // k=8
      break;
    case 3:
      g_add(s, 35, 13, 40);
      break;
    default:
      break;
  })
  // phase 28: round 8 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 36, 19, 14, mx);
      break;
    case 1:
      g_mul_mxu(s, 37, 20, 21, mx);
      break;
    case 2:
      g_mul_mxu(s, 38, 24, 25, mx);
      break;
    case 3:
      g_mul_mxu(s, 54, 39, 1, mx);
      break;
    case 4:
      g_mul_mxu(s, 55, 2, 3, mx);
      break;
    case 5:
      g_mul_mxu(s, 70, 4, 23, mx);
      break;
    case 6:
      g_mul_mxu(s, 71, 26, 35, mx);
      break;
    case 7:
      g_mul_mxu(s, 72, 13, 40, mx);
      break;
    default:
      break;
  })
  // phase 29: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_load(s, 2, xp, 0, n, lane);
      g_sub(s, 25, 48, 49, 0);  // k=2
      break;
    case 1:
      g_load(s, 3, yp, 0, n, lane);
      g_add(s, 26, 48, 49);
      break;
    case 2:
      g_sub(s, 4, 44, 45, 0);  // k=2
      g_sub(s, 35, 57, 58, 0);  // k=2
      break;
    case 3:
      g_add(s, 14, 44, 45);
      g_add(s, 73, 57, 58);
      break;
    case 4:
      g_sub(s, 20, 43, 42, 0);  // k=2
      g_sub(s, 74, 60, 61, 0);  // k=2
      break;
    case 5:
      g_add(s, 21, 43, 42);
      g_add(s, 75, 60, 61);
      break;
    case 6:
      g_sub(s, 23, 33, 34, 0);  // k=2
      g_sub(s, 76, 63, 52, 0);  // k=2
      break;
    case 7:
      g_add(s, 24, 33, 34);
      g_add(s, 77, 63, 52);
      break;
    default:
      break;
  })
  // phase 30: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 33, 46, 14, 1);  // k=4
      g_sub(s, 52, 53, 77, 1);  // k=4
      break;
    case 1:
      g_sub(s, 34, 32, 21, 1);  // k=4
      g_sub(s, 57, 74, 25, 1);  // k=4
      break;
    case 2:
      g_add(s, 42, 20, 20);
      g_sub(s, 58, 76, 23, 1);  // k=4
      break;
    case 3:
      g_add(s, 43, 4, 4);
      break;
    case 4:
      g_sub(s, 44, 47, 24, 1);  // k=4
      break;
    case 5:
      g_sub(s, 45, 56, 26, 1);  // k=4
      break;
    case 6:
      g_sub(s, 48, 59, 73, 1);  // k=4
      break;
    case 7:
      g_sub(s, 49, 62, 75, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 31: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 14, 34, 34);
      g_add(s, 53, 35, 48);
      break;
    case 1:
      g_add(s, 20, 33, 33);
      break;
    case 2:
      g_add(s, 21, 43, 4);
      break;
    case 3:
      g_sub(s, 24, 49, 45, 2);  // k=8
      break;
    case 4:
      g_sub(s, 26, 57, 35, 1);  // k=4
      break;
    case 5:
      g_sub(s, 32, 52, 44, 2);  // k=8
      break;
    case 6:
      g_sub(s, 46, 58, 25, 1);  // k=4
      break;
    case 7:
      g_sub(s, 47, 35, 48, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 32: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 4, 20, 33);
      break;
    case 1:
      g_neg(s, 34, 21, 3);  // k=16
      break;
    case 2:
      g_sub(s, 43, 24, 48, 2);  // k=8
      break;
    case 3:
      g_sub(s, 49, 32, 45, 2);  // k=8
      break;
    case 4:
      g_add(s, 52, 46, 47);
      break;
    default:
      break;
  })
  // phase 33: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_neg(s, 20, 4, 3);  // k=16
      break;
    case 1:
      g_sub(s, 21, 26, 43, 4);  // k=32
      break;
    case 2:
      g_add(s, 24, 26, 43);
      break;
    case 3:
      g_add(s, 32, 49, 53);
      break;
    default:
      break;
  })
  // phase 34: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 4, 21, 23);
      break;
    case 1:
      g_add(s, 26, 24, 44);
      break;
    default:
      break;
  })
  // phase 35: round 9 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 21, 34, 2, mx);
      break;
    case 1:
      g_mul_mxu(s, 24, 20, 2, mx);
      break;
    case 2:
      g_mul_mxu(s, 43, 42, 3, mx);
      break;
    case 3:
      g_mul_mxu(s, 49, 14, 3, mx);
      break;
    case 4:
      g_mul_mxu(s, 53, 4, 0, mx);
      break;
    case 5:
      g_mul_mxu(s, 33, 26, 0, mx);
      break;
    case 6:
      g_mul_mxu(s, 46, 52, 0, mx);
      break;
    case 7:
      g_mul_mxu(s, 47, 32, 0, mx);
      break;
    default:
      break;
  })
  // phase 36: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 2, 64, 65, 0);  // k=2
      g_sub(s, 42, 30, 41, 0);  // k=2
      break;
    case 1:
      g_add(s, 3, 64, 65);
      g_add(s, 52, 30, 41);
      break;
    case 2:
      g_sub(s, 4, 67, 68, 0);  // k=2
      g_sub(s, 57, 7, 8, 0);  // k=2
      break;
    case 3:
      g_add(s, 14, 67, 68);
      g_add(s, 58, 7, 8);
      break;
    case 4:
      g_sub(s, 20, 9, 10, 0);  // k=2
      g_sub(s, 56, 27, 50, 0);  // k=2
      break;
    case 5:
      g_add(s, 26, 9, 10);
      g_add(s, 59, 27, 50);
      break;
    case 6:
      g_sub(s, 32, 12, 28, 0);  // k=2
      break;
    case 7:
      g_add(s, 34, 12, 28);
      break;
    default:
      break;
  })
  // phase 37: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 7, 66, 3, 1);  // k=4
      g_sub(s, 41, 42, 20, 1);  // k=4
      break;
    case 1:
      g_sub(s, 8, 2, 23, 1);  // k=4
      g_sub(s, 50, 57, 4, 1);  // k=4
      break;
    case 2:
      g_sub(s, 9, 69, 14, 1);  // k=4
      g_sub(s, 64, 56, 4, 1);  // k=4
      break;
    case 3:
      g_sub(s, 10, 11, 26, 1);  // k=4
      break;
    case 4:
      g_sub(s, 12, 29, 34, 1);  // k=4
      break;
    case 5:
      g_sub(s, 27, 6, 52, 1);  // k=4
      break;
    case 6:
      g_sub(s, 28, 22, 58, 1);  // k=4
      break;
    case 7:
      g_sub(s, 30, 51, 59, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 38: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 2, 7, 44, 2);  // k=8
      g_sub(s, 29, 32, 12, 2);  // k=8
      break;
    case 1:
      g_sub(s, 3, 8, 35, 1);  // k=4
      g_add(s, 34, 32, 12);
      break;
    case 2:
      g_sub(s, 6, 27, 10, 2);  // k=8
      break;
    case 3:
      g_sub(s, 11, 41, 32, 1);  // k=4
      break;
    case 4:
      g_sub(s, 14, 28, 9, 2);  // k=8
      break;
    case 5:
      g_sub(s, 22, 50, 20, 1);  // k=4
      break;
    case 6:
      g_sub(s, 23, 30, 9, 2);  // k=8
      break;
    case 7:
      g_sub(s, 26, 64, 32, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 39: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 7, 2, 48, 2);  // k=8
      break;
    case 1:
      g_add(s, 8, 3, 25);
      break;
    case 2:
      g_sub(s, 27, 6, 12, 2);  // k=8
      break;
    case 3:
      g_sub(s, 28, 14, 10, 2);  // k=8
      break;
    case 4:
      g_sub(s, 30, 23, 12, 2);  // k=8
      break;
    case 5:
      g_add(s, 32, 22, 29);
      break;
    case 6:
      g_add(s, 35, 26, 20);
      break;
    default:
      break;
  })
  // phase 40: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 2, 7, 45);
      break;
    case 1:
      g_sub(s, 3, 11, 27, 4);  // k=32
      break;
    case 2:
      g_add(s, 6, 11, 27);
      break;
    case 3:
      g_add(s, 12, 28, 34);
      break;
    case 4:
      g_add(s, 14, 30, 10);
      break;
    default:
      break;
  })
  // phase 41: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 7, 3, 4);
      break;
    case 1:
      g_add(s, 10, 6, 9);
      break;
    default:
      break;
  })
  // phase 42: round 10 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 3, 8, 0, mx);
      break;
    case 1:
      g_mul_mxu(s, 4, 2, 0, mx);
      break;
    case 2:
      g_mul_mxu(s, 6, 7, 0, mx);
      break;
    case 3:
      g_mul_mxu(s, 9, 10, 0, mx);
      break;
    case 4:
      g_mul_mxu(s, 11, 32, 0, mx);
      break;
    case 5:
      g_mul_mxu(s, 27, 12, 0, mx);
      break;
    case 6:
      g_mul_mxu(s, 28, 35, 0, mx);
      break;
    case 7:
      g_mul_mxu(s, 30, 14, 0, mx);
      break;
    default:
      break;
  })
  // phase 43: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 2, 5, 36, 0);  // k=2
      break;
    case 1:
      g_add(s, 7, 5, 36);
      break;
    case 2:
      g_add(s, 8, 54, 54);
      break;
    case 3:
      g_add(s, 10, 70, 70);
      break;
    case 4:
      g_add(s, 12, 72, 72);
      break;
    case 5:
      g_add(s, 14, 39, 39);
      break;
    case 6:
      g_add(s, 32, 1, 1);
      break;
    case 7:
      g_sub(s, 35, 55, 31, 0);  // k=2
      break;
    default:
      break;
  })
  // phase 44: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 1, 37, 7, 1);  // k=4
      break;
    case 1:
      g_add(s, 5, 2, 2);
      break;
    case 2:
      g_sub(s, 31, 10, 19, 1);  // k=4
      break;
    case 3:
      g_sub(s, 36, 35, 38, 0);  // k=2
      break;
    default:
      break;
  })
  // phase 45: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 7, 1, 1);
      break;
    case 1:
      g_add(s, 10, 5, 2);
      break;
    case 2:
      g_sub(s, 19, 31, 8, 1);  // k=4
      break;
    case 3:
      g_add(s, 35, 36, 36);
      break;
    default:
      break;
  })
  // phase 46: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 2, 7, 1);
      break;
    case 1:
      g_sub(s, 5, 10, 14, 1);  // k=4
      break;
    case 2:
      g_add(s, 31, 19, 19);
      break;
    case 3:
      g_add(s, 36, 35, 35);
      break;
    default:
      break;
  })
  // phase 47: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 1, 2, 32, 2);  // k=8
      break;
    case 1:
      g_add(s, 7, 31, 31);
      break;
    case 2:
      g_sub(s, 10, 71, 36, 4);  // k=32
      break;
    default:
      break;
  })
  // phase 48: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 2, 12, 7, 5);  // k=64
      break;
    case 1:
      g_sub(s, 32, 35, 10, 5);  // k=64
      break;
    default:
      break;
  })
  // phase 49: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 7, 31, 2, 6);  // k=128
      break;
    default:
      break;
  })
  // phase 50: round 11 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 31, 32, 0, mx);
      break;
    case 1:
      g_mul_mxu(s, 12, 7, 0, mx);
      break;
    case 2:
      g_mul_mxu(s, 35, 5, 0, mx);
      break;
    case 3:
      g_mul_mxu(s, 36, 1, 0, mx);
      break;
    case 4:
      g_mul_mxu(s, 71, 21, 0, mx);
      break;
    case 5:
      g_mul_mxu(s, 14, 24, 0, mx);
      break;
    case 6:
      g_mul_mxu(s, 19, 43, 0, mx);
      break;
    case 7:
      g_mul_mxu(s, 37, 49, 0, mx);
      break;
    default:
      break;
  })
  // phase 51: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 1, 6, 53, 1);  // k=4
      g_add(s, 39, 53, 53);
      break;
    case 1:
      g_sub(s, 5, 9, 33, 1);  // k=4
      g_add(s, 54, 33, 33);
      break;
    case 2:
      g_sub(s, 7, 11, 46, 1);  // k=4
      break;
    case 3:
      g_sub(s, 21, 27, 47, 1);  // k=4
      break;
    case 4:
      g_sub(s, 24, 28, 3, 1);  // k=4
      break;
    case 5:
      g_sub(s, 32, 30, 4, 1);  // k=4
      break;
    case 6:
      g_sub(s, 43, 3, 4, 1);  // k=4
      break;
    case 7:
      g_add(s, 49, 3, 4);
      break;
    default:
      break;
  })
  // phase 52: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 6, 1, 43, 2);  // k=8
      break;
    case 1:
      g_sub(s, 9, 5, 49, 2);  // k=8
      break;
    case 2:
      g_sub(s, 11, 7, 53, 1);  // k=4
      break;
    case 3:
      g_sub(s, 27, 21, 33, 1);  // k=4
      break;
    case 4:
      g_sub(s, 28, 24, 46, 1);  // k=4
      break;
    case 5:
      g_sub(s, 30, 32, 47, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 53: round 12 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 1, 6, 0, mx);
      break;
    case 1:
      g_mul_mxu(s, 5, 9, 0, mx);
      break;
    case 2:
      g_mul_mxu(s, 7, 11, 0, mx);
      break;
    case 3:
      g_mul_mxu(s, 21, 27, 0, mx);
      break;
    case 4:
      g_mul_mxu(s, 24, 28, 0, mx);
      break;
    case 5:
      g_mul_mxu(s, 32, 30, 0, mx);
      break;
    case 6:
      g_mul_mxu(s, 33, 39, 0, mx);
      break;
    case 7:
      g_mul_mxu(s, 43, 54, 0, mx);
      break;
    default:
      break;
  })
  // phase 54: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 6, 17, 18);
      break;
    case 1:
      g_add(s, 9, 15, 16);
      break;
    case 2:
      g_add(s, 11, 46, 46);
      break;
    case 3:
      g_add(s, 27, 47, 47);
      break;
    case 4:
      g_add(s, 28, 3, 3);
      break;
    case 5:
      g_add(s, 30, 4, 4);
      break;
    default:
      break;
  })
  // phase 55: round 13 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 3, 17, 15, mx);
      break;
    case 1:
      g_mul_mxu(s, 4, 18, 16, mx);
      break;
    case 2:
      g_mul_mxu(s, 46, 6, 9, mx);
      break;
    case 3:
      g_mul_mxu(s, 47, 13, 31, mx);
      break;
    case 4:
      g_mul_mxu(s, 39, 11, 0, mx);
      break;
    case 5:
      g_mul_mxu(s, 54, 27, 0, mx);
      break;
    case 6:
      g_mul_mxu(s, 49, 28, 0, mx);
      break;
    case 7:
      g_mul_mxu(s, 53, 30, 0, mx);
      break;
    default:
      break;
  })
  // phase 56: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 6, 13, 40);
      break;
    case 1:
      g_add(s, 9, 31, 12);
      break;
    case 2:
      g_add(s, 11, 1, 5);
      break;
    case 3:
      g_add(s, 15, 35, 36);
      break;
    case 4:
      g_add(s, 16, 24, 32);
      break;
    case 5:
      g_add(s, 17, 71, 14);
      break;
    default:
      break;
  })
  // phase 57: round 14 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 13, 40, 12, mx);
      break;
    case 1:
      g_mul_mxu(s, 31, 6, 9, mx);
      break;
    case 2:
      g_mul_mxu(s, 18, 1, 35, mx);
      break;
    case 3:
      g_mul_mxu(s, 27, 5, 36, mx);
      break;
    case 4:
      g_mul_mxu(s, 28, 11, 15, mx);
      break;
    case 5:
      g_mul_mxu(s, 30, 24, 71, mx);
      break;
    case 6:
      g_mul_mxu(s, 55, 32, 14, mx);
      break;
    case 7:
      g_mul_mxu(s, 70, 16, 17, mx);
      break;
    default:
      break;
  })
  // phase 58: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 6, 1, 5);
      break;
    case 1:
      g_add(s, 9, 71, 14);
      break;
    case 2:
      g_add(s, 11, 7, 21);
      break;
    case 3:
      g_add(s, 12, 35, 36);
      break;
    default:
      break;
  })
  // phase 59: round 15 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 15, 1, 71, mx);
      break;
    case 1:
      g_mul_mxu(s, 16, 5, 14, mx);
      break;
    case 2:
      g_mul_mxu(s, 17, 6, 9, mx);
      break;
    case 3:
      g_mul_mxu(s, 40, 7, 35, mx);
      break;
    case 4:
      g_mul_mxu(s, 72, 21, 36, mx);
      break;
    case 5:
      g_mul_mxu(s, 34, 11, 12, mx);
      break;
    case 6:
      g_mul_mxu(s, 45, 7, 71, mx);
      break;
    case 7:
      g_mul_mxu(s, 20, 21, 14, mx);
      break;
    default:
      break;
  })
  // phase 60: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 6, 7, 21);
      break;
    case 1:
      g_add(s, 9, 71, 14);
      break;
    case 2:
      g_add(s, 11, 24, 32);
      break;
    case 3:
      g_add(s, 12, 35, 36);
      break;
    case 4:
      g_add(s, 22, 49, 53);
      break;
    case 5:
      g_add(s, 23, 19, 37);
      break;
    default:
      break;
  })
  // phase 61: round 16 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 25, 6, 9, mx);
      break;
    case 1:
      g_mul_mxu(s, 26, 24, 35, mx);
      break;
    case 2:
      g_mul_mxu(s, 29, 32, 36, mx);
      break;
    case 3:
      g_mul_mxu(s, 48, 11, 12, mx);
      break;
    case 4:
      g_mul_mxu(s, 41, 49, 19, mx);
      break;
    case 5:
      g_mul_mxu(s, 44, 53, 37, mx);
      break;
    case 6:
      g_mul_mxu(s, 50, 22, 23, mx);
      break;
    case 7:
      g_mul_mxu(s, 64, 33, 19, mx);
      break;
    default:
      break;
  })
  // phase 62: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 6, 1, 33);
      break;
    case 1:
      g_add(s, 9, 5, 43);
      break;
    case 2:
      g_add(s, 11, 33, 43);
      break;
    case 3:
      g_add(s, 12, 19, 37);
      break;
    case 4:
      g_add(s, 22, 39, 54);
      break;
    case 5:
      g_add(s, 23, 19, 37);
      break;
    case 6:
      g_add(s, 42, 35, 36);
      break;
    default:
      break;
  })
  // phase 63: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 1, 6, 9);
      break;
    default:
      break;
  })
  // phase 64: round 17 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 5, 43, 37, mx);
      break;
    case 1:
      g_mul_mxu(s, 33, 11, 12, mx);
      break;
    case 2:
      g_mul_mxu(s, 51, 39, 19, mx);
      break;
    case 3:
      g_mul_mxu(s, 52, 54, 37, mx);
      break;
    case 4:
      g_mul_mxu(s, 56, 22, 23, mx);
      break;
    case 5:
      g_mul_mxu(s, 57, 6, 35, mx);
      break;
    case 6:
      g_mul_mxu(s, 58, 9, 36, mx);
      break;
    case 7:
      g_mul_mxu(s, 59, 1, 42, mx);
      break;
    default:
      break;
  })
  // phase 65: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 1, 7, 39);
      break;
    case 1:
      g_add(s, 11, 21, 54);
      break;
    case 2:
      g_add(s, 12, 24, 49);
      break;
    case 3:
      g_add(s, 22, 32, 53);
      break;
    case 4:
      g_add(s, 23, 71, 19);
      break;
    case 5:
      g_add(s, 42, 14, 37);
      break;
    case 6:
      g_add(s, 43, 6, 9);
      break;
    default:
      break;
  })
  // phase 66: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 7, 12, 22);
      break;
    case 1:
      g_add(s, 14, 23, 42);
      break;
    case 2:
      g_add(s, 19, 23, 42);
      break;
    default:
      break;
  })
  // phase 67: round 18 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 21, 12, 23, mx);
      break;
    case 1:
      g_mul_mxu(s, 24, 22, 42, mx);
      break;
    case 2:
      g_mul_mxu(s, 32, 7, 14, mx);
      break;
    case 3:
      g_mul_mxu(s, 37, 6, 23, mx);
      break;
    case 4:
      g_mul_mxu(s, 39, 9, 42, mx);
      break;
    case 5:
      g_mul_mxu(s, 49, 43, 19, mx);
      break;
    case 6:
      g_mul_mxu(s, 53, 1, 35, mx);
      break;
    case 7:
      g_mul_mxu(s, 54, 11, 36, mx);
      break;
    default:
      break;
  })
  // phase 68: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 6, 1, 11);
      break;
    case 1:
      g_add(s, 7, 35, 36);
      break;
    case 2:
      g_add(s, 9, 1, 11);
      break;
    case 3:
      g_add(s, 14, 23, 42);
      break;
    case 4:
      g_add(s, 19, 12, 22);
      break;
    case 5:
      g_add(s, 43, 35, 36);
      break;
    default:
      break;
  })
  // phase 69: round 19 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 71, 10, 0, mx);
      if (live) g_store(t_out, 0, n, lane, s, 71);
      break;
    case 1:
      g_mul_mxu(s, 66, 6, 7, mx);
      break;
    case 2:
      g_mul_mxu(s, 69, 1, 23, mx);
      break;
    case 3:
      g_mul_mxu(s, 65, 11, 42, mx);
      break;
    case 4:
      g_mul_mxu(s, 67, 9, 14, mx);
      break;
    case 5:
      g_mul_mxu(s, 68, 12, 35, mx);
      break;
    case 6:
      g_mul_mxu(s, 62, 22, 36, mx);
      break;
    case 7:
      g_mul_mxu(s, 73, 19, 43, mx);
      break;
    default:
      break;
  })
  // phase 70: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 1, 3, 4, 0);  // k=2
      g_sub(s, 19, 30, 55, 0);  // k=2
      break;
    case 1:
      g_add(s, 6, 3, 4);
      g_add(s, 22, 30, 55);
      break;
    case 2:
      g_sub(s, 7, 47, 13, 0);  // k=2
      g_sub(s, 23, 15, 16, 0);  // k=2
      break;
    case 3:
      g_add(s, 9, 47, 13);
      g_sub(s, 35, 40, 72, 0);  // k=2
      break;
    case 4:
      g_add(s, 10, 38, 38);
      g_sub(s, 36, 41, 44, 0);  // k=2
      break;
    case 5:
      g_add(s, 11, 8, 8);
      g_add(s, 42, 41, 44);
      break;
    case 6:
      g_sub(s, 12, 18, 27, 0);  // k=2
      g_sub(s, 43, 51, 52, 0);  // k=2
      break;
    case 7:
      g_add(s, 14, 18, 27);
      g_add(s, 71, 51, 52);
      break;
    default:
      break;
  })
  // phase 71: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 3, 46, 6, 1);  // k=4
      g_sub(s, 41, 56, 71, 1);  // k=4
      break;
    case 1:
      g_sub(s, 4, 31, 9, 1);  // k=4
      g_add(s, 44, 23, 35);
      break;
    case 2:
      g_add(s, 8, 10, 10);
      break;
    case 3:
      g_add(s, 13, 11, 11);
      break;
    case 4:
      g_add(s, 18, 1, 1);
      break;
    case 5:
      g_sub(s, 27, 28, 14, 1);  // k=4
      break;
    case 6:
      g_sub(s, 30, 70, 22, 1);  // k=4
      break;
    case 7:
      g_sub(s, 38, 50, 42, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 72: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 1, 8, 8);
      break;
    case 1:
      g_add(s, 6, 13, 13);
      break;
    case 2:
      g_add(s, 9, 3, 3);
      break;
    case 3:
      g_sub(s, 10, 19, 30, 2);  // k=8
      break;
    case 4:
      g_add(s, 11, 19, 30);
      break;
    case 5:
      g_sub(s, 14, 36, 38, 2);  // k=8
      break;
    case 6:
      g_sub(s, 22, 43, 41, 2);  // k=8
      break;
    case 7:
      g_add(s, 23, 43, 41);
      break;
    default:
      break;
  })
  // phase 73: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 3, 7, 1, 3);  // k=16
      break;
    case 1:
      g_sub(s, 8, 4, 6, 4);  // k=32
      break;
    case 2:
      g_add(s, 13, 12, 10);
      break;
    case 3:
      g_add(s, 19, 27, 11);
      break;
    case 4:
      g_add(s, 30, 44, 14);
      break;
    default:
      break;
  })
  // phase 74: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 1, 13, 22);
      break;
    case 1:
      g_add(s, 4, 19, 23);
      break;
    default:
      break;
  })
  // phase 75: round 20 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 22, 2, 0, mx);
      if (live) g_store(t_out, 1, n, lane, s, 22);
      break;
    case 1:
      g_mul_mxu(s, 23, 3, 0, mx);
      if (live) g_store(t_out, 2, n, lane, s, 23);
      break;
    case 2:
      g_mul_mxu(s, 6, 8, 0, mx);
      if (live) g_store(t_out, 3, n, lane, s, 6);
      break;
    case 3:
      g_mul_mxu(s, 7, 18, 0, mx);
      if (live) g_store(t_out, 4, n, lane, s, 7);
      break;
    case 4:
      g_mul_mxu(s, 10, 9, 0, mx);
      if (live) g_store(t_out, 5, n, lane, s, 10);
      break;
    case 5:
      g_mul_mxu(s, 11, 1, 0, mx);
      if (live) g_store(f_out, 0, n, lane, s, 11);
      break;
    case 6:
      g_mul_mxu(s, 12, 4, 0, mx);
      if (live) g_store(f_out, 1, n, lane, s, 12);
      break;
    case 7:
      g_mul_mxu(s, 27, 30, 0, mx);
      if (live) g_store(f_out, 2, n, lane, s, 27);
      break;
    default:
      break;
  })
  // phase 76: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 1, 15, 16);
      g_sub(s, 10, 57, 58, 0);  // k=2
      g_sub(s, 28, 69, 65, 0);  // k=2
      break;
    case 1:
      g_add(s, 2, 40, 72);
      g_add(s, 11, 57, 58);
      g_sub(s, 31, 68, 62, 0);  // k=2
      break;
    case 2:
      g_sub(s, 3, 45, 20, 0);  // k=2
      g_sub(s, 12, 21, 24, 0);  // k=2
      g_add(s, 35, 36, 38);
      break;
    case 3:
      g_add(s, 4, 45, 20);
      g_add(s, 18, 21, 24);
      break;
    case 4:
      g_sub(s, 6, 26, 29, 0);  // k=2
      g_sub(s, 22, 37, 39, 0);  // k=2
      break;
    case 5:
      g_add(s, 7, 26, 29);
      g_add(s, 23, 37, 39);
      break;
    case 6:
      g_sub(s, 8, 64, 5, 0);  // k=2
      g_sub(s, 27, 53, 54, 0);  // k=2
      break;
    case 7:
      g_add(s, 9, 64, 5);
      g_add(s, 30, 53, 54);
      break;
    default:
      break;
  })
  // phase 77: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 5, 17, 1, 1);  // k=4
      g_sub(s, 36, 66, 30, 1);  // k=4
      break;
    case 1:
      g_sub(s, 15, 34, 2, 1);  // k=4
      g_add(s, 37, 3, 6);
      break;
    case 2:
      g_sub(s, 16, 25, 4, 1);  // k=4
      g_add(s, 38, 22, 27);
      break;
    case 3:
      g_sub(s, 20, 48, 7, 1);  // k=4
      g_add(s, 39, 28, 31);
      break;
    case 4:
      g_sub(s, 21, 33, 9, 1);  // k=4
      break;
    case 5:
      g_sub(s, 24, 59, 11, 1);  // k=4
      break;
    case 6:
      g_sub(s, 26, 32, 18, 1);  // k=4
      break;
    case 7:
      g_sub(s, 29, 49, 23, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 78: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 1, 5, 15);
      break;
    case 1:
      g_add(s, 2, 16, 20);
      break;
    case 2:
      g_sub(s, 3, 12, 26, 2);  // k=8
      break;
    case 3:
      g_add(s, 4, 12, 26);
      break;
    case 4:
      g_add(s, 6, 29, 36);
      break;
    case 5:
      g_add(s, 7, 37, 8);
      break;
    case 6:
      g_sub(s, 9, 38, 44, 2);  // k=8
      break;
    case 7:
      g_sub(s, 11, 39, 37, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 79: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 5, 10, 3);
      break;
    case 1:
      g_add(s, 12, 24, 4);
      break;
    case 2:
      g_add(s, 15, 1, 35);
      break;
    case 3:
      g_add(s, 16, 2, 21);
      break;
    case 4:
      g_sub(s, 20, 6, 1, 3);  // k=16
      break;
    case 5:
      g_sub(s, 26, 9, 8, 1);  // k=4
      break;
    case 6:
      g_sub(s, 29, 11, 43, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 80: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 1, 5, 13, 3);  // k=16
      break;
    case 1:
      g_sub(s, 3, 12, 19, 3);  // k=16
      break;
    case 2:
      g_sub(s, 4, 20, 21, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 81: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 5, 1, 14, 3);  // k=16
      break;
    case 1:
      g_sub(s, 12, 3, 35, 3);  // k=16
      break;
    default:
      break;
  })
  // phase 82: round 21 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 1, 15, 0, mx);
      if (live) g_store(f_out, 3, n, lane, s, 1);
      break;
    case 1:
      g_mul_mxu(s, 3, 7, 0, mx);
      if (live) g_store(f_out, 4, n, lane, s, 3);
      break;
    case 2:
      g_mul_mxu(s, 14, 16, 0, mx);
      if (live) g_store(f_out, 5, n, lane, s, 14);
      break;
    case 3:
      g_mul_mxu(s, 35, 5, 0, mx);
      if (live) g_store(f_out, 6, n, lane, s, 35);
      break;
    case 4:
      g_mul_mxu(s, 13, 12, 0, mx);
      if (live) g_store(f_out, 7, n, lane, s, 13);
      break;
    case 5:
      g_mul_mxu(s, 19, 26, 0, mx);
      if (live) g_store(f_out, 8, n, lane, s, 19);
      break;
    case 6:
      g_mul_mxu(s, 20, 4, 0, mx);
      if (live) g_store(f_out, 9, n, lane, s, 20);
      break;
    case 7:
      g_mul_mxu(s, 21, 29, 0, mx);
      if (live) g_store(f_out, 10, n, lane, s, 21);
      break;
    default:
      break;
  })
  // phase 83: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 1, 69, 65);
      break;
    case 1:
      g_add(s, 3, 68, 62);
      break;
    default:
      break;
  })
  // phase 84: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 62, 67, 1, 1);  // k=4
      break;
    case 1:
      g_sub(s, 65, 73, 3, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 85: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 1, 62, 65);
      break;
    default:
      break;
  })
  // phase 86: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 62, 1, 2, 3);  // k=16
      break;
    default:
      break;
  })
  // phase 87: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 1, 62, 41, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 88: round 22 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu(s, 41, 1, 0, mx);
      if (live) g_store(f_out, 11, n, lane, s, 41);
      break;
    default:
      break;
  })
}

extern "C" int lh_miller_step_dbl_mxu_g8(const void* f, const void* t, const void* xp, const void* yp, void* f_out, void* t_out, int n,
                              void* stream) {
  constexpr int kShared = static_cast<int>(sizeof(lh::MxuShared<8, kMxuRows>)) + 2028 * 2 * lh::kGroupLanes;
  static_assert(kShared <= 232448, "one block's shared memory on sm_90");
  static const cudaError_t attr = cudaFuncSetAttribute(
      miller_step_dbl_mxu_g8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n > 0) {
    miller_step_dbl_mxu_g8_kernel<<<(n + lh::kGroupLanes - 1) / lh::kGroupLanes, 8 * lh::kGroupLanes,
                          kShared, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(f), static_cast<const uint32_t*>(t), static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(yp),
        static_cast<uint32_t*>(f_out), static_cast<uint32_t*>(t_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// miller_step_add_mxu: 353 limb ops, 111 Montgomery products on the 13-bit plane, 62 slots.
static __global__ void __launch_bounds__(kBlock)
miller_step_add_mxu_kernel(const uint32_t* __restrict__ f, const uint32_t* __restrict__ t, const uint32_t* __restrict__ q, const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp, const int32_t* __restrict__ bit, uint32_t* __restrict__ f_out, uint32_t* __restrict__ t_out, int n) {
  __shared__ lh::MxuShared<1> mxu_sm;
  const lh::MxuCtx mx = lh::mxu_setup(mxu_sm);
  const int gl = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
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
  k_mul(s[27], s[25], s[26], mx);
  k_mul(s[26], s[17], s[18], mx);
  k_add(s[25], s[26], s[26]);
  k_add(s[26], s[27], s[25]);
  k_add(s[28], s[17], s[18]);
  k_mul(s[29], s[27], s[17], mx);
  k_mul(s[30], s[25], s[18], mx);
  k_mul(s[31], s[26], s[28], mx);
  k_sub(s[28], s[29], s[30], 0);  // k=2
  k_add(s[26], s[29], s[30]);
  k_sub(s[30], s[31], s[26], 1);  // k=4
  k_add(s[31], s[19], s[20]);
  k_add(s[26], s[27], s[25]);
  k_mul(s[29], s[19], s[27], mx);
  k_mul(s[27], s[20], s[25], mx);
  k_mul(s[25], s[31], s[26], mx);
  k_sub(s[31], s[29], s[27], 0);  // k=2
  k_add(s[26], s[29], s[27]);
  k_sub(s[29], s[25], s[26], 1);  // k=4
  k_sub(s[26], s[31], s[13], 1);  // k=4
  k_sub(s[31], s[29], s[14], 1);  // k=4
  k_add(s[29], s[21], s[22]);
  k_add(s[25], s[28], s[30]);
  k_mul(s[27], s[21], s[28], mx);
  k_mul(s[28], s[22], s[30], mx);
  k_mul(s[30], s[29], s[25], mx);
  k_sub(s[29], s[27], s[28], 0);  // k=2
  k_add(s[25], s[27], s[28]);
  k_sub(s[28], s[30], s[25], 1);  // k=4
  k_add(s[30], s[17], s[18]);
  k_add(s[25], s[26], s[31]);
  k_mul(s[27], s[17], s[26], mx);
  k_mul(s[32], s[18], s[31], mx);
  k_mul(s[33], s[30], s[25], mx);
  k_sub(s[30], s[27], s[32], 0);  // k=2
  k_add(s[25], s[27], s[32]);
  k_sub(s[32], s[33], s[25], 1);  // k=4
  k_sub(s[33], s[26], s[31], 3);  // k=16
  k_add(s[25], s[26], s[31]);
  k_mul(s[27], s[33], s[25], mx);
  k_mul(s[33], s[26], s[31], mx);
  k_add(s[25], s[33], s[33]);
  k_sub(s[33], s[29], s[15], 1);  // k=4
  k_sub(s[29], s[28], s[16], 1);  // k=4
  k_add(s[28], s[33], s[29]);
  k_add(s[34], s[19], s[20]);
  k_mul(s[35], s[33], s[19], mx);
  k_mul(s[19], s[29], s[20], mx);
  k_mul(s[20], s[28], s[34], mx);
  k_sub(s[34], s[35], s[19], 0);  // k=2
  k_add(s[28], s[35], s[19]);
  k_sub(s[35], s[20], s[28], 1);  // k=4
  k_add(s[28], s[21], s[22]);
  k_add(s[20], s[30], s[32]);
  k_mul(s[19], s[21], s[30], mx);
  k_mul(s[21], s[22], s[32], mx);
  k_mul(s[22], s[28], s[20], mx);
  k_sub(s[28], s[19], s[21], 0);  // k=2
  k_add(s[20], s[19], s[21]);
  k_sub(s[21], s[22], s[20], 1);  // k=4
  k_sub(s[22], s[33], s[29], 3);  // k=16
  k_add(s[20], s[33], s[29]);
  k_mul(s[19], s[22], s[20], mx);
  k_mul(s[22], s[33], s[29], mx);
  k_add(s[20], s[22], s[22]);
  k_add(s[22], s[26], s[31]);
  k_add(s[36], s[27], s[25]);
  k_mul(s[37], s[26], s[27], mx);
  k_mul(s[26], s[31], s[25], mx);
  k_mul(s[31], s[22], s[36], mx);
  k_sub(s[36], s[37], s[26], 0);  // k=2
  k_add(s[22], s[37], s[26]);
  k_sub(s[37], s[31], s[22], 1);  // k=4
  k_add(s[31], s[13], s[14]);
  k_add(s[22], s[27], s[25]);
  k_mul(s[26], s[13], s[27], mx);
  k_mul(s[27], s[14], s[25], mx);
  k_mul(s[25], s[31], s[22], mx);
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
  k_mul(s[27], s[21], s[0], mx);
  k_mul(s[21], s[31], s[0], mx);
  k_add(s[31], s[33], s[29]);
  k_add(s[19], s[27], s[21]);
  k_mul(s[20], s[33], s[27], mx);
  k_mul(s[27], s[29], s[21], mx);
  k_mul(s[21], s[31], s[19], mx);
  k_sub(s[31], s[20], s[27], 0);  // k=2
  k_add(s[19], s[20], s[27]);
  k_sub(s[27], s[21], s[19], 1);  // k=4
  k_add(s[21], s[15], s[16]);
  k_add(s[19], s[36], s[37]);
  k_mul(s[20], s[15], s[36], mx);
  k_mul(s[36], s[16], s[37], mx);
  k_mul(s[37], s[21], s[19], mx);
  k_sub(s[21], s[20], s[36], 0);  // k=2
  k_add(s[19], s[20], s[36]);
  k_sub(s[36], s[37], s[19], 1);  // k=4
  k_sub(s[37], s[31], s[21], 1);  // k=4
  k_sub(s[31], s[27], s[36], 2);  // k=8
  k_neg(s[36], s[33], 2);  // k=8
  k_neg(s[33], s[29], 3);  // k=16
  k_mul(s[29], s[36], s[23], mx);
  k_mul(s[36], s[33], s[23], mx);
  k_mul(s[33], s[30], s[24], mx);
  k_mul(s[23], s[32], s[24], mx);
  k_mul(s[24], s[25], s[0], mx);
  k_mul(s[25], s[34], s[0], mx);
  k_mul(s[34], s[29], s[0], mx);
  k_mul(s[29], s[36], s[0], mx);
  k_mul(s[36], s[33], s[0], mx);
  k_mul(s[33], s[23], s[0], mx);
  k_mul(s[23], s[28], s[0], mx);
  k_mul(s[28], s[35], s[0], mx);
  k_mul(s[35], s[37], s[0], mx);
  k_mul(s[37], s[31], s[0], mx);
  k_mul(s[31], s[30], s[0], mx);
  k_mul(s[30], s[32], s[0], mx);
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
  k_mul(s[41], s[1], s[24], mx);
  k_mul(s[42], s[2], s[25], mx);
  k_mul(s[43], s[39], s[40], mx);
  k_sub(s[40], s[41], s[42], 0);  // k=2
  k_add(s[39], s[41], s[42]);
  k_sub(s[42], s[43], s[39], 1);  // k=4
  k_add(s[43], s[5], s[6]);
  k_add(s[39], s[34], s[29]);
  k_mul(s[41], s[5], s[34], mx);
  k_mul(s[44], s[6], s[29], mx);
  k_mul(s[45], s[43], s[39], mx);
  k_sub(s[43], s[41], s[44], 0);  // k=2
  k_add(s[39], s[41], s[44]);
  k_sub(s[44], s[45], s[39], 1);  // k=4
  k_add(s[45], s[1], s[2]);
  k_add(s[39], s[34], s[29]);
  k_mul(s[41], s[1], s[34], mx);
  k_mul(s[46], s[2], s[29], mx);
  k_mul(s[47], s[45], s[39], mx);
  k_sub(s[45], s[41], s[46], 0);  // k=2
  k_add(s[39], s[41], s[46]);
  k_sub(s[46], s[47], s[39], 1);  // k=4
  k_add(s[47], s[3], s[4]);
  k_add(s[39], s[24], s[25]);
  k_mul(s[41], s[3], s[24], mx);
  k_mul(s[48], s[4], s[25], mx);
  k_mul(s[49], s[47], s[39], mx);
  k_sub(s[47], s[41], s[48], 0);  // k=2
  k_add(s[39], s[41], s[48]);
  k_sub(s[48], s[49], s[39], 1);  // k=4
  k_add(s[49], s[3], s[4]);
  k_add(s[39], s[34], s[29]);
  k_mul(s[41], s[3], s[34], mx);
  k_mul(s[34], s[4], s[29], mx);
  k_mul(s[29], s[49], s[39], mx);
  k_sub(s[49], s[41], s[34], 0);  // k=2
  k_add(s[39], s[41], s[34]);
  k_sub(s[41], s[29], s[39], 1);  // k=4
  k_add(s[39], s[5], s[6]);
  k_add(s[29], s[24], s[25]);
  k_mul(s[34], s[5], s[24], mx);
  k_mul(s[50], s[6], s[25], mx);
  k_mul(s[51], s[39], s[29], mx);
  k_sub(s[39], s[34], s[50], 0);  // k=2
  k_add(s[29], s[34], s[50]);
  k_sub(s[50], s[51], s[29], 1);  // k=4
  k_add(s[51], s[11], s[12]);
  k_add(s[29], s[36], s[33]);
  k_mul(s[34], s[11], s[36], mx);
  k_mul(s[52], s[12], s[33], mx);
  k_mul(s[53], s[51], s[29], mx);
  k_sub(s[51], s[34], s[52], 0);  // k=2
  k_add(s[29], s[34], s[52]);
  k_sub(s[52], s[53], s[29], 1);  // k=4
  k_add(s[53], s[7], s[8]);
  k_add(s[29], s[36], s[33]);
  k_mul(s[34], s[7], s[36], mx);
  k_mul(s[54], s[8], s[33], mx);
  k_mul(s[55], s[53], s[29], mx);
  k_sub(s[53], s[34], s[54], 0);  // k=2
  k_add(s[29], s[34], s[54]);
  k_sub(s[54], s[55], s[29], 1);  // k=4
  k_add(s[55], s[9], s[10]);
  k_add(s[29], s[36], s[33]);
  k_mul(s[34], s[9], s[36], mx);
  k_mul(s[36], s[10], s[33], mx);
  k_mul(s[33], s[55], s[29], mx);
  k_sub(s[55], s[34], s[36], 0);  // k=2
  k_add(s[29], s[34], s[36]);
  k_sub(s[36], s[33], s[29], 1);  // k=4
  k_add(s[33], s[32], s[27]);
  k_add(s[29], s[24], s[25]);
  k_mul(s[34], s[32], s[24], mx);
  k_mul(s[56], s[27], s[25], mx);
  k_mul(s[57], s[33], s[29], mx);
  k_sub(s[33], s[34], s[56], 0);  // k=2
  k_add(s[29], s[34], s[56]);
  k_sub(s[56], s[57], s[29], 1);  // k=4
  k_add(s[57], s[20], s[22]);
  k_add(s[29], s[26], s[38]);
  k_mul(s[34], s[20], s[26], mx);
  k_mul(s[58], s[22], s[38], mx);
  k_mul(s[59], s[57], s[29], mx);
  k_sub(s[57], s[34], s[58], 0);  // k=2
  k_add(s[29], s[34], s[58]);
  k_sub(s[58], s[59], s[29], 1);  // k=4
  k_add(s[59], s[32], s[27]);
  k_add(s[29], s[26], s[38]);
  k_mul(s[34], s[32], s[26], mx);
  k_mul(s[32], s[27], s[38], mx);
  k_mul(s[27], s[59], s[29], mx);
  k_sub(s[59], s[34], s[32], 0);  // k=2
  k_add(s[29], s[34], s[32]);
  k_sub(s[34], s[27], s[29], 1);  // k=4
  k_add(s[29], s[21], s[19]);
  k_add(s[27], s[24], s[25]);
  k_mul(s[32], s[21], s[24], mx);
  k_mul(s[60], s[19], s[25], mx);
  k_mul(s[61], s[29], s[27], mx);
  k_sub(s[29], s[32], s[60], 0);  // k=2
  k_add(s[27], s[32], s[60]);
  k_sub(s[60], s[61], s[27], 1);  // k=4
  k_add(s[61], s[21], s[19]);
  k_add(s[27], s[26], s[38]);
  k_mul(s[32], s[21], s[26], mx);
  k_mul(s[26], s[19], s[38], mx);
  k_mul(s[38], s[61], s[27], mx);
  k_sub(s[61], s[32], s[26], 0);  // k=2
  k_add(s[27], s[32], s[26]);
  k_sub(s[32], s[38], s[27], 1);  // k=4
  k_add(s[38], s[20], s[22]);
  k_add(s[27], s[24], s[25]);
  k_mul(s[26], s[20], s[24], mx);
  k_mul(s[24], s[22], s[25], mx);
  k_mul(s[25], s[38], s[27], mx);
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
  k_mul(s[60], s[38], s[0], mx);
  k_mul(s[38], s[32], s[0], mx);
  k_mul(s[32], s[26], s[0], mx);
  k_mul(s[26], s[34], s[0], mx);
  k_mul(s[34], s[29], s[0], mx);
  k_mul(s[29], s[51], s[0], mx);
  k_mul(s[51], s[61], s[0], mx);
  k_mul(s[61], s[50], s[0], mx);
  k_mul(s[50], s[58], s[0], mx);
  k_mul(s[58], s[53], s[0], mx);
  k_mul(s[53], s[56], s[0], mx);
  k_mul(s[56], s[59], s[0], mx);
  k_sel(s[59], take, s[60], s[1]);
  if (live) k_store(f_out, 0, n, lane, s[59]);
  k_sel(s[60], take, s[38], s[2]);
  if (live) k_store(f_out, 1, n, lane, s[60]);
  k_sel(s[60], take, s[32], s[3]);
  if (live) k_store(f_out, 2, n, lane, s[60]);
  k_sel(s[60], take, s[26], s[4]);
  if (live) k_store(f_out, 3, n, lane, s[60]);
  k_sel(s[60], take, s[34], s[5]);
  if (live) k_store(f_out, 4, n, lane, s[60]);
  k_sel(s[60], take, s[29], s[6]);
  if (live) k_store(f_out, 5, n, lane, s[60]);
  k_sel(s[60], take, s[51], s[7]);
  if (live) k_store(f_out, 6, n, lane, s[60]);
  k_sel(s[60], take, s[61], s[8]);
  if (live) k_store(f_out, 7, n, lane, s[60]);
  k_sel(s[61], take, s[50], s[9]);
  if (live) k_store(f_out, 8, n, lane, s[61]);
  k_sel(s[61], take, s[58], s[10]);
  if (live) k_store(f_out, 9, n, lane, s[61]);
  k_sel(s[61], take, s[53], s[11]);
  if (live) k_store(f_out, 10, n, lane, s[61]);
  k_sel(s[61], take, s[56], s[12]);
  if (live) k_store(f_out, 11, n, lane, s[61]);
  k_sel(s[61], take, s[23], s[13]);
  if (live) k_store(t_out, 0, n, lane, s[61]);
  k_sel(s[61], take, s[28], s[14]);
  if (live) k_store(t_out, 1, n, lane, s[61]);
  k_sel(s[61], take, s[35], s[15]);
  if (live) k_store(t_out, 2, n, lane, s[61]);
  k_sel(s[61], take, s[37], s[16]);
  if (live) k_store(t_out, 3, n, lane, s[61]);
  k_sel(s[61], take, s[31], s[17]);
  if (live) k_store(t_out, 4, n, lane, s[61]);
  k_sel(s[61], take, s[30], s[18]);
  if (live) k_store(t_out, 5, n, lane, s[61]);
}

extern "C" int lh_miller_step_add_mxu(const void* f, const void* t, const void* q, const void* xp, const void* yp, const void* bit, void* f_out, void* t_out, int n,
                              void* stream) {
  if (n > 0) {
    miller_step_add_mxu_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(f), static_cast<const uint32_t*>(t), static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(yp), static_cast<const int32_t*>(bit),
        static_cast<uint32_t*>(f_out), static_cast<uint32_t*>(t_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
