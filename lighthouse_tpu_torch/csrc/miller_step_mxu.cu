// Generated by lighthouse_tpu_torch/crypto/bls/torch_backend/codegen.py; do not edit.
// The MXU variants of kernels 2 and 3: the same fused Miller steps with
// every Montgomery product on the 31 x 13-bit plane (kernel 7's core,
// csrc/mxu.cuh), as pallas_miller.py builds _step_dbl_kernel and
// _step_add_kernel with mxu=True (_Ctx -> pallas_fp._core_pair).  Printed
// from the same step programs as miller_step.cu; the plain PyTorch version
// runs them over mxu_kernel.mont_mul_mxu_plain.
//
// Both steps run in the group form of miller_step.cu (csrc/group.cuh) with
// G = 8 threads per lane in blocks of 32 lanes (miller_kernel.DBL_MXU_GROUP,
// ADD_MXU_GROUP), so each warp is the 32 lanes of one rank: a phase's switch
// on the rank is warp-uniform and every product's mma.sync (csrc/mxu.cuh) is
// made by a whole warp, its N dimension the warp's 32 lanes; the tail
// threads run lane n - 1 again and store nothing.  Each warp stages its DMMA
// products in shared memory beside the block's slots, in passes of ROWS rows
// of C (g_mul_mxu<ROWS>, MxuShared<G, ROWS>): the doubling step the 64 rows
// of m * P in two passes of 32, the addition step, whose 92 slots take more
// room, in four of 16, so that 8 warps' staging and the slots fit in one
// block (each launcher asserts the bytes).
//
// Planes are (planes, 26, n) limb-major, so limb i of neighbouring lanes are
// neighbouring words and every load and store coalesces.
#include "group.cuh"
#include "mxu.cuh"

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

template <int ROWS>
__device__ __noinline__ void g_mul_mxu(uint16_t* s, int o, int a, int b, const lh::MxuCtx& mx) {
  uint32_t x[NL], y[NL], r[NL];
  g_get(s, a, x);
  g_get(s, b, y);
  lh::mont_core_mxu<ROWS>(x, y, r, mx);
  g_put(s, o, r);
}

}  // namespace

// miller_step_dbl_mxu_g8: 565 limb ops, 169 Montgomery products on the 13-bit plane;
// 8 threads per lane, 22 rounds of products in 88 phases, 78 slots
// (129,792 bytes of shared memory per block of 32 lanes, and
// sizeof(lh::MxuShared<8, 32>) of DMMA staging for its 8 warps).
static __global__ void __launch_bounds__(8 * lh::kGroupLanes)
miller_step_dbl_mxu_g8_kernel(const uint32_t* __restrict__ f, const uint32_t* __restrict__ t, const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp, uint32_t* __restrict__ f_out, uint32_t* __restrict__ t_out, int n) {
  LH_MXU_GROUP_SHARED(8, 32, mxu_sm, uint16_t, slots, 2028);
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
      g_mul_mxu<32>(s, 31, 17, 18, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 32, 13, 14, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 33, 19, 20, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 34, 15, 16, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 35, 21, 0, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 36, 22, 0, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 37, 29, 0, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 38, 30, 0, mx);
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
      g_mul_mxu<32>(s, 39, 32, 34, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 40, 17, 18, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 41, 33, 15, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 42, 20, 16, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 43, 22, 21, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 44, 31, 33, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 45, 19, 20, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 46, 29, 30, mx);
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
      g_mul_mxu<32>(s, 43, 17, 20, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 42, 18, 41, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 32, 22, 21, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 33, 1, 7, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 34, 2, 8, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 47, 29, 30, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 48, 3, 9, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 49, 4, 10, mx);
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
      g_mul_mxu<32>(s, 56, 20, 21, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 57, 5, 11, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 58, 6, 12, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 59, 22, 29, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 60, 30, 50, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 61, 41, 51, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 62, 54, 55, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 63, 52, 53, mx);
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
      g_mul_mxu<32>(s, 52, 20, 21, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 53, 1, 2, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 64, 22, 30, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 65, 29, 41, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 66, 7, 8, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 67, 50, 27, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 68, 51, 28, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 69, 55, 54, mx);
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
      g_mul_mxu<32>(s, 9, 1, 23, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 10, 2, 24, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 11, 3, 20, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 12, 7, 25, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 28, 8, 26, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 29, 4, 21, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 30, 5, 22, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 41, 6, 27, mx);
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
      g_mul_mxu<32>(s, 5, 31, 13, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 6, 3, 4, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 7, 20, 35, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 8, 21, 36, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 22, 1, 23, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 27, 24, 37, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 50, 25, 38, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 51, 2, 26, mx);
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
      g_mul_mxu<32>(s, 36, 19, 14, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 37, 20, 21, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 38, 24, 25, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 54, 39, 1, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 55, 2, 3, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 70, 4, 23, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 71, 26, 35, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 72, 13, 40, mx);
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
      g_mul_mxu<32>(s, 21, 34, 2, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 24, 20, 2, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 43, 42, 3, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 49, 14, 3, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 53, 4, 0, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 33, 26, 0, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 46, 52, 0, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 47, 32, 0, mx);
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
      g_mul_mxu<32>(s, 3, 8, 0, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 4, 2, 0, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 6, 7, 0, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 9, 10, 0, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 11, 32, 0, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 27, 12, 0, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 28, 35, 0, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 30, 14, 0, mx);
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
      g_mul_mxu<32>(s, 31, 32, 0, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 12, 7, 0, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 35, 5, 0, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 36, 1, 0, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 71, 21, 0, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 14, 24, 0, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 19, 43, 0, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 37, 49, 0, mx);
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
      g_mul_mxu<32>(s, 1, 6, 0, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 5, 9, 0, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 7, 11, 0, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 21, 27, 0, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 24, 28, 0, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 32, 30, 0, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 33, 39, 0, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 43, 54, 0, mx);
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
      g_mul_mxu<32>(s, 3, 17, 15, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 4, 18, 16, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 46, 6, 9, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 47, 13, 31, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 39, 11, 0, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 54, 27, 0, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 49, 28, 0, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 53, 30, 0, mx);
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
      g_mul_mxu<32>(s, 13, 40, 12, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 31, 6, 9, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 18, 1, 35, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 27, 5, 36, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 28, 11, 15, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 30, 24, 71, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 55, 32, 14, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 70, 16, 17, mx);
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
      g_mul_mxu<32>(s, 15, 1, 71, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 16, 5, 14, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 17, 6, 9, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 40, 7, 35, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 72, 21, 36, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 34, 11, 12, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 45, 7, 71, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 20, 21, 14, mx);
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
      g_mul_mxu<32>(s, 25, 6, 9, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 26, 24, 35, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 29, 32, 36, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 48, 11, 12, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 41, 49, 19, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 44, 53, 37, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 50, 22, 23, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 64, 33, 19, mx);
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
      g_mul_mxu<32>(s, 5, 43, 37, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 33, 11, 12, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 51, 39, 19, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 52, 54, 37, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 56, 22, 23, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 57, 6, 35, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 58, 9, 36, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 59, 1, 42, mx);
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
      g_mul_mxu<32>(s, 21, 12, 23, mx);
      break;
    case 1:
      g_mul_mxu<32>(s, 24, 22, 42, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 32, 7, 14, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 37, 6, 23, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 39, 9, 42, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 49, 43, 19, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 53, 1, 35, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 54, 11, 36, mx);
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
      g_mul_mxu<32>(s, 71, 10, 0, mx);
      if (live) g_store(t_out, 0, n, lane, s, 71);
      break;
    case 1:
      g_mul_mxu<32>(s, 66, 6, 7, mx);
      break;
    case 2:
      g_mul_mxu<32>(s, 69, 1, 23, mx);
      break;
    case 3:
      g_mul_mxu<32>(s, 65, 11, 42, mx);
      break;
    case 4:
      g_mul_mxu<32>(s, 67, 9, 14, mx);
      break;
    case 5:
      g_mul_mxu<32>(s, 68, 12, 35, mx);
      break;
    case 6:
      g_mul_mxu<32>(s, 62, 22, 36, mx);
      break;
    case 7:
      g_mul_mxu<32>(s, 73, 19, 43, mx);
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
      g_mul_mxu<32>(s, 22, 2, 0, mx);
      if (live) g_store(t_out, 1, n, lane, s, 22);
      break;
    case 1:
      g_mul_mxu<32>(s, 23, 3, 0, mx);
      if (live) g_store(t_out, 2, n, lane, s, 23);
      break;
    case 2:
      g_mul_mxu<32>(s, 6, 8, 0, mx);
      if (live) g_store(t_out, 3, n, lane, s, 6);
      break;
    case 3:
      g_mul_mxu<32>(s, 7, 18, 0, mx);
      if (live) g_store(t_out, 4, n, lane, s, 7);
      break;
    case 4:
      g_mul_mxu<32>(s, 10, 9, 0, mx);
      if (live) g_store(t_out, 5, n, lane, s, 10);
      break;
    case 5:
      g_mul_mxu<32>(s, 11, 1, 0, mx);
      if (live) g_store(f_out, 0, n, lane, s, 11);
      break;
    case 6:
      g_mul_mxu<32>(s, 12, 4, 0, mx);
      if (live) g_store(f_out, 1, n, lane, s, 12);
      break;
    case 7:
      g_mul_mxu<32>(s, 27, 30, 0, mx);
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
      g_mul_mxu<32>(s, 1, 15, 0, mx);
      if (live) g_store(f_out, 3, n, lane, s, 1);
      break;
    case 1:
      g_mul_mxu<32>(s, 3, 7, 0, mx);
      if (live) g_store(f_out, 4, n, lane, s, 3);
      break;
    case 2:
      g_mul_mxu<32>(s, 14, 16, 0, mx);
      if (live) g_store(f_out, 5, n, lane, s, 14);
      break;
    case 3:
      g_mul_mxu<32>(s, 35, 5, 0, mx);
      if (live) g_store(f_out, 6, n, lane, s, 35);
      break;
    case 4:
      g_mul_mxu<32>(s, 13, 12, 0, mx);
      if (live) g_store(f_out, 7, n, lane, s, 13);
      break;
    case 5:
      g_mul_mxu<32>(s, 19, 26, 0, mx);
      if (live) g_store(f_out, 8, n, lane, s, 19);
      break;
    case 6:
      g_mul_mxu<32>(s, 20, 4, 0, mx);
      if (live) g_store(f_out, 9, n, lane, s, 20);
      break;
    case 7:
      g_mul_mxu<32>(s, 21, 29, 0, mx);
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
      g_mul_mxu<32>(s, 41, 1, 0, mx);
      if (live) g_store(f_out, 11, n, lane, s, 41);
      break;
    default:
      break;
  })
}

extern "C" int lh_miller_step_dbl_mxu_g8(const void* f, const void* t, const void* xp, const void* yp, void* f_out, void* t_out, int n,
                              void* stream) {
  constexpr int kShared = static_cast<int>(sizeof(lh::MxuShared<8, 32>)) + 2028 * 2 * lh::kGroupLanes;
  static_assert(kShared <= 232448, "one block's shared memory on sm_90");
  const cudaError_t attr = lh::set_shared_limit(miller_step_dbl_mxu_g8_kernel, kShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n > 0) {
    miller_step_dbl_mxu_g8_kernel<<<(n + lh::kGroupLanes - 1) / lh::kGroupLanes, 8 * lh::kGroupLanes,
                          kShared, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(f), static_cast<const uint32_t*>(t), static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(yp),
        static_cast<uint32_t*>(f_out), static_cast<uint32_t*>(t_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// miller_step_add_mxu_g8: 353 limb ops, 111 Montgomery products on the 13-bit plane;
// 8 threads per lane, 15 rounds of products in 59 phases, 92 slots
// (153,088 bytes of shared memory per block of 32 lanes, and
// sizeof(lh::MxuShared<8, 16>) of DMMA staging for its 8 warps).
static __global__ void __launch_bounds__(8 * lh::kGroupLanes)
miller_step_add_mxu_g8_kernel(const uint32_t* __restrict__ f, const uint32_t* __restrict__ t, const uint32_t* __restrict__ q, const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp, const int32_t* __restrict__ bit, uint32_t* __restrict__ f_out, uint32_t* __restrict__ t_out, int n) {
  LH_MXU_GROUP_SHARED(8, 16, mxu_sm, uint16_t, slots, 2392);
  const lh::MxuCtx mx = lh::mxu_setup(mxu_sm);
  const int gl = lh::group_lane();
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
  uint16_t* const s = slots + lh::group_slot();
  const bool take = bit[lane] != 0;
  // phase 1: linear ops
  LH_RANKS(8, switch (r) {
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
  LH_RANKS(8, switch (r) {
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
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 4, 2, 3, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 5, 0, 1, mx);
      break;
    default:
      break;
  })
  // phase 4: linear ops
  LH_RANKS(8, switch (r) {
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
  LH_RANKS(8, switch (r) {
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
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 10, 4, 0, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 11, 6, 1, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 12, 5, 7, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 13, 2, 4, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 14, 3, 6, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 15, 8, 9, mx);
      break;
    default:
      break;
  })
  // phase 7: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_load(s, 4, t, 0, n, lane);
      g_add(s, 18, 0, 1);
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
    default:
      break;
  })
  // phase 8: linear ops
  LH_RANKS(8, switch (r) {
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
  LH_RANKS(8, switch (r) {
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
  LH_RANKS(8, switch (r) {
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
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 17, 6, 8, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 19, 7, 10, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 20, 14, 12, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 21, 0, 13, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 22, 1, 9, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 23, 18, 11, mx);
      break;
    case 6:
      g_mul_mxu<16>(s, 24, 15, 16, mx);
      break;
    case 7:
      g_mul_mxu<16>(s, 25, 13, 9, mx);
      break;
    default:
      break;
  })
  // phase 12: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_load(s, 8, t, 2, n, lane);
      break;
    case 1:
      g_load(s, 10, t, 3, n, lane);
      break;
    case 2:
      g_sub(s, 11, 17, 19, 0);  // k=2
      break;
    case 3:
      g_add(s, 12, 17, 19);
      break;
    case 4:
      g_sub(s, 14, 21, 22, 0);  // k=2
      break;
    case 5:
      g_add(s, 15, 21, 22);
      break;
    case 6:
      g_add(s, 16, 2, 3);
      break;
    case 7:
      g_add(s, 18, 6, 7);
      break;
    default:
      break;
  })
  // phase 13: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 17, 20, 12, 1);  // k=4
      break;
    case 1:
      g_sub(s, 19, 23, 15, 1);  // k=4
      break;
    case 2:
      g_sub(s, 21, 11, 8, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 14: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 11, 17, 10, 1);  // k=4
      break;
    case 1:
      g_add(s, 12, 14, 19);
      break;
    default:
      break;
  })
  // phase 15: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 17, 21, 11);
      break;
    case 1:
      g_sub(s, 15, 21, 11, 3);  // k=16
      break;
    case 2:
      g_add(s, 20, 21, 11);
      break;
    default:
      break;
  })
  // phase 16: round 4 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 23, 21, 2, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 22, 11, 3, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 26, 17, 16, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 27, 6, 14, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 28, 7, 19, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 29, 18, 12, mx);
      break;
    case 6:
      g_mul_mxu<16>(s, 30, 15, 20, mx);
      break;
    case 7:
      g_mul_mxu<16>(s, 31, 21, 11, mx);
      break;
    default:
      break;
  })
  // phase 17: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_load(s, 2, xp, 0, n, lane);
      break;
    case 1:
      g_add(s, 3, 25, 25);
      break;
    case 2:
      g_add(s, 6, 13, 9);
      break;
    case 3:
      g_add(s, 7, 4, 5);
      break;
    case 4:
      g_neg(s, 12, 21, 2);  // k=8
      break;
    case 5:
      g_neg(s, 15, 11, 3);  // k=16
      break;
    default:
      break;
  })
  // phase 18: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 25, 24, 3);
      break;
    case 1:
      g_add(s, 16, 24, 3);
      break;
    default:
      break;
  })
  // phase 19: round 5 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 17, 13, 24, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 18, 9, 3, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 20, 6, 25, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 32, 4, 24, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 33, 5, 3, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 34, 7, 16, mx);
      break;
    case 6:
      g_mul_mxu<16>(s, 35, 12, 2, mx);
      break;
    case 7:
      g_mul_mxu<16>(s, 36, 15, 2, mx);
      break;
    default:
      break;
  })
  // phase 20: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_one(s, 2);
      g_add(s, 16, 17, 18);
      break;
    case 1:
      g_load(s, 3, yp, 0, n, lane);
      g_sub(s, 24, 32, 33, 0);  // k=2
      break;
    case 2:
      g_sub(s, 6, 23, 22, 0);  // k=2
      g_add(s, 25, 32, 33);
      break;
    case 3:
      g_add(s, 7, 23, 22);
      break;
    case 4:
      g_sub(s, 9, 27, 28, 0);  // k=2
      break;
    case 5:
      g_add(s, 12, 27, 28);
      break;
    case 6:
      g_add(s, 13, 31, 31);
      break;
    case 7:
      g_sub(s, 15, 17, 18, 0);  // k=2
      break;
    default:
      break;
  })
  // phase 21: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 17, 26, 7, 1);  // k=4
      break;
    case 1:
      g_sub(s, 18, 29, 12, 1);  // k=4
      break;
    case 2:
      g_sub(s, 22, 20, 16, 1);  // k=4
      break;
    case 3:
      g_sub(s, 23, 34, 25, 1);  // k=4
      break;
    case 4:
      g_sub(s, 27, 6, 9, 1);  // k=4
      break;
    case 5:
      g_sub(s, 28, 30, 15, 1);  // k=4
      break;
    case 6:
      g_add(s, 31, 24, 24);
      break;
    default:
      break;
  })
  // phase 22: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 6, 17, 18, 2);  // k=8
      break;
    case 1:
      g_sub(s, 7, 13, 22, 2);  // k=8
      break;
    case 2:
      g_add(s, 9, 23, 23);
      break;
    case 3:
      g_sub(s, 12, 28, 31, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 23: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 13, 7, 9, 3);  // k=16
      break;
    case 1:
      g_sub(s, 17, 24, 12, 3);  // k=16
      break;
    default:
      break;
  })
  // phase 24: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 7, 23, 13, 4);  // k=32
      break;
    default:
      break;
  })
  // phase 25: round 6 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 23, 17, 2, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 9, 7, 2, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 24, 14, 3, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 18, 19, 3, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 28, 27, 2, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 31, 6, 2, mx);
      break;
    case 6:
      g_mul_mxu<16>(s, 16, 35, 2, mx);
      break;
    case 7:
      g_mul_mxu<16>(s, 20, 36, 2, mx);
      break;
    default:
      break;
  })
  // phase 26: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 3, 21, 11);
      break;
    case 1:
      g_add(s, 6, 23, 9);
      break;
    case 2:
      g_add(s, 7, 8, 10);
      break;
    case 3:
      g_add(s, 17, 15, 22);
      break;
    default:
      break;
  })
  // phase 27: round 7 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 27, 21, 23, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 35, 11, 9, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 36, 3, 6, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 25, 8, 15, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 26, 10, 22, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 29, 7, 17, mx);
      break;
    case 6:
      g_mul_mxu<16>(s, 30, 24, 2, mx);
      break;
    case 7:
      g_mul_mxu<16>(s, 34, 18, 2, mx);
      break;
    default:
      break;
  })
  // phase 28: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_load(s, 3, f, 0, n, lane);
      break;
    case 1:
      g_load(s, 6, f, 1, n, lane);
      break;
    case 2:
      g_load(s, 7, f, 4, n, lane);
      break;
    case 3:
      g_load(s, 9, f, 5, n, lane);
      break;
    case 4:
      g_add(s, 11, 28, 31);
      break;
    case 5:
      g_add(s, 15, 16, 20);
      break;
    default:
      break;
  })
  // phase 29: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 17, 3, 6);
      break;
    case 1:
      g_add(s, 18, 7, 9);
      break;
    default:
      break;
  })
  // phase 30: round 8 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 21, 3, 28, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 22, 6, 31, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 23, 17, 11, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 24, 7, 16, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 32, 9, 20, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 33, 18, 15, mx);
      break;
    case 6:
      g_mul_mxu<16>(s, 37, 3, 16, mx);
      break;
    case 7:
      g_mul_mxu<16>(s, 38, 6, 20, mx);
      break;
    default:
      break;
  })
  // phase 31: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_load(s, 11, f, 2, n, lane);
      break;
    case 1:
      g_load(s, 15, f, 3, n, lane);
      break;
    case 2:
      g_add(s, 17, 3, 6);
      break;
    case 3:
      g_add(s, 18, 16, 20);
      break;
    case 4:
      g_add(s, 39, 28, 31);
      break;
    case 5:
      g_add(s, 40, 16, 20);
      break;
    default:
      break;
  })
  // phase 32: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 41, 11, 15);
      break;
    case 1:
      g_add(s, 42, 11, 15);
      break;
    default:
      break;
  })
  // phase 33: round 9 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 43, 17, 18, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 44, 11, 28, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 45, 15, 31, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 46, 41, 39, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 47, 11, 16, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 48, 15, 20, mx);
      break;
    case 6:
      g_mul_mxu<16>(s, 49, 42, 40, mx);
      break;
    case 7:
      g_mul_mxu<16>(s, 50, 7, 28, mx);
      break;
    default:
      break;
  })
  // phase 34: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_load(s, 17, f, 6, n, lane);
      break;
    case 1:
      g_load(s, 18, f, 7, n, lane);
      break;
    case 2:
      g_load(s, 39, f, 10, n, lane);
      break;
    case 3:
      g_load(s, 40, f, 11, n, lane);
      break;
    case 4:
      g_add(s, 41, 7, 9);
      break;
    case 5:
      g_add(s, 42, 28, 31);
      break;
    case 6:
      g_add(s, 51, 30, 34);
      break;
    case 7:
      g_add(s, 52, 30, 34);
      break;
    default:
      break;
  })
  // phase 35: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 53, 39, 40);
      break;
    case 1:
      g_add(s, 54, 17, 18);
      break;
    default:
      break;
  })
  // phase 36: round 10 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 55, 9, 31, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 56, 41, 42, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 57, 39, 30, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 58, 40, 34, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 59, 53, 51, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 60, 17, 30, mx);
      break;
    case 6:
      g_mul_mxu<16>(s, 61, 18, 34, mx);
      break;
    case 7:
      g_mul_mxu<16>(s, 62, 54, 52, mx);
      break;
    default:
      break;
  })
  // phase 37: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_load(s, 41, f, 8, n, lane);
      g_add(s, 65, 30, 34);
      break;
    case 1:
      g_load(s, 42, f, 9, n, lane);
      g_add(s, 66, 28, 31);
      break;
    case 2:
      g_add(s, 51, 3, 17);
      break;
    case 3:
      g_add(s, 52, 6, 18);
      break;
    case 4:
      g_add(s, 53, 7, 39);
      break;
    case 5:
      g_add(s, 54, 9, 40);
      break;
    case 6:
      g_add(s, 63, 16, 30);
      break;
    case 7:
      g_add(s, 64, 20, 34);
      break;
    default:
      break;
  })
  // phase 38: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 16, 41, 42);
      break;
    case 1:
      g_add(s, 20, 51, 52);
      break;
    default:
      break;
  })
  // phase 39: round 11 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 67, 41, 30, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 68, 42, 34, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 69, 16, 65, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 70, 51, 28, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 71, 52, 31, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 72, 20, 66, mx);
      break;
    case 6:
      g_mul_mxu<16>(s, 73, 53, 63, mx);
      break;
    case 7:
      g_mul_mxu<16>(s, 74, 54, 64, mx);
      break;
    default:
      break;
  })
  // phase 40: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 16, 11, 41);
      break;
    case 1:
      g_add(s, 20, 15, 42);
      break;
    case 2:
      g_add(s, 30, 53, 54);
      break;
    case 3:
      g_add(s, 34, 63, 64);
      break;
    case 4:
      g_add(s, 65, 51, 52);
      break;
    case 5:
      g_add(s, 66, 63, 64);
      break;
    case 6:
      g_add(s, 75, 28, 31);
      break;
    default:
      break;
  })
  // phase 41: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 76, 16, 20);
      break;
    default:
      break;
  })
  // phase 42: round 12 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 77, 30, 34, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 78, 51, 63, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 79, 52, 64, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 80, 65, 66, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 81, 16, 28, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 82, 20, 31, mx);
      break;
    case 6:
      g_mul_mxu<16>(s, 83, 76, 75, mx);
      break;
    case 7:
      g_mul_mxu<16>(s, 84, 16, 63, mx);
      break;
    default:
      break;
  })
  // phase 43: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 30, 27, 35, 0);  // k=2
      break;
    case 1:
      g_sub(s, 34, 25, 26, 0);  // k=2
      break;
    case 2:
      g_add(s, 51, 16, 20);
      break;
    case 3:
      g_add(s, 52, 63, 64);
      break;
    case 4:
      g_add(s, 65, 53, 54);
      break;
    case 5:
      g_add(s, 66, 28, 31);
      break;
    default:
      break;
  })
  // phase 44: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 16, 30, 34, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 45: round 13 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 30, 12, 2, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 34, 13, 2, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 63, 16, 2, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 75, 20, 64, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 76, 51, 52, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 85, 53, 28, mx);
      break;
    case 6:
      g_mul_mxu<16>(s, 86, 54, 31, mx);
      break;
    case 7:
      g_mul_mxu<16>(s, 87, 65, 66, mx);
      break;
    default:
      break;
  })
  // phase 46: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 12, 27, 35);
      g_sub(s, 53, 44, 45, 0);  // k=2
      g_add(s, 91, 67, 68);
      break;
    case 1:
      g_add(s, 13, 25, 26);
      g_add(s, 54, 44, 45);
      break;
    case 2:
      g_sub(s, 16, 21, 22, 0);  // k=2
      g_sub(s, 64, 47, 48, 0);  // k=2
      break;
    case 3:
      g_add(s, 20, 21, 22);
      g_sub(s, 65, 50, 55, 0);  // k=2
      break;
    case 4:
      g_sub(s, 28, 24, 32, 0);  // k=2
      g_sub(s, 66, 57, 58, 0);  // k=2
      break;
    case 5:
      g_add(s, 31, 24, 32);
      g_add(s, 88, 57, 58);
      break;
    case 6:
      g_sub(s, 51, 37, 38, 0);  // k=2
      g_sub(s, 89, 60, 61, 0);  // k=2
      break;
    case 7:
      g_add(s, 52, 37, 38);
      g_sub(s, 90, 67, 68, 0);  // k=2
      break;
    default:
      break;
  })
  // phase 47: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 21, 36, 12, 1);  // k=4
      g_add(s, 37, 51, 53);
      break;
    case 1:
      g_sub(s, 22, 29, 13, 1);  // k=4
      g_add(s, 38, 64, 65);
      break;
    case 2:
      g_sub(s, 24, 23, 20, 1);  // k=4
      break;
    case 3:
      g_sub(s, 25, 33, 31, 1);  // k=4
      break;
    case 4:
      g_sub(s, 26, 43, 52, 1);  // k=4
      break;
    case 5:
      g_sub(s, 27, 46, 54, 1);  // k=4
      break;
    case 6:
      g_sub(s, 32, 59, 88, 1);  // k=4
      break;
    case 7:
      g_sub(s, 35, 69, 91, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 48: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 12, 21, 22, 2);  // k=8
      g_add(s, 43, 38, 89);
      break;
    case 1:
      g_sub(s, 13, 28, 25, 2);  // k=8
      break;
    case 2:
      g_add(s, 20, 28, 25);
      break;
    case 3:
      g_add(s, 23, 26, 27);
      break;
    case 4:
      g_sub(s, 29, 66, 32, 2);  // k=8
      break;
    case 5:
      g_add(s, 31, 66, 32);
      break;
    case 6:
      g_sub(s, 33, 90, 35, 2);  // k=8
      break;
    case 7:
      g_add(s, 36, 90, 35);
      break;
    default:
      break;
  })
  // phase 49: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 21, 16, 13);
      break;
    case 1:
      g_add(s, 22, 24, 20);
      break;
    case 2:
      g_add(s, 25, 37, 29);
      break;
    case 3:
      g_add(s, 26, 23, 31);
      break;
    default:
      break;
  })
  // phase 50: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 13, 21, 33);
      break;
    case 1:
      g_add(s, 16, 22, 36);
      break;
    default:
      break;
  })
  // phase 51: round 14 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 33, 12, 2, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 36, 14, 2, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 20, 19, 2, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 24, 13, 2, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 27, 16, 2, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 28, 25, 2, mx);
      break;
    case 6:
      g_mul_mxu<16>(s, 32, 26, 2, mx);
      break;
    case 7:
      g_mul_mxu<16>(s, 66, 43, 2, mx);
      break;
    default:
      break;
  })
  // phase 52: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 12, 47, 48);
      g_add(s, 46, 78, 79);
      break;
    case 1:
      g_add(s, 13, 50, 55);
      g_sub(s, 51, 81, 82, 0);  // k=2
      break;
    case 2:
      g_add(s, 14, 60, 61);
      g_add(s, 52, 81, 82);
      break;
    case 3:
      g_sub(s, 16, 70, 71, 0);  // k=2
      g_sub(s, 53, 84, 75, 0);  // k=2
      break;
    case 4:
      g_add(s, 19, 70, 71);
      g_add(s, 54, 84, 75);
      break;
    case 5:
      g_sub(s, 25, 73, 74, 0);  // k=2
      g_sub(s, 59, 85, 86, 0);  // k=2
      break;
    case 6:
      g_add(s, 26, 73, 74);
      g_add(s, 64, 85, 86);
      break;
    case 7:
      g_sub(s, 43, 78, 79, 0);  // k=2
      break;
    default:
      break;
  })
  // phase 53: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 47, 49, 12, 1);  // k=4
      g_sub(s, 73, 87, 64, 1);  // k=4
      break;
    case 1:
      g_sub(s, 48, 56, 13, 1);  // k=4
      g_add(s, 74, 43, 51);
      break;
    case 2:
      g_sub(s, 50, 62, 14, 1);  // k=4
      g_add(s, 75, 53, 59);
      break;
    case 3:
      g_sub(s, 55, 72, 19, 1);  // k=4
      break;
    case 4:
      g_sub(s, 60, 77, 26, 1);  // k=4
      break;
    case 5:
      g_sub(s, 61, 80, 46, 1);  // k=4
      break;
    case 6:
      g_sub(s, 70, 83, 52, 1);  // k=4
      break;
    case 7:
      g_sub(s, 71, 76, 54, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 54: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 12, 47, 48);
      break;
    case 1:
      g_sub(s, 13, 25, 60, 2);  // k=8
      break;
    case 2:
      g_add(s, 14, 25, 60);
      break;
    case 3:
      g_add(s, 19, 61, 70);
      break;
    case 4:
      g_add(s, 26, 71, 73);
      break;
    case 5:
      g_sub(s, 43, 74, 37, 2);  // k=8
      break;
    case 6:
      g_sub(s, 46, 75, 38, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 55: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_add(s, 25, 16, 13);
      break;
    case 1:
      g_add(s, 37, 55, 14);
      break;
    case 2:
      g_add(s, 38, 12, 50);
      break;
    case 3:
      g_sub(s, 47, 19, 23, 3);  // k=16
      break;
    case 4:
      g_sub(s, 48, 26, 12, 3);  // k=16
      break;
    case 5:
      g_sub(s, 60, 43, 89, 1);  // k=4
      break;
    case 6:
      g_sub(s, 61, 46, 90, 1);  // k=4
      break;
    default:
      break;
  })
  // phase 56: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 12, 25, 21, 3);  // k=16
      break;
    case 1:
      g_sub(s, 13, 37, 22, 3);  // k=16
      break;
    case 2:
      g_sub(s, 14, 47, 50, 2);  // k=8
      break;
    case 3:
      g_sub(s, 16, 48, 35, 2);  // k=8
      break;
    default:
      break;
  })
  // phase 57: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sub(s, 21, 12, 29, 3);  // k=16
      break;
    case 1:
      g_sub(s, 22, 13, 31, 3);  // k=16
      break;
    default:
      break;
  })
  // phase 58: round 15 of products
  LH_RANKS(8, switch (r) {
    case 0:
      g_mul_mxu<16>(s, 12, 38, 2, mx);
      break;
    case 1:
      g_mul_mxu<16>(s, 13, 21, 2, mx);
      break;
    case 2:
      g_mul_mxu<16>(s, 29, 22, 2, mx);
      break;
    case 3:
      g_mul_mxu<16>(s, 31, 60, 2, mx);
      break;
    case 4:
      g_mul_mxu<16>(s, 25, 14, 2, mx);
      break;
    case 5:
      g_mul_mxu<16>(s, 35, 61, 2, mx);
      break;
    case 6:
      g_mul_mxu<16>(s, 37, 16, 2, mx);
      break;
    default:
      break;
  })
  // phase 59: linear ops
  LH_RANKS(8, switch (r) {
    case 0:
      g_sel(s, 2, take, 24, 3);
      if (live) g_store(f_out, 0, n, lane, s, 2);
      g_sel(s, 47, take, 31, 41);
      if (live) g_store(f_out, 8, n, lane, s, 47);
      g_sel(s, 55, take, 36, 0);
      if (live) g_store(t_out, 4, n, lane, s, 55);
      break;
    case 1:
      g_sel(s, 14, take, 27, 6);
      if (live) g_store(f_out, 1, n, lane, s, 14);
      g_sel(s, 48, take, 25, 42);
      if (live) g_store(f_out, 9, n, lane, s, 48);
      g_sel(s, 89, take, 20, 1);
      if (live) g_store(t_out, 5, n, lane, s, 89);
      break;
    case 2:
      g_sel(s, 16, take, 28, 11);
      if (live) g_store(f_out, 2, n, lane, s, 16);
      g_sel(s, 50, take, 35, 39);
      if (live) g_store(f_out, 10, n, lane, s, 50);
      break;
    case 3:
      g_sel(s, 21, take, 32, 15);
      if (live) g_store(f_out, 3, n, lane, s, 21);
      g_sel(s, 19, take, 37, 40);
      if (live) g_store(f_out, 11, n, lane, s, 19);
      break;
    case 4:
      g_sel(s, 22, take, 66, 7);
      if (live) g_store(f_out, 4, n, lane, s, 22);
      g_sel(s, 23, take, 30, 4);
      if (live) g_store(t_out, 0, n, lane, s, 23);
      break;
    case 5:
      g_sel(s, 38, take, 12, 9);
      if (live) g_store(f_out, 5, n, lane, s, 38);
      g_sel(s, 26, take, 34, 5);
      if (live) g_store(t_out, 1, n, lane, s, 26);
      break;
    case 6:
      g_sel(s, 60, take, 13, 17);
      if (live) g_store(f_out, 6, n, lane, s, 60);
      g_sel(s, 43, take, 63, 8);
      if (live) g_store(t_out, 2, n, lane, s, 43);
      break;
    case 7:
      g_sel(s, 61, take, 29, 18);
      if (live) g_store(f_out, 7, n, lane, s, 61);
      g_sel(s, 46, take, 33, 10);
      if (live) g_store(t_out, 3, n, lane, s, 46);
      break;
    default:
      break;
  })
}

extern "C" int lh_miller_step_add_mxu_g8(const void* f, const void* t, const void* q, const void* xp, const void* yp, const void* bit, void* f_out, void* t_out, int n,
                              void* stream) {
  constexpr int kShared = static_cast<int>(sizeof(lh::MxuShared<8, 16>)) + 2392 * 2 * lh::kGroupLanes;
  static_assert(kShared <= 232448, "one block's shared memory on sm_90");
  const cudaError_t attr = lh::set_shared_limit(miller_step_add_mxu_g8_kernel, kShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n > 0) {
    miller_step_add_mxu_g8_kernel<<<(n + lh::kGroupLanes - 1) / lh::kGroupLanes, 8 * lh::kGroupLanes,
                          kShared, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(f), static_cast<const uint32_t*>(t), static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(yp), static_cast<const int32_t*>(bit),
        static_cast<uint32_t*>(f_out), static_cast<uint32_t*>(t_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
