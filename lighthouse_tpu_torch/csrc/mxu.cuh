// Kernel 7's core: the Montgomery product on the 31 x 13-bit plane, one lane
// per thread, with the two lane-invariant products on the FP64 tensor cores.
//
// CUDA twin of lighthouse_tpu/crypto/bls/jax_backend/pallas_mxu.py:
// mont_core_mxu.  Same operand contract as mont.cuh's mont_core (quasi-15
// limbs in, bound product <= 2000; STRICT 15-bit limbs out), same algebra on
// the 13-bit plane (R = 2^390 = 2^(30 * 13)):
//
//   a13, b13 = to13(a), to13(b)   quasi-13 limbs (<= 8193), exact in value
//   t = a13 * b13                 61 columns, three 13-bit carry passes
//   m = (t * P'13) mod R          columns 0..29, three carry passes
//   u = m * P13                   61 columns, three carry passes
//   out = to15((t + u) / R)       61-step carry, then a 13 -> 15 regroup
//
// The limbs are the reference's byte for byte: the same column sums, the same
// carry passes, and P13 / P'13 are _to13 of the 15-bit constants (codegen
// prints them into limb_constants.cuh).  Carry passes only move carries up,
// so m needs the 465 products of t * P'13 with i + j <= 29, not all 961.
//
// a * b has two per-lane operands: its 961 products are 32-bit multiply-adds
// (each below 8193^2 < 2^26.01, each column sum below 31 * 8193^2 < 2^31).
// t * P'13 and m * P13 have a lane-invariant right operand, so they are
// matrix products with the lanes along N:
//
//   m_raw = Toeplitz(P'13)[0:32, 0:32] @ T      (T: t13 rows 0..29, by lane)
//   u_raw = Toeplitz(P13)[0:64, 0:32] @ M       (M: m13 rows 0..29, by lane)
//
// Each runs on the FP64 tensor cores as mma.sync.aligned.m8n8k4 (DMMA): a
// warp stages its 32 lanes' limbs in shared memory as B (32 x 32), the A
// fragments come from a per-block table of the Toeplitz diagonals, tiles that
// are all zero are skipped at compile time (20 + 40 of 32 + 64 per n-tile),
// and the C fragments go back through shared memory to their lanes.  Every
// product is below 2^27 and every sum below 2^31: exact integers in a 53-bit
// mantissa, converted back with __double2uint_rz.
//
// mma.sync needs all 32 threads of the warp, so every call must be
// warp-uniform and a kernel using it keeps its tail threads alive (they run
// lane n - 1's operands again and store nothing).  Host builds of these
// sources (the CPU tests compile them with g++) leave the DMMA part out and
// supply the two products from mxu_host.h.
#pragma once

#include "mont.cuh"

namespace lh {

constexpr int NL13 = 31;             // 30 limbs span R = 2^390, plus a spill limb
constexpr int NC13 = 2 * NL13 - 1;   // 61 schoolbook columns
constexpr int NLOW = 30;             // m = the low 30 columns of t * P'13
constexpr uint32_t M13 = 0x1FFFu;    // 13-bit limb mask
constexpr uint32_t QMAX15 = 32896u;  // quasi-15 limb bound (fp.QMAX)
constexpr int kMxuPPrime = 0;        // the two lane-invariant operands
constexpr int kMxuP = 1;

// One 13-bit carry pass over NC columns (pallas_mxu._compress13); the top
// column's carry is dropped.  Walking down reads each column before it is
// rewritten.
template <int NC>
__device__ __forceinline__ void compress13(uint32_t (&c)[NC]) {
#pragma unroll
  for (int k = NC - 1; k >= 1; --k) c[k] = (c[k] & M13) + (c[k - 1] >> 13);
  c[0] &= M13;
}

// (26) quasi-15 limbs -> (31) quasi-13 limbs, exact in value (pallas_mxu._to13):
// limb i sits at bit 15 i = 13 q + r and splits into 13-bit chunks at columns
// q, q + 1 and, where QMAX15 << r reaches bit 26, q + 2; one carry pass.
__device__ __forceinline__ void to13(const uint32_t (&a)[NL], uint32_t (&o)[NL13]) {
#pragma unroll
  for (int k = 0; k < NL13; ++k) o[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const int q = 15 * i / 13, r = 15 * i % 13;
    const uint32_t v = a[i] << r;  // <= QMAX15 << 12 < 2^27.1
    o[q] += v & M13;
    o[q + 1] += (v >> 13) & M13;
    if ((QMAX15 << r) >> 26) o[q + 2] += v >> 26;
  }
  compress13(o);
}

// (31) STRICT 13-bit limbs of a value below 2^390 -> (26) strict 15-bit limbs
// (pallas_mxu._to15): limb q collects bits [15 q, 15 q + 15) of the 13-bit
// limbs j, j + 1 and, where 15 q is 12 bits into limb j, j + 2.
__device__ __forceinline__ void to15(const uint32_t (&a)[NL13], uint32_t (&o)[NL]) {
#pragma unroll
  for (int q = 0; q < NL; ++q) {
    const int j = 15 * q / 13, r = 15 * q % 13;
    uint32_t acc = (a[j] >> r) + (a[j + 1] << (13 - r));
    if (26 - r < 15) acc += a[j + 2] << (26 - r);
    o[q] = acc & MASK;
  }
}

// The 61 columns of a13 * b13 by 961 multiply-adds, then three carry passes
// (pallas_mxu._dot_cols of two per-lane operands).
__device__ __forceinline__ void cols13(const uint32_t (&a)[NL13], const uint32_t (&b)[NL13],
                                       uint32_t (&t)[NC13]) {
#pragma unroll
  for (int k = 0; k < NC13; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NL13; ++i) {
#pragma unroll
    for (int j = 0; j < NL13; ++j) t[i + j] += a[i] * b[j];
  }
  compress13(t);
  compress13(t);
  compress13(t);
}

// (t + u) / R: the reference's 61-step carry, keeping columns 30..60 as
// strict 13-bit limbs, then the regroup to 15 bits.
__device__ __forceinline__ void mxu_finish(const uint32_t (&t)[NC13], const uint32_t (&u)[NC13],
                                           uint32_t (&out)[NL]) {
  uint32_t o13[NL13];
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < NC13; ++k) {
    const uint32_t s = t[k] + u[k] + carry;
    carry = s >> 13;
    if (k >= NLOW) o13[k - NLOW] = s & M13;
  }
  to15(o13, out);
}

}  // namespace lh

namespace lh {

constexpr int kStride = 40;  // words per staging row: conflict-free B loads
constexpr int kTabOff = 16;  // table entry of Toeplitz diagonal 0
constexpr int kTab = 64;     // diagonals -16..47 (those reached are -10..40)

}  // namespace lh

#ifdef __CUDACC__

namespace lh {

// Where one warp's DMMA products stage their operands.
struct MxuCtx {
  uint32_t (*in)[kStride];   // 32 rows (limbs) x 32 lanes: the B operand
  uint32_t (*out)[kStride];  // ROWS rows (columns) x 32 lanes: the C result
  const double* tab;         // [2][kTab] Toeplitz diagonals of P'13 and P13
  int lane;                  // lane of this thread in its warp
};

// Shared memory of a block of W warps.  With ROWS = 64 a product's 64 rows
// of C are staged at once; with ROWS = 32 the 64-row product (m * P) is
// staged in two passes of 32 rows, for blocks of many warps (the group form
// of the Miller step), whose staging would not fit in shared memory beside
// their values otherwise.
template <int W, int ROWS = 64>
struct MxuShared {
  double tab[2][kTab];
  uint32_t in[W][32][kStride];
  uint32_t out[W][ROWS][kStride];
};

// A group kernel's shared memory (csrc/group.cuh: one rank per warp, W
// ranks) with the DMMA staging of its warps: the staging first, then `words`
// of `type` per lane of the block, all in dynamic shared memory (static
// shared memory stops at 48 KB a block).  The launcher asks for
// sizeof(MxuShared<W, ROWS>) + words * sizeof(type) * kGroupLanes bytes.
#define LH_MXU_GROUP_SHARED(W, ROWS, sm, type, name, words)                             \
  extern __shared__ __align__(16) unsigned char lh_mxu_dyn[];                           \
  lh::MxuShared<W, ROWS>& sm = *reinterpret_cast<lh::MxuShared<W, ROWS>*>(lh_mxu_dyn); \
  type* const name = reinterpret_cast<type*>(lh_mxu_dyn + sizeof(lh::MxuShared<W, ROWS>))

// Fill the diagonal tables from the constants and hand each warp its
// buffers.  Every thread of the block must call it (it synchronises).
template <int W, int ROWS>
__device__ __forceinline__ MxuCtx mxu_setup(MxuShared<W, ROWS>& sm) {
  for (int i = threadIdx.x; i < 2 * kTab; i += blockDim.x) {
    const int d = i % kTab - kTabOff;
    const uint32_t* c = i < kTab ? kPPrime13 : kP13;
    sm.tab[i / kTab][i % kTab] = (d >= 0 && d < NL13) ? static_cast<double>(c[d]) : 0.0;
  }
  __syncthreads();
  const int w = threadIdx.x >> 5;
  return MxuCtx{sm.in[w], sm.out[w], &sm.tab[0][0], static_cast<int>(threadIdx.x & 31)};
}

// D = A * B + D on an 8 x 8 x 4 tile in FP64.  Fragments: A[g][q], B[q][g],
// D[g][2q + 0/1] for thread g * 4 + q of the warp.
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

// y[k] = sum_{i < 30} C[k - i] x[i] for k < NY, C the 13-bit limbs of P'
// (which = kMxuPPrime) or P (kMxuP), for the 32 lanes of the warp at once:
// the (RT * 8) x 32 Toeplitz matrix times the 32 x 32 matrix of the lanes'
// x, its rows staged through ``out`` ROWS at a time (every C entry is an
// exact integer, so the passes change no byte).  Warp-cooperative: every
// thread of the warp calls it together.
template <int RT, int NY, int ROWS = 64>
__device__ __forceinline__ void toeplitz_dot(int which, const uint32_t* x, uint32_t (&y)[NY],
                                             const MxuCtx& mx) {
  constexpr int HT = RT < ROWS / 8 ? RT : ROWS / 8;  // row tiles per pass
  static_assert(RT % HT == 0, "whole passes of row tiles");
  const int g = mx.lane >> 2, q = mx.lane & 3;
  const double* diag = mx.tab + which * kTab + kTabOff + g - q;
#pragma unroll
  for (int i = 0; i < 32; ++i) mx.in[i][mx.lane] = i < NLOW ? x[i] : 0u;
  __syncwarp();
#pragma unroll
  for (int h = 0; h < RT / HT; ++h) {  // pass h: row tiles h * HT .. h * HT + HT - 1
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // n-tile j: lanes 8 j .. 8 j + 7
      double b[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) b[c] = static_cast<double>(mx.in[4 * c + q][8 * j + g]);
#pragma unroll
      for (int rr = 0; rr < HT; ++rr) {  // rows 8 r .. 8 r + 7 of the product
        const int r = h * HT + rr;
        double d0 = 0.0, d1 = 0.0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {  // k-tile c: limbs 4 c .. 4 c + 3
          // the tile's diagonals are 8 r - 4 c - 3 .. 8 r - 4 c + 7; C is zero
          // outside 0..30
          if (8 * r - 4 * c + 7 < 0 || 8 * r - 4 * c - 3 >= NL13) continue;
          dmma(d0, d1, diag[8 * r - 4 * c], b[c]);
        }
        mx.out[8 * rr + g][8 * j + 2 * q] = __double2uint_rz(d0);
        mx.out[8 * rr + g][8 * j + 2 * q + 1] = __double2uint_rz(d1);
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 8 * HT; ++k)
      if (8 * HT * h + k < NY) y[8 * HT * h + k] = mx.out[k][mx.lane];
    if (h + 1 < RT / HT) __syncwarp();  // read before the next pass overwrites
  }
}

}  // namespace lh

#else
#include "mxu_host.h"
#endif

namespace lh {

// out = a * b * R^-1 (mod P) representative, strict 15-bit limbs, on the
// 13-bit plane (pallas_mxu.mont_core_mxu).  Warp-cooperative.  ROWS is the
// staging's rows of C (MxuShared).
template <int ROWS = 64>
__device__ __forceinline__ void mont_core_mxu(const uint32_t (&a)[NL], const uint32_t (&b)[NL],
                                              uint32_t (&out)[NL], const MxuCtx& mx) {
  uint32_t t[NC13];
  {
    uint32_t a13[NL13], b13[NL13];
    to13(a, a13);
    to13(b, b13);
    cols13(a13, b13, t);
  }
  uint32_t m[NLOW];
  toeplitz_dot<4, NLOW, ROWS>(kMxuPPrime, t, m, mx);
  compress13(m);
  compress13(m);
  compress13(m);
  uint32_t u[NC13];
  toeplitz_dot<8, NC13, ROWS>(kMxuP, m, u, mx);
  compress13(u);
  compress13(u);
  compress13(u);
  mxu_finish(t, u, out);
}

}  // namespace lh
