// Montgomery product on 26 x 15-bit limbs, one lane per thread.
//
// CUDA twin of lighthouse_tpu/crypto/bls/jax_backend/pallas_fp.py:_mont_core
// (_wide_product + _mont_reduce).  Output limbs are STRICT and identical to
// the reference's: the quasi-normalized m = (t * P') mod R is not unique, so
// the column sums and carry passes below follow the reference step for step
// (two one-step carry passes over the 52-column schoolbook, m from the low 26
// columns of t * P' after its two passes, u = m * P, one 52-step carry).
//
// Inputs are quasi limbs (<= 32,896) whose value bounds multiply to <= 2000
// P^2.  Each 32-bit product is <= 32896^2 < 2^31, and every column sum stays
// below 2^21, so plain uint32 arithmetic never wraps.
//
// The square (mont_sqr_core) is the twin of pallas_fp._mont_sqr_core: the
// j >= i triangle of the schoolbook with the cross products doubled before
// the lo/hi split (351 products instead of 676), then the same reduction.
// A doubled cross product reaches 2^31.02: it fits a uint32 register (never
// the port's int32 storage, where no product is kept).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "limb_constants.cuh"

namespace lh {

constexpr int NL = 26;           // limbs per field element
constexpr uint32_t MASK = 0x7FFFu;  // 15-bit limb mask

// One carry pass over NC columns: each column keeps its low 15 bits plus the
// high bits of the column below; the top column's carry is dropped.  Walking
// down from the top reads every lower column before it is rewritten.
template <int NC>
__device__ __forceinline__ void compress1(uint32_t (&c)[NC]) {
#pragma unroll
  for (int k = NC - 1; k >= 1; --k) c[k] = (c[k] & MASK) + (c[k - 1] >> 15);
  c[0] &= MASK;
}

// Schoolbook a * b: column i+j takes the low 15 bits of a_i * b_j and column
// i+j+1 its high bits; then two carry passes (pallas_fp._wide_product).
__device__ __forceinline__ void wide_product(const uint32_t (&a)[NL],
                                             const uint32_t (&b)[NL],
                                             uint32_t (&t)[2 * NL]) {
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      const uint32_t p = a[i] * b[j];
      t[i + j] += p & MASK;
      t[i + j + 1] += p >> 15;
    }
  }
  compress1(t);
  compress1(t);
}

// The low 26 columns of the same schoolbook (both carry passes included):
// column k < 26 of a carry pass depends only on columns k and k-1, so this
// equals the reference's _wide_product(t[:26], P')[:26] with the products
// above column 25 never formed (351 of 676).
__device__ __forceinline__ void low_product(const uint32_t (&a)[NL],
                                            const uint32_t (&b)[NL],
                                            uint32_t (&m)[NL]) {
#pragma unroll
  for (int k = 0; k < NL; ++k) m[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
#pragma unroll
    for (int j = 0; i + j < NL; ++j) {
      const uint32_t p = a[i] * b[j];
      m[i + j] += p & MASK;
      if (i + j + 1 < NL) m[i + j + 1] += p >> 15;
    }
  }
  compress1(m);
  compress1(m);
}

// Schoolbook a * a over the j >= i triangle (pallas_fp._wide_square): the
// cross product a_i * a_j (j > i) is doubled once and then split, the
// diagonal a_i * a_i split as is; then two carry passes.  i = 25 has no
// cross terms.  The column sums differ from wide_product(a, a)'s before the
// carry passes, so the reduction below may land on another representative:
// this routine is held byte for byte against _mont_sqr_core, never against
// mont_core(a, a).
__device__ __forceinline__ void wide_square(const uint32_t (&a)[NL],
                                            uint32_t (&t)[2 * NL]) {
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t d = a[i] * a[i];
    t[2 * i] += d & MASK;
    t[2 * i + 1] += d >> 15;
#pragma unroll
    for (int j = i + 1; j < NL; ++j) {
      const uint32_t p = a[i] * a[j];
      const uint32_t p2 = p + p;  // < 2^31.02
      t[i + j] += p2 & MASK;
      t[i + j + 1] += p2 >> 15;
    }
  }
  compress1(t);
  compress1(t);
}

// Montgomery reduction of a 52-column product (pallas_fp._mont_reduce):
// m = low 26 columns of t * P', u = m * P, then one 52-step carry over
// t + u, whose low 26 limbs vanish (t + u is divisible by R).
__device__ __forceinline__ void mont_reduce(const uint32_t (&t)[2 * NL],
                                            uint32_t (&out)[NL]) {
  uint32_t tl[NL], pp[NL], pl[NL];
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    tl[k] = t[k];
    pp[k] = kPPrime[k];
    pl[k] = kP[k];
  }
  uint32_t m[NL];
  low_product(tl, pp, m);
  uint32_t u[2 * NL];
  wide_product(m, pl, u);
  uint32_t carry = 0;
#pragma unroll
  for (int k = 0; k < 2 * NL; ++k) {
    const uint32_t s = t[k] + u[k] + carry;
    carry = s >> 15;
    if (k >= NL) out[k - NL] = s & MASK;
  }
}

// out = a * b * R^-1 (mod P) representative, strict limbs.
__device__ __forceinline__ void mont_core(const uint32_t (&a)[NL],
                                          const uint32_t (&b)[NL],
                                          uint32_t (&out)[NL]) {
  uint32_t t[2 * NL];
  wide_product(a, b, t);
  mont_reduce(t, out);
}

// out = a * a * R^-1 (mod P) representative by the triangle square.
__device__ __forceinline__ void mont_sqr_core(const uint32_t (&a)[NL],
                                              uint32_t (&out)[NL]) {
  uint32_t t[2 * NL];
  wide_square(a, t);
  mont_reduce(t, out);
}

}  // namespace lh

extern "C" const char* lh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
