// Kernels 4 and 5: a^e for a static exponent e, in Fp and in Fp2, as one
// launch each.
//
// Replaces lighthouse_tpu/crypto/bls/jax_backend/pallas_fp.py:
//   kernel 4: _make_megachain_kernel / _megachain_call / pow_chain_limbs
//   kernel 5: _make_fp2_megachain_kernel / _fp2_megachain_call / fp2_pow_chain
//
// The exponent arrives as an MSB-first tape of base-16 digits (one int32
// each, in device memory; every thread reads the same word, so the loads
// broadcast).  Each thread owns one lane: it builds the 16-entry power table
// (powers[0] = the Montgomery one, powers[1] = the base, powers[k] =
// powers[k-1] * base), starts from powers[tape[0]], and for every later digit
// squares four times and multiplies by powers[digit].  A 0 digit multiplies
// by the one: value-preserving, but it rewrites the limbs, so it is never
// skipped (byte identity with the reference).
//
// The Fp chain squares with the triangle square (_core_pair's sqr); the Fp2
// chain squares and multiplies through its own cores (_fp2_sqr_core,
// _fp2_mul_core), which use fixed 16P / 2P subtraction biases and only the
// full product.
//
// The MXU variants (fp_chain_mxu_kernel, fp2_chain_mxu_kernel; the
// reference's chain kernels built with mxu=True) run every product on the
// 13-bit plane (kernel 7's core, mxu.cuh), the Fp chain's square as the full
// product mont(a, a) (pallas_fp._core_pair).  The core is warp-cooperative:
// the digit tape is the same for every lane, so every call is warp-uniform,
// and the tail threads run lane n - 1's operands again and store nothing.
//
// What bounds it on the card: integer multiplies.  One Fp lane of the p-2
// chain does 14 + 95 * 5 products (about 0.75M 32-bit multiplies) against
// 208 bytes of traffic.  One thread per lane leaves most of each SM idle at
// the path's widths; the power table is indexed by a runtime digit and so
// lives in local memory.  A faster design (several threads per lane, the
// table in shared memory) is later work.
#include "mxu.cuh"

namespace {

using lh::NL;

constexpr int kBlock = 32;  // 4,096 lanes -> 128 blocks, one per SM
constexpr int kWindow = 4;  // pallas_fp.CHAIN_WINDOW
constexpr int kPowers = 1 << kWindow;
constexpr int kBias2 = 0;   // row of 2P in lh::kBias (fp.BIAS_KS order)
constexpr int kBias16 = 3;  // row of 16P

// o = a * b * R^-1; o may alias a or b.
__device__ __noinline__ void c_mul(uint32_t* o, const uint32_t* a, const uint32_t* b) {
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

// o = a * a * R^-1 by the triangle square; o may alias a.
__device__ __noinline__ void c_sqr(uint32_t* o, const uint32_t* a) {
  uint32_t x[NL], r[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = a[i];
  lh::mont_sqr_core(x, r);
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = r[i];
}

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

// The two cores a chain runs on: the 15-bit product and triangle square, or
// the 13-bit product for both.
struct Vpu {
  __device__ __forceinline__ void mul(uint32_t* o, const uint32_t* a, const uint32_t* b) const {
    c_mul(o, a, b);
  }
  __device__ __forceinline__ void sqr(uint32_t* o, const uint32_t* a) const { c_sqr(o, a); }
};

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
fp_chain_kernel(const int32_t* __restrict__ tape, int n_digits,
                const uint32_t* __restrict__ base, uint32_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t acc[NL];
  fp_chain_body(Vpu{}, tape, n_digits, base, n, lane, acc);
  store(out, n, lane, acc);
}

__global__ void __launch_bounds__(kBlock)
fp2_chain_kernel(const int32_t* __restrict__ tape, int n_digits,
                 const uint32_t* __restrict__ a0, const uint32_t* __restrict__ a1,
                 uint32_t* __restrict__ o0, uint32_t* __restrict__ o1, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t c0[NL], c1[NL];
  fp2_chain_body(Vpu{}, tape, n_digits, a0, a1, n, lane, c0, c1);
  store(o0, n, lane, c0);
  store(o1, n, lane, c1);
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

}  // namespace

// tape: (n_digits,) int32 base-16 digits, MSB first, each in [0, 16);
// base, out: (26, n) int32 limb planes, contiguous, on the current device.
// Returns cudaGetLastError().
extern "C" int lh_fp_chain(const void* tape, int n_digits, const void* base, void* out, int n,
                           void* stream) {
  if (n > 0) {
    fp_chain_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tape), n_digits, static_cast<const uint32_t*>(base),
        static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// As lh_fp_chain, for the Fp2 element a0 + a1 u; writes o0, o1.
extern "C" int lh_fp2_chain(const void* tape, int n_digits, const void* a0, const void* a1,
                            void* o0, void* o1, int n, void* stream) {
  if (n > 0) {
    fp2_chain_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(tape), n_digits, static_cast<const uint32_t*>(a0),
        static_cast<const uint32_t*>(a1), static_cast<uint32_t*>(o0),
        static_cast<uint32_t*>(o1), n);
  }
  return static_cast<int>(cudaGetLastError());
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
