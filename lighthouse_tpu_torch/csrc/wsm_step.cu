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
// One thread per lane.  Planes are (planes, 26, n) limb-major, so limb i of
// neighbouring lanes are neighbouring words and every load and store
// coalesces.  Intermediates live in the slot array s (registers spilling to
// local memory); every Montgomery product is one call of the non-inlined
// k_mul, which keeps the build short.
#include "mont.cuh"

namespace {

using lh::NL;

constexpr int kBlock = 32;  // 4,097 lanes -> 129 blocks, one per SM

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

__device__ __noinline__ void k_sqr(uint32_t* o, const uint32_t* a) {
  uint32_t x[NL], r[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = a[i];
  lh::mont_sqr_core(x, r);
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = r[i];
}

__device__ __forceinline__ void k_zero(uint32_t* o) {
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i] = 0;
}

}  // namespace

// wsm_step_g1: 70 limb ops, 17 Montgomery products, 8 squares, 13 slots.
static __global__ void __launch_bounds__(kBlock)
wsm_step_g1_kernel(const uint32_t* __restrict__ acc, const uint32_t* __restrict__ inf_acc, const uint32_t* __restrict__ base, const uint32_t* __restrict__ inf_base, const uint32_t* __restrict__ bit, uint32_t* __restrict__ acc_out, uint32_t* __restrict__ inf_out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t s[13][NL];
  k_one(s[0]);
  k_load(s[1], acc, 0, n, lane);
  k_load(s[2], acc, 1, n, lane);
  k_load(s[3], acc, 2, n, lane);
  const uint32_t f4 = inf_acc[lane];
  k_load(s[4], base, 0, n, lane);
  k_load(s[5], base, 1, n, lane);
  const uint32_t f7 = inf_base[lane];
  const uint32_t f8 = bit[lane];
  k_sqr(s[6], s[1]);
  k_sqr(s[7], s[2]);
  k_mul(s[8], s[2], s[3]);
  k_add(s[3], s[6], s[6]);
  k_add(s[2], s[3], s[6]);
  k_add(s[3], s[1], s[7]);
  k_sqr(s[1], s[7]);
  k_sqr(s[7], s[3]);
  k_sqr(s[3], s[2]);
  k_sub(s[9], s[7], s[6], 0);  // k=2
  k_sub(s[7], s[9], s[1], 0);  // k=2
  k_add(s[9], s[7], s[7]);
  k_add(s[7], s[9], s[9]);
  k_sub(s[6], s[3], s[7], 4);  // k=32
  k_sub(s[7], s[9], s[6], 5);  // k=64
  k_mul(s[9], s[7], s[0]);
  k_mul(s[7], s[2], s[9]);
  k_add(s[9], s[1], s[1]);
  k_add(s[1], s[9], s[9]);
  k_add(s[9], s[1], s[1]);
  k_sub(s[1], s[7], s[9], 3);  // k=16
  k_add(s[9], s[8], s[8]);
  k_mul(s[8], s[6], s[0]);
  k_mul(s[6], s[1], s[0]);
  k_mul(s[1], s[9], s[0]);
  k_sqr(s[9], s[1]);
  k_mul(s[7], s[4], s[9]);
  k_mul(s[2], s[1], s[9]);
  k_mul(s[9], s[5], s[2]);
  k_sub(s[2], s[7], s[8], 1);  // k=4
  k_sub(s[7], s[9], s[6], 1);  // k=4
  k_add(s[9], s[7], s[7]);
  k_add(s[7], s[2], s[2]);
  k_sqr(s[3], s[7]);
  k_mul(s[7], s[2], s[3]);
  k_mul(s[10], s[8], s[3]);
  k_sqr(s[3], s[9]);
  k_sub(s[11], s[3], s[7], 0);  // k=2
  k_add(s[3], s[10], s[10]);
  k_sub(s[12], s[11], s[3], 1);  // k=4
  k_sub(s[11], s[10], s[12], 2);  // k=8
  k_mul(s[10], s[9], s[11]);
  k_mul(s[11], s[6], s[7]);
  k_add(s[7], s[11], s[11]);
  k_sub(s[11], s[10], s[7], 1);  // k=4
  k_add(s[10], s[1], s[1]);
  k_mul(s[7], s[10], s[2]);
  k_mul(s[10], s[12], s[0]);
  k_mul(s[12], s[11], s[0]);
  k_mul(s[11], s[7], s[0]);
  k_sel(s[7], f7 != 0, s[8], s[10]);
  k_sel(s[10], f7 != 0, s[6], s[12]);
  k_sel(s[12], f7 != 0, s[1], s[11]);
  k_sel(s[11], f4 != 0, s[4], s[7]);
  k_sel(s[7], f4 != 0, s[5], s[10]);
  k_sel(s[10], f4 != 0, s[0], s[12]);
  const uint32_t f65 = f4 & f7;
  k_sel(s[12], f8 != 0, s[11], s[8]);
  k_store(acc_out, 0, n, lane, s[12]);
  k_sel(s[12], f8 != 0, s[7], s[6]);
  k_store(acc_out, 1, n, lane, s[12]);
  k_sel(s[12], f8 != 0, s[10], s[1]);
  k_store(acc_out, 2, n, lane, s[12]);
  const uint32_t f69 = f8 != 0 ? f65 : f4;
  inf_out[lane] = f69;
}

extern "C" int lh_wsm_step_g1(const void* acc, const void* inf_acc, const void* base, const void* inf_base, const void* bit, void* acc_out, void* inf_out, int n,
                              void* stream) {
  if (n > 0) {
    wsm_step_g1_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(acc), static_cast<const uint32_t*>(inf_acc), static_cast<const uint32_t*>(base), static_cast<const uint32_t*>(inf_base), static_cast<const uint32_t*>(bit),
        static_cast<uint32_t*>(acc_out), static_cast<uint32_t*>(inf_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// wsm_step_g2: 227 limb ops, 68 Montgomery products, 24 slots.
static __global__ void __launch_bounds__(kBlock)
wsm_step_g2_kernel(const uint32_t* __restrict__ acc, const uint32_t* __restrict__ inf_acc, const uint32_t* __restrict__ base, const uint32_t* __restrict__ inf_base, const uint32_t* __restrict__ bit, uint32_t* __restrict__ acc_out, uint32_t* __restrict__ inf_out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t s[24][NL];
  k_one(s[0]);
  k_load(s[1], acc, 0, n, lane);
  k_load(s[2], acc, 1, n, lane);
  k_load(s[3], acc, 2, n, lane);
  k_load(s[4], acc, 3, n, lane);
  k_load(s[5], acc, 4, n, lane);
  k_load(s[6], acc, 5, n, lane);
  const uint32_t f7 = inf_acc[lane];
  k_load(s[7], base, 0, n, lane);
  k_load(s[8], base, 1, n, lane);
  k_load(s[9], base, 2, n, lane);
  k_load(s[10], base, 3, n, lane);
  const uint32_t f12 = inf_base[lane];
  const uint32_t f13 = bit[lane];
  k_sub(s[11], s[1], s[2], 1);  // k=4
  k_add(s[12], s[1], s[2]);
  k_mul(s[13], s[11], s[12]);
  k_mul(s[12], s[1], s[2]);
  k_add(s[11], s[12], s[12]);
  k_sub(s[12], s[3], s[4], 1);  // k=4
  k_add(s[14], s[3], s[4]);
  k_mul(s[15], s[12], s[14]);
  k_mul(s[14], s[3], s[4]);
  k_add(s[12], s[14], s[14]);
  k_add(s[14], s[3], s[4]);
  k_add(s[16], s[5], s[6]);
  k_mul(s[17], s[3], s[5]);
  k_mul(s[5], s[4], s[6]);
  k_mul(s[6], s[14], s[16]);
  k_sub(s[16], s[17], s[5], 0);  // k=2
  k_add(s[14], s[17], s[5]);
  k_sub(s[17], s[6], s[14], 1);  // k=4
  k_add(s[14], s[13], s[13]);
  k_add(s[6], s[11], s[11]);
  k_add(s[5], s[14], s[13]);
  k_add(s[14], s[6], s[11]);
  k_add(s[6], s[1], s[15]);
  k_add(s[1], s[2], s[12]);
  k_sub(s[2], s[15], s[12], 1);  // k=4
  k_add(s[4], s[15], s[12]);
  k_mul(s[3], s[2], s[4]);
  k_mul(s[4], s[15], s[12]);
  k_add(s[15], s[4], s[4]);
  k_sub(s[4], s[6], s[1], 2);  // k=8
  k_add(s[12], s[6], s[1]);
  k_mul(s[2], s[4], s[12]);
  k_mul(s[12], s[6], s[1]);
  k_add(s[6], s[12], s[12]);
  k_sub(s[12], s[5], s[14], 2);  // k=8
  k_add(s[1], s[5], s[14]);
  k_mul(s[4], s[12], s[1]);
  k_mul(s[12], s[5], s[14]);
  k_add(s[1], s[12], s[12]);
  k_sub(s[12], s[2], s[13], 0);  // k=2
  k_sub(s[13], s[6], s[11], 1);  // k=4
  k_sub(s[11], s[12], s[3], 0);  // k=2
  k_sub(s[12], s[13], s[15], 1);  // k=4
  k_add(s[13], s[11], s[11]);
  k_add(s[11], s[12], s[12]);
  k_add(s[12], s[13], s[13]);
  k_add(s[6], s[11], s[11]);
  k_sub(s[2], s[4], s[12], 4);  // k=32
  k_sub(s[12], s[1], s[6], 5);  // k=64
  k_sub(s[6], s[13], s[2], 5);  // k=64
  k_sub(s[13], s[11], s[12], 6);  // k=128
  k_mul(s[11], s[6], s[0]);
  k_mul(s[6], s[13], s[0]);
  k_add(s[13], s[5], s[14]);
  k_add(s[1], s[11], s[6]);
  k_mul(s[4], s[5], s[11]);
  k_mul(s[11], s[14], s[6]);
  k_mul(s[14], s[13], s[1]);
  k_sub(s[13], s[4], s[11], 0);  // k=2
  k_add(s[1], s[4], s[11]);
  k_sub(s[11], s[14], s[1], 1);  // k=4
  k_add(s[14], s[3], s[3]);
  k_add(s[3], s[15], s[15]);
  k_add(s[15], s[14], s[14]);
  k_add(s[14], s[3], s[3]);
  k_add(s[3], s[15], s[15]);
  k_add(s[15], s[14], s[14]);
  k_sub(s[14], s[13], s[3], 3);  // k=16
  k_sub(s[13], s[11], s[15], 4);  // k=32
  k_add(s[15], s[16], s[16]);
  k_add(s[16], s[17], s[17]);
  k_mul(s[17], s[2], s[0]);
  k_mul(s[2], s[12], s[0]);
  k_mul(s[12], s[14], s[0]);
  k_mul(s[14], s[13], s[0]);
  k_mul(s[13], s[15], s[0]);
  k_mul(s[15], s[16], s[0]);
  k_sub(s[16], s[13], s[15], 1);  // k=4
  k_add(s[11], s[13], s[15]);
  k_mul(s[3], s[16], s[11]);
  k_mul(s[16], s[13], s[15]);
  k_add(s[11], s[16], s[16]);
  k_add(s[16], s[7], s[8]);
  k_add(s[1], s[3], s[11]);
  k_mul(s[4], s[7], s[3]);
  k_mul(s[6], s[8], s[11]);
  k_mul(s[5], s[16], s[1]);
  k_sub(s[16], s[4], s[6], 0);  // k=2
  k_add(s[1], s[4], s[6]);
  k_sub(s[6], s[5], s[1], 1);  // k=4
  k_add(s[5], s[13], s[15]);
  k_add(s[1], s[3], s[11]);
  k_mul(s[4], s[13], s[3]);
  k_mul(s[3], s[15], s[11]);
  k_mul(s[11], s[5], s[1]);
  k_sub(s[5], s[4], s[3], 0);  // k=2
  k_add(s[1], s[4], s[3]);
  k_sub(s[4], s[11], s[1], 1);  // k=4
  k_add(s[11], s[9], s[10]);
  k_add(s[1], s[5], s[4]);
  k_mul(s[3], s[9], s[5]);
  k_mul(s[5], s[10], s[4]);
  k_mul(s[4], s[11], s[1]);
  k_sub(s[11], s[3], s[5], 0);  // k=2
  k_add(s[1], s[3], s[5]);
  k_sub(s[5], s[4], s[1], 1);  // k=4
  k_sub(s[4], s[16], s[17], 1);  // k=4
  k_sub(s[16], s[6], s[2], 1);  // k=4
  k_sub(s[6], s[11], s[12], 1);  // k=4
  k_sub(s[11], s[5], s[14], 1);  // k=4
  k_add(s[5], s[6], s[6]);
  k_add(s[6], s[11], s[11]);
  k_add(s[11], s[4], s[4]);
  k_add(s[1], s[16], s[16]);
  k_mul(s[3], s[11], s[0]);
  k_mul(s[11], s[1], s[0]);
  k_sub(s[1], s[3], s[11], 1);  // k=4
  k_add(s[18], s[3], s[11]);
  k_mul(s[19], s[1], s[18]);
  k_mul(s[18], s[3], s[11]);
  k_add(s[11], s[18], s[18]);
  k_add(s[18], s[4], s[16]);
  k_add(s[3], s[19], s[11]);
  k_mul(s[1], s[4], s[19]);
  k_mul(s[20], s[16], s[11]);
  k_mul(s[21], s[18], s[3]);
  k_sub(s[18], s[1], s[20], 0);  // k=2
  k_add(s[3], s[1], s[20]);
  k_sub(s[20], s[21], s[3], 1);  // k=4
  k_add(s[21], s[17], s[2]);
  k_add(s[3], s[19], s[11]);
  k_mul(s[1], s[17], s[19]);
  k_mul(s[19], s[2], s[11]);
  k_mul(s[11], s[21], s[3]);
  k_sub(s[21], s[1], s[19], 0);  // k=2
  k_add(s[3], s[1], s[19]);
  k_sub(s[19], s[11], s[3], 1);  // k=4
  k_mul(s[11], s[5], s[0]);
  k_mul(s[3], s[6], s[0]);
  k_sub(s[1], s[11], s[3], 1);  // k=4
  k_add(s[22], s[11], s[3]);
  k_mul(s[23], s[1], s[22]);
  k_mul(s[22], s[11], s[3]);
  k_add(s[11], s[22], s[22]);
  k_sub(s[22], s[23], s[18], 1);  // k=4
  k_sub(s[23], s[11], s[20], 2);  // k=8
  k_add(s[11], s[21], s[21]);
  k_add(s[3], s[19], s[19]);
  k_sub(s[1], s[22], s[11], 2);  // k=8
  k_sub(s[22], s[23], s[3], 3);  // k=16
  k_mul(s[23], s[5], s[0]);
  k_mul(s[5], s[6], s[0]);
  k_sub(s[6], s[21], s[1], 3);  // k=16
  k_sub(s[21], s[19], s[22], 4);  // k=32
  k_mul(s[19], s[6], s[0]);
  k_mul(s[6], s[21], s[0]);
  k_add(s[21], s[23], s[5]);
  k_add(s[3], s[19], s[6]);
  k_mul(s[11], s[23], s[19]);
  k_mul(s[23], s[5], s[6]);
  k_mul(s[6], s[21], s[3]);
  k_sub(s[21], s[11], s[23], 0);  // k=2
  k_add(s[3], s[11], s[23]);
  k_sub(s[23], s[6], s[3], 1);  // k=4
  k_add(s[6], s[12], s[14]);
  k_add(s[3], s[18], s[20]);
  k_mul(s[11], s[12], s[18]);
  k_mul(s[18], s[14], s[20]);
  k_mul(s[20], s[6], s[3]);
  k_sub(s[6], s[11], s[18], 0);  // k=2
  k_add(s[3], s[11], s[18]);
  k_sub(s[18], s[20], s[3], 1);  // k=4
  k_add(s[20], s[6], s[6]);
  k_add(s[6], s[18], s[18]);
  k_sub(s[18], s[21], s[20], 2);  // k=8
  k_sub(s[21], s[23], s[6], 3);  // k=16
  k_add(s[23], s[13], s[13]);
  k_add(s[6], s[15], s[15]);
  k_add(s[20], s[23], s[6]);
  k_add(s[3], s[4], s[16]);
  k_mul(s[11], s[23], s[4]);
  k_mul(s[23], s[6], s[16]);
  k_mul(s[16], s[20], s[3]);
  k_sub(s[20], s[11], s[23], 0);  // k=2
  k_add(s[3], s[11], s[23]);
  k_sub(s[23], s[16], s[3], 1);  // k=4
  k_mul(s[16], s[1], s[0]);
  k_mul(s[1], s[22], s[0]);
  k_mul(s[22], s[18], s[0]);
  k_mul(s[18], s[21], s[0]);
  k_mul(s[21], s[20], s[0]);
  k_mul(s[20], s[23], s[0]);
  k_sel(s[23], f12 != 0, s[17], s[16]);
  k_sel(s[16], f12 != 0, s[2], s[1]);
  k_sel(s[1], f12 != 0, s[12], s[22]);
  k_sel(s[22], f12 != 0, s[14], s[18]);
  k_sel(s[18], f12 != 0, s[13], s[21]);
  k_sel(s[21], f12 != 0, s[15], s[20]);
  k_zero(s[20]);
  k_sel(s[3], f7 != 0, s[7], s[23]);
  k_sel(s[23], f7 != 0, s[8], s[16]);
  k_sel(s[16], f7 != 0, s[9], s[1]);
  k_sel(s[9], f7 != 0, s[10], s[22]);
  k_sel(s[22], f7 != 0, s[0], s[18]);
  k_sel(s[18], f7 != 0, s[20], s[21]);
  const uint32_t f219 = f7 & f12;
  k_sel(s[21], f13 != 0, s[3], s[17]);
  k_store(acc_out, 0, n, lane, s[21]);
  k_sel(s[21], f13 != 0, s[23], s[2]);
  k_store(acc_out, 1, n, lane, s[21]);
  k_sel(s[23], f13 != 0, s[16], s[12]);
  k_store(acc_out, 2, n, lane, s[23]);
  k_sel(s[23], f13 != 0, s[9], s[14]);
  k_store(acc_out, 3, n, lane, s[23]);
  k_sel(s[23], f13 != 0, s[22], s[13]);
  k_store(acc_out, 4, n, lane, s[23]);
  k_sel(s[23], f13 != 0, s[18], s[15]);
  k_store(acc_out, 5, n, lane, s[23]);
  const uint32_t f226 = f13 != 0 ? f219 : f7;
  inf_out[lane] = f226;
}

extern "C" int lh_wsm_step_g2(const void* acc, const void* inf_acc, const void* base, const void* inf_base, const void* bit, void* acc_out, void* inf_out, int n,
                              void* stream) {
  if (n > 0) {
    wsm_step_g2_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(acc), static_cast<const uint32_t*>(inf_acc), static_cast<const uint32_t*>(base), static_cast<const uint32_t*>(inf_base), static_cast<const uint32_t*>(bit),
        static_cast<uint32_t*>(acc_out), static_cast<uint32_t*>(inf_out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
