// Generated by lighthouse_tpu_torch/crypto/bls/torch_backend/codegen.py; do not edit.
// The MXU variants of kernels 2 and 3: the same fused Miller steps with
// every Montgomery product on the 31 x 13-bit plane (kernel 7's core,
// csrc/mxu.cuh), as pallas_miller.py builds _step_dbl_kernel and
// _step_add_kernel with mxu=True (_Ctx -> pallas_fp._core_pair).  Printed
// from the same step programs as miller_step.cu; the plain PyTorch version
// runs them over mxu_kernel.mont_mul_mxu_plain.
//
// One thread per lane, one warp per block.  Planes are (planes, 26, n)
// limb-major, so limb i of neighbouring lanes are neighbouring words and every
// load and store coalesces.  Intermediates live in the slot array s
// (registers spilling to local memory); every Montgomery product is one call
// of the non-inlined k_mul on the 13-bit plane (csrc/mxu.cuh), which the
// whole warp makes together: the programs are straight-line, and the tail
// threads run lane n - 1's operands again and store nothing.
#include "mxu.cuh"

namespace {

using lh::NL;

constexpr int kBlock = 32;  // 4,097 lanes -> 129 blocks, one per SM

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

}  // namespace

// miller_step_dbl_mxu: 565 limb ops, 169 Montgomery products on the 13-bit plane, 40 slots.
static __global__ void __launch_bounds__(kBlock)
miller_step_dbl_mxu_kernel(const uint32_t* __restrict__ f, const uint32_t* __restrict__ t, const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp, uint32_t* __restrict__ f_out, uint32_t* __restrict__ t_out, int n) {
  __shared__ lh::MxuShared<1> mxu_sm;
  const lh::MxuCtx mx = lh::mxu_setup(mxu_sm);
  const int gl = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
  uint32_t s[40][NL];
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
  k_load(s[19], xp, 0, n, lane);
  k_load(s[20], yp, 0, n, lane);
  k_sub(s[21], s[13], s[14], 1);  // k=4
  k_add(s[22], s[13], s[14]);
  k_mul(s[23], s[21], s[22], mx);
  k_mul(s[22], s[13], s[14], mx);
  k_add(s[21], s[22], s[22]);
  k_sub(s[22], s[15], s[16], 1);  // k=4
  k_add(s[24], s[15], s[16]);
  k_mul(s[25], s[22], s[24], mx);
  k_mul(s[24], s[15], s[16], mx);
  k_add(s[22], s[24], s[24]);
  k_sub(s[24], s[17], s[18], 1);  // k=4
  k_add(s[26], s[17], s[18]);
  k_mul(s[27], s[24], s[26], mx);
  k_mul(s[26], s[17], s[18], mx);
  k_add(s[24], s[26], s[26]);
  k_add(s[26], s[15], s[16]);
  k_add(s[28], s[17], s[18]);
  k_mul(s[29], s[15], s[17], mx);
  k_mul(s[30], s[16], s[18], mx);
  k_mul(s[31], s[26], s[28], mx);
  k_sub(s[28], s[29], s[30], 0);  // k=2
  k_add(s[26], s[29], s[30]);
  k_sub(s[30], s[31], s[26], 1);  // k=4
  k_add(s[31], s[23], s[23]);
  k_add(s[26], s[21], s[21]);
  k_add(s[29], s[31], s[23]);
  k_add(s[31], s[26], s[21]);
  k_add(s[26], s[13], s[25]);
  k_add(s[32], s[14], s[22]);
  k_add(s[33], s[23], s[21]);
  k_add(s[34], s[13], s[14]);
  k_mul(s[35], s[23], s[13], mx);
  k_mul(s[13], s[21], s[14], mx);
  k_mul(s[14], s[33], s[34], mx);
  k_sub(s[34], s[35], s[13], 0);  // k=2
  k_add(s[33], s[35], s[13]);
  k_sub(s[35], s[14], s[33], 1);  // k=4
  k_add(s[33], s[27], s[24]);
  k_add(s[14], s[17], s[18]);
  k_mul(s[13], s[27], s[17], mx);
  k_mul(s[17], s[24], s[18], mx);
  k_mul(s[18], s[33], s[14], mx);
  k_sub(s[33], s[13], s[17], 0);  // k=2
  k_add(s[14], s[13], s[17]);
  k_sub(s[17], s[18], s[14], 1);  // k=4
  k_add(s[18], s[23], s[21]);
  k_add(s[14], s[27], s[24]);
  k_mul(s[13], s[23], s[27], mx);
  k_mul(s[27], s[21], s[24], mx);
  k_mul(s[24], s[18], s[14], mx);
  k_sub(s[18], s[13], s[27], 0);  // k=2
  k_add(s[14], s[13], s[27]);
  k_sub(s[27], s[24], s[14], 1);  // k=4
  k_sub(s[24], s[25], s[22], 1);  // k=4
  k_add(s[14], s[25], s[22]);
  k_mul(s[13], s[24], s[14], mx);
  k_mul(s[24], s[25], s[22], mx);
  k_add(s[14], s[24], s[24]);
  k_sub(s[24], s[26], s[32], 2);  // k=8
  k_add(s[36], s[26], s[32]);
  k_mul(s[37], s[24], s[36], mx);
  k_mul(s[36], s[26], s[32], mx);
  k_add(s[32], s[36], s[36]);
  k_sub(s[36], s[29], s[31], 2);  // k=8
  k_add(s[26], s[29], s[31]);
  k_mul(s[24], s[36], s[26], mx);
  k_mul(s[36], s[29], s[31], mx);
  k_add(s[26], s[36], s[36]);
  k_add(s[36], s[34], s[34]);
  k_add(s[38], s[35], s[35]);
  k_add(s[39], s[36], s[34]);
  k_add(s[36], s[38], s[35]);
  k_add(s[38], s[25], s[25]);
  k_add(s[25], s[22], s[22]);
  k_sub(s[22], s[39], s[38], 1);  // k=4
  k_sub(s[39], s[36], s[25], 2);  // k=8
  k_sub(s[36], s[37], s[23], 0);  // k=2
  k_sub(s[37], s[32], s[21], 1);  // k=4
  k_sub(s[32], s[36], s[13], 0);  // k=2
  k_sub(s[36], s[37], s[14], 1);  // k=4
  k_add(s[37], s[32], s[32]);
  k_add(s[32], s[36], s[36]);
  k_add(s[36], s[37], s[37]);
  k_add(s[21], s[32], s[32]);
  k_sub(s[23], s[24], s[36], 4);  // k=32
  k_sub(s[36], s[26], s[21], 5);  // k=64
  k_add(s[26], s[15], s[16]);
  k_add(s[21], s[33], s[17]);
  k_mul(s[24], s[15], s[33], mx);
  k_mul(s[33], s[16], s[17], mx);
  k_mul(s[17], s[26], s[21], mx);
  k_sub(s[26], s[24], s[33], 0);  // k=2
  k_add(s[21], s[24], s[33]);
  k_sub(s[33], s[17], s[21], 1);  // k=4
  k_add(s[21], s[26], s[26]);
  k_add(s[26], s[33], s[33]);
  k_add(s[33], s[18], s[18]);
  k_add(s[17], s[27], s[27]);
  k_add(s[24], s[33], s[18]);
  k_add(s[33], s[17], s[27]);
  k_neg(s[27], s[24], 3);  // k=16
  k_neg(s[24], s[33], 3);  // k=16
  k_mul(s[33], s[27], s[19], mx);
  k_mul(s[27], s[24], s[19], mx);
  k_mul(s[24], s[21], s[20], mx);
  k_mul(s[21], s[26], s[20], mx);
  k_sub(s[26], s[37], s[23], 5);  // k=64
  k_sub(s[37], s[32], s[36], 6);  // k=128
  k_mul(s[32], s[26], s[0], mx);
  k_mul(s[26], s[37], s[0], mx);
  k_add(s[37], s[29], s[31]);
  k_add(s[20], s[32], s[26]);
  k_mul(s[19], s[29], s[32], mx);
  k_mul(s[32], s[31], s[26], mx);
  k_mul(s[31], s[37], s[20], mx);
  k_sub(s[37], s[19], s[32], 0);  // k=2
  k_add(s[20], s[19], s[32]);
  k_sub(s[32], s[31], s[20], 1);  // k=4
  k_add(s[31], s[13], s[13]);
  k_add(s[13], s[14], s[14]);
  k_add(s[14], s[31], s[31]);
  k_add(s[31], s[13], s[13]);
  k_add(s[13], s[14], s[14]);
  k_add(s[14], s[31], s[31]);
  k_sub(s[31], s[37], s[13], 3);  // k=16
  k_sub(s[37], s[32], s[14], 4);  // k=32
  k_add(s[32], s[28], s[28]);
  k_add(s[28], s[30], s[30]);
  k_mul(s[30], s[22], s[0], mx);
  k_mul(s[22], s[39], s[0], mx);
  k_mul(s[39], s[33], s[0], mx);
  k_mul(s[33], s[27], s[0], mx);
  k_mul(s[27], s[24], s[0], mx);
  k_mul(s[24], s[21], s[0], mx);
  k_mul(s[21], s[23], s[0], mx);
  if (live) k_store(t_out, 0, n, lane, s[21]);
  k_mul(s[23], s[36], s[0], mx);
  if (live) k_store(t_out, 1, n, lane, s[23]);
  k_mul(s[36], s[31], s[0], mx);
  if (live) k_store(t_out, 2, n, lane, s[36]);
  k_mul(s[36], s[37], s[0], mx);
  if (live) k_store(t_out, 3, n, lane, s[36]);
  k_mul(s[37], s[32], s[0], mx);
  if (live) k_store(t_out, 4, n, lane, s[37]);
  k_mul(s[37], s[28], s[0], mx);
  if (live) k_store(t_out, 5, n, lane, s[37]);
  k_add(s[37], s[1], s[2]);
  k_add(s[28], s[7], s[8]);
  k_mul(s[32], s[1], s[7], mx);
  k_mul(s[36], s[2], s[8], mx);
  k_mul(s[31], s[37], s[28], mx);
  k_sub(s[37], s[32], s[36], 0);  // k=2
  k_add(s[28], s[32], s[36]);
  k_sub(s[36], s[31], s[28], 1);  // k=4
  k_add(s[31], s[3], s[4]);
  k_add(s[28], s[9], s[10]);
  k_mul(s[32], s[3], s[9], mx);
  k_mul(s[23], s[4], s[10], mx);
  k_mul(s[21], s[31], s[28], mx);
  k_sub(s[31], s[32], s[23], 0);  // k=2
  k_add(s[28], s[32], s[23]);
  k_sub(s[32], s[21], s[28], 1);  // k=4
  k_add(s[28], s[5], s[6]);
  k_add(s[21], s[11], s[12]);
  k_mul(s[23], s[5], s[11], mx);
  k_mul(s[14], s[6], s[12], mx);
  k_mul(s[13], s[28], s[21], mx);
  k_sub(s[28], s[23], s[14], 0);  // k=2
  k_add(s[21], s[23], s[14]);
  k_sub(s[23], s[13], s[21], 1);  // k=4
  k_add(s[21], s[3], s[5]);
  k_add(s[13], s[4], s[6]);
  k_add(s[14], s[9], s[11]);
  k_add(s[20], s[10], s[12]);
  k_add(s[19], s[21], s[13]);
  k_add(s[26], s[14], s[20]);
  k_mul(s[29], s[21], s[14], mx);
  k_mul(s[21], s[13], s[20], mx);
  k_mul(s[20], s[19], s[26], mx);
  k_sub(s[26], s[29], s[21], 0);  // k=2
  k_add(s[19], s[29], s[21]);
  k_sub(s[29], s[20], s[19], 1);  // k=4
  k_add(s[20], s[1], s[3]);
  k_add(s[19], s[2], s[4]);
  k_add(s[21], s[7], s[9]);
  k_add(s[13], s[8], s[10]);
  k_add(s[14], s[20], s[19]);
  k_add(s[17], s[21], s[13]);
  k_mul(s[18], s[20], s[21], mx);
  k_mul(s[21], s[19], s[13], mx);
  k_mul(s[19], s[14], s[17], mx);
  k_sub(s[17], s[18], s[21], 0);  // k=2
  k_add(s[14], s[18], s[21]);
  k_sub(s[21], s[19], s[14], 1);  // k=4
  k_add(s[19], s[1], s[5]);
  k_add(s[14], s[2], s[6]);
  k_add(s[18], s[7], s[11]);
  k_add(s[13], s[8], s[12]);
  k_add(s[20], s[19], s[14]);
  k_add(s[16], s[18], s[13]);
  k_mul(s[15], s[19], s[18], mx);
  k_mul(s[19], s[14], s[13], mx);
  k_mul(s[14], s[20], s[16], mx);
  k_sub(s[20], s[15], s[19], 0);  // k=2
  k_add(s[16], s[15], s[19]);
  k_sub(s[19], s[14], s[16], 1);  // k=4
  k_sub(s[16], s[26], s[31], 1);  // k=4
  k_sub(s[26], s[29], s[32], 2);  // k=8
  k_sub(s[29], s[16], s[28], 1);  // k=4
  k_sub(s[16], s[26], s[23], 2);  // k=8
  k_sub(s[26], s[17], s[37], 1);  // k=4
  k_sub(s[17], s[21], s[36], 2);  // k=8
  k_sub(s[21], s[26], s[31], 1);  // k=4
  k_sub(s[26], s[17], s[32], 2);  // k=8
  k_sub(s[17], s[20], s[37], 1);  // k=4
  k_sub(s[20], s[19], s[36], 2);  // k=8
  k_sub(s[19], s[17], s[28], 1);  // k=4
  k_sub(s[17], s[20], s[23], 2);  // k=8
  k_sub(s[20], s[29], s[16], 4);  // k=32
  k_add(s[14], s[29], s[16]);
  k_add(s[29], s[20], s[37]);
  k_add(s[37], s[14], s[36]);
  k_sub(s[36], s[28], s[23], 2);  // k=8
  k_add(s[14], s[28], s[23]);
  k_add(s[28], s[21], s[36]);
  k_add(s[36], s[26], s[14]);
  k_add(s[26], s[19], s[31]);
  k_add(s[31], s[17], s[32]);
  k_mul(s[32], s[29], s[0], mx);
  k_mul(s[29], s[37], s[0], mx);
  k_mul(s[37], s[28], s[0], mx);
  k_mul(s[28], s[36], s[0], mx);
  k_mul(s[36], s[26], s[0], mx);
  k_mul(s[26], s[31], s[0], mx);
  k_add(s[31], s[1], s[7]);
  k_add(s[17], s[2], s[8]);
  k_add(s[19], s[3], s[9]);
  k_add(s[14], s[4], s[10]);
  k_add(s[21], s[5], s[11]);
  k_add(s[23], s[6], s[12]);
  k_sub(s[20], s[11], s[12], 1);  // k=4
  k_add(s[16], s[11], s[12]);
  k_add(s[12], s[1], s[20]);
  k_add(s[20], s[2], s[16]);
  k_add(s[16], s[3], s[7]);
  k_add(s[7], s[4], s[8]);
  k_add(s[8], s[5], s[9]);
  k_add(s[9], s[6], s[10]);
  k_add(s[10], s[31], s[17]);
  k_add(s[6], s[12], s[20]);
  k_mul(s[5], s[31], s[12], mx);
  k_mul(s[4], s[17], s[20], mx);
  k_mul(s[3], s[10], s[6], mx);
  k_sub(s[10], s[5], s[4], 0);  // k=2
  k_add(s[6], s[5], s[4]);
  k_sub(s[5], s[3], s[6], 1);  // k=4
  k_add(s[6], s[19], s[14]);
  k_add(s[3], s[16], s[7]);
  k_mul(s[4], s[19], s[16], mx);
  k_mul(s[2], s[14], s[7], mx);
  k_mul(s[1], s[6], s[3], mx);
  k_sub(s[6], s[4], s[2], 0);  // k=2
  k_add(s[3], s[4], s[2]);
  k_sub(s[4], s[1], s[3], 1);  // k=4
  k_add(s[3], s[21], s[23]);
  k_add(s[1], s[8], s[9]);
  k_mul(s[2], s[21], s[8], mx);
  k_mul(s[11], s[23], s[9], mx);
  k_mul(s[15], s[3], s[1], mx);
  k_sub(s[3], s[2], s[11], 0);  // k=2
  k_add(s[1], s[2], s[11]);
  k_sub(s[11], s[15], s[1], 1);  // k=4
  k_add(s[15], s[19], s[21]);
  k_add(s[1], s[14], s[23]);
  k_add(s[2], s[16], s[8]);
  k_add(s[13], s[7], s[9]);
  k_add(s[18], s[15], s[1]);
  k_add(s[25], s[2], s[13]);
  k_mul(s[38], s[15], s[2], mx);
  k_mul(s[15], s[1], s[13], mx);
  k_mul(s[13], s[18], s[25], mx);
  k_sub(s[25], s[38], s[15], 0);  // k=2
  k_add(s[18], s[38], s[15]);
  k_sub(s[38], s[13], s[18], 1);  // k=4
  k_add(s[18], s[31], s[19]);
  k_add(s[19], s[17], s[14]);
  k_add(s[14], s[12], s[16]);
  k_add(s[16], s[20], s[7]);
  k_mul(s[7], s[14], s[0], mx);
  k_mul(s[14], s[16], s[0], mx);
  k_add(s[16], s[18], s[19]);
  k_add(s[13], s[7], s[14]);
  k_mul(s[15], s[18], s[7], mx);
  k_mul(s[18], s[19], s[14], mx);
  k_mul(s[19], s[16], s[13], mx);
  k_sub(s[16], s[15], s[18], 0);  // k=2
  k_add(s[13], s[15], s[18]);
  k_sub(s[18], s[19], s[13], 1);  // k=4
  k_add(s[19], s[31], s[21]);
  k_add(s[31], s[17], s[23]);
  k_add(s[23], s[12], s[8]);
  k_add(s[12], s[20], s[9]);
  k_mul(s[20], s[23], s[0], mx);
  k_mul(s[23], s[12], s[0], mx);
  k_add(s[12], s[19], s[31]);
  k_add(s[9], s[20], s[23]);
  k_mul(s[8], s[19], s[20], mx);
  k_mul(s[20], s[31], s[23], mx);
  k_mul(s[31], s[12], s[9], mx);
  k_sub(s[12], s[8], s[20], 0);  // k=2
  k_add(s[9], s[8], s[20]);
  k_sub(s[20], s[31], s[9], 1);  // k=4
  k_sub(s[31], s[25], s[6], 1);  // k=4
  k_sub(s[25], s[38], s[4], 2);  // k=8
  k_sub(s[38], s[31], s[3], 1);  // k=4
  k_sub(s[31], s[25], s[11], 2);  // k=8
  k_sub(s[25], s[16], s[10], 1);  // k=4
  k_sub(s[16], s[18], s[5], 2);  // k=8
  k_sub(s[18], s[25], s[6], 1);  // k=4
  k_sub(s[25], s[16], s[4], 2);  // k=8
  k_sub(s[16], s[12], s[10], 1);  // k=4
  k_sub(s[12], s[20], s[5], 2);  // k=8
  k_sub(s[20], s[16], s[3], 1);  // k=4
  k_sub(s[16], s[12], s[11], 2);  // k=8
  k_sub(s[12], s[38], s[31], 4);  // k=32
  k_add(s[9], s[38], s[31]);
  k_add(s[38], s[12], s[10]);
  k_add(s[12], s[9], s[5]);
  k_sub(s[9], s[3], s[11], 2);  // k=8
  k_add(s[5], s[3], s[11]);
  k_add(s[11], s[18], s[9]);
  k_add(s[18], s[25], s[5]);
  k_add(s[25], s[20], s[6]);
  k_add(s[20], s[16], s[4]);
  k_mul(s[16], s[38], s[0], mx);
  k_mul(s[38], s[12], s[0], mx);
  k_mul(s[12], s[11], s[0], mx);
  k_mul(s[11], s[18], s[0], mx);
  k_mul(s[18], s[25], s[0], mx);
  k_mul(s[25], s[20], s[0], mx);
  k_sub(s[20], s[16], s[32], 1);  // k=4
  k_sub(s[16], s[38], s[29], 1);  // k=4
  k_sub(s[38], s[12], s[37], 1);  // k=4
  k_sub(s[12], s[11], s[28], 1);  // k=4
  k_sub(s[11], s[18], s[36], 1);  // k=4
  k_sub(s[18], s[25], s[26], 1);  // k=4
  k_sub(s[25], s[36], s[26], 1);  // k=4
  k_add(s[4], s[36], s[26]);
  k_sub(s[6], s[20], s[25], 2);  // k=8
  k_sub(s[25], s[16], s[4], 2);  // k=8
  k_sub(s[16], s[38], s[32], 1);  // k=4
  k_sub(s[38], s[12], s[29], 1);  // k=4
  k_sub(s[12], s[11], s[37], 1);  // k=4
  k_sub(s[11], s[18], s[28], 1);  // k=4
  k_add(s[18], s[32], s[32]);
  k_add(s[32], s[29], s[29]);
  k_add(s[29], s[37], s[37]);
  k_add(s[37], s[28], s[28]);
  k_add(s[28], s[36], s[36]);
  k_add(s[36], s[26], s[26]);
  k_mul(s[26], s[6], s[0], mx);
  k_mul(s[6], s[25], s[0], mx);
  k_mul(s[25], s[16], s[0], mx);
  k_mul(s[16], s[38], s[0], mx);
  k_mul(s[38], s[12], s[0], mx);
  k_mul(s[12], s[11], s[0], mx);
  k_mul(s[11], s[18], s[0], mx);
  k_mul(s[18], s[32], s[0], mx);
  k_mul(s[32], s[29], s[0], mx);
  k_mul(s[29], s[37], s[0], mx);
  k_mul(s[37], s[28], s[0], mx);
  k_mul(s[28], s[36], s[0], mx);
  k_add(s[36], s[26], s[11]);
  k_add(s[4], s[6], s[18]);
  k_add(s[20], s[25], s[32]);
  k_add(s[5], s[16], s[29]);
  k_add(s[9], s[38], s[37]);
  k_add(s[3], s[12], s[28]);
  k_add(s[10], s[39], s[27]);
  k_add(s[31], s[33], s[24]);
  k_add(s[8], s[26], s[6]);
  k_add(s[23], s[30], s[22]);
  k_mul(s[19], s[26], s[30], mx);
  k_mul(s[17], s[6], s[22], mx);
  k_mul(s[21], s[8], s[23], mx);
  k_sub(s[23], s[19], s[17], 0);  // k=2
  k_add(s[8], s[19], s[17]);
  k_sub(s[19], s[21], s[8], 1);  // k=4
  k_add(s[21], s[38], s[12]);
  k_add(s[8], s[39], s[33]);
  k_mul(s[17], s[38], s[39], mx);
  k_mul(s[13], s[12], s[33], mx);
  k_mul(s[15], s[21], s[8], mx);
  k_sub(s[21], s[17], s[13], 0);  // k=2
  k_add(s[8], s[17], s[13]);
  k_sub(s[17], s[15], s[8], 1);  // k=4
  k_add(s[15], s[26], s[6]);
  k_add(s[8], s[39], s[33]);
  k_mul(s[13], s[26], s[39], mx);
  k_mul(s[26], s[6], s[33], mx);
  k_mul(s[6], s[15], s[8], mx);
  k_sub(s[15], s[13], s[26], 0);  // k=2
  k_add(s[8], s[13], s[26]);
  k_sub(s[26], s[6], s[8], 1);  // k=4
  k_add(s[8], s[25], s[16]);
  k_add(s[6], s[30], s[22]);
  k_mul(s[13], s[25], s[30], mx);
  k_mul(s[14], s[16], s[22], mx);
  k_mul(s[7], s[8], s[6], mx);
  k_sub(s[8], s[13], s[14], 0);  // k=2
  k_add(s[6], s[13], s[14]);
  k_sub(s[14], s[7], s[6], 1);  // k=4
  k_add(s[7], s[25], s[16]);
  k_add(s[6], s[39], s[33]);
  k_mul(s[13], s[25], s[39], mx);
  k_mul(s[39], s[16], s[33], mx);
  k_mul(s[33], s[7], s[6], mx);
  k_sub(s[7], s[13], s[39], 0);  // k=2
  k_add(s[6], s[13], s[39]);
  k_sub(s[39], s[33], s[6], 1);  // k=4
  k_add(s[33], s[38], s[12]);
  k_add(s[6], s[30], s[22]);
  k_mul(s[13], s[38], s[30], mx);
  k_mul(s[38], s[12], s[22], mx);
  k_mul(s[12], s[33], s[6], mx);
  k_sub(s[33], s[13], s[38], 0);  // k=2
  k_add(s[6], s[13], s[38]);
  k_sub(s[38], s[12], s[6], 1);  // k=4
  k_add(s[12], s[37], s[28]);
  k_add(s[6], s[27], s[24]);
  k_mul(s[13], s[37], s[27], mx);
  k_mul(s[37], s[28], s[24], mx);
  k_mul(s[28], s[12], s[6], mx);
  k_sub(s[12], s[13], s[37], 0);  // k=2
  k_add(s[6], s[13], s[37]);
  k_sub(s[37], s[28], s[6], 1);  // k=4
  k_add(s[28], s[11], s[18]);
  k_add(s[6], s[27], s[24]);
  k_mul(s[13], s[11], s[27], mx);
  k_mul(s[11], s[18], s[24], mx);
  k_mul(s[18], s[28], s[6], mx);
  k_sub(s[28], s[13], s[11], 0);  // k=2
  k_add(s[6], s[13], s[11]);
  k_sub(s[13], s[18], s[6], 1);  // k=4
  k_add(s[18], s[32], s[29]);
  k_add(s[6], s[27], s[24]);
  k_mul(s[11], s[32], s[27], mx);
  k_mul(s[32], s[29], s[24], mx);
  k_mul(s[29], s[18], s[6], mx);
  k_sub(s[18], s[11], s[32], 0);  // k=2
  k_add(s[6], s[11], s[32]);
  k_sub(s[32], s[29], s[6], 1);  // k=4
  k_add(s[29], s[36], s[4]);
  k_add(s[6], s[30], s[22]);
  k_mul(s[11], s[36], s[30], mx);
  k_mul(s[24], s[4], s[22], mx);
  k_mul(s[27], s[29], s[6], mx);
  k_sub(s[29], s[11], s[24], 0);  // k=2
  k_add(s[6], s[11], s[24]);
  k_sub(s[24], s[27], s[6], 1);  // k=4
  k_add(s[27], s[9], s[3]);
  k_add(s[6], s[10], s[31]);
  k_mul(s[11], s[9], s[10], mx);
  k_mul(s[16], s[3], s[31], mx);
  k_mul(s[25], s[27], s[6], mx);
  k_sub(s[27], s[11], s[16], 0);  // k=2
  k_add(s[6], s[11], s[16]);
  k_sub(s[16], s[25], s[6], 1);  // k=4
  k_add(s[25], s[36], s[4]);
  k_add(s[6], s[10], s[31]);
  k_mul(s[11], s[36], s[10], mx);
  k_mul(s[36], s[4], s[31], mx);
  k_mul(s[4], s[25], s[6], mx);
  k_sub(s[25], s[11], s[36], 0);  // k=2
  k_add(s[6], s[11], s[36]);
  k_sub(s[36], s[4], s[6], 1);  // k=4
  k_add(s[6], s[20], s[5]);
  k_add(s[4], s[30], s[22]);
  k_mul(s[11], s[20], s[30], mx);
  k_mul(s[1], s[5], s[22], mx);
  k_mul(s[2], s[6], s[4], mx);
  k_sub(s[6], s[11], s[1], 0);  // k=2
  k_add(s[4], s[11], s[1]);
  k_sub(s[11], s[2], s[4], 1);  // k=4
  k_add(s[4], s[20], s[5]);
  k_add(s[2], s[10], s[31]);
  k_mul(s[1], s[20], s[10], mx);
  k_mul(s[20], s[5], s[31], mx);
  k_mul(s[31], s[4], s[2], mx);
  k_sub(s[4], s[1], s[20], 0);  // k=2
  k_add(s[2], s[1], s[20]);
  k_sub(s[20], s[31], s[2], 1);  // k=4
  k_add(s[31], s[9], s[3]);
  k_add(s[2], s[30], s[22]);
  k_mul(s[1], s[9], s[30], mx);
  k_mul(s[30], s[3], s[22], mx);
  k_mul(s[22], s[31], s[2], mx);
  k_sub(s[31], s[1], s[30], 0);  // k=2
  k_add(s[2], s[1], s[30]);
  k_sub(s[30], s[22], s[2], 1);  // k=4
  k_sub(s[22], s[21], s[17], 2);  // k=8
  k_add(s[2], s[21], s[17]);
  k_add(s[21], s[23], s[22]);
  k_add(s[23], s[19], s[2]);
  k_add(s[19], s[15], s[8]);
  k_add(s[15], s[26], s[14]);
  k_add(s[26], s[7], s[33]);
  k_add(s[33], s[39], s[38]);
  k_sub(s[39], s[12], s[37], 2);  // k=8
  k_add(s[38], s[12], s[37]);
  k_sub(s[37], s[27], s[16], 2);  // k=8
  k_add(s[12], s[27], s[16]);
  k_add(s[27], s[29], s[37]);
  k_add(s[37], s[24], s[12]);
  k_add(s[24], s[25], s[6]);
  k_add(s[25], s[36], s[11]);
  k_add(s[36], s[4], s[31]);
  k_add(s[31], s[20], s[30]);
  k_sub(s[30], s[18], s[32], 2);  // k=8
  k_add(s[20], s[18], s[32]);
  k_add(s[4], s[21], s[30]);
  k_add(s[30], s[23], s[20]);
  k_add(s[20], s[19], s[39]);
  k_add(s[11], s[15], s[38]);
  k_add(s[6], s[26], s[28]);
  k_add(s[12], s[33], s[13]);
  k_sub(s[29], s[27], s[21], 3);  // k=16
  k_sub(s[27], s[37], s[23], 3);  // k=16
  k_sub(s[37], s[24], s[19], 2);  // k=8
  k_sub(s[24], s[25], s[15], 3);  // k=16
  k_sub(s[25], s[36], s[26], 2);  // k=8
  k_sub(s[36], s[31], s[33], 3);  // k=16
  k_sub(s[33], s[29], s[39], 3);  // k=16
  k_sub(s[39], s[27], s[38], 3);  // k=16
  k_sub(s[38], s[37], s[28], 1);  // k=4
  k_sub(s[37], s[24], s[13], 2);  // k=8
  k_sub(s[24], s[25], s[18], 1);  // k=4
  k_sub(s[25], s[36], s[32], 2);  // k=8
  k_mul(s[36], s[4], s[0], mx);
  if (live) k_store(f_out, 0, n, lane, s[36]);
  k_mul(s[36], s[30], s[0], mx);
  if (live) k_store(f_out, 1, n, lane, s[36]);
  k_mul(s[36], s[20], s[0], mx);
  if (live) k_store(f_out, 2, n, lane, s[36]);
  k_mul(s[36], s[11], s[0], mx);
  if (live) k_store(f_out, 3, n, lane, s[36]);
  k_mul(s[36], s[6], s[0], mx);
  if (live) k_store(f_out, 4, n, lane, s[36]);
  k_mul(s[36], s[12], s[0], mx);
  if (live) k_store(f_out, 5, n, lane, s[36]);
  k_mul(s[36], s[33], s[0], mx);
  if (live) k_store(f_out, 6, n, lane, s[36]);
  k_mul(s[36], s[39], s[0], mx);
  if (live) k_store(f_out, 7, n, lane, s[36]);
  k_mul(s[39], s[38], s[0], mx);
  if (live) k_store(f_out, 8, n, lane, s[39]);
  k_mul(s[39], s[37], s[0], mx);
  if (live) k_store(f_out, 9, n, lane, s[39]);
  k_mul(s[39], s[24], s[0], mx);
  if (live) k_store(f_out, 10, n, lane, s[39]);
  k_mul(s[39], s[25], s[0], mx);
  if (live) k_store(f_out, 11, n, lane, s[39]);
}

extern "C" int lh_miller_step_dbl_mxu(const void* f, const void* t, const void* xp, const void* yp, void* f_out, void* t_out, int n,
                              void* stream) {
  if (n > 0) {
    miller_step_dbl_mxu_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
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
