// Kernel 7: batched Montgomery product on the 31 x 13-bit plane, (26, n)
// quasi-15 limb planes in, strict 15-bit limbs out.
//
// Replaces lighthouse_tpu/crypto/bls/jax_backend/pallas_mxu.py:mont_core_mxu
// as called by pallas_fp.py:_mont_kernel_mxu (_mont_call(..., mxu=True)).
// One thread per lane, two warps per block; limb i of lane l sits at word
// i * n + l, so each load and store of a warp is one coalesced line.  The
// tail threads stay alive for the warp's DMMA (mxu.cuh): they recompute lane
// n - 1 and store nothing.
#include "mxu.cuh"

namespace {

constexpr int kBlock = 64;

__global__ void __launch_bounds__(kBlock)
mont_mul_mxu_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                    uint32_t* __restrict__ out, int n) {
  __shared__ lh::MxuShared<kBlock / 32> sm;
  const lh::MxuCtx mx = lh::mxu_setup(sm);
  const int gl = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
  uint32_t x[lh::NL], y[lh::NL], r[lh::NL];
#pragma unroll
  for (int i = 0; i < lh::NL; ++i) {
    x[i] = a[static_cast<size_t>(i) * n + lane];
    y[i] = b[static_cast<size_t>(i) * n + lane];
  }
  lh::mont_core_mxu(x, y, r, mx);
  if (live) {
#pragma unroll
    for (int i = 0; i < lh::NL; ++i) out[static_cast<size_t>(i) * n + lane] = r[i];
  }
}

}  // namespace

// a, b, out: (26, n) int32 (bit-identical to uint32 for these values),
// contiguous, on the current device.  Returns cudaGetLastError().
extern "C" int lh_mont_mul_mxu(const void* a, const void* b, void* out, int n, void* stream) {
  if (n > 0) {
    mont_mul_mxu_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
