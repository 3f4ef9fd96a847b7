// Kernel 1: batched Montgomery product on (26, n) limb planes.
//
// Replaces lighthouse_tpu/crypto/bls/jax_backend/pallas_fp.py:_mont_kernel.
// One thread per lane; limb i of lane l sits at word i * n + l, so each of
// the 26 loads and stores of a warp is one coalesced 128-byte line.  The
// ragged edge is masked instead of padded.
#include "mont.cuh"

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, int n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t x[lh::NL], y[lh::NL], r[lh::NL];
#pragma unroll
  for (int i = 0; i < lh::NL; ++i) {
    x[i] = a[static_cast<size_t>(i) * n + lane];
    y[i] = b[static_cast<size_t>(i) * n + lane];
  }
  lh::mont_core(x, y, r);
#pragma unroll
  for (int i = 0; i < lh::NL; ++i) out[static_cast<size_t>(i) * n + lane] = r[i];
}

}  // namespace

// a, b, out: (26, n) int32 (bit-identical to uint32 for these values),
// contiguous, on the current device.  Returns cudaGetLastError().
extern "C" int lh_mont_mul(const void* a, const void* b, void* out, int n,
                           void* stream) {
  if (n > 0) {
    mont_mul_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
