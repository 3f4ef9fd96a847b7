// Kernel 1: batched Montgomery product on (26, n) limb planes.
//
// Replaces lighthouse_tpu/crypto/bls/jax_backend/pallas_fp.py:_mont_kernel.
// Limb i of lane l sits at word i * n + l, so the loads and stores of
// neighbouring lanes coalesce.  Two designs, one result:
//
// * mont_mul_group_kernel<G, L>: G threads per lane in blocks of L lanes
//   (group.cuh, mont_coop.cuh).  With one thread per lane the whole
//   1,703-multiply schoolbook, its carry passes and the 52-step carry are
//   one thread's stream of some 8,500 straight-line instructions, and at
//   the path's widths (2 to 4,096 lanes) about one warp runs on each SM
//   sub-partition that has work: the time per launch hardly depends on the
//   width.  The group cuts every schoolbook into tiles of the same shape,
//   one per rank, so each thread issues about 1/G of the products from a
//   short code path that all ranks share, and the card gets G times the
//   warps.  What bounds it then is the integer issue rate of the SMs (every
//   product is a multiply, a mask, a shift and an add, at 64 a clock per SM)
//   and the latency of its six phases.
// * mont_mul_kernel: one thread per lane, blocks of 128.  At widths that
//   fill the card it issues fewer instructions in all (no tile padding, no
//   exchanges, no barriers), so the launcher keeps it for those
//   (mont_kernel.form_for).
//
// The ragged edge is masked, not padded: the one-thread form returns early,
// the group form keeps its tail threads to the last barrier and stores
// nothing for them.
#include "mont_coop.cuh"

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

template <int G, int L>
__global__ void __launch_bounds__(G * L)
mont_mul_group_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      uint32_t* __restrict__ out, int n) {
  __shared__ uint32_t sm[lh::coop::kGroupShared<G, L>];
  const int gl = lh::group_lane<L>();
  const bool live = gl < n;
  lh::coop::mont_group<G, L>(a, b, out, n, live ? gl : n - 1, live, sm);
}

}  // namespace

// a, b, out: (26, n) int32 (bit-identical to uint32 for these values),
// contiguous, on the current device.  The form: group threads per lane in
// blocks of `lanes` lanes, one of (16, 8), (16, 16), (4, 32), or (1, 128)
// for the one-thread form.  Returns cudaGetLastError().
extern "C" int lh_mont_mul(const void* a, const void* b, void* out, int n, int group,
                           int lanes, void* stream) {
  const auto* x = static_cast<const uint32_t*>(a);
  const auto* y = static_cast<const uint32_t*>(b);
  auto* o = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (group == 16 && lanes == 8) {
      mont_mul_group_kernel<16, 8><<<(n + 7) / 8, 16 * 8, 0, s>>>(x, y, o, n);
    } else if (group == 16 && lanes == 16) {
      mont_mul_group_kernel<16, 16><<<(n + 15) / 16, 16 * 16, 0, s>>>(x, y, o, n);
    } else if (group == 4 && lanes == 32) {
      mont_mul_group_kernel<4, 32><<<(n + 31) / 32, 4 * 32, 0, s>>>(x, y, o, n);
    } else if (group == 1 && lanes == kBlock) {
      mont_mul_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, s>>>(x, y, o, n);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
