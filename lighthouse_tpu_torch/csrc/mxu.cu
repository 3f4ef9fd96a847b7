// Kernel 7: batched Montgomery product on the 31 x 13-bit plane, (26, n)
// quasi-15 limb planes in, strict 15-bit limbs out.
//
// Replaces lighthouse_tpu/crypto/bls/jax_backend/pallas_mxu.py:mont_core_mxu
// as called by pallas_fp.py:_mont_kernel_mxu (_mont_call(..., mxu=True)).
// Limb i of lane l sits at word i * n + l, so a warp's loads and stores are
// coalesced lines.  Two designs, one result:
//
// * mont_mul_mxu_group_kernel<G>: G ranks per lane, one rank per warp, in
//   blocks of 32 lanes (group.cuh), on mxu_coop.cuh's mont_group_mxu_core,
//   the core of kernels 4m and 5m.  The core's first phase reads the
//   operands straight from global memory (each rank only the 15-bit limbs
//   that reach its block of to13 limbs), and beside it clears t's column
//   sums and fills the block's Toeplitz tables; its last phase stores the
//   strict limbs of live lanes.  At the path's widths the one-thread form
//   ran one thread's serial stream of some thousand multiply-adds and carry
//   passes per lane on about one warp per SM; the group deals each product's
//   tiles, DMMA tile pairs and carry blocks to G warps.
// * mont_mul_mxu_kernel: one thread per lane (mxu.cuh's mont_core_mxu),
//   blocks of 64, each warp staging its DMMA products in shared memory.  At
//   widths of several waves of the group form it issues fewer instructions
//   in all (no tile padding, no atomics, no barriers), so the launcher keeps
//   it for those (mxu_kernel.form_for).
//
// What bounds it on the card: the bytes are 312 per lane and the multiplies
// 961 IMADs and 1,365 DMMA multiply-adds per lane, a bound of some hundred
// nanoseconds at most of the path's widths; the group form takes the latency
// of the core's eight barrier phases with 8 warps a block, and the launch.
//
// The tail threads of the last block stay alive (every mma.sync is made by
// a whole warp): they run lane n - 1's operands again and store nothing.
#include "mxu_coop.cuh"

namespace {

namespace c13 = lh::coop13;

constexpr int kBlock = 64;  // the one-thread form
// Ranks per lane of the group form (mxu_kernel.MXU_FORM, blocks of 32
// lanes), the faster of G = 8 and G = 16 at every width (PERF.md)
constexpr int kMontMxuGroup = 8;
// A block's shared words in the group form: the Toeplitz tables, then the
// work rows
template <int G>
constexpr int kMontMxuShared = c13::kTabWords + c13::kWorkWords<G>;

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

template <int G>
__global__ void __launch_bounds__(G * 32)
mont_mul_mxu_group_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                          uint32_t* __restrict__ out, int n) {
  LH_COOP13_SHARED(sm, kMontMxuShared<G>);
  const int gl = lh::group_lane();
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
  const c13::Work w{sm + c13::kTabWords};
  double* const tab = reinterpret_cast<double*>(sm);
  c13::mont_group_mxu_core<G>(
      c13::PlaneIn{a, n, lane}, c13::PlaneIn{b, n, lane}, w, tab, lh::coop::Plane{out, n, lane},
      live, [&](int r) {
        c13::clear_sums<G>(r, w);
        c13::fill_tables<G>(r, tab);
      }, [](int) {});
}

}  // namespace

// a, b, out: (26, n) int32 (bit-identical to uint32 for these values),
// contiguous, on the current device.  The form: `group` ranks per lane in
// blocks of `lanes` lanes, (kMontMxuGroup, 32), or (1, 64) for the
// one-thread form.  Returns cudaGetLastError().
extern "C" int lh_mont_mul_mxu(const void* a, const void* b, void* out, int n, int group,
                               int lanes, void* stream) {
  constexpr int G = kMontMxuGroup;
  constexpr int kShared = kMontMxuShared<G> * 4;
  static_assert(kShared <= 232448, "one block's shared memory on sm_90");
  const auto* x = static_cast<const uint32_t*>(a);
  const auto* y = static_cast<const uint32_t*>(b);
  auto* o = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (group == G && lanes == 32) {
    const cudaError_t attr = lh::set_shared_limit(mont_mul_mxu_group_kernel<G>, kShared);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    if (n > 0) mont_mul_mxu_group_kernel<G><<<(n + 31) / 32, G * 32, kShared, s>>>(x, y, o, n);
  } else if (group == 1 && lanes == kBlock) {
    if (n > 0) mont_mul_mxu_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, s>>>(x, y, o, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
