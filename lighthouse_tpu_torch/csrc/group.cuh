// Groups of threads that work on one lane together (kernels 1, 2, 3 and 2m).
//
// Layout on the card: a block holds L lanes and G ranks, thread
// t = r * L + l (rank-major).  With L = 32 (kGroupLanes, the Miller steps)
// each warp is 32 lanes of ONE rank, so a rank's own code (a switch on r)
// runs without diverging, and may hold warp-cooperative instructions (the
// mma.sync of kernel 2m's products, csrc/mxu.cuh); with L = 8 or 16
// (kernel 1's small blocks) a warp holds 32 / L ranks, whose code must then
// be the same instructions at rank-dependent offsets.  Limb i of the block's lanes are neighbouring words of global
// memory, so loads and stores coalesce; per-lane state shared by the ranks
// sits in shared memory as [word][L lanes].
//
// A cooperative kernel is a sequence of phases, each a block over the rank
// r behind LH_RANKS(G, ...) or LH_RANKS_OF(G, L, ...).  On the card the
// block runs once per thread and ends with __syncthreads(), which orders
// the phases for the whole group.  Compiled for the host
// (tests/torch_host_cuda.py, where a kernel body runs once per lane) the
// macro is a loop over the ranks (upwards, or downwards when
// host_ranks_down is set), kLanes<L> is 1, and the phases run in order as
// they do on the card.  State that a later phase reads goes through the
// shared arrays, never a register kept across phases, so both readings
// compute the same bytes.
//
// The tail of the last block stays alive to the end (every thread reaches
// every barrier): its threads read lane n - 1 again and store nothing.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#ifdef __CUDACC__
#include <mutex>
#include <set>
#include <tuple>
#endif

namespace lh {

// Lanes per block L on the card; 1 on the host, where a kernel body runs
// once per lane.
#ifdef __CUDACC__
template <int L>
constexpr int kLanes = L;
#else
template <int L>
constexpr int kLanes = 1;
#endif
constexpr int kGroupLanes = kLanes<32>;  // the default: a warp of lanes per rank

// The lane slot of this thread in its block's shared arrays, its lane, and
// its rank in the lane's group (0 on the host, where the ranks are a loop
// inside LH_RANKS), for blocks of L lanes.
template <int L = 32>
__device__ __forceinline__ int group_slot() { return threadIdx.x % kLanes<L>; }
template <int L = 32>
__device__ __forceinline__ int group_lane() {
  return blockIdx.x * kLanes<L> + group_slot<L>();
}
template <int L = 32>
__device__ __forceinline__ int group_rank() { return threadIdx.x / kLanes<L>; }

#ifdef __CUDACC__
// Raise a kernel's dynamic shared-memory limit to `bytes` on the current
// device, the one its launch goes to.  The attribute belongs to each
// device's context, so it is set once per (kernel, device, bytes): a process
// whose seats sit on several cards sets it on each card, at its first launch
// there (a launch on a card where it was never set fails above 48 KB).
// Thread-safe; a table lookup under a mutex on every later launch.
inline cudaError_t set_shared_limit(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::set<std::tuple<const void*, int, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(kernel, dev, bytes);
  std::lock_guard<std::mutex> hold(mu);
  if (done.count(key)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.insert(key);
  return err;
}
template <class Kernel>
inline cudaError_t set_shared_limit(Kernel kernel, int bytes) {
  return set_shared_limit(reinterpret_cast<const void*>(kernel), bytes);
}
#endif

}  // namespace lh

// A block's shared array of `words` per lane: dynamic shared memory on the
// card (the launcher sets its size), a local array on the host.
#ifdef __CUDACC__
#define LH_GROUP_SHARED(type, name, words) extern __shared__ type name[]
#else
#define LH_GROUP_SHARED(type, name, words) type name[words]
#endif

#ifdef __CUDACC__
#define LH_RANKS_OF(G, L, ...)                     \
  {                                                \
    const int r = lh::group_rank<L>();             \
    __VA_ARGS__;                                   \
  }                                                \
  __syncthreads();
#else
// Shared-memory atomics on the host, where the ranks of a phase run one
// after another.
inline uint32_t atomicAdd(uint32_t* p, uint32_t v) {
  const uint32_t old = *p;
  *p = old + v;
  return old;
}

namespace lh {
// The order in which the host runs a phase's ranks: up, or down when a test
// sets this, so that a rank reading another rank's write of the same phase
// (a race on the card) gives different bytes in the two orders.
inline int host_ranks_down = 0;
}  // namespace lh
#define LH_RANKS_OF(G, L, ...)                                    \
  for (int q_ = 0; q_ < (G); ++q_) {                              \
    const int r = lh::host_ranks_down ? (G) - 1 - q_ : q_;        \
    __VA_ARGS__;                                                  \
  }
#endif
// A phase of a group in blocks of 32 lanes.
#define LH_RANKS(G, ...) LH_RANKS_OF(G, 32, __VA_ARGS__)
