"""Compile the port's CUDA sources for the host, for the CPU tests.

A shim header turns the CUDA qualifiers into plain C++, the ``extern "C"``
launchers (which use <<<>>>) are cut, and a harness appended by the test
runs each kernel body once per lane.  The kernels' arithmetic can then be
held against the plain PyTorch versions lane by lane on a machine with no
card and no nvcc.

csrc/mxu.cuh's warp-cooperative part (the two products on the FP64 tensor
cores) is device-only; for host builds ``mxu_host.h`` below supplies the
same two products, y[k] = sum_i C[k - i] x[i], by a loop per lane, also in
a row-range form for the tile pairs of csrc/mxu_coop.cuh (and an empty
shared-memory setup; a group kernel's slots are a local array).  The
rest of the MXU kernels (to13, the a * b columns, the carry passes, to15,
the chains' control flow, the group form's phases) runs on the host as it
does on the card.
"""

import ctypes
import re
import shutil
import subprocess

import pytest

from lighthouse_tpu_torch.crypto.bls.torch_backend import _build

SHIM = r"""
#pragma once
#include <cstddef>
#include <cstdint>
#define __device__
#define __global__
#define __constant__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(x)
#define __restrict__
struct Dim { int x; };
extern thread_local Dim blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
#define __shared__
inline void __syncthreads() {}
inline void __syncwarp() {}
"""

# The host stand-in for csrc/mxu.cuh's DMMA part (included by mxu.cuh when
# it is not compiled by nvcc).
MXU_HOST = r"""
#pragma once
namespace lh {
struct MxuCtx {
  int unused;
};
template <int W, int ROWS = 64>
struct MxuShared {
  int unused;
};
template <int W, int ROWS>
inline MxuCtx mxu_setup(MxuShared<W, ROWS>&) {
  return MxuCtx{0};
}
template <int RT, int NY, int ROWS = 64>
inline void toeplitz_dot(int which, const uint32_t* x, uint32_t (&y)[NY], const MxuCtx&) {
  const uint32_t* c = which == kMxuPPrime ? kPPrime13 : kP13;
  for (int k = 0; k < NY; ++k) {
    uint32_t acc = 0;
    for (int i = 0; i < NLOW; ++i)
      if (k - i >= 0 && k - i < NL13) acc += c[k - i] * x[i];
    y[k] = acc;
  }
}
// The row-range form (csrc/mxu_coop.cuh's tile pairs): rows [row0, row0 + 8)
// below ny of y = Toeplitz(C) @ x for one lane, x its 32 rows (consecutive
// words on the host), as a DMMA row tile sums its eight k-tiles.
inline void toeplitz_rows(int which, const uint32_t* x, uint32_t* y, int row0, int ny) {
  const uint32_t* c = which == kMxuPPrime ? kPPrime13 : kP13;
  for (int k = row0; k < row0 + 8 && k < ny; ++k) {
    uint32_t acc = 0;
    for (int i = 0; i < 32; ++i)
      if (k - i >= 0 && k - i < NL13) acc += c[k - i] * x[i];
    y[k] = acc;
  }
}
}  // namespace lh
#define LH_MXU_GROUP_SHARED(W, ROWS, sm, type, name, words) \
  lh::MxuShared<W, ROWS> sm;                                \
  type name[words]
"""

# Harness prefix: EACH_LANE(call) runs a kernel body for lanes 0..n-1.
LANES = r"""
thread_local Dim blockIdx, threadIdx, blockDim;
#define EACH_LANE(call) \
  blockDim.x = 1; threadIdx.x = 0; \
  for (int l = 0; l < n; ++l) { blockIdx.x = l; call; }
"""


def build(tmp_dir, name: str, harness: str, source: str | None = None) -> ctypes.CDLL:
    """csrc/<name>.cu (or the CUDA text ``source``) plus ``harness`` (after
    LANES), built with g++ into ``tmp_dir`` and loaded.  Skips the test
    without a host compiler."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    (tmp_dir / "cuda_runtime.h").write_text(SHIM)
    (tmp_dir / "mxu_host.h").write_text(MXU_HOST)
    src = (_build.CSRC / f"{name}.cu").read_text() if source is None else source
    src = re.sub(r'extern "C" int lh_.*?\n}\n', "", src, flags=re.S)
    (tmp_dir / f"{name}.cpp").write_text(src + LANES + harness)
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", f"-I{tmp_dir}",
                    f"-I{_build.CSRC}", "-o", str(tmp_dir / f"{name}.so"),
                    str(tmp_dir / f"{name}.cpp")], check=True, capture_output=True)
    return ctypes.CDLL(str(tmp_dir / f"{name}.so"))


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
