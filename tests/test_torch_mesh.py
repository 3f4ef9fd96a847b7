"""The port's mesh (lighthouse_tpu_torch/parallel/mesh.py) against the JAX
package's on its 8-device CPU mesh (tests/conftest.py).

The port's mesh is a tuple of seats in one process: ``make_mesh(8,
device="cpu")`` is the counterpart of the reference's 8 virtual CPU
devices.  Each collective runs over both meshes on the same small int
tensors: the reference inside ``shard_map``, the port over the list of its
seats' partials.  The Fp12 ring runs at width 4 (the reference's program
over 8 devices takes 15 s to compile on one core; over 4, 7 s).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from jax.sharding import PartitionSpec as JPS

from lighthouse_tpu.crypto.bls import fields as O
from lighthouse_tpu.crypto.bls import params
from lighthouse_tpu.crypto.bls.jax_backend import tower as JT
from lighthouse_tpu.parallel import mesh as JM
from lighthouse_tpu_torch.crypto.bls import fields as PF
from lighthouse_tpu_torch.crypto.bls.torch_backend import tower as T
from lighthouse_tpu_torch.parallel import mesh as M

W = 8


@pytest.fixture(scope="module")
def ref_mesh():
    return JM.make_mesh(W)


@pytest.fixture(scope="module")
def mesh():
    return M.make_mesh(W, device="cpu")


def _ref(fn, mesh, x, out_specs=JPS()):
    return jax.jit(JM.compat_shard_map(fn, mesh, in_specs=(JPS(None, JM.BATCH_AXIS),),
                                       out_specs=out_specs))(x)


def _pieces(x: np.ndarray, width: int) -> list:
    return list(torch.from_numpy(x).chunk(width, dim=-1))


def test_mesh_is_a_hashable_record_of_seats(mesh):
    assert mesh.width == W and mesh.shape == {"batch": W} and mesh.axis == M.BATCH_AXIS
    assert all(s == torch.device("cpu") for s in mesh.seats)
    assert mesh == M.make_mesh(W, device="cpu") and hash(mesh) == hash(M.make_mesh(W, device="cpu"))
    assert {mesh: 1}[M.Mesh(("cpu",) * W)] == 1
    assert M.make_mesh(device="cpu").width == 1
    with pytest.raises(ValueError):
        M.Mesh(())


def test_make_mesh_raises_without_enough_cuda_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices, have 0"):
        M.make_mesh(2)
    with pytest.raises(RuntimeError, match="need 1 CUDA devices"):
        M.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert M.make_mesh().seats == tuple(torch.device("cuda", i) for i in range(4))
    assert M.make_mesh(2).seats == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(RuntimeError, match="need 8 CUDA devices, have 4"):
        M.make_mesh(8)
    # the reference raises the same way past its visible devices
    with pytest.raises(RuntimeError):
        JM.make_mesh(len(jax.devices()) + 1)


def test_batch_spec_matches_the_reference():
    for ndim, pos in ((0, -1), (1, -1), (2, -1), (2, 0), (3, 1)):
        assert tuple(M.batch_spec(ndim, pos)) == tuple(JM.batch_spec(ndim, pos))


def test_allgather_tree_matches_the_reference(ref_mesh, mesh):
    x = np.arange(3 * 16, dtype=np.int32).reshape(3, 16)
    want = np.asarray(_ref(lambda a: JM.allgather_tree(a), ref_mesh, jnp.asarray(x)))
    got = M.allgather_tree(_pieces(x, W))
    assert got.shape == (3, 16) and np.array_equal(got.numpy(), want)
    # a tree with LFp-shaped leaves: limbs gathered, the largest bound kept
    from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F

    parts = [(F.LFp(p, 1.0 + i), p[0]) for i, p in enumerate(_pieces(x, W))]
    tree = M.allgather_tree(parts)
    assert tree[0].bound == float(W) and np.array_equal(tree[0].limbs.numpy(), want)
    assert np.array_equal(tree[1].numpy(), want[0])


@pytest.mark.parametrize("bad", [None, 13])
def test_and_reduce_matches_the_reference(ref_mesh, mesh, bad):
    x = np.ones((1, 16), dtype=np.int32)
    if bad is not None:
        x[0, bad] = 0
    want = bool(_ref(lambda a: JM.and_reduce(jnp.all(a != 0)), ref_mesh, jnp.asarray(x)))
    got = M.and_reduce([torch.all(p != 0) for p in _pieces(x, W)])
    assert got.shape == (1,) and bool(got) is want is (bad is None)


def test_ring_reduce_additive_matches_the_reference(ref_mesh, mesh):
    x = np.arange(2 * W, dtype=np.int32).reshape(2, W) ** 2
    want = np.asarray(_ref(lambda a: JM.ring_reduce(a, jnp.add), ref_mesh, jnp.asarray(x),
                           out_specs=JPS(None, JM.BATCH_AXIS)))
    got = M.ring_reduce(_pieces(x, W), torch.add)
    assert len(got) == W
    assert np.array_equal(torch.cat(got, dim=-1).numpy(), want)
    assert all(np.array_equal(g.numpy()[:, 0], x.sum(axis=1)) for g in got)


def _key12(v):
    return tuple((c.c0, c.c1) for c6 in (v.c0, v.c1) for c in (c6.c0, c6.c1, c6.c2))


def test_ring_reduce_fp12_matches_the_reference():
    """The fp12 ring of make_pair_sharded_aggregate_verify: each seat's
    accumulator is the product of every seat's value, as on the reference's
    mesh, and the same as the oracle's product."""
    width = 4
    rng = random.Random(3)
    vals = [O.Fp12(*(O.Fp6(*(O.Fp2(rng.randrange(params.P), rng.randrange(params.P))
                             for _ in range(3))) for _ in range(2))) for _ in range(width)]
    spec = JPS(None, JM.BATCH_AXIS)
    want = JT.fp12_decode(_ref(lambda f: JM.ring_reduce(f, JT.fp12_mul), JM.make_mesh(width),
                               JT.fp12_encode(vals), out_specs=spec))
    port_vals = [PF.Fp12(*(PF.Fp6(*(PF.Fp2(c.c0, c.c1) for c in (c6.c0, c6.c1, c6.c2)))
                           for c6 in (v.c0, v.c1))) for v in vals]
    parts = [T.fp12_encode([v], "cpu") for v in port_vals]
    with torch.inference_mode():
        got = [T.fp12_decode(acc)[0] for acc in M.ring_reduce(parts, T.fp12_mul)]
    prod = vals[0]
    for v in vals[1:]:
        prod = prod * v
    assert [_key12(g) for g in got] == [_key12(w) for w in want] == [_key12(prod)] * width


def test_dp_shard_map_runs_local_then_combine(ref_mesh, mesh):
    """Every leaf split on its trailing axis, seat i on its columns, the
    partials combined in a second step: the reference's local function with
    its collective inside gives the same result."""
    x = np.arange(4 * 16, dtype=np.int32).reshape(4, 16)
    w = (np.arange(16, dtype=np.int32) % 5).reshape(1, 16)

    def ref_local(a, b):
        return JM.allgather_tree(jnp.sum(a * b, axis=0, keepdims=True))

    want = np.asarray(jax.jit(JM.dp_shard_map(ref_local, ref_mesh))(jnp.asarray(x),
                                                                    jnp.asarray(w)))
    seen = []

    def local(a, b):
        seen.append(a.shape)
        return torch.sum(a * b, dim=0, keepdim=True)

    got = M.dp_shard_map(local, mesh, M.allgather_tree)(torch.from_numpy(x), torch.from_numpy(w))
    assert seen == [(4, 2)] * W
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="does not divide"):
        M.dp_shard_map(local, mesh, M.allgather_tree)(torch.ones(2, 12), torch.ones(1, 12))


def test_seat_context_is_entered_for_each_seat(monkeypatch):
    """dp_shard_map and ring_reduce run each seat's work under its
    seat_context; on CUDA that makes the seat's card current."""
    entered = []
    real = M.seat_context

    def spy(device):
        entered.append(torch.device(device))
        return real(device)

    monkeypatch.setattr(M, "seat_context", spy)
    seats = (torch.device("cpu"),) * 4
    mesh = M.Mesh(seats)
    M.dp_shard_map(lambda a: a.sum().reshape(1), mesh, M.and_reduce)(torch.ones(1, 8))
    assert entered.count(torch.device("cpu")) >= 4
    entered.clear()
    M.ring_reduce([torch.tensor([i]) for i in range(4)], torch.add)
    assert entered == [torch.device("cpu")] * 12  # 3 hops x 4 seats
    # on a CUDA seat the context is torch.cuda.device of that card
    assert isinstance(real(torch.device("cuda", 1)), torch.cuda.device)


# ---------------------------------------------------------------------------
# One card per seat, any card: the kernels' shared-memory attribute is set
# per device, not once per process
# ---------------------------------------------------------------------------


def _sources():
    from lighthouse_tpu_torch.crypto.bls.torch_backend import _build, codegen

    out = {p.name: p.read_text() for p in sorted(_build.CSRC.iterdir())
           if p.suffix in (".cu", ".cuh")}
    out["codegen.py"] = open(codegen.__file__).read()
    return out


def test_no_shared_memory_attribute_is_set_once_per_process():
    """Every cudaFuncSetAttribute in csrc/ and in codegen.py's templates is a
    plain call (lh::set_shared_limit's, per device), never the initializer
    of a function-static; every launcher with dynamic shared memory goes
    through lh::set_shared_limit."""
    import re

    calls = 0
    for name, text in _sources().items():
        for m in re.finditer(r"cudaFuncSetAttribute\s*\(", text):
            start = max(text.rfind(c, 0, m.start()) for c in ";{}")
            statement = text[start + 1:m.start()]
            assert not re.search(r"\bstatic\b", statement), (name, statement.strip())
            calls += 1
        launches = len(re.findall(r"<<<[^>]*kShared", text))
        if launches:
            assert text.count("set_shared_limit(") >= min(launches, 1), name
    assert calls == 1  # the one in group.cuh's set_shared_limit
    texts = _sources()
    for name in ("miller_step.cu", "miller_step_mxu.cu", "wsm_step.cu"):
        assert texts[name].count("lh::set_shared_limit(") == 2, name
    assert texts["mxu.cu"].count("lh::set_shared_limit(") == 1
    assert texts["chain.cu"].count("lh::set_shared_limit(") == 1  # launch_group
    assert texts["codegen.py"].count("lh::set_shared_limit(") == 2


_SET_LIMIT_HARNESS = r"""
#include <map>
#include <utility>
struct Dim { int x; };
extern Dim threadIdx, blockIdx, blockDim;
Dim threadIdx, blockIdx, blockDim;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
static int g_dev = 0;
static std::map<std::pair<const void*, int>, int> g_calls;
inline cudaError_t cudaGetDevice(int* d) { *d = g_dev; return cudaSuccess; }
inline cudaError_t cudaFuncSetAttribute(const void* f, cudaFuncAttribute, int v) {
  g_calls[{f, g_dev}] += 1;
  return v > 232448 ? cudaErrorInvalidValue : cudaSuccess;
}
"""

_SET_LIMIT_MAIN = r"""
static void kernel_a(int) {}
static void kernel_b(int) {}
extern "C" int probe(int* out) {
  int k = 0;
  for (int dev : {0, 0, 1, 1, 0, 2}) {
    g_dev = dev;
    if (lh::set_shared_limit(kernel_a, 129792) != cudaSuccess) return 1;
  }
  g_dev = 1;
  if (lh::set_shared_limit(kernel_b, 62464) != cudaSuccess) return 2;
  if (lh::set_shared_limit(kernel_b, 300000) == cudaSuccess) return 3;  // refused,
  if (lh::set_shared_limit(kernel_b, 300000) == cudaSuccess) return 4;  // and not cached
  for (int dev = 0; dev < 3; ++dev) {
    out[k++] = g_calls[{reinterpret_cast<const void*>(kernel_a), dev}];
    out[k++] = g_calls[{reinterpret_cast<const void*>(kernel_b), dev}];
  }
  return 0;
}
"""


def test_set_shared_limit_sets_the_attribute_once_per_kernel_and_device(tmp_path):
    """group.cuh's lh::set_shared_limit, built for the host with the runtime
    calls stubbed: a kernel's attribute is set at its first launch on each
    device (a process whose seats sit on several cards sets it on each), not
    again on a device where it was set, and a refused one is not cached."""
    import ctypes
    import shutil
    import subprocess

    from lighthouse_tpu_torch.crypto.bls.torch_backend import _build

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    (tmp_path / "cuda_runtime.h").write_text("#pragma once\n" + _SET_LIMIT_HARNESS)
    src = ("#define __device__\n#define __forceinline__ inline\n#define __CUDACC__ 1\n"
           '#include "group.cuh"\n' + _SET_LIMIT_MAIN)
    (tmp_path / "probe.cpp").write_text(src)
    subprocess.run([gxx, "-std=c++17", "-shared", "-fPIC", f"-I{tmp_path}", f"-I{_build.CSRC}",
                    "-o", str(tmp_path / "probe.so"), str(tmp_path / "probe.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(tmp_path / "probe.so"))
    out = (ctypes.c_int * 6)()
    assert lib.probe(out) == 0
    # (kernel_a, kernel_b) calls on devices 0, 1, 2
    assert list(out) == [1, 0, 1, 3, 1, 0]
