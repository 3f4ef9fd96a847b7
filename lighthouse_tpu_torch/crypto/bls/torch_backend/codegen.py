"""Generate the CUDA sources that are derived from Python tables and programs.

* ``csrc/limb_constants.cuh``: P, P', R mod P and the eight subtraction
  biases, from fp.py's re-derived tables.
* ``csrc/miller_step.cu``: kernels 2 and 3, printed from the recorded step
  programs of miller_kernel.py (one C statement per limb op, values kept in
  a per-thread slot array reused by liveness).
* ``csrc/miller_step_mxu.cu``: their MXU variants, the same programs with
  every product on the 13-bit plane (kernel 7's core).
* ``csrc/wsm_step.cu``: kernel 6 (its G1 and G2 entry points), printed the
  same way from the step programs of wsm_kernel.py.

The files are committed; ``tests/test_torch_miller.py`` regenerates them and
requires the text to be identical.  Regenerate after changing the formulas:

    python -m lighthouse_tpu_torch.crypto.bls.torch_backend.codegen
"""

from __future__ import annotations

from . import _build
from . import fp as F
from . import miller_kernel as MK
from . import mxu_kernel as X
from . import wsm_kernel as WK

HEADER = "// Generated by lighthouse_tpu_torch/crypto/bls/torch_backend/codegen.py; do not edit.\n"


def _array(values) -> str:
    return "{" + ", ".join(str(int(v)) for v in values) + "}"


def limb_constants() -> str:
    c13 = X.constants13()
    bias_rows = ",\n    ".join(_array(F.BIAS_NP[k]) for k in F.BIAS_KS)
    return f"""{HEADER}// Montgomery constants of the 26 x 15-bit limb plane (R = 2^390), from
// torch_backend/fp.py.
#pragma once

#include <cstdint>

namespace lh {{

__constant__ uint32_t kP[26] = {_array(F.P_NP)};
__constant__ uint32_t kPPrime[26] = {_array(F.PPRIME_NP)};  // -P^-1 mod R
__constant__ uint32_t kOne[26] = {_array(F.ONE_NP)};  // R mod P
// k*P with every non-top limb boosted past QMAX (fp._biased_kp), for
// k = {", ".join(str(k) for k in F.BIAS_KS)}: the subtraction bias a + kP - b.
__constant__ uint32_t kBias[{len(F.BIAS_KS)}][26] = {{
    {bias_rows}}};
// P and P' on the 31 x 13-bit plane for kernel 7's core: to13 of the limbs
// above, as pallas_mxu.mont_core_mxu re-limbs them in-kernel
// (mxu_kernel.constants13).
__constant__ uint32_t kP13[31] = {_array(c13["P13"])};
__constant__ uint32_t kPPrime13[31] = {_array(c13["PP13"])};

}}  // namespace lh
"""


_MILLER_DOC = """// Kernels 2 and 3: the fused Miller doubling and addition steps, replacing
// lighthouse_tpu/crypto/bls/jax_backend/pallas_miller.py:_step_dbl_kernel and
// _step_add_kernel.  Printed from the step programs that
// torch_backend/miller_kernel.py records from the formulas of
// pallas_miller.py; the plain PyTorch version runs the same programs.
//
"""

_MILLER_MXU_DOC = """// The MXU variants of kernels 2 and 3: the same fused Miller steps with
// every Montgomery product on the 31 x 13-bit plane (kernel 7's core,
// csrc/mxu.cuh), as pallas_miller.py builds _step_dbl_kernel and
// _step_add_kernel with mxu=True (_Ctx -> pallas_fp._core_pair).  Printed
// from the same step programs as miller_step.cu; the plain PyTorch version
// runs them over mxu_kernel.mont_mul_mxu_plain.
//
"""

_WSM_DOC = """// Kernel 6: one double-and-always-add bit of the 64-bit weight scalar
// multiplication, for G1 and for G2, replacing
// lighthouse_tpu/crypto/bls/jax_backend/pallas_wsm.py:_make_step_kernel
// (_step_call).  Printed from the step programs that
// torch_backend/wsm_kernel.py records from the formulas of pallas_wsm.py
// (Jacobian double, mixed add of the affine base, the bit and infinity-flag
// selects); the plain PyTorch version runs the same programs.  Flags are
// (1, n) planes of 0/1 words, kept per lane in uint32 values.
//
"""

_HEAD = """// One thread per lane.  Planes are (planes, 26, n) limb-major, so limb i of
// neighbouring lanes are neighbouring words and every load and store
// coalesces.  Intermediates live in the slot array s (registers spilling to
// local memory); every Montgomery product is one call of the non-inlined
// k_mul, which keeps the build short.
#include "mont.cuh"

namespace {

using lh::NL;

constexpr int kBlock = 32;  // 4,097 lanes -> 129 blocks, one per SM

"""

_K_MUL = """__device__ __noinline__ void k_mul(uint32_t* o, const uint32_t* a, const uint32_t* b) {
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
"""

_GLUE = """
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
"""

_HELPERS = _HEAD + _K_MUL + _GLUE

_HEAD_MXU = """// One thread per lane, one warp per block.  Planes are (planes, 26, n)
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

"""

_K_MUL_MXU = """__device__ __noinline__ void k_mul(uint32_t* o, const uint32_t* a, const uint32_t* b,
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
"""

_SQR_HELPERS = """
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
"""

_END_HELPERS = """
}  // namespace
"""

# program -> (input buffers, output buffers), in the kernel's argument order
_SIGNATURES = {
    "miller_step_dbl": (("f", "t", "xp", "yp"), ("f_out", "t_out")),
    "miller_step_add": (("f", "t", "q", "xp", "yp", "bit"), ("f_out", "t_out")),
    "wsm_step_g1": (("acc", "inf_acc", "base", "inf_base", "bit"), ("acc_out", "inf_out")),
    "wsm_step_g2": (("acc", "inf_acc", "base", "inf_base", "bit"), ("acc_out", "inf_out")),
}


def _body(prog: MK.Program, mxu: bool = False) -> tuple[list, int]:
    """C statements for a program, slots assigned by liveness: an output
    slot is taken before the op's dead inputs are released, so no op reads
    and writes one slot.  Flags live in named uint32 values, not slots;
    the Miller addition bit is the bool ``take``.  With ``mxu`` every product
    (a square too) is the 13-bit k_mul, and stores are kept to live lanes."""
    guard = "if (live) " if mxu else ""
    last = {}
    for idx, op in enumerate(prog.ops):
        for i in op.ins:
            last[i] = idx
    stores = {vid: (buf, plane) for buf, plane, vid in prog.outputs}
    free, slot, n_slots, lines = [], {}, 0, []

    def s(vid):
        kind = prog.ops[vid].kind
        if kind == "bit":
            return "take"
        if kind in MK.FLAGS:
            return f"f{vid}"
        return f"s[{slot[vid]}]"

    def mask(vid):
        return s(vid) if prog.ops[vid].kind == "bit" else f"{s(vid)} != 0"

    for idx, op in enumerate(prog.ops):
        if op.kind in MK.FLAGS:
            if op.kind == "bit":
                lines.append("const bool take = bit[lane] != 0;")
            elif op.kind == "flag":
                lines.append(f"const uint32_t {s(op.out)} = {op.arg}[lane];")
            elif op.kind == "and":
                lines.append(f"const uint32_t {s(op.out)} = {s(op.ins[0])} & {s(op.ins[1])};")
            else:  # fsel
                lines.append(f"const uint32_t {s(op.out)} = {mask(op.ins[0])} ? "
                             f"{s(op.ins[1])} : {s(op.ins[2])};")
            if op.out in stores:
                buf, _ = stores[op.out]
                lines.append(f"{guard}{buf}[lane] = {s(op.out)};")
            continue
        if free:
            slot[op.out] = free.pop()
        else:
            slot[op.out] = n_slots
            n_slots += 1
        o, ins = s(op.out), [s(i) for i in op.ins]
        if op.kind == "in":
            buf, plane = op.arg
            lines.append(f"k_load({o}, {buf}, {plane}, n, lane);")
        elif op.kind == "one":
            lines.append(f"k_one({o});")
        elif op.kind == "zero":
            lines.append(f"k_zero({o});")
        elif op.kind == "mul" and mxu:
            lines.append(f"k_mul({o}, {ins[0]}, {ins[1]}, mx);")
        elif op.kind == "sqr" and mxu:
            lines.append(f"k_mul({o}, {ins[0]}, {ins[0]}, mx);")
        elif op.kind == "mul":
            lines.append(f"k_mul({o}, {ins[0]}, {ins[1]});")
        elif op.kind == "sqr":
            lines.append(f"k_sqr({o}, {ins[0]});")
        elif op.kind == "add":
            lines.append(f"k_add({o}, {ins[0]}, {ins[1]});")
        elif op.kind == "sub":
            lines.append(f"k_sub({o}, {ins[0]}, {ins[1]}, {F.BIAS_KS.index(op.arg)});  // k={op.arg}")
        elif op.kind == "neg":
            lines.append(f"k_neg({o}, {ins[0]}, {F.BIAS_KS.index(op.arg)});  // k={op.arg}")
        elif op.kind == "sel":
            lines.append(f"k_sel({o}, {mask(op.ins[0])}, {ins[1]}, {ins[2]});")
        else:
            raise AssertionError(op.kind)
        if op.out in stores:
            buf, plane = stores[op.out]
            lines.append(f"{guard}k_store({buf}, {plane}, n, lane, {o});")
        dead = {i for i in op.ins if last[i] == idx and prog.ops[i].kind not in MK.FLAGS}
        if op.out not in last:
            dead.add(op.out)
        free.extend(sorted(slot[v] for v in dead))
    return lines, n_slots


def _kernel(prog: MK.Program, mxu: bool = False) -> str:
    lines, n_slots = _body(prog, mxu)
    inputs, outputs = _SIGNATURES[prog.name]
    name = prog.name + "_mxu" if mxu else prog.name
    # the Miller addition bit is an (n,) int32 row; limb and flag planes are uint32
    has_bit = any(op.kind == "bit" for op in prog.ops)
    ctypes = {nm: "int32_t" if nm == "bit" and has_bit else "uint32_t" for nm in inputs}
    params = [f"const {ctypes[nm]}* __restrict__ {nm}" for nm in inputs]
    params += [f"uint32_t* __restrict__ {name}" for name in outputs] + ["int n"]
    body = "\n".join("  " + ln for ln in lines)
    c_args = ", ".join(f"const void* {nm}" for nm in inputs)
    c_outs = ", ".join(f"void* {nm}" for nm in outputs)
    casts = ", ".join(f"static_cast<const {ctypes[nm]}*>({nm})" for nm in inputs)
    out_casts = ", ".join(f"static_cast<uint32_t*>({nm})" for nm in outputs)
    counts = f"{prog.n_mul} Montgomery products"
    if prog.n_sqr:
        counts += f", {prog.n_sqr} squares"
    if mxu:
        counts += " on the 13-bit plane"
        prologue = """  __shared__ lh::MxuShared<1> mxu_sm;
  const lh::MxuCtx mx = lh::mxu_setup(mxu_sm);
  const int gl = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;"""
    else:
        prologue = """  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;"""
    return f"""
// {name}: {len(prog.ops)} limb ops, {counts}, {n_slots} slots.
static __global__ void __launch_bounds__(kBlock)
{name}_kernel({", ".join(params)}) {{
{prologue}
  uint32_t s[{n_slots}][NL];
{body}
}}

extern "C" int lh_{name}({c_args}, {c_outs}, int n,
                              void* stream) {{
  if (n > 0) {{
    {name}_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        {casts},
        {out_casts}, n);
  }}
  return static_cast<int>(cudaGetLastError());
}}
"""


def miller_step_source() -> str:
    kernels = "".join(_kernel(MK.program(step)) for step in ("dbl", "add"))
    return HEADER + _MILLER_DOC + _HELPERS + _END_HELPERS + kernels


def miller_step_mxu_source() -> str:
    kernels = "".join(_kernel(MK.program(step), mxu=True) for step in ("dbl", "add"))
    return HEADER + _MILLER_MXU_DOC + _HEAD_MXU + _K_MUL_MXU + _GLUE + _END_HELPERS + kernels


def wsm_step_source() -> str:
    kernels = "".join(_kernel(WK.program(nc)) for nc in (1, 2))
    return HEADER + _WSM_DOC + _HELPERS + _SQR_HELPERS + _END_HELPERS + kernels


def generate_sources() -> dict:
    """{file name under csrc/: text} for every generated source."""
    return {
        "limb_constants.cuh": limb_constants(),
        "miller_step.cu": miller_step_source(),
        "miller_step_mxu.cu": miller_step_mxu_source(),
        "wsm_step.cu": wsm_step_source(),
    }


def main() -> None:
    for name, text in generate_sources().items():
        (_build.CSRC / name).write_text(text)
        print(f"wrote {_build.CSRC / name}")


if __name__ == "__main__":
    main()
