"""Generate the CUDA sources that are derived from Python tables and programs.

* ``csrc/limb_constants.cuh``: P, P', R mod P and the eight subtraction
  biases, from fp.py's re-derived tables.
* ``csrc/miller_step.cu``: kernels 2 and 3, printed from the recorded step
  programs of miller_kernel.py, one C statement per limb op, in the group
  form (``_kernel(..., group=G)``): G threads per lane run the program's
  products side by side, in rounds scheduled by ``group_schedule``, their
  values in shared memory.
* ``csrc/miller_step_mxu.cu``: their MXU variants, the same programs with
  every product on the 13-bit plane (kernel 7's core), both in the group
  form (``_kernel(..., mxu=True, group=G)``, one rank per warp, each warp's
  DMMA products staged in MXU_GROUP_ROWS rows a pass).
* ``csrc/wsm_step.cu``: kernel 6 (its G1 and G2 entry points), printed one
  thread per lane from the step programs of wsm_kernel.py.

The files are committed; ``tests/test_torch_miller.py`` regenerates them and
requires the text to be identical.  Regenerate after changing the formulas:

    python -m lighthouse_tpu_torch.crypto.bls.torch_backend.codegen
"""

from __future__ import annotations

import collections
import dataclasses

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

_MILLER_HEAD = """// Both steps run in the group form: G = 16 threads per lane
// (csrc/group.cuh; miller_kernel.DBL_GROUP, ADD_GROUP).  One thread per lane
// ran a step's 169 (dbl) or 111 (add) products one after another, each a
// 1,703-multiply chain of one thread, with one warp per SM at the Miller
// loop's 4,097 lanes: the card waited on that thread's issue rate and
// latency.  The products of one dependency level are independent, so the
// group runs them side by side: rounds of at most G products (one per
// thread, the unchanged lh::mont_core, so the bytes are the same by
// construction) and the linear ops between them dealt to the ranks, a
// barrier after each phase.  The serial chain falls from 169 products to 11
// rounds (dbl) and from 111 to 10 (add), and the card gets G times the
// warps.  The lane's values live in shared memory, 16 bits a limb, in
// slots reassigned by the phase schedule (codegen.group_schedule).
// The addition step's bit is read by every thread; its selects are linear
// ops like the others.
//
// Planes are (planes, 26, n) limb-major, so limb i of neighbouring lanes are
// neighbouring words and every load and store coalesces; each input plane
// is read once and each output plane written once.
#include "group.cuh"
#include "mont.cuh"

namespace {

using lh::NL;

"""

_HEAD_MXU = """// Both steps run in the group form of miller_step.cu (csrc/group.cuh) with
// G = 8 threads per lane in blocks of 32 lanes (miller_kernel.DBL_MXU_GROUP,
// ADD_MXU_GROUP), so each warp is the 32 lanes of one rank: a phase's switch
// on the rank is warp-uniform and every product's mma.sync (csrc/mxu.cuh) is
// made by a whole warp, its N dimension the warp's 32 lanes; the tail
// threads run lane n - 1 again and store nothing.  Each warp stages its DMMA
// products in shared memory beside the block's slots, in passes of ROWS rows
// of C (g_mul_mxu<ROWS>, MxuShared<G, ROWS>): the doubling step the 64 rows
// of m * P in two passes of 32, the addition step, whose 92 slots take more
// room, in four of 16, so that 8 warps' staging and the slots fit in one
// block (each launcher asserts the bytes).
//
// Planes are (planes, 26, n) limb-major, so limb i of neighbouring lanes are
// neighbouring words and every load and store coalesces.
#include "group.cuh"
#include "mxu.cuh"

namespace {

using lh::NL;
"""

# Rows of C a group form's warp stages per pass (MxuShared), by program.
MXU_GROUP_ROWS = {"miller_step_dbl": 32, "miller_step_add": 16}
SHARED_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90 (227 KB)


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

_GROUP_HELPERS = """
// The group form (csrc/group.cuh): G threads per lane, the lane's values in
// shared memory, slot k limb i of the lane at s[(k * NL + i) * kGroupLanes].
// A slot holds 16 bits: every value is quasi limbs (inputs, <= QMAX), strict
// limbs (products) or limbs after one carry pass (add, sub, neg: below
// 2^15 + 8), all below 2^16.
using lh::kGroupLanes;

__device__ __forceinline__ uint16_t* g_at(uint16_t* s, int k) { return s + k * NL * kGroupLanes; }

__device__ __forceinline__ void g_put(uint16_t* s, int k, const uint32_t (&c)[NL]) {
  uint16_t* o = g_at(s, k);
#pragma unroll
  for (int i = 0; i < NL; ++i) o[i * kGroupLanes] = static_cast<uint16_t>(c[i]);
}

__device__ __forceinline__ void g_get(uint16_t* s, int k, uint32_t (&c)[NL]) {
  const uint16_t* a = g_at(s, k);
#pragma unroll
  for (int i = 0; i < NL; ++i) c[i] = a[i * kGroupLanes];
}

// a + b, one carry pass
__device__ __noinline__ void g_add(uint16_t* s, int o, int a, int b) {
  uint32_t x[NL], y[NL];
  g_get(s, a, x);
  g_get(s, b, y);
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] += y[i];
  lh::compress1(x);
  g_put(s, o, x);
}

// a + kP - b, one carry pass (the bias dominates b limb by limb)
__device__ __noinline__ void g_sub(uint16_t* s, int o, int a, int b, int kidx) {
  uint32_t x[NL], y[NL];
  g_get(s, a, x);
  g_get(s, b, y);
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = x[i] + lh::kBias[kidx][i] - y[i];
  lh::compress1(x);
  g_put(s, o, x);
}

// kP - a, one carry pass
__device__ __noinline__ void g_neg(uint16_t* s, int o, int a, int kidx) {
  uint32_t x[NL];
  g_get(s, a, x);
#pragma unroll
  for (int i = 0; i < NL; ++i) x[i] = lh::kBias[kidx][i] - x[i];
  lh::compress1(x);
  g_put(s, o, x);
}

__device__ __forceinline__ void g_sel(uint16_t* s, int o, bool take, int a, int b) {
  uint16_t* d = g_at(s, o);
  const uint16_t* x = g_at(s, take ? a : b);
#pragma unroll
  for (int i = 0; i < NL; ++i) d[i * kGroupLanes] = x[i * kGroupLanes];
}

__device__ __forceinline__ void g_one(uint16_t* s, int o) {
  uint16_t* d = g_at(s, o);
#pragma unroll
  for (int i = 0; i < NL; ++i) d[i * kGroupLanes] = static_cast<uint16_t>(lh::kOne[i]);
}

__device__ __forceinline__ void g_zero(uint16_t* s, int o) {
  uint16_t* d = g_at(s, o);
#pragma unroll
  for (int i = 0; i < NL; ++i) d[i * kGroupLanes] = 0;
}

__device__ __forceinline__ void g_load(uint16_t* s, int o, const uint32_t* base, int plane,
                                       int n, int lane) {
  uint16_t* d = g_at(s, o);
#pragma unroll
  for (int i = 0; i < NL; ++i)
    d[i * kGroupLanes] = static_cast<uint16_t>(base[(static_cast<size_t>(plane) * NL + i) * n + lane]);
}

__device__ __forceinline__ void g_store(uint32_t* base, int plane, int n, int lane, uint16_t* s,
                                        int k) {
  const uint16_t* v = g_at(s, k);
#pragma unroll
  for (int i = 0; i < NL; ++i) base[(static_cast<size_t>(plane) * NL + i) * n + lane] = v[i * kGroupLanes];
}
"""

_GROUP_MUL = """
__device__ __noinline__ void g_mul(uint16_t* s, int o, int a, int b) {
  uint32_t x[NL], y[NL], r[NL];
  g_get(s, a, x);
  g_get(s, b, y);
  lh::mont_core(x, y, r);
  g_put(s, o, r);
}

__device__ __noinline__ void g_sqr(uint16_t* s, int o, int a) {
  uint32_t x[NL], r[NL];
  g_get(s, a, x);
  lh::mont_sqr_core(x, r);
  g_put(s, o, r);
}
"""

# the group form's product on the 13-bit plane: warp-cooperative, so a
# phase's products are made by whole warps (one rank each); ROWS: the rows
# of C each warp stages per pass
_GROUP_MUL_MXU = """
template <int ROWS>
__device__ __noinline__ void g_mul_mxu(uint16_t* s, int o, int a, int b, const lh::MxuCtx& mx) {
  uint32_t x[NL], y[NL], r[NL];
  g_get(s, a, x);
  g_get(s, b, y);
  lh::mont_core_mxu<ROWS>(x, y, r, mx);
  g_put(s, o, r);
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


def _body(prog: MK.Program) -> tuple[list, int]:
    """C statements for a program, slots assigned by liveness: an output
    slot is taken before the op's dead inputs are released, so no op reads
    and writes one slot.  Flags live in named uint32 values, not slots;
    the Miller addition bit is the bool ``take``."""
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
                lines.append(f"{buf}[lane] = {s(op.out)};")
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
            lines.append(f"k_store({buf}, {plane}, n, lane, {o});")
        dead = {i for i in op.ins if last[i] == idx and prog.ops[i].kind not in MK.FLAGS}
        if op.out not in last:
            dead.add(op.out)
        free.extend(sorted(slot[v] for v in dead))
    return lines, n_slots


@dataclasses.dataclass(frozen=True)
class GroupSchedule:
    """A step program laid out for G threads per lane.

    ``phases[p][r]`` lists the value ids rank r computes in phase p, in
    order; every phase ends at a barrier of the group.  A phase holds
    either one round of products (at most one per rank) or linear ops whose
    inputs all come from earlier phases.  ``slot`` gives every limb value
    its shared-memory slot; flag values are computed by every thread before
    the first phase and hold no slot."""

    group: int
    phases: tuple
    slot: dict
    n_slots: int
    n_rounds: int


def group_schedule(prog: MK.Program, group: int) -> GroupSchedule:
    """Rounds of at most ``group`` products, each taking the ready products
    (every operand computed, or a linear op away from computed values) with
    the longest chain of products still after them, so the rounds follow
    the program's dependency levels and the longest path sets their count.
    The linear ops a round needs run just before it, in phases by their
    depth among themselves; the ops left after the last round (the outputs'
    linear tails) run last.  Ops of a phase are dealt to the ranks round
    robin.

    Slots are assigned by liveness over phases: a value holds its slot from
    the phase that writes it through the last phase that reads it, and a
    slot is handed on only at a phase boundary, so no slot is written in a
    phase that reads it."""
    ops = prog.ops
    kind = {op.out: op.kind for op in ops}
    ins = {op.out: op.ins for op in ops}
    consumers = collections.defaultdict(list)
    for op in ops:
        for i in op.ins:
            consumers[i].append(op.out)
    height = {}  # products on the longest chain after the value
    for op in reversed(ops):
        height[op.out] = max((height[c] + (kind[c] in MK.PRODUCTS) for c in consumers[op.out]),
                             default=0)
    done = {op.out for op in ops if op.kind in MK.FLAGS}
    phases = []

    def closure(vids):
        """The linear ops not yet computed that ``vids`` need, themselves included."""
        acc, stack = set(), list(vids)
        while stack:
            v = stack.pop()
            if v in done or v in acc:
                continue
            assert kind[v] not in MK.PRODUCTS
            acc.add(v)
            stack.extend(ins[v])
        return acc

    def deal(vids):
        ranks = [[] for _ in range(group)]
        for k, v in enumerate(vids):
            ranks[k % group].append(v)
        phases.append(tuple(tuple(r) for r in ranks))

    def linear(vids):
        depth = {}
        for v in sorted(vids):  # program order: inputs before their consumers
            depth[v] = 1 + max((depth[i] for i in ins[v] if i in vids), default=0)
        for d in range(1, max(depth.values(), default=0) + 1):
            deal(sorted(v for v in vids if depth[v] == d))
        done.update(vids)

    def available(v, memo):
        if v not in memo:
            memo[v] = v in done or (kind[v] not in MK.PRODUCTS
                                    and all(available(i, memo) for i in ins[v]))
        return memo[v]

    remaining = [op.out for op in ops if op.kind in MK.PRODUCTS]
    n_rounds = 0
    while remaining:
        memo = {}
        ready = [v for v in remaining if all(available(i, memo) for i in ins[v])]
        pick = sorted(ready, key=lambda v: (-height[v], v))[:group]
        linear(closure([i for v in pick for i in ins[v]]))
        deal(sorted(pick))
        done.update(pick)
        remaining = [v for v in remaining if v not in done]
        n_rounds += 1
    linear(closure([op.out for op in ops if op.out not in done]))

    phase_of = {v: p for p, ranks in enumerate(phases) for r in ranks for v in r}
    last = {v: phase_of[v] for v in phase_of}
    for v in phase_of:
        for i in ins[v]:
            if i in last:
                last[i] = max(last[i], phase_of[v])
    slot, free, n_slots = {}, [], 0
    by_last = collections.defaultdict(list)
    for v, p in last.items():
        by_last[p].append(v)
    for p, ranks in enumerate(phases):
        for v in sorted(v for r in ranks for v in r):
            if free:
                slot[v] = free.pop()
            else:
                slot[v] = n_slots
                n_slots += 1
        free.extend(sorted((slot[v] for v in by_last[p]), reverse=True))
    return GroupSchedule(group, tuple(phases), slot, n_slots, n_rounds)


def _signature(prog: MK.Program) -> dict:
    """The C pieces of a step kernel's signature and launch: its parameters,
    the launcher's arguments and the casts between them, and the count of
    products for its header line."""
    inputs, outputs = _SIGNATURES[prog.name]
    # the Miller addition bit is an (n,) int32 row; limb and flag planes are uint32
    has_bit = any(op.kind == "bit" for op in prog.ops)
    ctypes = {nm: "int32_t" if nm == "bit" and has_bit else "uint32_t" for nm in inputs}
    params = [f"const {ctypes[nm]}* __restrict__ {nm}" for nm in inputs]
    params += [f"uint32_t* __restrict__ {nm}" for nm in outputs] + ["int n"]
    counts = f"{prog.n_mul} Montgomery products"
    if prog.n_sqr:
        counts += f", {prog.n_sqr} squares"
    return {"params": ", ".join(params),
            "c_args": ", ".join(f"const void* {nm}" for nm in inputs),
            "c_outs": ", ".join(f"void* {nm}" for nm in outputs),
            "casts": ", ".join(f"static_cast<const {ctypes[nm]}*>({nm})" for nm in inputs),
            "out_casts": ", ".join(f"static_cast<uint32_t*>({nm})" for nm in outputs),
            "counts": counts}


def _kernel(prog: MK.Program, mxu: bool = False, group: int | None = None) -> str:
    """A step program's kernel and its C launcher lh_<name>: one thread per
    lane (15-bit only), or with ``group`` the group form (G threads per lane,
    launched as lh_<name>_g<G>, or lh_<name>_mxu_g<G> with ``mxu``, its warps
    staging MXU_GROUP_ROWS' rows of C a pass)."""
    if group is not None:
        return _group_kernel(prog, group, mxu)
    assert not mxu, "the MXU steps are printed in the group form only"
    lines, n_slots = _body(prog)
    name = prog.name
    sig = _signature(prog)
    body = "\n".join("  " + ln for ln in lines)
    counts = sig["counts"]
    return f"""
// {name}: {len(prog.ops)} limb ops, {counts}, {n_slots} slots.
static __global__ void __launch_bounds__(kBlock)
{name}_kernel({sig["params"]}) {{
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  uint32_t s[{n_slots}][NL];
{body}
}}

extern "C" int lh_{name}({sig["c_args"]}, {sig["c_outs"]}, int n,
                              void* stream) {{
  if (n > 0) {{
    {name}_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        {sig["casts"]},
        {sig["out_casts"]}, n);
  }}
  return static_cast<int>(cudaGetLastError());
}}
"""


def _group_op(prog: MK.Program, sched: GroupSchedule, vid: int, stores: dict,
              rows: int | None) -> list:
    op = prog.ops[vid]
    o = sched.slot[vid]
    ins = [sched.slot.get(i) for i in op.ins]
    if op.kind == "in":
        buf, plane = op.arg
        line = f"g_load(s, {o}, {buf}, {plane}, n, lane);"
    elif op.kind in ("one", "zero"):
        line = f"g_{op.kind}(s, {o});"
    elif op.kind in MK.PRODUCTS and rows:  # a square too is the 13-bit product
        line = f"g_mul_mxu<{rows}>(s, {o}, {ins[0]}, {ins[-1]}, mx);"
    elif op.kind in ("mul", "add"):
        line = f"g_{op.kind}(s, {o}, {ins[0]}, {ins[1]});"
    elif op.kind == "sqr":
        line = f"g_sqr(s, {o}, {ins[0]});"
    elif op.kind == "sub":
        line = f"g_sub(s, {o}, {ins[0]}, {ins[1]}, {F.BIAS_KS.index(op.arg)});  // k={op.arg}"
    elif op.kind == "neg":
        line = f"g_neg(s, {o}, {ins[0]}, {F.BIAS_KS.index(op.arg)});  // k={op.arg}"
    elif op.kind == "sel":
        mask = op.ins[0]
        cond = "take" if prog.ops[mask].kind == "bit" else f"f{mask} != 0"
        line = f"g_sel(s, {o}, {cond}, {ins[1]}, {ins[2]});"
    else:
        raise AssertionError(op.kind)
    lines = [line]
    if vid in stores:
        buf, plane = stores[vid]
        lines.append(f"if (live) g_store({buf}, {plane}, n, lane, s, {o});")
    return lines


def _group_body(prog: MK.Program, sched: GroupSchedule, rows: int | None) -> list:
    """C statements of the group form: the flag values, computed by every
    thread (they depend on flags only, and rank 0 stores the outputs among
    them), then one LH_RANKS block per phase, a case per rank.  With ``rows``
    the products are the 13-bit g_mul_mxu<rows>."""
    stores = {vid: (buf, plane) for buf, plane, vid in prog.outputs}
    lines = []
    for op in prog.ops:
        if op.kind not in MK.FLAGS:
            continue
        v = f"f{op.out}"
        if op.kind == "bit":
            lines.append("const bool take = bit[lane] != 0;")
        elif op.kind == "flag":
            lines.append(f"const uint32_t {v} = {op.arg}[lane];")
        elif op.kind == "and":
            lines.append(f"const uint32_t {v} = f{op.ins[0]} & f{op.ins[1]};")
        else:  # fsel
            m = op.ins[0]
            cond = "take" if prog.ops[m].kind == "bit" else f"f{m} != 0"
            lines.append(f"const uint32_t {v} = {cond} ? f{op.ins[1]} : f{op.ins[2]};")
        if op.out in stores:
            lines.append(f"if (live && lh::group_rank() == 0) {stores[op.out][0]}[lane] = {v};")
    products = 0
    for p, ranks in enumerate(sched.phases):
        first = next(v for r in ranks for v in r)
        if prog.ops[first].kind in MK.PRODUCTS:
            products += 1
            what = f"round {products} of products"
        else:
            what = "linear ops"
        lines.append(f"// phase {p + 1}: {what}")
        lines.append(f"LH_RANKS({sched.group}, switch (r) {{")
        for r, vids in enumerate(ranks):
            if not vids:
                continue
            lines.append(f"  case {r}:")
            for vid in vids:
                lines.extend("    " + ln for ln in _group_op(prog, sched, vid, stores, rows))
            lines.append("    break;")
        lines.append("  default:")
        lines.append("    break;")
        lines.append("})")
    return lines


def _group_kernel(prog: MK.Program, group: int, mxu: bool) -> str:
    """The group form of a step kernel: ``group`` threads per lane in
    rank-major blocks of 32 lanes (csrc/group.cuh), the program run in the
    phases of group_schedule, its values in 16-bit shared-memory slots.
    With ``mxu`` every product is the 13-bit one (g_mul_mxu<rows>), each warp
    (one rank) making its DMMA products together, staged beside the slots in
    the program's MXU_GROUP_ROWS rows of C a pass."""
    sched = group_schedule(prog, group)
    rows = MXU_GROUP_ROWS[prog.name] if mxu else None
    name = f"{prog.name}_mxu_g{group}" if mxu else f"{prog.name}_g{group}"
    sig = _signature(prog)
    body = "\n".join("  " + ln for ln in _group_body(prog, sched, rows))
    words = sched.n_slots * F.N
    shared = words * 2 * 32
    counts = sig["counts"] + (" on the 13-bit plane" if mxu else "")
    size = f"({shared:,} bytes of shared memory per block of 32 lanes)"
    if mxu:
        size = (f"({shared:,} bytes of shared memory per block of 32 lanes, and\n"
                f"// sizeof(lh::MxuShared<{group}, {rows}>) of DMMA staging for its {group} warps)")
        prologue = f"""  LH_MXU_GROUP_SHARED({group}, {rows}, mxu_sm, uint16_t, slots, {words});
  const lh::MxuCtx mx = lh::mxu_setup(mxu_sm);"""
        extra = f"static_cast<int>(sizeof(lh::MxuShared<{group}, {rows}>)) + "
    else:
        prologue = f"  LH_GROUP_SHARED(uint16_t, slots, {words});"
        extra = ""
    return f"""
// {name}: {len(prog.ops)} limb ops, {counts};
// {group} threads per lane, {sched.n_rounds} rounds of products in {len(sched.phases)} phases, {sched.n_slots} slots
// {size}.
static __global__ void __launch_bounds__({group} * lh::kGroupLanes)
{name}_kernel({sig["params"]}) {{
{prologue}
  const int gl = lh::group_lane();
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
  uint16_t* const s = slots + lh::group_slot();
{body}
}}

extern "C" int lh_{name}({sig["c_args"]}, {sig["c_outs"]}, int n,
                              void* stream) {{
  constexpr int kShared = {extra}{words} * 2 * lh::kGroupLanes;
  static_assert(kShared <= {SHARED_LIMIT}, "one block's shared memory on sm_90");
  static const cudaError_t attr = cudaFuncSetAttribute(
      {name}_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n > 0) {{
    {name}_kernel<<<(n + lh::kGroupLanes - 1) / lh::kGroupLanes, {group} * lh::kGroupLanes,
                          kShared, static_cast<cudaStream_t>(stream)>>>(
        {sig["casts"]},
        {sig["out_casts"]}, n);
  }}
  return static_cast<int>(cudaGetLastError());
}}
"""


def miller_step_source() -> str:
    kernels = _kernel(MK.program("dbl"), group=MK.DBL_GROUP)
    kernels += _kernel(MK.program("add"), group=MK.ADD_GROUP)
    return (HEADER + _MILLER_DOC + _MILLER_HEAD + _GROUP_HELPERS + _GROUP_MUL + _END_HELPERS
            + kernels)


def miller_step_mxu_source() -> str:
    kernels = _kernel(MK.program("dbl"), mxu=True, group=MK.DBL_MXU_GROUP)
    kernels += _kernel(MK.program("add"), mxu=True, group=MK.ADD_MXU_GROUP)
    return (HEADER + _MILLER_MXU_DOC + _HEAD_MXU + _GROUP_HELPERS + _GROUP_MUL_MXU
            + _END_HELPERS + kernels)


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
