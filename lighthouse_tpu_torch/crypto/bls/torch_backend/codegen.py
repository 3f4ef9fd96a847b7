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
* ``csrc/wsm_step.cu``: kernel 6 (its G1 and G2 entry points), printed from
  the step programs of wsm_kernel.py in the form of wsm_kernel.FORMS: G2 in
  the group form, G1 in the cooperative form (``_coop_kernel``): 16 threads
  per lane make each product together, one after another (kernel 4's
  tiles), the linear ops riding in the products' phases
  (``coop_schedule``), the step run from a table of phases.

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

_WSM_HEAD = """// One thread per lane ran a step's products one after another, each a
// 1,703-multiply chain of one thread (1,378 for a square), with under one
// warp per SM at the path's 4,096 lanes.  Each curve now has the form that
// was the faster at that width (wsm_kernel.FORMS, PERF.md):
// * G2 (68 products) in the group form of miller_step.cu: G = 16 threads per
//   lane in blocks of 32 lanes run the products of a dependency level side
//   by side, 10 rounds of at most 16 products, each the unchanged
//   lh::mont_core of one thread; the linear ops between them are dealt to
//   the ranks, the values in 16-bit shared-memory slots (group_schedule).
// * G1 (17 products and 8 squares, in 8 rounds of at most 4: too few to
//   keep a group busy) in the cooperative form of kernel 4: 16 threads per
//   lane in blocks of 8 lanes make each product together, one after another
//   (csrc/mont_coop.cuh's tiles; the squares by the group triangle square,
//   as the reference squares G1 with _wide_square), the linear ops riding in
//   the products' phases (coop_schedule).
//
// Planes are (planes, 26, n) limb-major, so limb i of neighbouring lanes are
// neighbouring words and every load and store coalesces; each input plane
// is read once and each output plane written once.
#include "group.cuh"
#include "mont_coop.cuh"

namespace {

using lh::NL;

"""

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
    elif op.kind in ("mul", "add"):  # no program in the group form squares
        line = f"g_{op.kind}(s, {o}, {ins[0]}, {ins[1]});"
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


def _kernel(prog: MK.Program, group: int, mxu: bool = False) -> str:
    """A step program's kernel in the group form and its C launcher
    lh_<name>_g<G> (lh_<name>_mxu_g<G> with ``mxu``): ``group`` threads per
    lane in rank-major blocks of 32 lanes (csrc/group.cuh), the program run
    in the phases of group_schedule, its values in 16-bit shared-memory
    slots.
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
  const cudaError_t attr = lh::set_shared_limit({name}_kernel, kShared);
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



@dataclasses.dataclass(frozen=True)
class CoopSchedule:
    """A step program laid out for the cooperative form: 16 ranks per lane
    make each product together (mont_coop.cuh's tiles), one product after
    another, in five phases each (t or the square's triangle, m, u, the
    tail's sums, its carry into the output).

    ``phases[p]`` is (product value id or None, its stage 0-4, the linear
    ops of the phase in program order); phase 0 is the setup (inputs, pads,
    constants) and holds no op.  A product reads its operands in its stage 0
    and writes its output in stage 4; a linear op reads and writes in its
    phase.  ``slot`` gives every limb value its shared array, assigned by
    liveness over phases as in group_schedule."""

    phases: tuple
    slot: dict
    n_slots: int


COOP_STAGES = 5  # phases per product: t, m, u, the tail's sums, its carry
COOP_LIN_CAP = 4  # linear ops per phase, where the dependencies leave room


def coop_schedule(prog: MK.Program) -> CoopSchedule:
    """Products in the order that starts each the earliest (ties to the
    longest chain of products after it), each five phases after the last;
    the linear ops between them ride in the products' phases, first as
    early as their inputs allow (to fix when each product can start), then
    moved as late as their readers allow (to shorten what they hold), at
    most COOP_LIN_CAP a phase where the window leaves a choice.  Phases
    without a product are added only where a product waits on a chain of
    linear ops, and for the outputs' tails."""
    ops = prog.ops
    kind = {op.out: op.kind for op in ops}
    ins = {op.out: tuple(i for i in op.ins if kind[i] not in MK.FLAGS) for op in ops}
    limb = [op.out for op in ops if op.kind not in MK.FLAGS]
    consumers = collections.defaultdict(list)
    for v in limb:
        for i in ins[v]:
            consumers[i].append(v)
    height = {}
    for v in reversed(limb):
        height[v] = max((height[c] + (kind[c] in MK.PRODUCTS) for c in consumers[v]), default=0)
    start, done = {}, {}  # products' stage 0; every value's write phase
    asap = {}

    def ready(v):
        """v's write phase if it can be known without a product not yet placed."""
        if v in done:
            return done[v]
        if kind[v] in MK.PRODUCTS:
            return None
        if kind[v] == "in":
            done[v] = 0
            return 0
        deps = [ready(i) for i in ins[v]]
        if any(d is None for d in deps):
            return None
        asap[v] = done[v] = 1 + max(deps, default=0)
        return done[v]

    free_from = 1
    left = [v for v in limb if kind[v] in MK.PRODUCTS]
    while left:
        est = {}
        for v in left:
            deps = [ready(i) for i in ins[v]]
            if all(d is not None for d in deps):
                est[v] = max([free_from] + [d + 1 for d in deps])
        v = min(est, key=lambda v: (est[v], -height[v], v))
        start[v] = est[v]
        done[v] = est[v] + COOP_STAGES - 1
        free_from = done[v] + 1
        left.remove(v)
    for v in limb:
        ready(v)
    last = max(done.values())

    # as late as the readers allow: a linear op moves to the latest phase
    # before its first reader with room (a product reads in its stage 0;
    # an output, stored as it is written, stays in the window's last phase)
    outputs = {vid for _, _, vid in prog.outputs}
    place = dict(done)
    count = collections.Counter()
    for v in reversed(limb):
        if kind[v] in MK.PRODUCTS or kind[v] == "in":
            continue
        reads = [start[c] if kind[c] in MK.PRODUCTS else place[c] for c in consumers[v]]
        latest = min(reads) - 1 if reads else last
        lo = asap[v]
        assert lo <= latest, (v, lo, latest)
        roomy = [p for p in range(latest, lo - 1, -1) if count[p] < COOP_LIN_CAP]
        place[v] = latest if v in outputs or not roomy else roomy[0]
        count[place[v]] += 1

    phases = []
    by_phase = collections.defaultdict(list)
    for v in limb:
        if kind[v] not in MK.PRODUCTS and kind[v] != "in":
            by_phase[place[v]].append(v)
    for p in range(last + 1):
        prod = next(((v, p - s) for v, s in start.items() if s <= p < s + COOP_STAGES),
                    (None, None))
        phases.append((*prod, tuple(by_phase[p])))

    # slots by liveness over phases: a value holds its array from the phase
    # that writes it through the last phase that reads it (its own, for an
    # output: stored as it is written)
    read_at = {v: place[v] for v in limb}
    for v in limb:
        at = start[v] if kind[v] in MK.PRODUCTS else place[v]
        for i in ins[v]:
            read_at[i] = max(read_at[i], at)
    written = collections.defaultdict(list)
    freed = collections.defaultdict(list)
    for v in limb:
        written[place[v]].append(v)
        freed[read_at[v]].append(v)
    slot, free, n_slots = {}, [], 0
    for p in range(last + 1):
        for v in sorted(written[p]):
            if free:
                slot[v] = free.pop()
            else:
                slot[v] = n_slots
                n_slots += 1
        free.extend(sorted((slot[v] for v in freed[p]), reverse=True))
    return CoopSchedule(tuple(phases), slot, n_slots)


# The cooperative form's shape: ranks per lane and lanes per block
# (wsm_kernel.FORMS), and a lane's shared words besides its arrays (one
# product's work, lh::coop::kWorkWords: three column sums of 64 words, the
# carry maps, s = t + u).
COOP_RANKS, COOP_LANES = 16, 8
COOP_WORK = 3 * 64 + COOP_RANKS + 2 * F.N
_OPERAND_WORDS = 28  # an array: 26 limbs and two zero pads


def coop_shared_bytes(n_slots: int) -> int:
    """Shared memory of one block of the cooperative form (kCoopShared):
    its lanes' arrays and work, then P' and P."""
    return ((COOP_WORK + n_slots * _OPERAND_WORDS) * COOP_LANES + 2 * _OPERAND_WORDS) * 4


# The codes of a table row (coop_phase): word 0's stage, then linear ops.
COOP_STAGE = ("none", "t", "sqr", "m", "u", "sums", "carry")
COOP_LIN = ("none", "add", "sub", "neg", "sel", "one", "zero", "store")


def coop_pack(code: int, q: int = 0, o: int = 0, a: int = 0, b: int = 0) -> int:
    """A packed row word: bits 0-2 the code, 3-5 q (a bias row or a flag
    bit), then the arrays o, a, b in a byte each."""
    assert code < 8 and q < 8 and max(o, a, b) < 256
    return code | q << 3 | o << 8 | a << 16 | b << 24


_COOP_HELPERS = """
// The cooperative form (kernel 4's group, csrc/mont_coop.cuh): kCoopRanks
// threads per lane in blocks of kCoopLanes lanes make each product together,
// one after another, in five phases (t = a * b, or the triangle square; m;
// u = m * P; the tail's sums; its carry into the output), every operand a
// shared-memory array of 28 words (limbs 26 and 27 zero).  A step is a table
// of phases (codegen.coop_schedule): row p holds the product's stage and its
// arrays, then the linear ops that ride in the phase, each packed in 32 bits
// (coop_lin).  One loop over the rows runs the step, so the code holds one
// copy of each tile.
using lh::coop::Arena;
using lh::coop::Lane;
using lh::coop::NP;
using lh::coop::Work;

constexpr int kCoopRanks = COOP_RANKS;  // Shape<16>; the square's tiles need 16
constexpr int kCoopLanes = COOP_LANES;  // lanes per block
// Shared words per block for `Arrays` arrays a lane: the lanes' arrays and
// one product's work after them, then P' and P (28 words each).
template <int Arrays>
constexpr int kCoopShared =
    (Arrays * NP + lh::coop::kWorkWords<kCoopRanks>) * lh::kLanes<kCoopLanes> + 2 * NP;

// A phase's product stage (word 0 of a row): bits 0-2 the stage, bits 8-15,
// 16-23, 24-31 the arrays o, a, b.
enum : uint32_t { kStageNone, kStageT, kStageSqr, kStageM, kStageU, kStageSums, kStageCarry };
// A linear op: bits 0-2 the kind, bits 3-5 the bias row of lh::kBias (sub,
// neg) or the flag bit (sel), bits 8-15, 16-23, 24-31 the arrays o, a, b; a
// store writes array o to the output plane a.  0 ends a row.
enum : uint32_t { kLinNone, kLinAdd, kLinSub, kLinNeg, kLinSel, kLinOne, kLinZero, kLinStore };

// A lane's group: its arrays, one product's work, the block's P' and P.
struct Coop {
  Arena<kCoopLanes> ar;
  Work w;
  uint32_t* pp;
  __device__ __forceinline__ Lane arr(uint32_t j) const { return ar.arr(static_cast<int>(j)); }
};

// Rank r's share of the linear op `op`; `flags` holds the lane's flag bits.
__device__ __forceinline__ void coop_lin(int r, const Coop& c, uint32_t op, uint32_t flags,
                                         uint32_t* out, int n, int lane, bool live) {
  const Lane o = c.arr(op >> 8 & 255u), a = c.arr(op >> 16 & 255u), b = c.arr(op >> 24);
  const uint32_t q = op >> 3 & 7u;
  switch (op & 7u) {
    case kLinAdd:
      lh::coop::pass<kCoopRanks>(r, o, [&](int k) { return a(k) + b(k); });
      break;
    case kLinSub:  // a + kP - b (the bias dominates b limb by limb)
      lh::coop::pass<kCoopRanks>(r, o, [&](int k) { return a(k) + lh::kBias[q][k] - b(k); });
      break;
    case kLinNeg:  // kP - a
      lh::coop::pass<kCoopRanks>(r, o, [&](int k) { return lh::kBias[q][k] - a(k); });
      break;
    case kLinSel: {
      const Lane x = (flags >> q & 1u) ? a : b;
      for (int k = r; k < NL; k += kCoopRanks) o(k) = x(k);
      break;
    }
    case kLinOne:
      for (int k = r; k < NL; k += kCoopRanks) o(k) = lh::kOne[k];
      break;
    case kLinZero:
      for (int k = r; k < NL; k += kCoopRanks) o(k) = 0;
      break;
    case kLinStore:
      for (int k = r; k < NL; k += kCoopRanks)
        if (live) out[(static_cast<size_t>(op >> 16 & 255u) * NL + k) * n + lane] = o(k);
      break;
    default:
      break;
  }
}

// The setup phase, rank r's share: zero every array's pads, clear the column
// sums, fill P' and P.
__device__ __forceinline__ void coop_setup(int r, const Coop& c, int arrays) {
  for (int j = r; j < arrays; j += kCoopRanks) c.ar.arr(j)(NL) = c.ar.arr(j)(NL + 1) = 0;
  lh::coop::clear_sums<kCoopRanks>(r, c.w);
  lh::coop::fill_constants<kCoopRanks, kCoopLanes>(r, c.pp, c.pp + NP);
}

// Limbs r, r + 16 of plane `plane` of a (planes, 26, n) input into array j.
__device__ __forceinline__ void coop_load(int r, const Coop& c, int j, const uint32_t* in,
                                          int plane, int n, int lane) {
  for (int k = r; k < NL; k += kCoopRanks)
    c.ar.arr(j)(k) = in[(static_cast<size_t>(plane) * NL + k) * n + lane];
}

// Rank r's share of one phase (row: the product's stage, then up to K
// linear ops).
template <int K>
__device__ __forceinline__ void coop_phase(int r, const Coop& c, const uint32_t* row,
                                           uint32_t flags, uint32_t* out, int n, int lane,
                                           bool live) {
  const uint32_t pw = row[0];
  const Lane o = c.arr(pw >> 8 & 255u), a = c.arr(pw >> 16 & 255u), b = c.arr(pw >> 24);
  const Work& w = c.w;
  switch (pw & 7u) {
    case kStageT:
      lh::coop::t_tile<kCoopRanks>(r, a, b, w.tsums);
      break;
    case kStageSqr:
      lh::coop::sq_tile<kCoopRanks>(r, a, w.tsums);
      break;
    case kStageM:
      lh::coop::m_tile<kCoopRanks>(r, w.tsums, c.pp, w.msums);
      break;
    case kStageU:
      lh::coop::u_tile<kCoopRanks>(r, w.msums, c.pp + NP, w.usums);
      break;
    case kStageSums:
      lh::coop::tail_sums<kCoopRanks>(r, w.tsums, w.usums, w.s, w.cmap);
      break;
    case kStageCarry:  // the sums cleared for the next product beside the carry
      lh::coop::tail_carry<kCoopRanks>(r, w.s, w.cmap, o, true);
      lh::coop::clear_sums<kCoopRanks>(r, w);
      break;
    default:
      break;
  }
  for (int i = 1; i <= K && row[i]; ++i) coop_lin(r, c, row[i], flags, out, n, lane, live);
}
"""


def _coop_rows(prog: MK.Program, sched: CoopSchedule) -> tuple[list, int]:
    """The table rows of a cooperative step (phase 0, the setup, has none)
    and their width K of linear ops: word 0 the product's stage and arrays,
    then the phase's linear ops, each output's store after it."""
    flag_bit = {op.out: k for k, op in enumerate(o for o in prog.ops if o.kind in MK.FLAGS)}
    assert len(flag_bit) <= 8
    stores = {vid: plane for buf, plane, vid in prog.outputs if prog.ops[vid].kind not in MK.FLAGS}
    slot = sched.slot
    rows = []
    for vid, stage, lin in sched.phases[1:]:
        row = [0]
        if vid is not None:
            op = prog.ops[vid]
            name = (op.kind == "sqr" and "sqr" or "t") if stage == 0 else COOP_STAGE[stage + 2]
            row[0] = coop_pack(COOP_STAGE.index(name), 0, slot[vid], slot[op.ins[0]],
                               slot[op.ins[-1]])
        for v in lin:
            op = prog.ops[v]
            arrays = [slot[i] for i in op.ins if i in slot]
            q = 0
            if op.kind == "sel":
                q = flag_bit[op.ins[0]]
            elif op.kind in ("sub", "neg"):
                q = F.BIAS_KS.index(op.arg)
            row.append(coop_pack(COOP_LIN.index(op.kind), q, slot[v], *arrays))
            if v in stores:
                row.append(coop_pack(COOP_LIN.index("store"), 0, slot[v], stores[v]))
        rows.append(row)
    width = max(len(r) for r in rows) - 1
    return [r + [0] * (width + 1 - len(r)) for r in rows], width


def _coop_kernel(prog: MK.Program) -> str:
    """A step program's cooperative form and its launcher lh_<name>_coop:
    COOP_RANKS threads per lane in blocks of COOP_LANES lanes (kernel 4's
    group), the products made one after another by the whole group, the
    linear ops in their phases (coop_schedule), run from a table of
    phases."""
    sched = coop_schedule(prog)
    rows, width = _coop_rows(prog, sched)
    name = f"{prog.name}_coop"
    table = f"k{''.join(w.capitalize() for w in name.split('_'))}"
    sig = _signature(prog)
    limb_out = next(buf for buf, _, vid in prog.outputs if prog.ops[vid].kind not in MK.FLAGS)
    flags = [op for op in prog.ops if op.kind in MK.FLAGS]
    lines = []
    for op in flags:
        v = f"f{op.out}"
        if op.kind == "flag":
            lines.append(f"const uint32_t {v} = {op.arg}[lane];")
        elif op.kind == "and":
            lines.append(f"const uint32_t {v} = f{op.ins[0]} & f{op.ins[1]};")
        elif op.kind == "fsel":
            lines.append(f"const uint32_t {v} = f{op.ins[0]} != 0 ? f{op.ins[1]} : f{op.ins[2]};")
        else:
            raise AssertionError(op.kind)
    for buf, _, vid in prog.outputs:
        if prog.ops[vid].kind in MK.FLAGS:
            lines.append(f"if (live && lh::group_rank<kCoopLanes>() == 0) {buf}[lane] = f{vid};")
    bits = " | ".join(f"(f{op.out} != 0u) << {k}" for k, op in enumerate(flags))
    lines.append(f"const uint32_t flags = {bits};")
    loads = [f"coop_load(r, c, {sched.slot[op.out]}, {op.arg[0]}, {op.arg[1]}, n, lane);"
             for op in prog.ops if op.kind == "in"]
    body = "\n".join("  " + ln for ln in lines)
    load_body = "\n".join("        " + ln for ln in loads)
    table_rows = ",\n    ".join(_array(r) for r in rows)
    n_products = prog.n_mul + prog.n_sqr
    tails = len(rows) - COOP_STAGES * n_products
    return f"""
// {name}: {len(prog.ops)} limb ops, {sig["counts"]};
// {COOP_RANKS} threads per lane in blocks of {COOP_LANES} lanes, the products one after
// another in {len(rows) + 1} phases (the setup, {n_products} x {COOP_STAGES}, {tails} more for the
// outputs' tails), {sched.n_slots} arrays ({coop_shared_bytes(sched.n_slots):,} bytes of shared
// memory per block).
__constant__ uint32_t {table}[{len(rows)}][{width + 1}] = {{
    {table_rows}}};

static __global__ void __launch_bounds__(kCoopRanks * kCoopLanes)
{name}_kernel({sig["params"]}) {{
  LH_GROUP_SHARED(uint32_t, sm, kCoopShared<{sched.n_slots}>);
  const int gl = lh::group_lane<kCoopLanes>();
  const bool live = gl < n;
  const int lane = live ? gl : n - 1;
  const Arena<kCoopLanes> ar{{sm + lh::group_slot<kCoopLanes>()}};
  const Coop c{{ar, ar.work<kCoopRanks>({sched.n_slots} * NP),
               sm + kCoopShared<{sched.n_slots}> - 2 * NP}};
{body}
  LH_RANKS_OF(kCoopRanks, kCoopLanes, coop_setup(r, c, {sched.n_slots});
{load_body})
#pragma unroll 1
  for (int p = 0; p < {len(rows)}; ++p) {{
    LH_RANKS_OF(kCoopRanks, kCoopLanes,
                coop_phase<{width}>(r, c, {table}[p], flags, {limb_out}, n, lane, live))
  }}
}}

extern "C" int lh_{name}({sig["c_args"]}, {sig["c_outs"]}, int n,
                              void* stream) {{
  constexpr int kShared = kCoopShared<{sched.n_slots}> * 4;
  static_assert(kShared <= {SHARED_LIMIT}, "one block's shared memory on sm_90");
  const cudaError_t attr = lh::set_shared_limit({name}_kernel, kShared);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (n > 0) {{
    {name}_kernel<<<(n + kCoopLanes - 1) / kCoopLanes, kCoopRanks * kCoopLanes, kShared,
                          static_cast<cudaStream_t>(stream)>>>(
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
    kernels = ""
    for nc in (2, 1):
        kind, group, _ = WK.FORMS[nc]
        kernels += _kernel(WK.program(nc), group=group) if kind == "group" else _coop_kernel(
            WK.program(nc))
    helpers = (_COOP_HELPERS.replace("COOP_RANKS", str(COOP_RANKS))
               .replace("COOP_LANES", str(COOP_LANES)))
    return (HEADER + _WSM_DOC + _WSM_HEAD + _GROUP_HELPERS + _GROUP_MUL + helpers
            + _END_HELPERS + kernels)


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
