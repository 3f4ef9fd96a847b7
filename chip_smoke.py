#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the BLS batch-verification path on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  It drives the path under three arms: the default
(fused Miller steps; chains, fused scalar muls and MXU off, as on the TPU by
default), the chain-and-WSM arm (fp.set_chains(True), fp.set_wsm(True)) and
the mxu arm (chains + WSM + fp.set_mxu(True): every Montgomery product on
the 13-bit plane, kernel 7 and the MXU variants of kernels 2-5; the WSM
steps stay on the 15-bit core).  Phases, one JSON line each:

1. device: the card's name, power limit and max SM clock.
2. build: nvcc compiles csrc/*.cu (in parallel) into lighthouse_tpu_torch/_build/;
   ptxas's registers, stack, spills and shared memory of the group forms of
   kernels 1, 2, 3, 2m, 4 and 5, the one-thread kernels 3m, 4m and 5m, and
   the device functions the Miller steps call.
3. kernel checks: each hand-written kernel against its plain PyTorch version
   on the card, on seeded inputs at the Miller loop's width of 4,097 lanes
   (4,096 sets plus the (-G1, S) pair, a ragged edge for every block size),
   byte equality required: mont_mul and mont_mul_mxu on four corpora, and
   every form of mont_mul (mont_kernel.FORMS) also at 1, 2, G - 1, G + 1,
   L - 1, L + 1, 31 and 33 lanes (G threads per lane, L lanes per block);
   the Miller steps and their MXU variants on live pairing steps (random
   addition bits), and the group forms of kernels 2, 3 and 2m also at 1 and
   G + 1 lanes (G threads per lane); the Fp chain
   and its MXU variant at p-2 on strict and lazy bases; the Fp2 chain and
   its MXU variant at (p^2+7)/16; the 15-bit chains (the Fp chain in every
   form of chain_kernel.FP_FORMS, the Fp2 chain in FP2_FORM) also at 1, 2,
   G + 1, L - 1, L + 1 and 257 lanes; one
   G1 and one G2 WSM step on live points with random bits and infinity flags
   on either side.
4. reference: the device map-to-G2 on a few messages against the host
   hash_to_g2; the chains' outputs (both planes) on a few lanes against
   host pow and the oracle's Fp2.pow.
5. path, for each arm: TorchBackend(device="cuda", device_h2c=True)
   .verify_signature_sets on 4,096 signature sets (a tiled pool of seeded
   signed sets, with multi-key sets); True on the valid batch, False with
   one signature swapped for a valid signature of another message.  The
   valid verify's dispatch runs under torch's sync debug mode set to
   "error", so any host sync in the device program fails the run; launch
   counts come from each verify (Miller 63/63 in every arm; under the arm
   12 Fp chains, 4 Fp2 chains and 64 WSM steps per curve, none in the
   default arm; under the mxu arm the same counts on the MXU variants, the
   WSM steps on the 15-bit core, no 15-bit product and as many 13-bit
   products as the arm's 15-bit ones; WRAPPER_LAUNCHES in all).  The
   one-bad verify keeps copies of the kernels' operands (mont_mul and the
   chains: the first call at every width; the Miller
   steps: each step whose addition bit is set, and the last; the WSM
   steps: four bits), and each kernel is held byte for byte against its
   plain version on them (path_kernel_check).
6. kernel times, on the captured operands: CUDA events around runs of
   back-to-back launches, queued while the card sleeps so that the host's
   wrapper time stays out.  mont_mul at every width of the default path
   (mont_widths: calls x ms, its device time there), every form of it at
   the three widths with the most device time and at wider calls
   (mont_groups), and in the kernels line at the most-launched width with
   the three heaviest beside; mont_mul_mxu at the same width on the mxu
   arm's operands; the 15-bit chains at every width their arm launches, the
   Fp chain in every form and also at CHAIN_SWEEP widths between them
   (chain_forms, whose readings the kernels line reuses); the MXU chains at
   their arm's most-launched width; every other kernel on its arm's
   operands.
7. path_timing: verifies of the three arms interleaved (default, arm, mxu,
   mxu, arm, default), with marshal, dispatch and resolve times and peak
   memory for each arm.
8. profile: one more verify of each arm under torch.profiler, giving the
   kernel launches (DEVICE_KERNELS, counted from the runtime's launch
   records), every kernel the card ran and the share of the wall time the
   card was busy (a verify whose kernel records fall short of its launches,
   as when the profiler loses records, is profiled again, up to
   PROFILE_TRIES; if every try falls short, the busy time and share are
   null: the lost records carry time).

Then the kernels line, the nvidia-smi line and the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero before that line.
It exits non-zero, printing no result, without CUDA or outside a checkout.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time

N_SETS = 4096  # BASELINE.json configs[2]: 4096 unaggregated attestations
N_LANES = N_SETS + 1  # seeded-check width: the Miller loop's, sets + (-G1, S)
POOL = 64  # distinct signed sets, tiled to N_SETS
MULTI = 4  # of them: 16 signers on one message (host aggregation runs)
SEED = 20261016
TIME_WINDOWS = 5  # timing windows per function; the median is kept
KERNEL_LAUNCHES = 50  # back-to-back launches per window of a short kernel
LONG_LAUNCHES = 10  # ... of a kernel of a millisecond or more
PLAIN_LAUNCHES = 3  # back-to-back plain-version calls per window
SLEEP_CYCLES = 50_000_000  # ~25 ms at 1980 MHz: covers the host queueing a window
ARMS = ("default", "arm", "mxu")
TIMING_ORDER = ("default", "arm", "mxu", "mxu", "arm", "default")  # interleaved path verifies
WSM_KEEP = (0, 1, 32, 63)  # WSM step calls whose operands are kept
MONT_HEAVY = 3  # mont_mul widths of the default path timed: the most device time
# mont_mul widths beyond the path's, as multiples of the check width, where
# every form of kernel 1 is timed (where the one-thread form takes over)
MONT_WIDE = (4, 16, 64)
SWEEP_WINDOWS = 3  # timing windows per width in the mont_mul width sweep
# Fp-chain widths between the path's 1 and 4,096 where every form is timed
# (chain_kernel.form_for's crossover)
CHAIN_SWEEP = (16, 128, 512, 1024, 1536, 2048, 3072)
# launches per verify of 4,096 sets, by arm: the wrappers' counts in all, and
# the device kernels of the profiled verify
WRAPPER_LAUNCHES = {"default": 25_925, "arm": 7_465, "mxu": 7_465}
DEVICE_KERNELS = {"default": 303_366, "arm": 165_602, "mxu": 165_602}
PROFILE_TRIES = 3  # profiled verifies per arm at most, until one loses no kernel record
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
IMAD_PER_SM_CLK = 64  # 32-bit integer multiply-adds per SM per clock
# FP64 tensor-core multiply-adds per SM per clock: the H100 SXM data sheet's
# 67 TFLOP/s FP64 Tensor Core = 128 FMA x 2 x 132 SMs x 1,980 MHz
DMMA_FMA_PER_SM_CLK = 128

STEP_NAMES = ("miller_step_dbl", "miller_step_add")
WSM_NAMES = ("wsm_step_g1", "wsm_step_g2")
MXU_NAMES = ("mont_mul_mxu", "miller_step_dbl_mxu", "miller_step_add_mxu", "fp_chain_mxu",
             "fp2_chain_mxu")
KERNEL_NAMES = ("mont_mul",) + STEP_NAMES + ("fp_chain", "fp2_chain") + WSM_NAMES + MXU_NAMES


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, calls: int, queue_first: bool = False,
            windows: int = TIME_WINDOWS) -> float:
    """ms per call of fn() on the card: CUDA events around ``calls``
    back-to-back calls, divided by ``calls``; the median of ``windows``
    such windows, after a warm-up call.  With ``queue_first`` the card
    sleeps before the start event while the host queues every call, so a
    kernel shorter than its wrapper's host time is timed on the card alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queue_first:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def ptxas_report(log: str, names) -> dict:
    """{kernel or device function: {registers, stack, spill stores and loads,
    shared bytes}} from nvcc's -Xptxas -v output, for the functions whose
    (mangled) name contains one of ``names``."""
    import re

    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            current = next((nm for nm in names if nm in m.group(1)), None)
            if current:
                out.setdefault(current, {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[current].update(registers=int(m.group(1)),
                                smem=int(smem.group(1)) if smem else 0)
    return out


def _clone(args):
    return tuple(x.clone() if hasattr(x, "clone") else x for x in args)


def capture_kernel_operands(entry_points, mxu_active, keep_steps, run):
    """Run ``run()`` (one verify) with every kernel wrapper wrapped.  Every
    call goes through to the wrapper unchanged (and is counted there);
    clones of some operands are kept for the kernel-vs-plain check on the
    path's own shapes: mont_mul(_mxu) and the chains, the first call at each
    width (with the number of calls per width); the Miller steps, the calls
    in ``keep_steps``; the WSM steps, the calls in WSM_KEEP.
    ``entry_points`` lists (module, attribute, kernel name, number of
    operands, takes an mxu flag); a wrapper that takes the flag is named
    with "_mxu" when it runs its MXU variant (the flag, or ``mxu_active()``
    where the caller leaves it to the gate).  Returns (run's result, {name:
    {key: operands}}, {name: {width: calls}})."""
    ops = {name: {} for name in KERNEL_NAMES}
    widths = {name: {} for name in KERNEL_NAMES}
    seen = {name: 0 for name in KERNEL_NAMES}
    orig = {}

    def wrap(fn, base, n_ops, flagged):
        def wrapped(*args, **kw):
            operands = args[:n_ops]
            mxu = False
            if flagged:
                mxu = args[n_ops] if len(args) > n_ops else kw.get("mxu")
                if mxu is None:
                    mxu = mxu_active()
            name = base + "_mxu" if mxu else base
            n = operands[0].shape[-1]
            widths[name][n] = widths[name].get(n, 0) + 1
            if base in STEP_NAMES:
                if seen[name] in keep_steps:
                    ops[name][seen[name]] = _clone(operands)
            elif base in WSM_NAMES:
                if seen[name] in WSM_KEEP:
                    ops[name][seen[name]] = _clone(operands)
            elif n not in ops[name]:
                ops[name][n] = _clone(operands)
            seen[name] += 1
            return fn(*args, **kw)

        return wrapped

    for mod, attr, base, n_ops, flagged in entry_points:
        orig[(mod, attr)] = getattr(mod, attr)
        setattr(mod, attr, wrap(orig[(mod, attr)], base, n_ops, flagged))
    try:
        result = run()
    finally:
        for (mod, attr), fn in orig.items():
            setattr(mod, attr, fn)
    return result, ops, widths


def profile_verify(torch, bk, sets) -> dict:
    """One dispatch + resolve under torch.profiler (device activity only):
    the kernel launches the CUDA runtime recorded (device_kernels), the
    kernels the card ran (kernel_records: fewer when the profiler loses
    records of the card's side, which it can), their summed time, and the
    share of the verify's wall time in which the card was busy."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    mb = bk.marshal_sets(sets)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ok = bk.resolve(bk.dispatch(mb))
        wall_s = time.perf_counter() - t0
    if ok is not True:
        raise RuntimeError("the profiled verify returned False")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = sum(e.get("cat") == "cuda_runtime" and "LaunchKernel" in e["name"] for e in events)
    busy_us = sum(e["dur"] for e in kernels)
    by_name = {}
    for e in kernels:
        name = e["name"].replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].split("::")[-1][:60]
        count, us = by_name.get(name, (0, 0.0))
        by_name[name] = (count + 1, us + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_s": wall_s, "device_kernels": launches, "kernel_records": len(kernels),
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall_s if kernels else None,
            "top_kernels": [{"name": k, "launches": c, "s": us / 1e6} for k, (c, us) in top]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from lighthouse_tpu_torch.crypto.bls import api
        from lighthouse_tpu_torch.crypto.bls.curve import G1_GENERATOR, G2_GENERATOR
        from lighthouse_tpu_torch.crypto.bls.fields import Fp2 as OFp2
        from lighthouse_tpu_torch.crypto.bls.hash_to_curve import (
            hash_to_field_fp2, hash_to_g2)
        from lighthouse_tpu_torch.crypto.bls.torch_backend import (
            _build, backend, chain_kernel as CK, fp as F, h2c, miller_kernel as ML,
            mont_kernel as MK, mxu_kernel as X, points as P, tower as T, wsm_kernel as W)
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    rng = random.Random(SEED)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"phase": "device", "name": kind, "nvidia_smi": smi, "max_sm_clock_mhz": clock_mhz,
          "sms": sms, "torch": torch.__version__, "cuda": torch.version.cuda})
    imad_per_s = IMAD_PER_SM_CLK * sms * clock_mhz * 1e6
    dmma_fma_per_s = DMMA_FMA_PER_SM_CLK * sms * clock_mhz * 1e6

    # -- build ------------------------------------------------------------
    built = _build.build_all()
    emit({"phase": "build", "seconds": round(built["seconds"], 3), "built": built["built"],
          "dir": str(_build.build_dir().relative_to(_build.PKG_ROOT.parent)),
          "ptxas": built["ptxas"]})
    # the group forms of kernels 1, 2, 3, 2m, 4 and 5, kernels 3m, 4m and 5m,
    # and the device functions the Miller steps call
    group_fns = {"mont": tuple(f"mont_mul_group_kernelILi{g}ELi{lanes}E"
                               for g, lanes in MK.FORMS if g > 1) + ("mont_mul_kernel",),
                 "miller_step": (f"miller_step_dbl_g{ML.DBL_GROUP}_kernel",
                                 f"miller_step_add_g{ML.ADD_GROUP}_kernel",
                                 "g_mul", "g_add", "g_sub"),
                 "miller_step_mxu": (f"miller_step_dbl_mxu_g{ML.DBL_MXU_GROUP}_kernel",
                                     "miller_step_add_mxu_kernel", "g_mul_mxu", "k_mul",
                                     "g_add", "g_sub"),
                 "chain": tuple(f"fp_chain_group_kernelILi{lanes}E" for _, lanes in CK.FP_FORMS)
                 + (f"fp2_chain_group_kernelILi{CK.FP2_FORM[1]}E",
                    "fp_chain_mxu_kernel", "fp2_chain_mxu_kernel")}
    emit({"phase": "ptxas", **{lib: ptxas_report((_build.build_dir() / f"{lib}.log").read_text(),
                                                 names) for lib, names in group_fns.items()}})

    # -- kernel checks ----------------------------------------------------
    def rand_ints(n, k=1):
        return [rng.randrange(k * F.P_INT) for _ in range(n)]

    def rand_limbs(n, k=1):
        return torch.as_tensor(F.ints_to_limbs(rand_ints(n, k))).to(dev)

    def bound_ms(bytes_moved, imads, dmma_fmas=0):
        """The larger of the bytes' time at the memory rate and the
        operations' time: the integer multiply-adds at the IMAD rate and the
        FP64 tensor-core multiply-adds at the DMMA rate, on their own pipes
        (so the larger of the two)."""
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = max(imads / imad_per_s, dmma_fmas / dmma_fma_per_s) * 1e3
        return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")

    def max_abs_err(got, ref):
        return max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))

    # equal and max_abs_err per kernel, over the seeded and the path checks
    checked = {name: {"equal": True, "max_abs_err": 0} for name in KERNEL_NAMES}
    # name: (kernel wrapper, plain version)
    funcs = {"mont_mul": (lambda *a: [MK.mont_mul(*a)], lambda *a: [MK.mont_mul_plain(*a)]),
             "wsm_step_g1": (W.wsm_step_g1, W.wsm_step_g1_plain),
             "wsm_step_g2": (W.wsm_step_g2, W.wsm_step_g2_plain),
             "mont_mul_mxu": (lambda *a: [X.mont_mul_mxu(*a)],
                              lambda *a: [X.mont_mul_mxu_plain(*a)])}
    for mxu in (False, True):
        sfx = "_mxu" if mxu else ""
        funcs.update({
            "miller_step_dbl" + sfx: (
                lambda *a, m=mxu: ML.miller_step_dbl(*a, mxu=m),
                lambda *a, m=mxu: ML.miller_step_dbl_plain(*a, mxu=m)),
            "miller_step_add" + sfx: (
                lambda *a, m=mxu: ML.miller_step_add(*a, mxu=m),
                lambda *a, m=mxu: ML.miller_step_add_plain(*a, mxu=m)),
            "fp_chain" + sfx: (lambda *a, m=mxu: [CK.pow_chain(*a, mxu=m)],
                               lambda *a, m=mxu: [CK.pow_chain_plain(*a, mxu=m)]),
            "fp2_chain" + sfx: (lambda *a, m=mxu: CK.fp2_pow_chain(*a, mxu=m),
                                lambda *a, m=mxu: CK.fp2_pow_chain_plain(*a, mxu=m))})

    def hold(name, args, kern=None):
        """Byte equality of a kernel's outputs (through ``kern`` when given,
        else its wrapper) with its plain version's on the same operands;
        returns (equal, the kernel's outputs)."""
        wrapper, plain = funcs[name]
        got, ref = (kern or wrapper)(*args), plain(*args)
        torch.cuda.synchronize()
        eq = all(bool(torch.equal(g, r)) for g, r in zip(got, ref))
        checked[name]["equal"] &= eq
        checked[name]["max_abs_err"] = max(checked[name]["max_abs_err"], max_abs_err(got, ref))
        return eq, got

    n = N_LANES
    a_ints, b_ints = rand_ints(n), rand_ints(n)
    a = F.LFp(torch.as_tensor(F.encode_mont(a_ints)).to(dev), 1.0)
    b = F.LFp(torch.as_tensor(F.encode_mont(b_ints)).to(dev), 1.0)
    s, t = F.fp_add(a, a), F.fp_sub(b, a)
    corpora = {
        "strict": (a.limbs, b.limbs),
        "lazy_add_sub": (s.limbs, t.limbs),
        "lazy_sub_neg": (t.limbs, F.fp_neg(t).limbs),
        "all_qmax": (torch.full((F.N, n), F.QMAX, dtype=F.DTYPE, device=dev),) * 2,
    }
    for kernel in ("mont_mul", "mont_mul_mxu"):
        for name, (x, y) in corpora.items():
            eq, _ = hold(kernel, (x.contiguous(), y.contiguous()))
            emit({"phase": "kernel_check", "kernel": kernel, "corpus": name, "n": n,
                  "equal": eq})

    # every form of kernel 1 at widths around its group size and its block
    # (ragged tails) and the check width
    for form in MK.FORMS:
        g, lanes = form
        widths = sorted({1, 2, max(g - 1, 1), g + 1, lanes - 1, lanes + 1, 31, 33, n})
        eqs = [hold("mont_mul", (x[:, :w].contiguous(), y[:, :w].contiguous()),
                    lambda x, y, form=form: [MK.mont_mul(x, y, form=form)])[0]
               for w in widths for x, y in corpora.values()]
        emit({"phase": "kernel_check", "kernel": "mont_mul", "form": form,
              "corpora": len(corpora), "widths": widths, "equal": all(eqs)})

    # Miller-step and WSM-step inputs from live points: n distinct
    # [r]G1 and [s]G2 made on the card, then two dbl+add Miller steps.
    def gen_points(ops, gen_aff, encode):
        base = encode([gen_aff] * n, dev)
        bits = torch.tensor([[rng.getrandbits(1) for _ in range(n)] for _ in range(64)],
                            dtype=F.DTYPE, device=dev)
        bits[0] = 1
        jac = P.scalar_mul_bits(ops, P.from_affine(ops, base), bits)
        return jac, P.to_affine(ops, jac, F.fp_inv if ops is P.FP_OPS else T.fp2_inv)

    p_jac, p_aff = gen_points(P.FP_OPS, G1_GENERATOR, P.g1_encode)
    q_jac, q_aff = gen_points(P.FP2_OPS, G2_GENERATOR, P.g2_encode)

    def flat(c):
        return F.fp_reduce(c).limbs.contiguous()

    xp, yp = flat(p_aff[0]), flat(p_aff[1])
    q = torch.stack([flat(q_aff[0][0]), flat(q_aff[0][1]), flat(q_aff[1][0]), flat(q_aff[1][1])])
    one = F.const("ONE", xp).expand(F.N, n)
    f = torch.zeros((12, F.N, n), dtype=F.DTYPE, device=dev)
    f[0] = one
    tpt = torch.cat([q, torch.zeros_like(q[:2])])
    tpt[4] = one
    ones = torch.ones((n,), dtype=F.DTYPE, device=dev)
    for _ in range(2):
        f, tpt = ML.miller_step_dbl(f, tpt, xp, yp)
        f, tpt = ML.miller_step_add(f, tpt, q, xp, yp, ones)
    bit = torch.tensor([rng.getrandbits(1) for _ in range(n)], dtype=F.DTYPE, device=dev)
    for sfx in ("", "_mxu"):
        for name, args in (("miller_step_dbl" + sfx, (f, tpt, xp, yp)),
                           ("miller_step_add" + sfx, (f, tpt, q, xp, yp, bit))):
            eq, _ = hold(name, args)
            emit({"phase": "kernel_check", "kernel": name, "corpus": "pairing_steps", "n": n,
                  "equal": eq})

    # the Miller steps' group forms at 1 and G + 1 lanes (a ragged block of
    # 32)
    def cut(w, *planes):
        return tuple(x[..., :w].contiguous() for x in planes)

    for name, g, planes in (("miller_step_dbl", ML.DBL_GROUP, (f, tpt, xp, yp)),
                            ("miller_step_dbl_mxu", ML.DBL_MXU_GROUP, (f, tpt, xp, yp)),
                            ("miller_step_add", ML.ADD_GROUP, (f, tpt, q, xp, yp, bit))):
        widths = [1, g + 1]
        eqs = [hold(name, cut(w, *planes))[0] for w in widths]
        emit({"phase": "kernel_check", "kernel": name, "group": g, "corpus": "pairing_steps",
              "widths": widths, "equal": all(eqs)})

    # The chains: p-2 on strict and lazy (bound 4, inside the 4.3 P
    # contract) bases; (p^2+7)/16 on reduced Fp2 elements.
    lazy = F.fp_add(F.fp_add(t, a), F.LFp(torch.zeros_like(a.limbs), 0.0))
    chain_out, fp2_out = {}, {}
    for sfx in ("", "_mxu"):
        for name, base in (("strict", a.limbs), ("lazy_bound4", lazy.limbs.contiguous())):
            eq, got = hold("fp_chain" + sfx, (base, F.P_INT - 2))
            chain_out[name + sfx] = got[0]
            emit({"phase": "kernel_check", "kernel": "fp_chain" + sfx, "corpus": name, "n": n,
                  "exponent": "p-2", "equal": eq})
        eq, fp2_out[sfx] = hold("fp2_chain" + sfx, (a.limbs, b.limbs, h2c.SQRT_EXP_BITS))
        emit({"phase": "kernel_check", "kernel": "fp2_chain" + sfx, "corpus": "strict", "n": n,
              "exponent": "(p^2+7)/16", "equal": eq})
    # the 15-bit chains in each form at widths around its group size and its
    # block (ragged tails)
    def ragged(form):
        g, lanes = form
        return sorted({1, 2, g + 1, lanes - 1, lanes + 1, 257})

    for form in CK.FP_FORMS:
        eqs = [hold("fp_chain", (base[:, :w].contiguous(), F.P_INT - 2),
                    lambda *x, f=form: [CK.pow_chain(*x, mxu=False, form=f)])[0]
               for w in ragged(form) for base in (a.limbs, lazy.limbs)]
        emit({"phase": "kernel_check", "kernel": "fp_chain", "form": form,
              "corpora": ["strict", "lazy_bound4"], "widths": ragged(form), "equal": all(eqs)})
    eqs = [hold("fp2_chain", (*cut(w, a.limbs, b.limbs), h2c.SQRT_EXP_BITS),
                lambda *x: CK.fp2_pow_chain(*x, mxu=False))[0] for w in ragged(CK.FP2_FORM)]
    emit({"phase": "kernel_check", "kernel": "fp2_chain", "form": CK.FP2_FORM,
          "corpora": ["strict"], "widths": ragged(CK.FP2_FORM), "equal": all(eqs)})

    # One WSM step per curve on live points: the acc a reduced Jacobian
    # multiple of the generator, the base another lane's affine multiple;
    # random bits, and infinity flags set on about one lane in four on each
    # side, so every (acc flag, base flag) state occurs.
    def flags(p_one):
        return torch.tensor([[int(rng.random() < p_one) for _ in range(n)]], dtype=F.DTYPE,
                            device=dev)

    for name, ops, jac, aff in (("wsm_step_g1", P.FP_OPS, p_jac, p_aff),
                                ("wsm_step_g2", P.FP2_OPS, q_jac, q_aff)):
        acc = torch.stack([flat(lane) for c in jac[:3] for lane in ops.lanes(c)])
        base = torch.stack([flat(lane) for c in aff for lane in ops.lanes(c)]).roll(1, -1)
        args = (acc, flags(0.25), base.contiguous(), flags(0.25), flags(0.5))
        eq, _ = hold(name, args)
        emit({"phase": "kernel_check", "kernel": name, "corpus": "live_points_flags", "n": n,
              "equal": eq})
    if not all(c["equal"] for c in checked.values()):
        emit({"phase": "kernel_check", "error": "a kernel disagrees with its plain version"})
        return 1

    # -- reference --------------------------------------------------------
    msgs = [bytes([i]) * 32 for i in range(4)]
    us = [hash_to_field_fp2(m, 2) for m in msgs]
    h_aff = h2c.map_to_g2(T.fp2_encode([u[0] for u in us], dev),
                          T.fp2_encode([u[1] for u in us], dev))
    got = list(zip(T.fp2_decode(h_aff[0]), T.fp2_decode(h_aff[1])))
    ref_ok = got == [hash_to_g2(m) for m in msgs]
    emit({"phase": "reference", "check": "map_to_g2 vs host hash_to_g2", "n": len(msgs),
          "equal": ref_ok})
    k = 4
    lazy_ints = F.decode_mont(lazy.limbs[:, :k])
    want2 = [OFp2(x, y).pow(h2c.SQRT_EXP) for x, y in zip(a_ints[:k], b_ints[:k])]
    chains_ok = True
    for sfx in ("", "_mxu"):
        fp_ok = (F.decode_mont(chain_out["strict" + sfx][:, :k])
                 == [pow(v, F.P_INT - 2, F.P_INT) for v in a_ints[:k]]
                 and F.decode_mont(chain_out["lazy_bound4" + sfx][:, :k])
                 == [pow(v, F.P_INT - 2, F.P_INT) for v in lazy_ints])
        emit({"phase": "reference", "check": f"fp_chain{sfx} vs host pow(x, p-2, p)", "n": k,
              "equal": fp_ok})
        out0, out1 = fp2_out[sfx]
        got2 = [(x % F.P_INT, y % F.P_INT) for x, y in zip(F.decode_mont(out0[:, :k]),
                                                          F.decode_mont(out1[:, :k]))]
        fp2_ok = got2 == [(w.c0, w.c1) for w in want2]
        emit({"phase": "reference", "check": f"fp2_chain{sfx} vs oracle Fp2.pow((p^2+7)/16)",
              "n": k, "equal": fp2_ok})
        chains_ok = chains_ok and fp_ok and fp2_ok
    if not (ref_ok and chains_ok):
        return 1

    # -- path, under every arm ---------------------------------------------
    t0 = time.perf_counter()
    pool = []
    for i in range(POOL):
        msg = rng.randbytes(32)
        if i < MULTI:
            sks = [api.SecretKey(rng.randrange(1, api.params.R)) for _ in range(16)]
            agg_sk = api.SecretKey(sum(sk.int_value for sk in sks) % api.params.R)
            pool.append(api.SignatureSet(agg_sk.sign(msg), [sk.public_key() for sk in sks], msg))
        else:
            sk = api.SecretKey(rng.randrange(1, api.params.R))
            pool.append(api.SignatureSet(sk.sign(msg), [sk.public_key()], msg))
    sets = [pool[i % POOL] for i in range(N_SETS)]
    other = api.SecretKey(rng.randrange(1, api.params.R))
    bad = list(sets)
    bad[N_SETS // 2 + 7] = api.SignatureSet(
        other.sign(b"another message"), [other.public_key()], sets[N_SETS // 2 + 7].message)
    emit({"phase": "path_setup", "sets": N_SETS, "distinct": POOL, "multi_key_sets": MULTI,
          "signers_per_multi_key_set": 16, "seconds": round(time.perf_counter() - t0, 3)})

    def set_arm(arm: str) -> None:
        F.set_chains(arm != "default")
        F.set_wsm(arm != "default")
        F.set_mxu(arm == "mxu")

    # (module, wrapper, kernel name, operands, takes an mxu flag)
    entry_points = [(MK, "mont_mul", "mont_mul", 2, False),
                    (X, "mont_mul_mxu", "mont_mul_mxu", 2, False),
                    (ML, "miller_step_dbl", "miller_step_dbl", 4, True),
                    (ML, "miller_step_add", "miller_step_add", 6, True),
                    (CK, "pow_chain", "fp_chain", 2, True),
                    (CK, "fp2_pow_chain", "fp2_chain", 3, True),
                    (W, "wsm_step_g1", "wsm_step_g1", 5, False),
                    (W, "wsm_step_g2", "wsm_step_g2", 5, False)]
    keep_steps = ({i for i, b in enumerate(ML.X_BITS[1:]) if b} | {len(ML.X_BITS) - 2})
    zero = {name: 0 for name in KERNEL_NAMES}
    chains = {"fp_chain": 12, "fp2_chain": 4, "wsm_step_g1": 64, "wsm_step_g2": 64}
    want_counts = {
        "default": {**zero, "miller_step_dbl": 63, "miller_step_add": 63},
        "arm": {**zero, "miller_step_dbl": 63, "miller_step_add": 63, **chains},
        "mxu": {**zero, "miller_step_dbl_mxu": 63, "miller_step_add_mxu": 63,
                "fp_chain_mxu": 12, "fp2_chain_mxu": 4, "wsm_step_g1": 64, "wsm_step_g2": 64},
    }
    products = {"default": "mont_mul", "arm": "mont_mul", "mxu": "mont_mul_mxu"}
    bk = backend.TorchBackend(device="cuda", device_h2c=True)
    counts, path_ops, path_widths = {}, {}, {}
    for arm in ARMS:
        set_arm(arm)
        backend.reset_launch_counts()
        mb = bk.marshal_sets(sets)
        torch.cuda.set_sync_debug_mode("error")  # dispatch may only enqueue
        try:
            handle = bk.dispatch(mb)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        verdict = bk.resolve(handle)
        counts[arm] = backend.launch_counts()
        backend.reset_launch_counts()
        bad_verdict, path_ops[arm], path_widths[arm] = capture_kernel_operands(
            entry_points, F.mxu_active, keep_steps, lambda: bk.verify_signature_sets(bad))
        bad_counts = backend.launch_counts()
        emit({"phase": "path", "arm": arm, "verdict_valid": verdict,
              "verdict_one_bad": bad_verdict, "launches_per_verify": counts[arm],
              "launches_one_bad": bad_counts,
              "launches_per_verify_total": sum(counts[arm].values())})
        if not (verdict is True and bad_verdict is False):
            return 1
        if sum(counts[arm].values()) != WRAPPER_LAUNCHES[arm]:
            emit({"phase": "path", "arm": arm, "error": "unexpected wrapper launches per verify",
                  "want": WRAPPER_LAUNCHES[arm]})
            return 1
        for c in (counts[arm], bad_counts):
            prod = products[arm]
            if c[prod] <= 0 or any(c[k] != v for k, v in want_counts[arm].items() if k != prod):
                emit({"phase": "path", "arm": arm, "error": "unexpected launch counts",
                      "want": want_counts[arm]})
                return 1
    # the mxu arm runs the arm's path with every product on the 13-bit plane
    if counts["mxu"]["mont_mul_mxu"] != counts["arm"]["mont_mul"]:
        emit({"phase": "path", "error": "the mxu arm's 13-bit products differ in number from "
              "the arm's 15-bit products", "mxu": counts["mxu"]["mont_mul_mxu"],
              "arm": counts["arm"]["mont_mul"]})
        return 1

    # -- the kernels on the path's own operands ----------------------------
    with torch.inference_mode():
        for arm in ARMS:
            for name in KERNEL_NAMES:
                kept = path_ops[arm][name]
                if not kept:
                    continue
                eqs = [hold(name, args)[0] for args in kept.values()]
                emit({"phase": "path_kernel_check", "arm": arm, "kernel": name,
                      "kept": sorted(kept), "calls_by_width": dict(sorted(
                          path_widths[arm][name].items())), "equal": all(eqs)})
        if not all(c["equal"] for c in checked.values()):
            emit({"phase": "path_kernel_check",
                  "error": "a kernel disagrees with its plain version on the path's operands"})
            return 1

        # -- kernel times on their arm's operands --------------------------
        kernels = {}

        def record(name, args, source, replaces, bytes_moved, imads, long, dmma_fmas=0,
                   ms=None, **extra):
            """The kernels line's row of ``name`` on ``args``; ``ms`` is a
            reading taken in this run on the same args, else timed here."""
            kern, plain = funcs[name]
            bms, by = bound_ms(bytes_moved, imads, dmma_fmas)
            if ms is None:
                ms = time_ms(torch, lambda: kern(*args),
                             LONG_LAUNCHES if long else KERNEL_LAUNCHES, queue_first=True)
            kernels[name] = {
                "route": "cuda", "source": f"lighthouse_tpu_torch/csrc/{source}",
                "replaces": f"lighthouse_tpu/crypto/bls/jax_backend/{replaces}",
                **checked[name], "n": args[0].shape[-1], **extra, "ms": ms,
                "plain_ms": (time_ms(torch, lambda: plain(*args), 1, windows=3) if long
                             else time_ms(torch, lambda: plain(*args), PLAIN_LAUNCHES)),
                "bound_ms": bms, "bound_by": by, "library_ms": None}

        plane = F.N * 4  # bytes of one (26,) limb column
        # mont_mul on the default path, width by width: calls x ms is its
        # device time there; the widths with the most are timed in every
        # form of kernel 1, and so are wider calls, where the one-thread
        # form takes over (MK.form_for)
        mont_widths = path_widths["default"]["mont_mul"]
        mont_ops = path_ops["default"]["mont_mul"]
        sweep = {w: time_ms(torch, lambda a=mont_ops[w]: MK.mont_mul(*a), KERNEL_LAUNCHES,
                            queue_first=True, windows=SWEEP_WINDOWS) for w in mont_widths}
        by_time = sorted(mont_widths, key=lambda w: -mont_widths[w] * sweep[w])
        emit({"phase": "mont_widths", "arm": "default", "card": smi,
              "calls": sum(mont_widths.values()), "widths": len(mont_widths),
              "device_s": sum(c * sweep[w] for w, c in mont_widths.items()) / 1e3,
              "top": [{"n": w, "calls": mont_widths[w], "ms": sweep[w],
                       "device_s": mont_widths[w] * sweep[w] / 1e3, "form": MK.form_for(w)}
                      for w in by_time[:20]]})
        heavy = by_time[:MONT_HEAVY]
        forms = {w: mont_ops[w] for w in heavy}
        sx, sy = corpora["strict"]
        for k in MONT_WIDE:
            forms[k * n] = (sx.repeat(1, k).contiguous(), sy.repeat(1, k).contiguous())
        emit({"phase": "mont_groups", "card": smi, "ms": {
            w: {"x".join(map(str, f)): time_ms(torch, lambda f=f, a=args: MK.mont_mul(*a, form=f),
                                               KERNEL_LAUNCHES, queue_first=True,
                                               windows=SWEEP_WINDOWS) for f in MK.FORMS}
            for w, args in forms.items()}, "form_for": {w: MK.form_for(w) for w in forms}})
        del forms
        # mont_mul at the default path's most-launched width (the arm's is a
        # 2-lane call), with its heaviest widths beside; mont_mul_mxu at the
        # same width on the mxu arm's operands
        n_mont = max(mont_widths, key=mont_widths.get)
        record("mont_mul", mont_ops[n_mont], "mont.cu",
               "pallas_fp.py:141", 3 * plane * n_mont, MK.IMAD_PER_LANE * n_mont, False,
               form=MK.form_for(n_mont),
               heaviest_widths=[{"n": w, "calls": mont_widths[w], "ms": sweep[w],
                                 "bound_ms": bound_ms(3 * plane * w, MK.IMAD_PER_LANE * w)[0],
                                 "form": MK.form_for(w)} for w in heavy])
        mxu_ops = path_ops["mxu"]["mont_mul_mxu"]
        n_mxu = n_mont if n_mont in mxu_ops else max(mxu_ops)
        record("mont_mul_mxu", mxu_ops[n_mxu], "mxu.cu", "pallas_mxu.py:161",
               3 * plane * n_mxu, X.IMAD_PER_LANE * n_mxu, False,
               dmma_fmas=X.DMMA_FMA_PER_LANE * n_mxu)
        # the 15-bit chains at every width the arm launches: the Fp chain in
        # every form, there and at CHAIN_SWEEP widths cut from the arm's
        # widest operands (where form_for's crossover is read); the Fp2
        # chain in its one form
        def form_key(form):
            return "x".join(map(str, form))

        fp_ops = dict(path_ops["arm"]["fp_chain"])
        widest = fp_ops[max(fp_ops)]
        for w in CHAIN_SWEEP:
            if w < widest[0].shape[-1] and w not in fp_ops:
                fp_ops[w] = (widest[0][:, :w].contiguous(), *widest[1:])
        chain_ms = {"fp_chain": {
            w: {form_key(f): time_ms(torch, lambda f=f, a=args: CK.pow_chain(*a, mxu=False, form=f),
                                     LONG_LAUNCHES, queue_first=True) for f in CK.FP_FORMS}
            for w, args in sorted(fp_ops.items())}}
        chain_ms["fp2_chain"] = {
            w: {form_key(CK.FP2_FORM): time_ms(
                torch, lambda a=args: CK.fp2_pow_chain(*a, mxu=False), LONG_LAUNCHES,
                queue_first=True)} for w, args in sorted(path_ops["arm"]["fp2_chain"].items())}
        emit({"phase": "chain_forms", "card": smi, "ms": chain_ms,
              "calls_by_width": {name: path_widths["arm"][name] for name in chain_ms},
              "fastest": {w: min(t, key=t.get) for w, t in chain_ms["fp_chain"].items()},
              "form_for": {w: CK.form_for(w) for w in chain_ms["fp_chain"]}})
        del fp_ops, widest
        for arm, sfx, source in (("arm", "", "miller_step.cu"),
                                 ("mxu", "_mxu", "miller_step_mxu.cu")):
            ops = path_ops[arm]
            for step, planes_in, line in (("dbl", 20, 423), ("add", 24, 449)):
                name = f"miller_step_{step}{sfx}"
                call = [c for c in sorted(ops[name]) if ML.X_BITS[1 + c]][-1]
                args = ops[name][call]
                n_step = args[0].shape[-1]
                n_mul = ML.program(step).n_mul * n_step
                imad = X.IMAD_PER_LANE if sfx else MK.IMAD_PER_LANE
                # f, T (, Q), xp, yp planes read and f, T written; the add step's bit
                record(name, args, source, f"pallas_miller.py:{line}",
                       (planes_in + 18) * plane * n_step + (4 * n_step if step == "add" else 0),
                       n_mul * imad, True, dmma_fmas=n_mul * X.DMMA_FMA_PER_LANE if sfx else 0,
                       step=call, group=ML.group_of(step, bool(sfx)))
            for field, line, planes in (("fp", 181, 2), ("fp2", 278, 4)):
                name = f"{field}_chain{sfx}"
                widths = path_widths[arm][name]
                n_ch = max(widths, key=widths.get)
                args = ops[name][n_ch]
                bits = bin(args[1])[2:] if field == "fp" else "".join(map(str, args[2]))
                nd = len(CK.window_digits(bits))
                c = CK.products_per_lane(nd)[field]

                def work(w, field=field, planes=planes, nd=nd, c=c, sfx=sfx):
                    """(bytes, 32-bit multiplies, DMMA multiply-adds) of a w-lane call"""
                    return (planes * plane * w + 4 * nd,
                            CK.imads_per_lane(field, nd, bool(sfx)) * w,
                            (c["mul"] + c["sqr"]) * X.DMMA_FMA_PER_LANE * w if sfx else 0)

                def form(w, field=field):
                    return CK.form_for(w) if field == "fp" else CK.FP2_FORM

                extra = ({"group": 1, "form": (1, 32)} if sfx else
                         {"group": form(n_ch)[0], "form": form(n_ch),
                          "ms": chain_ms[name][n_ch][form_key(form(n_ch))],
                          "by_width": [{"n": w, "calls": widths[w],
                                        "ms": chain_ms[name][w][form_key(form(w))],
                                        "bound_ms": bound_ms(*work(w))[0],
                                        "form": form(w)} for w in sorted(widths)]})
                nbytes, imads, fmas = work(n_ch)
                record(name, args, "chain.cu", f"pallas_fp.py:{line}", nbytes, imads, True,
                       dmma_fmas=fmas, digits=nd, **extra)
        ops = path_ops["arm"]
        for name, nc in (("wsm_step_g1", 1), ("wsm_step_g2", 2)):
            call = max(ops[name])
            args = ops[name][call]
            n_w = args[0].shape[-1]
            prog = W.program(nc)
            record(name, args, "wsm_step.cu", "pallas_wsm.py:172",
                   8 * nc * plane * n_w + 4 * 4 * n_w,
                   (prog.n_mul * MK.IMAD_PER_LANE + prog.n_sqr * MK.SQR_IMAD_PER_LANE) * n_w,
                   False, step=call)
    del path_ops, ops, mxu_ops

    # -- path timing, the arms interleaved ---------------------------------
    timings = {arm: [] for arm in ARMS}
    peak = {arm: 0 for arm in ARMS}
    for arm in TIMING_ORDER:
        set_arm(arm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mb = bk.marshal_sets(sets)
        t1 = time.perf_counter()
        handle = bk.dispatch(mb)
        t2 = time.perf_counter()
        ok = bk.resolve(handle)
        t3 = time.perf_counter()
        if ok is not True:
            return 1
        timings[arm].append((t1 - t0, t2 - t1, t3 - t2))
        peak[arm] = max(peak[arm], torch.cuda.max_memory_allocated())
    for arm in ARMS:
        med = [statistics.median(c) for c in zip(*timings[arm])]
        emit({"phase": "path_timing", "arm": arm, "sets": N_SETS, "order": TIMING_ORDER,
              "reps": len(timings[arm]), "marshal_s": med[0], "dispatch_s": med[1],
              "resolve_s": med[2], "sets_per_s": N_SETS / sum(med),
              "device_sets_per_s": N_SETS / (med[1] + med[2]),
              "sets_per_s_each": [N_SETS / sum(r) for r in timings[arm]],
              "dispatch_s_each": [r[1] for r in timings[arm]],
              "launches_per_verify": sum(counts[arm].values()),
              "card": smi, "peak_mem_gib": peak[arm] / 2**30})
    for arm in ARMS:
        set_arm(arm)
        # the profiler can lose records of the card's side (kernel_records
        # short of the launches, the busy time with it), so such a verify is
        # profiled again, up to PROFILE_TRIES
        records_each = []
        for _ in range(PROFILE_TRIES):
            prof = profile_verify(torch, bk, sets)
            records_each.append(prof["kernel_records"])
            if prof["kernel_records"] == prof["device_kernels"]:
                break
        else:  # every try lost records: no busy time is printed as measured
            prof.update(device_busy_s=None, device_busy_share=None)
        emit({"phase": "profile", "arm": arm, "sets": N_SETS, "card": smi, **prof,
              "kernel_records_each": records_each})
        if prof["device_kernels"] != DEVICE_KERNELS[arm]:
            emit({"phase": "profile", "arm": arm, "error": "unexpected device kernels per verify",
                  "want": DEVICE_KERNELS[arm]})
            return 1
    set_arm("default")

    # launches: on the arm whose path the kernel is timed on
    home = {name: "mxu" if name in MXU_NAMES else "arm" for name in KERNEL_NAMES}
    out = []
    for name, rec in kernels.items():
        out.append({"name": name, **rec, "launches": counts[home[name]][name],
                    "launches_by_arm": {arm: counts[arm][name] for arm in ARMS}})
    emit({"kernels": out})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
