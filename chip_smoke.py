#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the BLS batch-verification path on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA.  Phases, one JSON line each:

1. device: the card's name, power limit and max SM clock.
2. build: nvcc compiles csrc/*.cu (in parallel) into lighthouse_tpu_torch/_build/.
3. kernel checks: each hand-written kernel (mont_mul, miller_step_dbl,
   miller_step_add) against its plain PyTorch version on the card, on
   seeded inputs at the Miller loop's width of 4,097 lanes (4,096 sets
   plus the (-G1, S) pair, a ragged edge for every block size), byte
   equality required.
4. reference: the device map-to-G2 on a few messages against the host
   hash_to_g2.
5. path: TorchBackend(device="cuda", device_h2c=True).verify_signature_sets
   on 4,096 signature sets (a tiled pool of seeded signed sets, with
   multi-key sets); True on the valid batch, False with one signature
   swapped for a valid signature of another message.  The first verify's
   dispatch runs under torch's sync debug mode set to "error", so any host
   sync in the device program fails the run; launch counts come from each
   of the two verifies.  The second verify also keeps copies of the
   kernels' operands (mont_mul: the first call at every width; the Miller
   steps: each step whose addition bit is set, and the last), and each
   kernel is held byte for byte against its plain version on them.
   Kernel times: CUDA events around runs of back-to-back launches on those
   operands (mont_mul at its most-launched width), queued while the card
   sleeps so that the host's wrapper time stays out.  Path timings and
   peak memory from three more verifies.
6. profile: one more verify under torch.profiler, giving every kernel the
   card ran and the share of the wall time the card was busy.

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
KERNEL_LAUNCHES = 50  # back-to-back kernel launches per window
PLAIN_LAUNCHES = 3  # back-to-back plain-version calls per window
SLEEP_CYCLES = 50_000_000  # ~25 ms at 1980 MHz: covers the host queueing a window
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
IMAD_PER_SM_CLK = 64  # 32-bit integer multiply-adds per SM per clock


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, calls: int, queue_first: bool = False) -> float:
    """ms per call of fn() on the card: CUDA events around ``calls``
    back-to-back calls, divided by ``calls``; the median of TIME_WINDOWS
    such windows, after a warm-up call.  With ``queue_first`` the card
    sleeps before the start event while the host queues every call, so a
    kernel shorter than its wrapper's host time is timed on the card alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIME_WINDOWS):
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


STEP_NAMES = ("miller_step_dbl", "miller_step_add")


def capture_kernel_operands(MK, ML, run):
    """Run ``run()`` (one verify) with the three kernel wrappers wrapped.
    Every call goes through to the wrapper unchanged (and is counted there);
    clones of some operands are kept for the kernel-vs-plain check on the
    path's own shapes: the first mont_mul call at each width, with the
    number of calls per width, and the Miller-step calls whose addition bit
    is set, and the last.  Returns (run's result, {width: (a, b)},
    {width: calls}, {step: [(call index, operands)]})."""
    keep = {i for i, b in enumerate(ML.X_BITS[1:]) if b} | {len(ML.X_BITS) - 2}
    orig = {"mont_mul": MK.mont_mul, **{s: getattr(ML, s) for s in STEP_NAMES}}
    mont_ops, mont_calls = {}, {}
    steps = {s: [] for s in STEP_NAMES}

    def mont_mul(a, b):
        n = a.shape[1]
        mont_calls[n] = mont_calls.get(n, 0) + 1
        if n not in mont_ops:
            mont_ops[n] = (a.clone(), b.clone())
        return orig["mont_mul"](a, b)

    def step(name):
        seen = [0]

        def wrapped(*args):
            if seen[0] in keep:
                steps[name].append((seen[0], tuple(x.clone() for x in args)))
            seen[0] += 1
            return orig[name](*args)

        return wrapped

    MK.mont_mul = mont_mul
    for s in STEP_NAMES:
        setattr(ML, s, step(s))
    try:
        result = run()
    finally:
        MK.mont_mul = orig["mont_mul"]
        for s in STEP_NAMES:
            setattr(ML, s, orig[s])
    return result, mont_ops, mont_calls, steps


def profile_verify(torch, bk, sets) -> dict:
    """One dispatch + resolve under torch.profiler (device activity only):
    the kernels the card ran, their summed time, and the share of the
    verify's wall time in which the card was busy."""
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
    busy_us = sum(e["dur"] for e in kernels)
    by_name = {}
    for e in kernels:
        name = e["name"].replace("(anonymous namespace)::", "")
        name = name.split("(")[0].split("<")[0].split("::")[-1][:60]
        count, us = by_name.get(name, (0, 0.0))
        by_name[name] = (count + 1, us + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"wall_s": wall_s, "device_kernels": len(kernels), "device_busy_s": busy_us / 1e6,
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
        from lighthouse_tpu_torch.crypto.bls.hash_to_curve import (
            hash_to_field_fp2, hash_to_g2)
        from lighthouse_tpu_torch.crypto.bls.torch_backend import (
            _build, backend, fp as F, h2c, miller_kernel as ML, mont_kernel as MK,
            points as P, tower as T)
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

    # -- build ------------------------------------------------------------
    built = _build.build_all()
    emit({"phase": "build", "seconds": round(built["seconds"], 3), "built": built["built"],
          "dir": str(_build.build_dir().relative_to(_build.PKG_ROOT.parent)),
          "ptxas": built["ptxas"]})

    # -- kernel checks ----------------------------------------------------
    def rand_limbs(n, k=1):
        return torch.as_tensor(
            F.ints_to_limbs([rng.randrange(k * F.P_INT) for _ in range(n)])).to(dev)

    def bound_ms(bytes_moved, imads):
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = imads / imad_per_s * 1e3
        return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")

    def max_abs_err(got, ref):
        return max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))

    # equal and max_abs_err per kernel, over the seeded and the path checks
    checked = {name: {"equal": True, "max_abs_err": 0} for name in ("mont_mul",) + STEP_NAMES}

    def hold(name, got, ref):
        """Byte equality of a kernel's outputs with its plain version's."""
        torch.cuda.synchronize()
        eq = all(bool(torch.equal(g, r)) for g, r in zip(got, ref))
        checked[name]["equal"] &= eq
        checked[name]["max_abs_err"] = max(checked[name]["max_abs_err"], max_abs_err(got, ref))
        return eq

    n = N_LANES
    a, b = F.LFp(rand_limbs(n), 1.0), F.LFp(rand_limbs(n), 1.0)
    s, t = F.fp_add(a, a), F.fp_sub(b, a)
    corpora = {
        "strict": (a.limbs, b.limbs),
        "lazy_add_sub": (s.limbs, t.limbs),
        "lazy_sub_neg": (t.limbs, F.fp_neg(t).limbs),
        "all_qmax": (torch.full((F.N, n), F.QMAX, dtype=F.DTYPE, device=dev),) * 2,
    }
    for name, (x, y) in corpora.items():
        x, y = x.contiguous(), y.contiguous()
        eq = hold("mont_mul", [MK.mont_mul(x, y)], [MK.mont_mul_plain(x, y)])
        emit({"phase": "kernel_check", "kernel": "mont_mul", "corpus": name, "n": n, "equal": eq})

    # Miller-step inputs from a real pairing's first steps: n distinct
    # pairs ([r]G1, [s]G2) made on the card, then two dbl+add steps.
    def gen_points(ops, gen_aff, encode):
        base = encode([gen_aff] * n, dev)
        bits = torch.tensor([[rng.getrandbits(1) for _ in range(n)] for _ in range(64)],
                            dtype=F.DTYPE, device=dev)
        bits[0] = 1
        jac = P.scalar_mul_bits(ops, P.from_affine(ops, base), bits)
        return P.to_affine(ops, jac, F.fp_inv if ops is P.FP_OPS else T.fp2_inv)

    p_aff = gen_points(P.FP_OPS, G1_GENERATOR, P.g1_encode)
    q_aff = gen_points(P.FP2_OPS, G2_GENERATOR, P.g2_encode)

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
    step_args = {"miller_step_dbl": (f, tpt, xp, yp),
                 "miller_step_add": (f, tpt, q, xp, yp, bit)}
    # name: (kernel wrapper, plain version, step program, input planes, TPU kernel line)
    steps = {"miller_step_dbl": (ML.miller_step_dbl, ML.miller_step_dbl_plain, "dbl", 20, 423),
             "miller_step_add": (ML.miller_step_add, ML.miller_step_add_plain, "add", 24, 449)}
    for name, (kern, plain, *_) in steps.items():
        args = step_args[name]
        eq = hold(name, kern(*args), plain(*args))
        emit({"phase": "kernel_check", "kernel": name, "corpus": "pairing_steps", "n": n,
              "equal": eq})
    if not all(c["equal"] for c in checked.values()):
        emit({"phase": "kernel_check", "error": "a kernel disagrees with its plain version"})
        return 1

    # -- reference: device map-to-G2 against the host hash_to_g2 ----------
    msgs = [bytes([i]) * 32 for i in range(4)]
    us = [hash_to_field_fp2(m, 2) for m in msgs]
    h_aff = h2c.map_to_g2(T.fp2_encode([u[0] for u in us], dev),
                          T.fp2_encode([u[1] for u in us], dev))
    got = list(zip(T.fp2_decode(h_aff[0]), T.fp2_decode(h_aff[1])))
    ref_ok = got == [hash_to_g2(m) for m in msgs]
    emit({"phase": "reference", "check": "map_to_g2 vs host hash_to_g2", "n": len(msgs),
          "equal": ref_ok})
    if not ref_ok:
        return 1

    # -- path -------------------------------------------------------------
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

    bk = backend.TorchBackend(device="cuda", device_h2c=True)
    backend.reset_launch_counts()
    mb = bk.marshal_sets(sets)
    torch.cuda.set_sync_debug_mode("error")  # dispatch may only enqueue
    try:
        handle = bk.dispatch(mb)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    verdict = bk.resolve(handle)
    counts = backend.launch_counts()
    backend.reset_launch_counts()
    bad_verdict, mont_ops, mont_calls, step_ops = capture_kernel_operands(
        MK, ML, lambda: bk.verify_signature_sets(bad))
    bad_counts = backend.launch_counts()
    emit({"phase": "path", "verdict_valid": verdict, "verdict_one_bad": bad_verdict,
          "launches_per_verify": counts, "launches_one_bad": bad_counts})
    if not (verdict is True and bad_verdict is False):
        return 1
    for c in (counts, bad_counts):
        if not (c["miller_step_dbl"] == 63 and c["miller_step_add"] == 63
                and c["mont_mul"] > 0):
            return 1

    # -- the kernels on the path's own operands, and their times ----------
    kernels = {}
    with torch.inference_mode():
        eqs = [hold("mont_mul", [MK.mont_mul(x, y)], [MK.mont_mul_plain(x, y)])
               for x, y in mont_ops.values()]
        emit({"phase": "path_kernel_check", "kernel": "mont_mul", "widths": len(mont_ops),
              "ragged_widths": sum(1 for w in mont_ops if w % 128),
              "calls_by_width": dict(sorted(mont_calls.items())), "equal": all(eqs)})
        for name, (kern, plain, *_) in steps.items():
            eqs = [hold(name, kern(*args), plain(*args)) for _, args in step_ops[name]]
            emit({"phase": "path_kernel_check", "kernel": name,
                  "calls": [i for i, _ in step_ops[name]],
                  "n": step_ops[name][0][1][0].shape[-1], "equal": all(eqs)})
        if not all(c["equal"] for c in checked.values()):
            emit({"phase": "path_kernel_check",
                  "error": "a kernel disagrees with its plain version on the path's operands"})
            return 1

        # mont_mul at its most-launched width on the path; the Miller steps
        # at the last kept step with the addition bit set (live f and T).
        n_mont = max(mont_calls, key=mont_calls.get)
        x, y = mont_ops[n_mont]
        bms, by = bound_ms(3 * F.N * 4 * n_mont, MK.IMAD_PER_LANE * n_mont)
        kernels["mont_mul"] = {
            "route": "cuda", "source": "lighthouse_tpu_torch/csrc/mont.cu",
            "replaces": "lighthouse_tpu/crypto/bls/jax_backend/pallas_fp.py:141",
            **checked["mont_mul"], "n": n_mont,
            "ms": time_ms(torch, lambda: MK.mont_mul(x, y), KERNEL_LAUNCHES, queue_first=True),
            "plain_ms": time_ms(torch, lambda: MK.mont_mul_plain(x, y), PLAIN_LAUNCHES),
            "bound_ms": bms, "bound_by": by, "library_ms": None}
        for name, (kern, plain, step, planes_in, line) in steps.items():
            call, args = [c for c in step_ops[name] if ML.X_BITS[1 + c[0]]][-1]
            n_step = args[0].shape[-1]
            # f, T (, Q), xp, yp planes read and f, T written; the add step's bit
            bytes_moved = (planes_in + 18) * F.N * 4 * n_step + (4 * n_step if step == "add" else 0)
            bms, by = bound_ms(bytes_moved, ML.program(step).n_mul * MK.IMAD_PER_LANE * n_step)
            kernels[name] = {
                "route": "cuda", "source": "lighthouse_tpu_torch/csrc/miller_step.cu",
                "replaces": f"lighthouse_tpu/crypto/bls/jax_backend/pallas_miller.py:{line}",
                **checked[name], "n": n_step, "step": call,
                "ms": time_ms(torch, lambda: kern(*args), KERNEL_LAUNCHES, queue_first=True),
                "plain_ms": time_ms(torch, lambda: plain(*args), PLAIN_LAUNCHES),
                "bound_ms": bms, "bound_by": by, "library_ms": None}
    del mont_ops, step_ops

    torch.cuda.reset_peak_memory_stats()  # peak_mem_gib: the timed verifies alone
    timings = []
    for _ in range(3):
        t0 = time.perf_counter()
        mb = bk.marshal_sets(sets)
        t1 = time.perf_counter()
        handle = bk.dispatch(mb)
        t2 = time.perf_counter()
        ok = bk.resolve(handle)
        t3 = time.perf_counter()
        if ok is not True:
            return 1
        timings.append((t1 - t0, t2 - t1, t3 - t2))
    med = [statistics.median(c) for c in zip(*timings)]
    emit({"phase": "path_timing", "sets": N_SETS, "reps": len(timings),
          "marshal_s": med[0], "dispatch_s": med[1], "resolve_s": med[2],
          "sets_per_s": N_SETS / sum(med),
          "device_sets_per_s": N_SETS / (med[1] + med[2]),
          "card": smi, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    emit({"phase": "profile", "sets": N_SETS, "card": smi, **profile_verify(torch, bk, sets)})

    out = []
    for name, rec in kernels.items():
        out.append({"name": name, **rec, "launches": counts[name]})
    emit({"kernels": out})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
