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
   kernels 1, 2, 3, 2m, 3m, 4, 5, 7, 4m and 5m (7, 4m and 5m: mxu_coop.cuh's
   mont_group_mxu_core, the chains' through mul13), kernel 6's forms (G2's
   group form, G1's cooperative form), the one-thread forms of kernels 1
   and 7, and the device functions the Miller and WSM steps call.
3. kernel checks: each hand-written kernel against its plain PyTorch version
   on the card, on seeded inputs at the Miller loop's width of 4,097 lanes
   (4,096 sets plus the (-G1, S) pair, a ragged edge for every block size),
   byte equality required: mont_mul and mont_mul_mxu on four corpora, and
   every form of mont_mul (mont_kernel.FORMS) also at 1, 2, G - 1, G + 1,
   L - 1, L + 1, 31 and 33 lanes (G threads per lane, L lanes per block),
   and every form of mont_mul_mxu (mxu_kernel.FORMS) at the same widths;
   the Miller steps and their MXU variants on live pairing steps (random
   addition bits), and the group forms of kernels 2, 3, 2m and 3m also at 1
   and G + 1 lanes (G threads per lane); the Fp chain
   and its MXU variant at p-2 on strict and lazy bases; the Fp2 chain and
   its MXU variant at (p^2+7)/16; the 15-bit chains (the Fp chain in every
   form of chain_kernel.FP_FORMS, the Fp2 chain in FP2_FORM) also at 1, 2,
   G + 1, L - 1, L + 1 and 257 lanes, the MXU chains (FP_MXU_FORM,
   FP2_MXU_FORM) also at 1 and 33; one
   G1 and one G2 WSM step on live points with random bits and infinity flags
   on either side, each curve's form (wsm_kernel.FORMS) also at 1, 17, 33
   and 257 lanes.
4. reference: the device map-to-G2 on a few messages against the host
   hash_to_g2; the chains' outputs (both planes) on a few lanes against
   host pow and the oracle's Fp2.pow.
5. path, for each arm, on the eager program (TorchBackend.local_verify_fn,
   the graph's comparison): TorchBackend(device="cuda", device_h2c=True)
   marshals 4,096 signature sets (a tiled pool of seeded signed sets, with
   multi-key sets); True on the valid batch, False with one signature
   swapped for a valid signature of another message (at N_SETS // 2 + 7)
   and False with the swap at set 0.  The
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
6. program, for each arm: bk.warm_compile(4,096) builds the key's CUDA
   graph (torch_backend/program.py): its key and fingerprint, warm-up,
   capture and instantiate seconds, the graph's nodes by type (kernel nodes
   = DEVICE_KERNELS), the wrapper launches counted during the capture
   (= WRAPPER_LAUNCHES, kernel by kernel the eager verify's), device and host
   memory.  graph_path: the valid, one-bad, valid and bad-at-0 batches
   dispatched in turn through the replayed graph under sync debug mode
   "error", all in flight before the first resolve: True, False, True,
   False, the eager verdicts on the same batches, no wrapper launch counted
   and no key built.
   boot (boot_phase): warm boot (torch_backend/aot.py, autotune.py,
   backend.enable_compile_cache) into an AOT store in a temporary directory:
   the arm plan tuned at autotune.CARD_SHAPES (each arm's trial ms, CUDA
   events around back-to-back launches, and the winners); a first boot in
   this process, a backend with the store attached building the verify key
   of the plan's arm at N_SETS (chains and WSM off) and one aggregate key
   (BOOT_AGG messages) from traffic, True, False, True, its launches at
   capture (under mxu13 every product on kernel 7, 2m and 3m 63 each, no
   chain and no WSM launch), the plan arm's kernels held byte for byte
   against their plain versions on the key's own operands (an eager verify
   under that arm), and one verify through the plan key against one through
   the default arm's key in turns; a second boot in a fresh process
   (``chip_smoke.py --second-boot``, second_boot): enable_compile_cache on
   the same build root, prewarm (2 loaded, 0 rejected, 0 stale, 3 plan
   shapes, no nvcc run, each key's build record), and the valid, one-bad and
   aggregate batches, passed as saved host tensors, through the prewarmed
   keys: True, False, True, no key built and no wrapper launch counted; the
   host memory of both processes.
   aggregate (aggregate_phase): TorchBackend.aggregate_verify through its
   captured programs (n padded to a power of two, the padding lanes
   masked), AGG_SIZES messages on the default arm and AGG_ARM_SIZE on the
   other two: each key's build record, a replayed and an eager call timed,
   True on a valid aggregate, False with the messages rotated and with one
   message twice.
   epoch (epoch_phase), for each arm: the mainnet-epoch batch at full shape
   (EPOCH_SETS sets, committees of EPOCH_COMMITTEE in EPOCH_POSITIONS
   positions, committee pubkeys summed on the card by the segment tree):
   the eager program (valid under sync debug mode "error"; a member key
   replaced; a padding flag cleared: True, False, False; its device kernels
   from a profile), then epoch_program's build record (kernel nodes = those
   device kernels, launches at capture = the eager ones) and the three
   batches replayed, all in flight before the first resolve, with the same
   verdicts; marshal (the tiled copy), dispatch and resolve seconds,
   sets/s and validators/s.  On the default and mxu arms, kernels 1 and 7
   on the tree's own operands at EPOCH_CHECK_WIDTHS and the widest call,
   byte for byte against their plain versions (in chunks of PLAIN_CHUNK
   lanes), and every width the program launches timed (epoch_widths).
   registry (registry_phase): the ingest engine (lighthouse_tpu_torch.ingest)
   with the resident pubkey registry: REGISTRY_SLOTS distinct PublicKey
   objects over the path pool's points synced into the cache (timed) and
   mirrored on the card (upload timed, its bytes); N_SETS single-signer sets
   at scattered slots marshalled with the gather on the card: the operand is
   a card tensor, byte-equal to host assembly and to the scalar marshal; under
   each arm through the key the program phase built, True, and False with
   one signature swapped (no key built, no launch counted on a replay);
   marshal seconds of the engine with the gather, with host assembly and of
   the scalar marshal, on the tiled corpus and on N_SETS distinct messages
   (marshal only; there also the engine through one thread per core, the
   reference's pool default), and the gather's ms; INGEST_FALLBACKS
   unchanged.
   epoch_balance (epoch_balance_phase): the per-epoch balance pipeline
   (per_epoch_torch) at BALANCE_VALIDATORS validators from seeded columns at
   MAINNET values, finalizing and leaking: the card's output equals the
   CPU run's exactly; upload, pipeline (median of BALANCE_RUNS) and
   download ms.
   mesh (mesh_phase): the mesh (parallel/, torch_backend/multichip.py) on
   the one card, a 2-seat mesh on cuda:0 whose seats share the main
   backend: (a) the sharded program (ShardedVerifyProgram over
   TorchBackend.seat_program: one 2,048-set key, its build record and the
   wrapper launches of the mesh path's first run) on the valid, one-bad and
   bad-at-0 batches, verdict vectors [T, T], [T, F], [F, T], and its
   dispatch + resolve time beside the single-device 4,096 key's; (b) the
   same in registry mode over the registry phase's 2^20 slots partitioned
   on the validator axis (per-seat bytes half the mirror's; the gathered
   planes byte-equal to the host take; the gather timed); (c) multichip's
   make_verify_sharded at MC_SETS sets (True, and False with one set's
   message point replaced) against the eager single-device program, and
   make_pair_sharded_aggregate_verify at AGG_MESH and AGG_MESH - 1 pairs
   (and one bad key) against TorchBackend.aggregate_verify; (d) a PodVerifier
   over the seats with a stand-in ladder, its seat key built before traffic
   (PodVerifier.warm_compile) and its shard deadline POD_SHARD_TIMEOUT_S:
   a clean 4,096 batch in one
   sharded dispatch, a POD_SETS batch with one bad set (only its seat's
   half re-verified, per-set verdicts equal to the stand-in's), a dropped
   shard rescued by a retry, a seat excluded and the batch re-sharded to
   width 1; (e) two threads dispatching THREAD_BATCHES alternating valid
   and bad 2,048-set batches each through one key on their own streams,
   every verdict right; the phase's seconds and host memory.
   serve (serve_phase): the front door (beacon/processor.py, integrity/,
   serve/) over the main backend on the default arm, registered as
   "torch", reusing the earlier phases' keys (4,096, 2,048, 32) and
   building the 8-set key before traffic (the canaries' and the child's
   key), captured into an AOT store in a temporary datadir beside a copy of
   the built kernel libraries; every key it builds printed with its seconds
   and host memory:
   (a) SERVE_PIPE_BATCHES valid 4,096-set batches through
   PipelinedVerifier.for_backend over the ingest engine, then in series:
   wall, marshal busy, device busy, occupancy, equal verdicts; (b) one bad
   set in a SERVE_BISECT_SETS batch through ResilientVerifier: per-set
   verdicts, the keys the bisection built (the 16-set key) and its device
   calls; (c)
   build_verify_stack (integrity auto, k = 2) -> VerifyService ->
   ServeApiServer on port 0, the tick pump running: an honest tenant posts
   SERVE_HTTP_REQS requests of SERVE_HTTP_REQ sets over HTTP (one bad set)
   while a greedy one posts at ten times its pace; polled verdicts equal
   the truth and the bare ResilientVerifier on the same FIFO batches, only
   the greedy tenant shed (429); then SERVE_BIG_REPS batches of SERVE_BIG
   sets through the service at k = 2 and k = 0 and bare: sets/s and
   p50 / p99 end-to-end latency, and the canary overhead against the
   reference's 2% bar (printed, not gated); (d) the 2-seat pod of the mesh
   phase wrapped in the guard (its marshal padding to N_SETS, so the seats
   replay the mesh phase's 2,048-set key), pod.gather=silent-stuck-true
   armed on a SERVE_LIE_SETS batch with a bad set: distrusted, the truth
   released from the CPU rung, then clean traffic back on the device; (e)
   the cross-arm audit (fraction 1.0, arms vpu15 then mxu13) on a
   SERVE_AUDIT_SETS batch, each audit's mode read from INTEGRITY_AUDITS
   (the card's arms, never the CPU floor), the mxu13 key's build printed;
   (f) run_selfcheck, its default corpus, over every verify key the
   backend holds; (g) ``python -m lighthouse_tpu_torch.serve --port 0
   --datadir <it> --prewarm --selfcheck`` in a child process (started
   after the 8-set key's capture, so its boot runs beside (b)-(e)): no nvcc
   (the copied libraries are its compile cache), the 8-set key built by its
   prewarm before its "up" line, its selfcheck over that key passed; then,
   on a thread beside (f), /health and one POST / poll round trip of
   SERVE_CHILD_SETS sets (one bad at SERVE_CHILD_BAD), the seconds from the
   POST to the verdicts; interrupted after (f), its exit (0) read at the
   phase's end with the store unchanged (a key built inside the request
   would have been captured).  Every clean batch must be
   journaled to the device rung with the breaker closed and no CPU-rung
   run; only (d)'s lie takes the CPU rung.
   node (node_phase): the node layers (the copies of the JAX package's
   beacon/, consensus/, network/) over the same backend: (a) on the default
   arm, a signed block's six sets (the 8-set key) through
   BlockSignatureVerifier, True, and False poisoned, as the oracle says;
   (b) on the chain-and-WSM arm, SyncManager syncs NODE_SYNC_SLOTS slots of
   an honest peer's chain as one batch, its bulk verify on the card (the
   arm's 64-set key: the one key the phase builds, so its warm-up and
   capture count the phase's launches), the head the peer's, and refuses
   the same blocks with one signature swapped (stalled, the peer
   greylisted); (c) process_epoch_altair on a NODE_EPOCH_VALIDATORS state,
   device=True (per_epoch_torch on the card) against device=False: the
   balances, inactivity scores, effective balances and exit epochs equal.
   Its host set-up (the blocks, the peer's chain, the syncing nodes at
   genesis, the epoch state and the host's transition) is made by
   node_prepare in the boot phase, while that phase waits for its second
   boot's process.
7. kernel times, on the captured operands: CUDA events around runs of
   back-to-back launches, queued while the card sleeps so that the host's
   wrapper time stays out.  mont_mul at every width of the default path
   (mont_widths: calls x ms, its device time there), every form of it at
   the three widths with the most device time and at wider calls
   (mont_groups), and in the kernels line at the most-launched width with
   the three heaviest beside; mont_mul_mxu in both forms at every width of
   the mxu arm (mxu_widths: calls x ms, its device time there, and the
   widths where form_for's form is not the faster), and in the kernels line
   at mont_mul's width with its three heaviest beside; the 15-bit chains at
   every width their arm launches, the Fp chain in every form and also at
   CHAIN_SWEEP widths between them (chain_forms, whose readings the kernels
   line reuses); the MXU chains at every width their arm launches (by_width
   in the kernels line); kernel 6 in each curve's form at the arm's 4,096
   lanes and at 16,384 (wsm_forms: the captured operands tiled); every other
   kernel on its arm's operands.
8. path_timing: one verify of each arm (TIMING_ORDER), each through the
   eager program and the graph (eager first, graph first on the last arm),
   with marshal,
   dispatch and resolve times and peak memory for each arm and path.
9. profile: one more verify of each arm under torch.profiler, eager and
   replayed, giving the kernel launches (eager: DEVICE_KERNELS, counted from
   the runtime's launch records; a replay is one graph launch), every kernel
   the card ran and the share of the wall time the card was busy (a verify
   whose kernel records fall short of its kernels, as when the profiler
   loses records, is profiled again, up to PROFILE_TRIES in all; if every
   try falls short, the busy time and share are null: the lost records
   carry time).  profile_stages: one eager verify of each of STAGE_ARMS with the
   CPU side traced too and the device program's stages (STAGES) as profiler
   ranges, giving each stage's device kernels and device time; "other" is
   the glue between the stages.

Then the kernels line (with each kernel's launches at capture per program
and arm: the verify's, the aggregate's at AGG_ARM_SIZE messages and the
epoch's; launches_mesh, the mesh path's first run on the default arm, its
seat key's warm-up and capture; launches_serve, the serve phase's run:
the warm-up and capture of the keys it builds; launches_node, the node
phase's run: the capture of its one key; kernels 1 and 7 also timed
at the epoch tree's widths), the
nvidia-smi line and the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero before that line.
It exits non-zero, printing no result, without CUDA or outside a checkout.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

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
# path verifies, one per arm and path (eager first, graph first on the last
# arm): a second round would take the run past half its time limit
TIMING_ORDER = ("default", "arm", "mxu")
WSM_KEEP = (0, 1, 32, 63)  # WSM step calls whose operands are kept
MONT_HEAVY = 3  # mont_mul widths of the default path timed: the most device time
# mont_mul widths beyond the path's, as multiples of the check width, where
# every form of kernel 1 is timed (where the one-thread form takes over)
MONT_WIDE = (4, 16, 64)
SWEEP_WINDOWS = 3  # timing windows per width in the mont_mul width sweep
# Fp-chain widths between the path's 1 and 4,096 where every form is timed
# (chain_kernel.form_for's crossover)
CHAIN_SWEEP = (16, 128, 512, 1024, 1536, 2048, 3072)
WSM_WIDE = 4  # kernel 6 is also timed at this many times the arm's width
# launches per verify of 4,096 sets, by arm: the wrappers' counts in all, and
# the device kernels of the profiled verify
WRAPPER_LAUNCHES = {"default": 25_925, "arm": 7_465, "mxu": 7_465}
DEVICE_KERNELS = {"default": 303_366, "arm": 165_602, "mxu": 165_602}
# profiled verifies per arm and path at most, until one loses no kernel record:
# an eager try costs up to ~30 s, and most tries lose a few records whatever
# their number
PROFILE_TRIES = 1
# the device program's stages, as (module name, function) pairs: the top-level
# calls of backend._verify_kernel(_h2c); a stage called inside another counts
# for the outer one
STAGES = {"map_to_g2": (("h2c", "map_to_g2"),),
          "g2_subgroup_check": (("P", "g2_subgroup_check"),),
          "scalar_muls": (("P", "scalar_mul_bits"), ("W", "scalar_mul_bits_fused")),
          "tree_reduce_g2": (("backend", "_tree_reduce_g2"),),
          "to_affine": (("P", "to_affine"),),
          "miller_loop": (("PR", "miller_loop"),),
          "gt_product": (("PR", "gt_product"),),
          "final_exp_is_one": (("PR", "final_exp_is_one"),)}
# arms profiled by stage: the mxu arm runs the arm's glue (every stage's kernel
# count the arm's), only its products differ
STAGE_ARMS = ("default", "arm")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
IMAD_PER_SM_CLK = 64  # 32-bit integer multiply-adds per SM per clock
# FP64 tensor-core multiply-adds per SM per clock: the H100 SXM data sheet's
# 67 TFLOP/s FP64 Tensor Core = 128 FMA x 2 x 132 SMs x 1,980 MHz
DMMA_FMA_PER_SM_CLK = 128
# aggregate_verify: message counts on the default arm, and on the other two
AGG_SIZES = (1, 3, 64)
AGG_ARM_SIZE = 64
# the epoch batch: BASELINE.json config 4 at tools/epoch_attestation_bench.py's
# defaults (2,048 sets, committees of 440 from a pool of 256 keys, padded to
# 512 positions); EPOCH_DISTINCT sets are built on the host and tiled
EPOCH_SETS = 2048
EPOCH_COMMITTEE = 440
EPOCH_POOL = 256
EPOCH_POSITIONS = 512
EPOCH_DISTINCT = 64
EPOCH_BAD_MEMBER = (1031, 5)  # (set, position): a member key replaced
EPOCH_BAD_PAD = (517, 500)  # (set, position past the committee): a padding flag cleared
# product widths of the tree's first two levels, where kernels 1 and 7 are held
# against their plain versions on the epoch's own operands (and the widest call)
EPOCH_CHECK_WIDTHS = (524_288, 262_144)
PLAIN_CHUNK = 131_072  # lanes per plain-version call in a wide check
# the resident pubkey registry (ingest): mainnet's ~1M validators, rounded up
BOOT_AGG = 64  # the aggregate key the boot phase's first boot builds (messages)
BOOT_SEED = SEED + 13  # the boot phase's own draws, so the later phases' stay as they were
BOOT_CHILD_TIMEOUT_S = 600  # the second boot's process
REGISTRY_SLOTS = 2**20
REGISTRY_BAD = N_SETS // 2 + 7  # the set whose signature is swapped
MARSHAL_REPS = 3  # marshal timings per form; the median is kept
GATHER_LAUNCHES = 50  # gathers per timing window
# the epoch balance pipeline: validators, and the pipeline runs timed (median)
BALANCE_VALIDATORS = 2**20
MC_SETS = 512  # multichip's sharded verify: the path pool's operands tiled
MC_BAD = 300  # the set whose message point is replaced
AGG_MESH = 64  # pairs of the pair-sharded aggregate verify (and 63, padded)
POD_SETS = 64  # the pod's one-bad batch: the path pool
POD_BAD = 40  # its one bad set (seat 1's half)
# the pod's shard deadline (its sharded one is 4x, as by default): on the one
# card the seats' replays run one after another, about 1.2 s for two
# 2,048-set shards, so the reference's 2 s default leaves too little room; a
# key's first build (tens of seconds) would still time out, so the pod's keys
# are built before it takes traffic (PodVerifier.warm_compile)
POD_SHARD_TIMEOUT_S = 5.0
THREAD_JOIN_S = 600  # (e)'s wait for its threads
THREAD_BATCHES = 20  # dispatches per thread through one key
BALANCE_RUNS = 5
SERVE_PIPE_BATCHES = 4  # (a) 4,096-set batches through the pipeline, then in series
SERVE_BISECT_SETS = 32  # (b) the ladder's one-bad batch: the 32-, 16- and 8-set keys
SERVE_BISECT_BAD = 21
SERVE_HTTP_REQS = 3  # (c) the honest tenant's requests of SERVE_HTTP_REQ sets
SERVE_HTTP_REQ = 8
SERVE_HTTP_BAD = 13  # the honest tenant's one bad set (its request 1)
SERVE_HTTP_PERIOD_S = 0.4  # the honest tenant's pace; the greedy one's is ten times it
SERVE_HTTP_GREEDY_THREADS = 2  # the greedy tenant's posting threads (a post decodes 8 keys)
SERVE_HTTP_RATE = 24.0  # both tenants' policy: sets/s and a burst of two requests
SERVE_HTTP_SIZES = (8,)  # the service's fill threshold: every flush pads to the 8-set key
SERVE_BIG = 2048  # (c) the throughput batches, SERVE_BIG_REPS of them for each k
SERVE_BIG_REPS = 2
SERVE_LIE_SETS = 8  # (d) the lie's batch and its bad set
SERVE_LIE_BAD = 3
SERVE_AUDIT_SETS = 32  # (e)
SERVE_CHILD_SETS = 8  # (g) the child's round trip, one bad set at SERVE_CHILD_BAD
SERVE_CHILD_BAD = 5
SERVE_CHILD_RUN_S = 400  # the child's --run-secs; it is interrupted once its round trip is done
SERVE_CHILD_UP_S = 240  # the longest wait for the child's "up" line (its prewarm and selfcheck)
SERVE_POLL_S = 300  # the longest wait for a verdict over HTTP

NODE_VALIDATORS = 16  # the node phase's interop chain (the reference tests' width)
NODE_SYNC_SLOTS = 8  # one epoch of the minimal preset, synced as one batch (44 sets: the 64 key)
NODE_SYNC_ARM = "arm"  # the sync's arm: chains and WSM, whose key builds in about half the time
NODE_EPOCH_VALIDATORS = 2**18  # the epoch state: the chain's interop validators and active copies
NODE_SEED = SEED + 16
STEP_NAMES = ("miller_step_dbl", "miller_step_add")
WSM_NAMES = ("wsm_step_g1", "wsm_step_g2")
MXU_NAMES = ("mont_mul_mxu", "miller_step_dbl_mxu", "miller_step_add_mxu", "fp_chain_mxu",
             "fp2_chain_mxu")
KERNEL_NAMES = ("mont_mul",) + STEP_NAMES + ("fp_chain", "fp2_chain") + WSM_NAMES + MXU_NAMES


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "t": round(time.perf_counter() - T0, 1)}
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


def profile_trace(torch, run, cpu=False):
    """run() (one verify, True expected) under torch.profiler: the card's
    activity and, with ``cpu``, the host's.  Returns (the verify's wall
    time, the trace's events).  The events are read from the profiler's own
    records, not from its chrome-trace export (writing and parsing that
    file costs several times the read of the records), in the export's
    form: "cat" kernel (a kernel the card ran), cuda_runtime (a CUDA
    runtime call on the host) or user_annotation (a record_function range
    on the host); "name"; "ts" and "dur" in microseconds; args.correlation,
    which ties a kernel to the runtime call that launched it.  The card's
    copies and fills and the card's spans of the host's ranges are left
    out, as the export files them under other categories."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        ok = run()
        wall_s = time.perf_counter() - t0
    if ok is not True:
        raise RuntimeError("the profiled verify returned False")
    kept, ranges = [], set()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(("Memcpy", "Memset")):
                continue
            cat = "kernel"
        elif e.is_user_annotation():
            cat = "user_annotation"
            ranges.add(name)
        elif name.startswith("cuda"):
            cat = "cuda_runtime"
        else:
            continue
        kept.append((cat, name, e.start_ns(), e.duration_ns(), e.correlation_id()))
    base = min((start for _, _, start, _, _ in kept), default=0)
    return wall_s, [{"cat": cat, "name": name, "ts": (start - base) / 1e3, "dur": dur / 1e3,
                     "args": {"correlation": corr}}
                    for cat, name, start, dur, corr in kept
                    if not (cat == "kernel" and name in ranges)]


def _kernel_name(e) -> str:
    name = e["name"].replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1][:60]


def profile_summary(wall_s, events) -> dict:
    """One profiled verify: the kernel launches the CUDA runtime recorded
    (device_kernels) and its graph launches, the kernels the card ran
    (kernel_records: fewer when the profiler loses records of the card's
    side, which it can), their summed time, and the share of the verify's
    wall time in which the card was busy."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    runtime = [e["name"] for e in events if e.get("cat") == "cuda_runtime"]
    busy_us = sum(e["dur"] for e in kernels)
    by_name = {}
    for e in kernels:
        count, us = by_name.get(_kernel_name(e), (0, 0.0))
        by_name[_kernel_name(e)] = (count + 1, us + e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_s": wall_s, "device_kernels": sum("LaunchKernel" in n for n in runtime),
            "graph_launches": sum("GraphLaunch" in n for n in runtime),
            "kernel_records": len(kernels), "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / wall_s if kernels else None,
            "top_kernels": [{"name": k, "launches": c, "s": us / 1e6} for k, (c, us) in top]}


@contextlib.contextmanager
def stage_ranges(torch, modules):
    """Wrap each function of STAGES (``modules`` maps the module names to
    the modules) in a profiler range named after its stage, only where no
    stage is open already, so that the ranges do not nest."""
    depth = [0]
    orig = {}

    def wrap(fn, stage):
        def wrapped(*args, **kw):
            if depth[0]:
                return fn(*args, **kw)
            depth[0] += 1
            try:
                with torch.profiler.record_function(stage):
                    return fn(*args, **kw)
            finally:
                depth[0] -= 1

        return wrapped

    for stage, fns in STAGES.items():
        for mod_name, attr in fns:
            mod = modules[mod_name]
            orig[(mod, attr)] = getattr(mod, attr)
            setattr(mod, attr, wrap(orig[(mod, attr)], stage))
    try:
        yield
    finally:
        for (mod, attr), fn in orig.items():
            setattr(mod, attr, fn)


def stage_summary(events) -> dict:
    """{stage: device kernels, kernel records, device seconds} of a verify
    traced with the CPU side under stage_ranges: a kernel belongs to the
    stage whose range holds the runtime call that launched it (matched by
    correlation id); "other" is the glue between the stages."""
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] in STAGES)
    launches = sorted((e["ts"], e.get("args", {}).get("correlation")) for e in events
                      if e.get("cat") == "cuda_runtime" and "LaunchKernel" in e["name"])
    stage_of, i = {}, 0
    for ts, corr in launches:
        while i < len(ranges) and ranges[i][1] < ts:
            i += 1
        inside = i < len(ranges) and ranges[i][0] <= ts
        stage_of[corr] = ranges[i][2] if inside else "other"
    out = {stage: {"device_kernels": 0, "kernel_records": 0, "device_s": 0.0}
           for stage in (*STAGES, "other")}
    for stage in stage_of.values():
        out[stage]["device_kernels"] += 1
    for e in events:
        if e.get("cat") == "kernel":
            stage = stage_of.get(e["args"].get("correlation"), "other")
            out[stage]["kernel_records"] += 1
            out[stage]["device_s"] += e["dur"] / 1e6
    return out


def g2_sum(points):
    """The oracle's sum of affine G2 points (the aggregate of signatures)."""
    from lighthouse_tpu_torch.crypto.bls.curve import Fp2, from_jacobian, jac_add, to_jacobian

    acc = to_jacobian(None, Fp2)
    for pt in points:
        acc = jac_add(acc, to_jacobian(pt, Fp2), Fp2)
    return from_jacobian(acc, Fp2)


def pack_operands(F, tree):
    """An operand tree as lists of {"limbs", "bound"} and {"tensor"} leaves:
    what torch.save writes with no class of the port, so that the second
    boot reads it with ``weights_only``."""
    if isinstance(tree, F.LFp):
        return {"limbs": tree.limbs, "bound": float(tree.bound)}
    if hasattr(tree, "shape"):
        return {"tensor": tree}
    return [pack_operands(F, c) for c in tree]


def unpack_operands(F, tree):
    if isinstance(tree, dict):
        return F.LFp(tree["limbs"], tree["bound"]) if "limbs" in tree else tree["tensor"]
    return tuple(unpack_operands(F, c) for c in tree)


def boot_phase(c, mbs):
    """Warm boot on the card (torch_backend/aot.py, autotune.py,
    backend.enable_compile_cache), into a store in a temporary directory.
    (a) tune: autotune.tune_and_store at CARD_SHAPES, each arm's trial ms per
    shape and the winners.  (b) first boot, in this process: a TorchBackend
    with the store attached verifies the valid and one-bad batches (``mbs``)
    at N_SETS sets and aggregate-verifies BOOT_AGG messages, so the verify
    key under the plan's arm (chains and WSM off) and one aggregate key are
    built from traffic and captured into the store; the plan key's launches
    at capture (on the mxu plane, when the plan picks mxu13: every product on
    kernel 7, 2m and 3m 63 each, no chain and no WSM launch); an eager verify
    under the plan's arm keeps the kernels' operands, and each is held byte
    for byte against its plain version; one verify through the plan key
    against one through the default arm's key, timed in turns.  (c) second
    boot, in a fresh process (``--second-boot``): enable_compile_cache on this
    process's build root, prewarm, the report (2 loaded, 0 rejected, 0 stale,
    3 plan shapes), no nvcc run, and the valid, one-bad and aggregate batches
    (saved host tensors) through the prewarmed keys: True, False, True, with
    no key built and no wrapper launch counted; while it runs, this process
    calls ``c.beside_child()`` (the node phase's host set-up) instead of
    waiting, and prints its seconds beside the child's.  Host memory of both
    processes.  Returns True, or None on a failure."""
    torch, api, backend, dev, smi, F, PG = c.torch, c.api, c.backend, c.dev, c.smi, c.F, c.PG
    from lighthouse_tpu_torch.crypto.bls.torch_backend import _build, aot, autotune

    t_phase = time.perf_counter()
    rng = random.Random(BOOT_SEED)
    F.set_chains(False)
    F.set_wsm(False)
    F.set_mxu(None)  # no override: the plan routes the product plane
    with tempfile.TemporaryDirectory(prefix="chip_smoke_boot_") as tmp:
        store = aot.AotStore(os.path.join(tmp, "aot_cache"))
        # (a) tune
        t0 = time.perf_counter()
        plan = autotune.tune_and_store(store)
        tune_s = time.perf_counter() - t0
        plan_mxu = F.mxu_for_batch(N_SETS)
        emit({"phase": "boot", "step": "tune", "card": smi, "seconds": tune_s,
              "identity": {k: plan[k] for k in ("torch", "cuda", "device_kind", "source_hash")},
              "trials_ms": {b: e["trials_ms"] for b, e in plan["shapes"].items()},
              "winners": {b: e["arm"] for b, e in plan["shapes"].items()},
              "plan_arm_at_n_sets": "mxu13" if plan_mxu else "vpu15"})
        if sorted(map(int, plan["shapes"])) != sorted(autotune.CARD_SHAPES) \
                or store.plan() != plan:
            emit({"phase": "boot", "error": "the plan does not cover CARD_SHAPES or did not "
                  "round-trip through the store"})
            return None

        # (b) first boot: the plan's keys built from traffic, captured into the store
        key = (N_SETS, True, plan_mxu, False, False)
        bk1 = backend.TorchBackend(device="cuda", device_h2c=True)
        bk1.attach_aot_store(store)
        rss0 = PG._host_rss_bytes()
        backend.reset_launch_counts()
        t0 = time.perf_counter()
        verdicts = [bk1.resolve(bk1.dispatch(mbs["valid"]))]  # builds the key, replays it
        build_and_first_s = time.perf_counter() - t0
        verdicts.append(bk1.resolve(bk1.dispatch(mbs["one_bad"])))
        at_capture = {k: bk1.builds[key]["launches"].get(k, 0) for k in KERNEL_NAMES}
        sks = [api.SecretKey(rng.randrange(1, api.params.R)) for _ in range(BOOT_AGG)]
        msgs = [rng.randbytes(32) for _ in range(BOOT_AGG)]
        pks = [sk.public_key() for sk in sks]
        agg_sig = api.Signature(g2_sum([sk.sign(m).point for sk, m in zip(sks, msgs)]))
        verdicts.append(bk1.aggregate_verify(pks, msgs, agg_sig))
        agg_size, agg_args = bk1.marshal_aggregate(pks, msgs, agg_sig)
        agg_key = ("agg", agg_size, F.mxu_for_batch(agg_size), False, False)
        entries = store.entries()
        first_rss = PG._host_rss_bytes()
        emit({"phase": "boot", "step": "first_boot", "card": smi, "key": key, "agg_key": agg_key,
              "verdicts": verdicts, "build_and_first_verify_s": build_and_first_s,
              "builds": {str(k): {f: v for f, v in rec.items() if f != "launches"}
                         for k, rec in bk1.builds.items()},
              "launches_at_capture": at_capture,
              "launches_at_capture_total": sum(at_capture.values()),
              "entries": sorted((m["cache_key"] for m in entries.values()), key=str),
              "host_rss_gib": first_rss / 2**30,
              "host_rss_added_gib": (first_rss - rss0) / 2**30})
        plane, steps = (("mont_mul_mxu", ("miller_step_dbl_mxu", "miller_step_add_mxu"))
                        if plan_mxu else ("mont_mul", ("miller_step_dbl", "miller_step_add")))
        want = {name: 0 for name in KERNEL_NAMES if name != plane}
        want.update({name: 63 for name in steps})
        if (verdicts != [True, False, True] or at_capture[plane] <= 0
                or any(at_capture[k] != v for k, v in want.items())
                or sorted((m["cache_key"] for m in entries.values()), key=str)
                != sorted([list(key), list(agg_key)], key=str)
                or any(entries[rec["fingerprint"]]["cache_key"] != list(k)
                       for k, rec in bk1.builds.items())):
            emit({"phase": "boot", "error": "unexpected first boot: verdicts, launches at "
                  "capture or store entries", "want_launches": want})
            return None

        # the plan key's kernels on its own operands: an eager verify under the
        # plan's arm keeps them, each held byte for byte against its plain version
        backend.reset_launch_counts()
        with F.pinned_arm(False, False, plan_mxu):
            bad_verdict, ops, widths = capture_kernel_operands(
                c.entry_points, F.mxu_active, c.keep_steps,
                lambda: bool(c.eager_dispatch(mbs["one_bad"])))
        eager_counts = backend.launch_counts()
        held = {}
        with torch.inference_mode():
            for name in (plane,) + steps:
                held[name] = all(c.hold(name, args)[0] for args in ops[name].values())
        emit({"phase": "boot", "step": "plan_key_kernels", "card": smi,
              "arm": {"chains": False, "wsm": False, "mxu": plan_mxu},
              "eager_verdict_one_bad": bad_verdict, "eager_launches_equal_capture":
              eager_counts == at_capture,
              "kernels": {name: {"equal": held[name], "kept": sorted(ops[name]),
                                 "calls_by_width": dict(sorted(widths[name].items()))}
                          for name in held}})
        if bad_verdict is not False or eager_counts != at_capture or not all(held.values()):
            emit({"phase": "boot", "error": "the plan key's kernels disagree with their plain "
                  "versions, or its eager launches with those at capture"})
            return None

        # one verify through the plan key and one through the default arm's key
        # (the program phase's), in turns: default, plan, plan, default
        default_key = (N_SETS, True, False, False, False)
        default_prog = c.bk._programs[default_key]
        plan_prog = bk1._programs[key]
        times = {"default": [], "plan": []}
        for which in ("default", "plan", "plan", "default"):
            prog = default_prog if which == "default" else plan_prog
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = bool(prog(*mbs["valid"].args))
            times[which].append(time.perf_counter() - t0)
            if ok is not True:
                return None
        emit({"phase": "boot", "step": "plan_vs_default", "card": smi, "sets": N_SETS,
              "dispatch_and_resolve_s": times,
              "median_s": {k: statistics.median(v) for k, v in times.items()},
              "plan_key": key, "default_key": default_key})

        # (c) the second boot, in a fresh process
        batches = os.path.join(tmp, "batches.pt")
        torch.save({"valid": pack_operands(F, mbs["valid"].args),
                    "one_bad": pack_operands(F, mbs["one_bad"].args),
                    "agg": pack_operands(F, agg_args)}, batches)
        # while it runs, this process does a later phase's host work
        # (c.beside_child) instead of waiting; the child's output goes to
        # files, so that a full pipe cannot stall it meanwhile
        out_f, err_f = (tempfile.TemporaryFile("w+") for _ in range(2))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--second-boot", store.root,
             str(_build.BUILD_ROOT), batches],
            stdout=out_f, stderr=err_f, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        try:
            beside_s = c.beside_child()
            rc = proc.wait(timeout=max(1.0, BOOT_CHILD_TIMEOUT_S - (time.perf_counter() - t0)))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        child_wall_s = time.perf_counter() - t0
        out_f.seek(0)
        err_f.seek(0)
        stdout, stderr = out_f.read(), err_f.read()
        out_f.close()
        err_f.close()
        lines = [ln for ln in stdout.splitlines() if ln.startswith('{"phase": "second_boot"')]
        child = json.loads(lines[-1]) if lines else {}
        child.pop("phase", None)
        emit({"phase": "boot", "step": "second_boot", "card": smi, "rc": rc,
              "wall_s": child_wall_s, "beside_s": beside_s, **child,
              "stderr_tail": stderr[-3000:] if rc else None})
        report = child.get("report", {})
        if (rc != 0 or child.get("enable_compile_cache") is not True
                or child.get("nvcc_runs") != 0
                or [report.get(k) for k in ("loaded", "rejected", "stale", "plan_shapes")]
                != [2, 0, 0, len(autotune.CARD_SHAPES)]
                or child.get("verdicts") != [True, False, True]
                or child.get("launches_on_verifies") != 0
                or child.get("keys_built_by_verifies") != 0
                or child.get("keys") != sorted([list(key), list(agg_key)], key=str)):
            emit({"phase": "boot", "error": "unexpected second boot"})
            return None
    del bk1, default_prog, plan_prog
    autotune.clear_plan()
    torch.cuda.empty_cache()
    emit({"phase": "boot", "step": "summary", "card": smi,
          "seconds": time.perf_counter() - t_phase,
          "host_rss_gib": {"first_boot_process": first_rss / 2**30,
                           "second_boot_process": child["rss_bytes"] / 2**30}})
    return True


def second_boot(store_root: str, build_root: str, batches: str) -> int:
    """The boot phase's second boot, in its own process: enable_compile_cache
    on ``build_root``, aot.prewarm from the store at ``store_root``, then the
    valid and one-bad verify batches and the aggregate batch saved at
    ``batches`` through the prewarmed keys.  Prints one JSON line
    ({"phase": "second_boot", ...}); exits 0 when it ran to its end."""
    t_start = time.perf_counter()
    import torch

    from lighthouse_tpu_torch.crypto.bls.torch_backend import _build, aot, backend
    from lighthouse_tpu_torch.crypto.bls.torch_backend import fp as F
    from lighthouse_tpu_torch.crypto.bls.torch_backend import program as PG

    cache_ok = backend.enable_compile_cache(build_root)
    nvcc0 = _build.nvcc_runs
    bk = backend.TorchBackend(device="cuda", device_h2c=True)
    t0 = time.perf_counter()
    report = aot.prewarm(bk, aot.AotStore(store_root))
    prewarm_wall_s = time.perf_counter() - t0
    saved = torch.load(batches, weights_only=True)
    valid, one_bad, agg = (unpack_operands(F, saved[k]) for k in ("valid", "one_bad", "agg"))
    keys0 = set(bk.builds)
    agg_n = agg[-1].shape[-1]
    backend.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")  # dispatch may only enqueue
    try:
        handles = [bk.dispatch(backend.MarshalledBatch(N_SETS, N_SETS, True, args))
                   for args in (valid, one_bad)]
        handles.append(bk._agg_program(agg_n)(*agg))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    verdicts = [bk.resolve(h) for h in handles]
    print(json.dumps({
        "phase": "second_boot", "pid": os.getpid(), "enable_compile_cache": cache_ok,
        "build_dir": str(_build.build_dir()), "nvcc_runs": _build.nvcc_runs - nvcc0,
        "report": report.to_row(), "prewarm_wall_s": prewarm_wall_s,
        "plan_mxu_at_n_sets": F.mxu_for_batch(N_SETS),
        "keys": sorted([list(k) for k in bk.builds], key=str), "verdicts": verdicts,
        "launches_on_verifies": sum(backend.launch_counts().values()),
        "keys_built_by_verifies": len(set(bk.builds) - keys0),
        "rss_bytes": PG._host_rss_bytes(),
        "process_s": time.perf_counter() - t_start}), flush=True)
    return 0


def aggregate_phase(c):
    """aggregate_verify on the card through its captured programs: AGG_SIZES
    messages on the default arm, AGG_ARM_SIZE on the other two; for each,
    the key's build record, a replayed and an eager call (through the
    program function itself) timed, and True on the valid input, False with
    the messages rotated and with one message twice.  Returns the launches
    counted at capture by arm (the last key of each), or None on a
    failure."""
    torch, api, backend, bk, dev, smi, rng = c.torch, c.api, c.backend, c.bk, c.dev, c.smi, c.rng
    set_arm, products = c.set_arm, c.products
    n_agg = max(AGG_SIZES + (AGG_ARM_SIZE,)) + 1
    agg_sks = [api.SecretKey(rng.randrange(1, api.params.R)) for _ in range(n_agg)]
    agg_msgs = [rng.randbytes(32) for _ in range(n_agg)]
    agg_pks = [sk.public_key() for sk in agg_sks]
    agg_sigs = [sk.sign(m).point for sk, m in zip(agg_sks, agg_msgs)]
    agg_counts = {}
    for arm, n_msgs in [("default", k) for k in AGG_SIZES] + [("arm", AGG_ARM_SIZE),
                                                               ("mxu", AGG_ARM_SIZE)]:
        set_arm(arm)
        sig = api.Signature(g2_sum(agg_sigs[:n_msgs]))
        pks, msgs = agg_pks[:n_msgs], agg_msgs[:n_msgs]
        if n_msgs > 1:  # messages rotated by one; the first message twice
            bad = ((pks, msgs[1:] + msgs[:1], sig), (pks, msgs[:-1] + msgs[:1], sig))
        else:  # another message; the signature over one message more
            bad = ((pks, agg_msgs[1:2], sig), (pks, msgs, api.Signature(g2_sum(agg_sigs[:2]))))
        t0 = time.perf_counter()
        size, args = bk.marshal_aggregate(pks, msgs, sig)
        marshal_s = time.perf_counter() - t0
        backend.reset_launch_counts()
        prog = bk._agg_program(size)
        t0 = time.perf_counter()
        verdict = bk.resolve(prog(*args))  # builds the key, then replays it
        first_s = time.perf_counter() - t0
        total = sum(backend.launch_counts().values())  # the warm-up's and the capture's
        key = ("agg", size, arm == "mxu", arm != "default", arm != "default")
        rec = bk.builds[key]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay_ok = bk.resolve(prog(*args))
        replay_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.inference_mode():
            eager_ok = bk.resolve(backend._aggregate_verify_kernel(*backend._to_device(args, dev)))
        eager_s = time.perf_counter() - t0
        verdicts = [verdict] + [bk.aggregate_verify(*b) for b in bad]
        at_capture = agg_counts[arm] = {k: rec["launches"].get(k, 0) for k in KERNEL_NAMES}
        emit({"phase": "aggregate", "arm": arm, "n": n_msgs, "key": key, "card": smi,
              "verdicts": verdicts, "replay_verdict": replay_ok, "eager_verdict": eager_ok,
              **{k: v for k, v in rec.items() if k != "launches"},
              "launches_at_capture": at_capture,
              "launches_at_capture_total": sum(at_capture.values()),
              "launches_warm_up_and_capture": total, "marshal_s": marshal_s,
              "build_and_first_call_s": first_s, "replay_s": replay_s, "eager_s": eager_s,
              "keys_built": len(bk.builds)})
        steps = [k + ("_mxu" if arm == "mxu" else "") for k in STEP_NAMES]
        if (verdicts != [True, False, False] or replay_ok is not True or eager_ok is not True
                or total != 2 * sum(at_capture.values())
                or min(at_capture[k] for k in [products[arm]] + steps) <= 0):
            emit({"phase": "aggregate", "arm": arm, "n": n_msgs, "error": "unexpected verdicts "
                  "or launches"})
            return None

    return agg_counts


def epoch_phase(c):
    """The epoch batch on the card at full shape (EPOCH_SETS sets of
    EPOCH_COMMITTEE members in EPOCH_POSITIONS positions, EPOCH_DISTINCT sets
    tiled), under each arm: the eager program (valid under sync debug mode
    "error", the two one-bad batches; device kernels from a profile), then
    epoch_program's build record and the three batches replayed in flight,
    True, False, False as the eager program, kernel nodes = the eager
    device kernels, launches at capture = the eager launches; marshal,
    dispatch and resolve of one more batch.  On the default and mxu arms,
    kernels 1 and 7 on the tree's own operands (EPOCH_CHECK_WIDTHS and the
    widest call, byte for byte) and every width the program launches, timed.
    Returns (launches at capture by arm, the timed widths by kernel), or None
    on a failure."""
    torch, api, backend, bk, dev, smi = c.torch, c.api, c.backend, c.bk, c.dev, c.smi
    set_arm, products, funcs, checked = c.set_arm, c.products, c.funcs, c.checked
    max_abs_err, bound_ms, hash_to_g2 = c.max_abs_err, c.bound_ms, c.hash_to_g2
    F, P, PG, MK, X = c.F, c.P, c.PG, c.MK, c.X
    t0 = time.perf_counter()
    pool_pts = [api.SecretKey(1000 + i).public_key().point for i in range(EPOCH_POOL)]
    committees, ep_sigs, ep_hs = [], [], []
    for s_ in range(EPOCH_DISTINCT):
        members = [(s_ * 7 + j * 3) % EPOCH_POOL for j in range(EPOCH_COMMITTEE)]
        committees.append([pool_pts[m] for m in members])
        msg = s_.to_bytes(8, "big") * 4
        ep_sigs.append(api.SecretKey(sum(1000 + m for m in members) % api.params.R)
                       .sign(msg).point)
        ep_hs.append(hash_to_g2(msg))
    cpu = torch.device("cpu")
    ep_pk, ep_mask = backend.encode_committee_pubkeys(committees, EPOCH_POSITIONS)
    weights = [0x9E3779B97F4A7C15 ^ (i * 0x2545F4914F6CDD1D) or 1 for i in range(EPOCH_SETS)]
    if any(w % 2**64 == 0 for w in weights):  # _pack_wbits keeps the low 64 bits
        return None
    ep_tail = (P.g2_encode(ep_sigs, cpu), P.g2_encode(ep_hs, cpu), backend._pack_wbits(weights))
    reps = EPOCH_SETS // EPOCH_DISTINCT
    bad_x, bad_y = P.g1_encode([api.SecretKey(31337).public_key().point], cpu)
    setup_s = time.perf_counter() - t0

    def tile_positions(t, _=None):
        """(..., positions * DISTINCT) -> (..., positions * SETS): each
        position's block of DISTINCT lanes repeated, so lane pos * SETS + set
        holds committee set % DISTINCT's member at pos."""
        lead = t.shape[:-1]
        return (t.reshape(*lead, EPOCH_POSITIONS, 1, EPOCH_DISTINCT)
                .expand(*lead, EPOCH_POSITIONS, reps, EPOCH_DISTINCT).reshape(*lead, -1)
                .contiguous())

    def epoch_marshal(corrupt=None):
        """The epoch operands at full shape, as CPU tensors: the encoded
        DISTINCT sets tiled to SETS (the sets' operands repeated), with one
        member key replaced ("member") or one padding flag cleared ("pad")."""
        pk = PG.map_operands(tile_positions, ep_pk)
        pad = tile_positions(ep_mask)
        if corrupt == "member":
            s_, pos = EPOCH_BAD_MEMBER
            pk[0].limbs[:, pos * EPOCH_SETS + s_] = bad_x.limbs[:, 0]
            pk[1].limbs[:, pos * EPOCH_SETS + s_] = bad_y.limbs[:, 0]
        elif corrupt == "pad":
            s_, pos = EPOCH_BAD_PAD
            pad[pos * EPOCH_SETS + s_] = False
        tail = PG.map_operands(lambda t, _: t.repeat(*([1] * (t.dim() - 1)), reps), ep_tail[:2])
        return (pk, pad, *tail, ep_tail[2])

    t0 = time.perf_counter()
    ep_batches = {"valid": epoch_marshal(), "bad_member": epoch_marshal("member"),
                  "bad_pad": epoch_marshal("pad")}
    emit({"phase": "epoch_setup", "sets": EPOCH_SETS, "committee": EPOCH_COMMITTEE,
          "positions": EPOCH_POSITIONS, "pool": EPOCH_POOL, "distinct": EPOCH_DISTINCT,
          "validators": EPOCH_SETS * EPOCH_COMMITTEE, "pk_lanes": ep_batches["valid"][1].numel(),
          "bad_member": EPOCH_BAD_MEMBER, "bad_pad": EPOCH_BAD_PAD, "setup_s": setup_s,
          "tile_s": (time.perf_counter() - t0) / 3})

    def epoch_eager(args):
        with torch.inference_mode():
            return backend._epoch_verify_kernel(*backend._to_device(args, dev), EPOCH_POSITIONS)

    def hold_wide(name, args):
        """hold() for a wide call: the kernel on every lane, its plain version
        PLAIN_CHUNK lanes at a time."""
        wrapper, plain = funcs[name]
        got = wrapper(*args)
        eq, err = True, 0
        for lo in range(0, args[0].shape[-1], PLAIN_CHUNK):
            ref = plain(*(a[:, lo:lo + PLAIN_CHUNK].contiguous() for a in args))
            part = [g[:, lo:lo + PLAIN_CHUNK] for g in got]
            eq &= all(bool(torch.equal(g, r)) for g, r in zip(part, ref))
            err = max(err, max_abs_err(part, ref))
        torch.cuda.synchronize()
        checked[name]["equal"] &= eq
        checked[name]["max_abs_err"] = max(checked[name]["max_abs_err"], err)
        return eq

    ep_counts, epoch_widths = {}, {}
    product_points = [(MK, "mont_mul", "mont_mul", 2, False),
                      (X, "mont_mul_mxu", "mont_mul_mxu", 2, False)]
    for arm in ARMS:
        set_arm(arm)
        name = products[arm]
        # the eager program: the valid batch may only enqueue, the one-bad
        # batches keep their products' operands (first call at each width)
        backend.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handle = epoch_eager(ep_batches["valid"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t1 = time.perf_counter()
        eager = {"valid": bk.resolve(handle)}
        eager_times = (t1 - t0, time.perf_counter() - t1)
        eager_counts = backend.launch_counts()
        eager_peak = torch.cuda.max_memory_allocated()
        eager["bad_member"], ops, widths = capture_kernel_operands(
            product_points, F.mxu_active, set(), lambda: bk.resolve(epoch_eager(
                ep_batches["bad_member"])))
        eager["bad_pad"] = bk.resolve(epoch_eager(ep_batches["bad_pad"]))
        prof = profile_summary(*profile_trace(
            torch, lambda: bk.resolve(epoch_eager(ep_batches["valid"]))))
        # the program: build, then the three batches in flight
        backend.reset_launch_counts()
        prog = bk.epoch_program(EPOCH_SETS, EPOCH_POSITIONS)
        t0 = time.perf_counter()
        built_ok = bk.resolve(prog(*ep_batches["valid"]))
        build_s = time.perf_counter() - t0
        total = sum(backend.launch_counts().values())
        key = ("epoch", EPOCH_SETS, EPOCH_POSITIONS, arm == "mxu",
                             arm != "default", arm != "default")
        rec = bk.builds[key]
        at_capture = ep_counts[arm] = {k: rec["launches"].get(k, 0) for k in KERNEL_NAMES}
        order = ("valid", "bad_member", "bad_pad")
        n_keys = len(bk.builds)
        backend.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")  # dispatch may only enqueue
        try:
            handles = [prog(*ep_batches[b]) for b in order]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t1 = time.perf_counter()
        verdicts = [bk.resolve(h) for h in handles]  # all three in flight before the first
        t2 = time.perf_counter()
        replay_launches = sum(backend.launch_counts().values())
        # one more valid batch: marshal (the tiled copy), dispatch, resolve
        t_m = time.perf_counter()
        args = epoch_marshal()
        t3 = time.perf_counter()
        handle = prog(*args)
        t4 = time.perf_counter()
        one_ok = bk.resolve(handle)
        t5 = time.perf_counter()
        del args
        wall = t5 - t_m
        emit({"phase": "epoch", "arm": arm, "key": key, "card": smi,
              "eager_verdicts": [eager[b] for b in order], "verdicts": verdicts,
              "batches": order, "build_verdict": built_ok, "timed_verdict": one_ok,
              **{k: v for k, v in rec.items() if k != "launches"},
              "launches_at_capture": at_capture,
              "launches_at_capture_total": sum(at_capture.values()),
              "launches_warm_up_and_capture": total, "eager_launches": eager_counts,
              "eager_device_kernels": prof["device_kernels"], "eager_profile_wall_s":
              prof["wall_s"], "eager_dispatch_s": eager_times[0],
              "eager_resolve_s": eager_times[1], "eager_peak_gib": eager_peak / 2**30,
              "build_and_first_call_s": build_s, "three_dispatch_s": t1 - t0,
              "three_resolve_s": t2 - t1, "launches_on_replay": replay_launches,
              "marshal_s": t3 - t_m, "dispatch_s": t4 - t3, "resolve_s": t5 - t4,
              "sets_per_s": EPOCH_SETS / wall,
              "validators_per_s": EPOCH_SETS * EPOCH_COMMITTEE / wall,
              "device_sets_per_s": EPOCH_SETS / (t5 - t3),
              "pool_gib": bk._pool.reserved_bytes() / 2**30, "keys_built": len(bk.builds)})
        steps = [k + ("_mxu" if arm == "mxu" else "") for k in STEP_NAMES]
        if not ([eager[b] for b in order] == verdicts == [True, False, False]
                and built_ok is True and one_ok is True and replay_launches == 0
                and len(bk.builds) == n_keys
                and rec["nodes"].get("kernel") == prof["device_kernels"]
                and at_capture == {k: eager_counts[k] for k in KERNEL_NAMES}
                and total == 2 * sum(at_capture.values())
                and min(at_capture[k] for k in [name] + steps) > 0):
            emit({"phase": "epoch", "arm": arm, "error": "unexpected verdicts, build or "
                  "launches"})
            return None
        if arm == "arm":
            continue
        # kernels 1 and 7 on the epoch's own operands: the tree's first two
        # levels' widths and the widest call, byte for byte; then every width
        # the epoch program launches, timed (calls x ms: its device time there)
        kept, calls = ops[name], widths[name]
        plane = F.N * 4
        bound = (lambda w: bound_ms(3 * plane * w, MK.IMAD_PER_LANE * w)) if name == "mont_mul" \
            else (lambda w: bound_ms(3 * plane * w, X.IMAD_PER_LANE * w, X.DMMA_FMA_PER_LANE * w))
        form_of = MK.form_for if name == "mont_mul" else X.form_for
        with torch.inference_mode():
            check = sorted({*EPOCH_CHECK_WIDTHS, max(kept)}, reverse=True)
            missing = [w for w in check if w not in kept]
            eqs = {w: hold_wide(name, kept[w]) for w in check if w in kept}
            emit({"phase": "epoch_kernel_check", "arm": arm, "kernel": name, "widths": check,
                  "equal": eqs, "missing": missing, "plain_chunk": PLAIN_CHUNK})
            if missing or not all(eqs.values()):
                return None
            ms = {w: time_ms(torch, lambda a=kept[w], k=funcs[name][0]: k(*a), KERNEL_LAUNCHES,
                             queue_first=True, windows=SWEEP_WINDOWS) for w in sorted(kept)}
        rows = sorted(({"n": w, "calls": calls[w], "ms": ms[w], "device_s": calls[w] * ms[w] / 1e3,
                        "bound_ms": bound(w)[0], "form": form_of(w)} for w in kept),
                      key=lambda r: -r["device_s"])
        epoch_widths[name] = {"arm": arm, "calls": sum(calls.values()), "widths": len(calls),
                              "device_s": sum(r["device_s"] for r in rows), "by_width": rows}
        emit({"phase": "epoch_widths", "kernel": name, "card": smi, **epoch_widths[name]})
        del kept, ops
    del ep_batches
    set_arm("default")
    return ep_counts, epoch_widths


def registry_phase(c):
    """The ingest engine with the resident registry: REGISTRY_SLOTS distinct
    PublicKey objects over the path pool's points, synced into the cache and
    mirrored on the card (timed; the mirror's bytes); N_SETS single-signer
    sets whose keys sit at scattered slots, marshalled by the engine with
    the gather on the card.  The gathered operand equals host assembly and
    the scalar marshal byte for byte; under each arm, through the key the
    program phase built, the batch gives True, and False with one signature
    swapped (dispatch under sync debug mode "error", no key built, no
    wrapper launch on a replay).  Marshal times: the engine with the gather,
    with host assembly, and the scalar marshal, on the tiled corpus and on
    N_SETS distinct messages under one signature (marshal only); the gather
    timed alone.  INGEST_FALLBACKS must not move.  Returns True, or None on
    a failure."""
    import numpy as np

    from lighthouse_tpu_torch.ingest import IngestEngine, MarshalPool
    from lighthouse_tpu_torch.utils import metrics as M

    torch, api, backend, bk, smi, rng = c.torch, c.api, c.backend, c.bk, c.smi, c.rng
    f0 = M.INGEST_FALLBACKS.value()
    singles = [s for s in c.pool if len(s.signing_keys) == 1]
    points = [s.signing_keys[0].point for s in singles]
    points += [pk.point for s in c.pool if len(s.signing_keys) > 1 for pk in s.signing_keys]

    class Registry:  # the beacon ValidatorPubkeyCache's interface: len, get
        def __init__(self, keys):
            self.keys = keys

        def __len__(self):
            return len(self.keys)

        def get(self, i):
            return self.keys[i]

    t0 = time.perf_counter()
    reg = Registry([api.PublicKey(points[i % len(points)]) for i in range(REGISTRY_SLOTS)])
    keys_s = time.perf_counter() - t0
    eng = IngestEngine(bk, pubkey_cache=reg)  # device_gather: on, the backend is on the card
    host = IngestEngine(bk, pubkey_cache=reg, device_gather=False, cache=eng.cache)
    t0 = time.perf_counter()
    synced = eng.cache.sync_registry(reg)
    sync_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mirror = eng.cache.registry_device()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    mirror_bytes = torch.cuda.memory_allocated() - mem0
    # set j: single pool set j % len(singles), its key at a scattered slot
    # (slot == the point's index mod len(points), drawn without repeats)
    per_point = REGISTRY_SLOTS // len(points)
    draws = rng.sample(range(per_point), N_SETS)
    slots = [j % len(singles) + len(points) * draws[j] for j in range(N_SETS)]
    sets = [api.SignatureSet(singles[j % len(singles)].signature, [reg.get(slots[j])],
                             singles[j % len(singles)].message) for j in range(N_SETS)]
    bad = list(sets)
    other = singles[(REGISTRY_BAD + 1) % len(singles)].signature
    bad[REGISTRY_BAD] = api.SignatureSet(other, sets[REGISTRY_BAD].signing_keys,
                                         sets[REGISTRY_BAD].message)
    weights = [rng.getrandbits(64) | 1 for _ in range(N_SETS)]
    mb = eng.marshal_sets(sets, weights)
    ref_host = host.marshal_sets(sets, weights)
    ref_scalar = bk.marshal_sets(sets, weights)
    pk = mb.args[0] if not mb.invalid else ()
    gathered = (len(pk) == 2 and all(x.limbs.device.type == "cuda" for x in pk)
                and isinstance(mb.ready, torch.cuda.Event) and mb.slots is None)
    torch.cuda.synchronize()

    def cpu_leaves(args):
        if isinstance(args, c.F.LFp):
            return [(args.limbs.cpu(), args.bound)]
        if isinstance(args, torch.Tensor):
            return [(args.cpu(), None)]
        return [leaf for a in args for leaf in cpu_leaves(a)]

    def same(a, b):
        la, lb = cpu_leaves(a.args), cpu_leaves(b.args)
        return len(la) == len(lb) and all(
            x.dtype == y.dtype and x.shape == y.shape and bx == by and torch.equal(x, y)
            for (x, bx), (y, by) in zip(la, lb))

    equal = {"host_assembly": same(mb, ref_host), "scalar_marshal": same(mb, ref_scalar)}
    mb_bad = eng.marshal_sets(bad)
    del ref_host, ref_scalar
    verdicts, builds = {}, {key: rec["capture_s"] for key, rec in bk.builds.items()}
    launches = 0
    for arm in ARMS:
        c.set_arm(arm)
        backend.reset_launch_counts()  # the counts just before the registry path
        torch.cuda.set_sync_debug_mode("error")  # dispatch may only enqueue
        try:
            handles = [bk.dispatch(b) for b in (mb, mb_bad)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        verdicts[arm] = [bk.resolve(h) for h in handles]  # both in flight first
        launches += sum(backend.launch_counts().values())  # read just after: a replay
    c.set_arm("default")
    rebuilt = {key: rec["capture_s"] for key, rec in bk.builds.items()} != builds

    def median_s(fn):
        runs = []
        for _ in range(MARSHAL_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            runs.append(time.perf_counter() - t0)
        return statistics.median(runs), out

    # the tiled corpus (len(singles) distinct messages), then N_SETS distinct
    # messages under one signature: marshal only
    distinct = [api.SignatureSet(singles[0].signature, s.signing_keys, b"distinct %d" % j)
                for j, s in enumerate(sets)]
    timings = {}
    for corpus, batch in (("tiled", sets), ("distinct", distinct)):
        row = {}
        row["engine_gather_s"], out = median_s(lambda b=batch: eng.marshal_sets(b))
        # the same, until the gather has run on the card
        row["engine_gather_ready_s"], _ = median_s(
            lambda b=batch: (eng.marshal_sets(b), torch.cuda.synchronize())[0])
        row["engine_host_s"], out_h = median_s(lambda b=batch: host.marshal_sets(b))
        row["scalar_s"], out_s = median_s(lambda b=batch: bk.marshal_sets(b))
        row["ok"] = not (out.invalid or out_h.invalid or out_s.invalid)
        row["scalar_over_engine_gather"] = row["scalar_s"] / row["engine_gather_s"]
        timings[corpus] = row
    # the reference's default pool, one thread per core, on the distinct
    # messages (once: the shards queue on the GIL)
    threads = os.cpu_count() or 1
    pooled = IngestEngine(bk, pubkey_cache=reg, cache=eng.cache,
                          pool=MarshalPool(workers=threads))
    t0 = time.perf_counter()
    out_p = pooled.marshal_sets(distinct)
    timings["distinct"].update(threads=threads, shards=pooled.pool.shard_count(N_SETS),
                               engine_gather_threads_s=time.perf_counter() - t0)
    timings["distinct"]["ok"] &= not out_p.invalid
    pooled.close()
    slot_arr = np.asarray(slots, dtype=np.int64)
    dev_slots = torch.as_tensor(slot_arr, device=c.dev)
    gather_ms = time_ms(torch, lambda: eng.cache.gather_device(slot_arr), GATHER_LAUNCHES)
    select_ms = time_ms(torch, lambda: (mirror[0].index_select(1, dev_slots),
                                        mirror[1].index_select(1, dev_slots)),
                        GATHER_LAUNCHES, queue_first=True)
    gather_bytes = 2 * (2 * c.F.N * 4 * N_SETS) + 8 * N_SETS  # read + write, the slots
    fallbacks = M.INGEST_FALLBACKS.value() - f0
    emit({"phase": "registry", "card": smi, "slots": REGISTRY_SLOTS, "points": len(points),
          "synced": synced, "keys_s": keys_s, "sync_s": sync_s, "upload_s": upload_s,
          "mirror_bytes": mirror_bytes, "mirror_bytes_expected": eng.cache.device_bytes(),
          "sets": N_SETS, "distinct_slots": len(set(slots)), "gathered_on_card": gathered,
          "equal": equal, "verdicts": verdicts, "bad_set": REGISTRY_BAD,
          "launches_on_replay": launches, "rebuilt": rebuilt, "keys_built": len(bk.builds),
          "marshal": timings, "gather_ms": gather_ms, "index_select_ms": select_ms,
          "index_select_bound_ms": gather_bytes / HBM_BYTES_PER_S * 1e3,
          "fallbacks": fallbacks})
    ok = (synced == REGISTRY_SLOTS and gathered and all(equal.values())
          and all(v == [True, False] for v in verdicts.values()) and len(verdicts) == 3
          and launches == 0 and not rebuilt and fallbacks == 0
          and mirror_bytes >= eng.cache.device_bytes()
          and all(r["ok"] for r in timings.values()))
    if not ok:
        emit({"phase": "registry", "error": "a registry check failed"})
        return None
    # the mesh phase shards this registry and marshals these batches
    c.registry = types.SimpleNamespace(eng=eng, sets=sets, bad=bad)
    return True


def epoch_balance_phase(c):
    """The epoch balance pipeline (per_epoch_torch) on the card at
    BALANCE_VALIDATORS validators from seeded numpy columns at MAINNET values
    (post-Bellatrix quotients), finalizing and leaking: the card's output
    equals the CPU run's exactly, through the entry point and through the
    kernel; upload, pipeline (median of BALANCE_RUNS) and download ms.
    Returns True, or None on a failure."""
    import numpy as np

    from lighthouse_tpu_torch.consensus.state_processing import arrays as PA
    from lighthouse_tpu_torch.consensus.state_processing import per_epoch_torch as PT

    torch, smi = c.torch, c.smi
    g = np.random.default_rng(SEED)
    n = BALANCE_VALIDATORS
    current, previous = 300_000, 299_999
    eb = np.where(g.random(n) < 0.95, 32, g.integers(17, 32, n)).astype(np.int64) * 10**9
    slashed = g.random(n) < 0.005
    exiting = g.random(n) < 0.01
    va = PA.ValidatorArrays(
        effective_balance=eb,
        slashed=slashed,
        activation_eligibility_epoch=np.zeros(n, np.int64),
        activation_epoch=np.where(g.random(n) < 0.01, PA.FAR,
                                  g.integers(0, previous, n)).astype(np.int64),
        exit_epoch=np.where(exiting, current + 5, PA.FAR).astype(np.int64),
        withdrawable_epoch=np.where(
            slashed, np.where(g.random(n) < 0.5, current + 4096, current + 100),
            np.where(exiting, current + 261, PA.FAR)).astype(np.int64),
        balances=np.maximum(eb + g.integers(-10**9, 10**9, n), 0).astype(np.int64),
    )
    flags = np.where(g.random(n) < 0.9, 7, g.integers(0, 8, n)).astype(np.int64)
    scores = np.where(g.random(n) < 0.9, 0, g.integers(0, 100, n)).astype(np.int64)
    kw = dict(multiplier=PT.BELLATRIX_SLASHING_MULTIPLIER,
              inactivity_quotient=PT.BELLATRIX_INACTIVITY_QUOTIENT)
    col_bytes = sum(np.asarray(x).nbytes for x in (
        va.effective_balance, va.balances, flags, va.slashed, scores)) + 4 * n
    out_bytes = 3 * 8 * n
    rows = {}
    for case, finalized in (("finalizing", previous - 1), ("leaking", previous - 10)):
        args = (va, flags, scores, current, previous, finalized, 64 * 32 * 10**9, PT.MAINNET)
        positional, static = PT.kernel_inputs(*args, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = PT.upload(positional, c.dev)
        torch.cuda.synchronize()
        upload_ms = (time.perf_counter() - t0) * 1e3
        runs = []
        with torch.inference_mode():
            for _ in range(BALANCE_RUNS + 1):  # the first is a warm-up
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = PT.epoch_kernel(*on_card, **static)
                end.record()
                end.synchronize()
                runs.append(start.elapsed_time(end))
            t0 = time.perf_counter()
            card = [x.cpu().numpy() for x in out]
            download_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            cpu = [x.numpy() for x in PT.epoch_kernel(*PT.upload(positional, "cpu"), **static)]
            cpu_ms = (time.perf_counter() - t0) * 1e3
        entry = PT.epoch_balance_pipeline(*args, **kw)  # the entry point, on the card
        equal = (all(np.array_equal(a, b) for a, b in zip(card, cpu))
                 and all(np.array_equal(a, b) for a, b in zip(entry, cpu)))
        moved = int((card[0] != va.balances).sum())
        rows[case] = {"in_leak": bool(positional[10]), "equal": equal,
                      "upload_ms": upload_ms, "pipeline_ms": statistics.median(runs[1:]),
                      "pipeline_ms_each": runs[1:], "download_ms": download_ms,
                      "host_cpu_ms": cpu_ms, "balances_moved": moved}
    emit({"phase": "epoch_balance", "card": smi, "validators": n, **rows,
          "bytes_moved": col_bytes + out_bytes,
          "bound_ms": (col_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3})
    if not (all(r["equal"] and r["balances_moved"] > 0 for r in rows.values())
            and rows["leaking"]["in_leak"] and not rows["finalizing"]["in_leak"]):
        emit({"phase": "epoch_balance", "error": "the card's output differs from the CPU's"})
        return None
    return True


def mesh_phase(c):
    """The mesh (parallel/, torch_backend/multichip.py) on the one card: a
    2-seat mesh on cuda:0, both seats on the main backend.  (a) the sharded
    program over the seats' keyed programs (one 2,048-set key), on the
    valid, one-bad and bad-at-0 batches, against the single-device 4,096
    key; (b) registry mode over the 2^20-slot registry of the registry
    phase, partitioned on the validator axis; (c) multichip's two programs
    against the single-device verdicts; (d) the pod over the seats with a
    stand-in ladder, its keys built before traffic: clean, one bad, a
    dropped shard retried, a seat excluded; (e) two threads dispatching through one key on their own
    streams.  Returns the launch counts of the mesh path (the sharded
    program's first run, which builds its key), or None on a failure."""
    import resource

    import numpy as np

    from lighthouse_tpu_torch.crypto.bls.torch_backend import multichip as MC
    from lighthouse_tpu_torch.parallel import make_mesh, partition as PP, pod as POD
    from lighthouse_tpu_torch.utils import faults as FA, metrics as M

    torch, api, backend, bk, smi, PG = c.torch, c.api, c.backend, c.bk, c.smi, c.PG
    t_phase = time.perf_counter()
    rss0 = PG._host_rss_bytes()
    c.set_arm("default")
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
        return ok

    mesh = make_mesh(2, device="cuda:0")
    shared = all(bk.for_device(seat) is bk for seat in mesh.seats)
    emit({"phase": "mesh", "step": "mesh", "seats": [str(s) for s in mesh.seats],
          "width": mesh.width, "shared_backend": shared})
    check(shared, "the seats do not share the backend")
    mbs, half = c.mesh_batches, N_SETS // mesh.width
    seat_key = (half, True, False, False, False)

    # -- (a) the sharded program -------------------------------------------
    prog = PP.ShardedVerifyProgram(mesh, seat_program=bk.seat_program, pk_wrap=bk.registry_pk_wrap)
    keys0 = set(bk.builds)
    backend.reset_launch_counts()  # the counts just before the mesh path
    first = prog.verdict_vector(mbs["valid"].args)  # builds the seat key
    mesh_counts = backend.launch_counts()  # read just after: the build's
    order = ("valid", "one_bad", "bad_at_0")
    backend.reset_launch_counts()
    handles = [prog.dispatch(mbs[name].args) for name in order]  # all in flight first
    vectors = [prog.resolve(h).tolist() for h in handles]
    replay_launches = sum(backend.launch_counts().values())
    new_keys = sorted(set(bk.builds) - keys0, key=str)
    rec = bk.builds.get(seat_key, {})
    timings = {"sharded": [], "single": [], "placement": []}
    for _ in range(3):
        for path in ("sharded", "single"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = (prog.resolve(prog.dispatch(mbs["valid"].args)).all() if path == "sharded"
                  else bk.resolve(bk.dispatch(mbs["valid"])))
            timings[path].append(time.perf_counter() - t0)
            check(bool(ok), f"{path} verify of the valid batch")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog.shard_operands(prog.pad_operands(mbs["valid"].args))
        torch.cuda.synchronize()
        timings["placement"].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in timings.items()}
    emit({"phase": "mesh", "step": "sharded", "card": smi, "batches": order,
          "verdict_vectors": vectors, "first_vector": first.tolist(), "new_keys": new_keys,
          "build": {k: v for k, v in rec.items() if k != "launches"},
          "launches_at_capture": rec.get("launches"),
          "launches_build_total": sum(mesh_counts.values()),
          "launches_on_replay": replay_launches,
          "sharded_s": med["sharded"], "single_s": med["single"],
          "placement_s": med["placement"],
          "sharded_sets_per_s": N_SETS / med["sharded"], "single_sets_per_s": N_SETS / med["single"],
          "sharded_over_single": med["single"] / med["sharded"],
          "sharded_s_each": timings["sharded"], "single_s_each": timings["single"]})
    check(vectors == [[True, True], [True, False], [False, True]] and first.tolist() == [True, True],
          "sharded verdict vectors")
    check(new_keys == [seat_key] and replay_launches == 0, "sharded keys or replay launches")
    check(all(mesh_counts[k] > 0 for k in ("mont_mul", "miller_step_dbl", "miller_step_add")),
          "the mesh path did not launch the default arm's kernels")

    # -- (b) registry mode ---------------------------------------------------
    reg = c.registry
    cache = reg.eng.cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reg_x, reg_y = cache.registry_device_sharded(mesh)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    per_seat = [x.nbytes + y.nbytes for x, y in zip(reg_x, reg_y)]
    other = reg.sets[1].signature
    bad0 = list(reg.sets)
    bad0[0] = api.SignatureSet(other, reg.sets[0].signing_keys, reg.sets[0].message)
    mesh_mbs = [reg.eng.marshal_for_mesh(b) for b in (reg.sets, reg.bad, bad0)]
    slots = mesh_mbs[0].slots
    seat_slots = [slots.to(seat) for seat in mesh.seats]
    xs, ys = PP._registry_gather(reg_x, reg_y, seat_slots, mesh)
    host_x, host_y = cache.registry_columns(slots.numpy())
    gathered_equal = (np.array_equal(torch.cat(xs, 1).cpu().numpy(), host_x)
                      and np.array_equal(torch.cat(ys, 1).cpu().numpy(), host_y))
    gather_ms = time_ms(torch, lambda: PP._registry_gather(reg_x, reg_y, seat_slots, mesh),
                        GATHER_LAUNCHES)
    keys0 = set(bk.builds)
    reg_vectors = [prog.resolve(prog.dispatch_registry((reg_x, reg_y), m.slots, m.args)).tolist()
                   for m in mesh_mbs]
    emit({"phase": "mesh", "step": "registry", "card": smi, "slots": cache.registry_size(),
          "mirror_bytes": cache.device_bytes(), "per_seat_bytes": per_seat,
          "upload_s": upload_s, "deferred": all(m.slots is not None for m in mesh_mbs),
          "gathered_equal": gathered_equal, "gather_ms": gather_ms,
          "bad_sets": [None, REGISTRY_BAD, 0], "verdict_vectors": reg_vectors,
          "keys_built": len(set(bk.builds) - keys0)})
    check(all(2 * b == cache.device_bytes() for b in per_seat) and gathered_equal
          and all(m.slots is not None for m in mesh_mbs) and set(bk.builds) == keys0
          and reg_vectors == [[True, True], [True, False], [False, True]], "registry mode")
    reg.eng.close()
    # the 2^20 registry's Python objects go before the rest of the phase
    c.registry = None
    del reg, cache, reg_x, reg_y, xs, ys, mesh_mbs, seat_slots

    # -- (c) multichip ---------------------------------------------------------
    bk_h = backend.TorchBackend(device="cuda", device_h2c=False)  # host H(m): marshal only
    mb64 = bk_h.marshal_sets(c.pool)
    reps = MC_SETS // len(c.pool)
    pk, sig, h, _ = PG.map_operands(lambda t, _: t.repeat(*([1] * (t.dim() - 1)), reps),
                                    mb64.args)
    wbits = backend._pack_wbits([c.rng.getrandbits(64) | 1 for _ in range(MC_SETS)])

    def one_bad_h(hh):
        """set MC_BAD's message point replaced by its neighbour's"""
        def cut(t, _):
            t = t.clone()
            t[..., MC_BAD] = t[..., MC_BAD + 1]
            return t
        return PG.map_operands(cut, hh)

    def eager_single(*args):
        with torch.inference_mode():
            return bool(bk_h.local_verify_fn()(*backend._to_device(args, c.dev)))

    sharded_verify = MC.make_verify_sharded(mesh)
    mc = {}
    for name, hh in (("valid", h), ("one_bad", one_bad_h(h))):
        args = (pk, sig, hh, wbits)
        t0 = time.perf_counter()
        got = bool(sharded_verify(*args))
        mc[name] = {"sharded": got, "sharded_s": time.perf_counter() - t0,
                    "single_eager": eager_single(*args)}
    keys0 = set(bk.builds)
    sks = [api.SecretKey(c.rng.randrange(1, api.params.R)) for _ in range(AGG_MESH)]
    msgs = [c.rng.randbytes(32) for _ in range(AGG_MESH)]
    sig_pts = [sk.sign(m).point for sk, m in zip(sks, msgs)]
    pks = [sk.public_key() for sk in sks]
    h_pts = [c.hash_to_g2(m) for m in msgs]
    pair_verify = MC.make_pair_sharded_aggregate_verify(mesh)
    host = torch.device("cpu")
    stranger = api.SecretKey(c.rng.randrange(1, api.params.R)).public_key()
    for name, n, keys in (("n64", AGG_MESH, pks), ("n63", AGG_MESH - 1, pks),
                          ("n64_one_bad", AGG_MESH, [stranger] + pks[1:])):
        sig_n = api.Signature(g2_sum(sig_pts[:n]))
        t0 = time.perf_counter()
        got = bool(pair_verify(c.P.g1_encode([k.point for k in keys[:n]], host),
                               c.P.g2_encode(h_pts[:n], host),
                               c.P.g2_encode([sig_n.point], host)))
        mc[name] = {"pair_sharded": got, "pair_sharded_s": time.perf_counter() - t0,
                    "single": bk.aggregate_verify(keys[:n], msgs[:n], sig_n)}
    emit({"phase": "mesh", "step": "multichip", "card": smi, "sets": MC_SETS, "bad_set": MC_BAD,
          "pairs": AGG_MESH, **mc, "keys_built": len(set(bk.builds) - keys0)})
    check(mc["valid"] == {**mc["valid"], "sharded": True, "single_eager": True}
          and mc["one_bad"] == {**mc["one_bad"], "sharded": False, "single_eager": False}
          and all(mc[k]["pair_sharded"] is mc[k]["single"] is (k != "n64_one_bad")
                  for k in ("n64", "n63", "n64_one_bad"))
          and set(bk.builds) == keys0, "multichip verdicts")
    del pk, sig, h, wbits, mb64

    # -- (d) the pod over the seats, with a stand-in ladder ------------------
    class StandIn:
        """The single-device ladder's surface (verify_batch, breaker,
        journal): the batch verified through the main backend and, where it
        fails, bisected down to each bad set alone.  A group of fewer than
        ``lanes`` sets runs padded with copies of its first set, through the
        pod's seat key of that many lanes, not a key of its own; each
        group's verdict is kept.  Its breaker always allows."""

        def __init__(self, lanes):
            self.lanes = lanes
            self.seconds = 0.0  # spent in verify_batch
            self.calls = 0  # device verifies
            self.journal = []
            self.groups = {}  # the groups' set ids -> their verdict
            self.breaker = types.SimpleNamespace(allow_device=lambda: True,
                                                 record_success=lambda: None,
                                                 record_failure=lambda: None)

        def group(self, sets):
            key = tuple(id(s) for s in sets)
            if key not in self.groups:
                self.calls += 1
                pad = sets[:1] * (self.lanes - len(sets))
                self.groups[key] = bk.verify_signature_sets(sets + pad)
            return self.groups[key]

        def verdicts(self, sets):
            if self.group(sets):
                return [True] * len(sets)
            if len(sets) == 1:
                return [False]
            mid = len(sets) // 2
            return self.verdicts(sets[:mid]) + self.verdicts(sets[mid:])

        def verify_batch(self, sets):
            self.journal.append(("device", len(sets)))
            t0, calls0 = time.perf_counter(), self.calls
            got = self.verdicts(list(sets))
            self.seconds += time.perf_counter() - t0
            return POD.BatchOutcome(got, self.calls - calls0)

    class SeatFaults(FA.FaultInjector):
        """pod.dispatch faults delivered only in the shard thread of seat 1."""

        def fire(self, site, payload=None):
            if site == "pod.dispatch" and threading.current_thread().name != "pod-shard-1":
                return payload
            return super().fire(site, payload)

    def pod_for(**kw):
        return POD.PodVerifier(standin, backend=bk, devices=list(mesh.seats),
                               shard_timeout=POD_SHARD_TIMEOUT_S, backoff_base=0.0, **kw)

    standin = StandIn(POD_SETS // mesh.width)
    keys0 = set(bk.builds)
    pod_rows = {}
    # the seat key of the one-bad batch, built before the pods take traffic
    # (the 4,096-set batches' keys, 2,048 and 4,096, are built already)
    t0 = time.perf_counter()
    warmed = pod_for().warm_compile([POD_SETS], widths=(mesh.width,))
    warm_s = time.perf_counter() - t0
    pod_key = (POD_SETS // mesh.width, True, False, False, False)
    pod_rows["warm"] = {"s": warm_s, "warmed": [[str(d), b] for d, b in warmed],
                        "build": {k: v for k, v in bk.builds.get(pod_key, {}).items()
                                  if k != "launches"}}

    def run(name, pod, sets):
        m0 = {k: getattr(M, k).value() for k in ("POD_RETRIES", "POD_RESHARDS", "POD_EXCLUSIONS",
                                                  "POD_FALLBACKS")}
        t0 = time.perf_counter()
        out = pod.verify_batch(sets)
        row = {"s": time.perf_counter() - t0, "device_calls": out.device_calls,
               "all_true": all(out.verdicts), "false_at": [i for i, v in enumerate(out.verdicts)
                                                          if not v],
               "excluded": pod.health.excluded() if pod.health else [],
               **{k.lower(): getattr(M, k).value() - v for k, v in m0.items()}}
        pod_rows[name] = row
        return out, row

    _, row = run("clean", pod_for(injector=FA.FaultInjector()), c.batches["valid"])
    check(row["all_true"] and row["device_calls"] == 2 and standin.journal == [("pod", N_SETS)],
          "pod clean")
    sets64 = list(c.pool[:POD_SETS])
    sets64[POD_BAD] = api.SignatureSet(c.pool[POD_BAD + 1].signature, c.pool[POD_BAD].signing_keys,
                                       c.pool[POD_BAD].message)
    del standin.journal[:]
    ladder_s0 = standin.seconds
    out, row = run("one_bad", pod_for(injector=FA.FaultInjector()), sets64)
    ladder = list(standin.journal)
    row.update(ladder_s=standin.seconds - ladder_s0, ladder_calls=out.device_calls - 2)
    t0 = time.perf_counter()
    # the stand-in's own verdicts on all 64, half by half (its key)
    half_pod = POD_SETS // mesh.width
    oracle = [v for i in range(0, POD_SETS, half_pod)
              for v in standin.verify_batch(sets64[i:i + half_pod]).verdicts]
    row.update(ladder=ladder, oracle_s=time.perf_counter() - t0,
               identical=out.verdicts == oracle)
    check(out.verdicts == oracle and ladder == [("device", half_pod)]
          and row["false_at"] == [POD_BAD], "pod one bad")
    inj = FA.FaultInjector()
    inj.arm("pod.dispatch", "shard-drop", times=1)
    _, row = run("retry", pod_for(injector=inj, sharded=False, max_shard_retries=2,
                                  exclusion_threshold=2), c.batches["valid"])
    check(row["all_true"] and row["device_calls"] == 2 and row["pod_retries"] == 1
          and row["excluded"] == [], "pod retry")
    inj = SeatFaults()
    inj.arm("pod.dispatch", "shard-drop")
    _, row = run("exclusion", pod_for(injector=inj, sharded=False, max_shard_retries=1,
                                      exclusion_threshold=2), c.batches["valid"])
    check(row["all_true"] and row["device_calls"] == 1 and row["excluded"] == [1]
          and row["pod_reshards"] == 1, "pod exclusion")
    new_keys = sorted(set(bk.builds) - keys0, key=str)
    emit({"phase": "mesh", "step": "pod", "card": smi, "rows": pod_rows, "bad_set": POD_BAD,
          "new_keys": new_keys})
    check(new_keys == [pod_key] and [b for _, b in warmed] == [pod_key[0]], "pod keys")

    # -- (e) two threads through one key ---------------------------------------
    good = bk.marshal_sets(c.batches["valid"][:half])
    bad = bk.marshal_sets(c.batches["bad_at_0"][:half])
    results, errors = {}, []

    def dispatcher(tid):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                want = [(i + tid) % 2 == 0 for i in range(THREAD_BATCHES)]
                handles = [bk.dispatch(good if ok else bad) for ok in want]
                results[tid] = ([bk.resolve(h) for h in handles], want)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(repr(exc))

    keys0 = set(bk.builds)
    threads = [threading.Thread(target=dispatcher, args=(t,)) for t in range(2)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(THREAD_JOIN_S)
    threads_s = time.perf_counter() - t0
    right = sum(g == w for got, want in results.values() for g, w in zip(got, want))
    emit({"phase": "mesh", "step": "threads", "card": smi, "key": seat_key,
          "dispatches": 2 * THREAD_BATCHES, "right": right, "errors": errors,
          "seconds": threads_s, "keys_built": len(set(bk.builds) - keys0)})
    check(right == 2 * THREAD_BATCHES and not errors and set(bk.builds) == keys0,
          "concurrent dispatches")

    emit({"phase": "mesh", "step": "cost", "card": smi,
          "seconds": time.perf_counter() - t_phase,
          "host_rss_gib_start": rss0 / 2**30, "host_rss_gib_end": PG._host_rss_bytes() / 2**30,
          "host_maxrss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
          "failures": failures})
    if failures:
        emit({"phase": "mesh", "error": "a mesh check failed", "failures": failures})
        return None
    return mesh_counts


def serve_phase(c):
    """The front door over the main backend on the default arm: (a) the
    pipelined stream against the same batches in series; (b) bisection of
    one bad set by the ladder; (c) the guarded service behind its HTTP edge,
    two tenants, then 2,048-set batches at k = 2 and k = 0; (d) a silent
    lie through the 2-seat pod caught by the canaries; (e) the cross-arm
    audit; (f) the selfcheck over every verify key; (g) the entry point in
    a child process.  Returns the launch counts of the phase's run (the
    builds of its keys), or None on a failure."""
    import re
    import signal
    import urllib.error
    import urllib.request

    from lighthouse_tpu_torch import cli as CLI
    from lighthouse_tpu_torch.beacon.processor import (
        CircuitBreaker, PipelinedVerifier, ResilientVerifier)
    from lighthouse_tpu_torch.crypto.bls.torch_backend import _build, aot
    from lighthouse_tpu_torch.ingest import IngestEngine
    from lighthouse_tpu_torch.integrity import CrossArmAuditor, IntegrityGuard, run_selfcheck
    from lighthouse_tpu_torch.parallel import make_mesh, pod as POD
    from lighthouse_tpu_torch.serve import ServeApiServer, TenantPolicy, VerifyService
    from lighthouse_tpu_torch.serve.stack import build_verify_stack
    from lighthouse_tpu_torch.utils import faults as FA, metrics as M

    torch, api, backend, bk, smi, PG = c.torch, c.api, c.backend, c.bk, c.smi, c.PG
    t_phase = time.perf_counter()
    rss0 = PG._host_rss_bytes()
    c.set_arm("default")
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
        return ok

    def oracle(sets):
        return api.cpu_backend().verify_signature_sets(list(sets))

    def one_bad(sets, i):
        """``sets`` with set i's signature swapped for its neighbour's"""
        out = list(sets)
        out[i] = api.SignatureSet(sets[i + 1].signature, sets[i].signing_keys, sets[i].message)
        return out

    def built(keys_before, step):
        """Emit every key built since ``keys_before`` with its seconds and
        host memory; returns the new keys."""
        new = sorted(set(bk.builds) - keys_before, key=str)
        for key in new:
            rec = bk.builds[key]
            emit({"phase": "serve", "step": "key_built", "by": step, "key": key,
                  **{k: rec.get(k) for k in ("build_s", "warmup_s", "capture_s", "instantiate_s",
                                             "capture_host_bytes", "instantiate_host_bytes")},
                  "host_rss_gib": PG._host_rss_bytes() / 2**30})
        return new

    def device_only(journal):
        return bool(journal) and all(kind in ("device", "pod") for kind, _ in journal)

    api.register_backend(bk)  # the main backend is "torch" for the stack
    api.set_backend("torch")
    single = [s for s in c.pool if len(s.signing_keys) == 1]  # 60 single-signer sets
    backend.reset_launch_counts()  # the counts just before the serve path

    def http(port, path, doc=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", method="POST" if doc is not None else "GET",
            data=None if doc is None else json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    def wire(sets):
        return [{"signature": "0x" + s.signature.to_bytes().hex(),
                 "pubkeys": ["0x" + k.to_bytes().hex() for k in s.signing_keys],
                 "message": "0x" + s.message.hex()} for s in sets]

    def poll(port, rid, until):
        while time.perf_counter() < until:
            status, doc = http(port, f"/eth/v1/verify/batch/{rid}")
            if status == 200 and doc["data"]["status"] == "done":
                return doc["data"]
            time.sleep(0.05)
        return None

    # -- the canaries' key (and the lie's seats' and the child's), built before
    # traffic and captured into the datadir (g)'s child boots from, beside a
    # copy of the built kernel libraries laid out as its compile cache
    datadir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    store = aot.AotStore(os.path.join(datadir, CLI.AOT_CACHE))
    shutil.copytree(_build.build_dir(),
                    os.path.join(datadir, CLI.KERNEL_CACHE, _build.source_hash()),
                    ignore=shutil.ignore_patterns("*.log", "*.tmp"))
    keys0 = set(bk.builds)
    bk.attach_aot_store(store)
    bk.warm_compile(8)
    bk.attach_aot_store(None)
    built(keys0, "warm_compile(8)")
    child_entries = sorted(m["cache_key"] for m in store.entries().values())
    check(child_entries == [[8, True, False, False, False]], "the child's store")

    # -- (g), started: the entry point in a child process, booting from the store
    root = os.path.dirname(os.path.abspath(__file__))
    err_log = tempfile.NamedTemporaryFile("w+", suffix=".log", delete=False)
    t_child = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "lighthouse_tpu_torch.serve", "--port", "0",
         "--datadir", datadir, "--prewarm", "--selfcheck", "--run-secs", str(SERVE_CHILD_RUN_S)],
        cwd=root, stdout=subprocess.PIPE, stderr=err_log, text=True)
    child_lines = []  # (seconds since its start, line): the "up" line is its first

    def read_child():
        for line in iter(child.stdout.readline, ""):
            child_lines.append((time.perf_counter() - t_child, line))

    reader = threading.Thread(target=read_child, daemon=True)
    reader.start()

    # -- (b) bisection of one bad set by the ladder ---------------------------
    calls = []

    def device_verify(sets):
        calls.append(len(sets))
        return bk.verify_signature_sets(sets)

    rv_b = ResilientVerifier(device_verify=device_verify, cpu_verify=oracle,
                             breaker=CircuitBreaker())
    sets_b = one_bad(single[:SERVE_BISECT_SETS + 1], SERVE_BISECT_BAD)[:SERVE_BISECT_SETS]
    keys0 = set(bk.builds)
    t0 = time.perf_counter()
    out_b = rv_b.verify_batch(sets_b)
    bisect_s = time.perf_counter() - t0
    new_b = built(keys0, "bisection")
    held = sorted(k[0] for k in bk.builds if isinstance(k[0], int) and not k[2] and not k[3])
    need_4096 = [1 << e for e in range(11, 2, -1)]  # 2,048 down to the 8-set key
    emit({"phase": "serve", "step": "bisection", "card": smi, "sets": SERVE_BISECT_SETS,
          "bad_set": SERVE_BISECT_BAD, "seconds": bisect_s, "device_calls": len(calls),
          "call_sizes": calls, "keys_built": new_b, "journal": rv_b.journal,
          "false_at": [i for i, v in enumerate(out_b.verdicts) if not v],
          "keys_a_4096_bisection_needs": need_4096,
          "of_them_not_held": [b for b in need_4096 if b not in held],
          "calls_at_4096": 1 + 2 * 12})
    check(out_b.verdicts == [i != SERVE_BISECT_BAD for i in range(SERVE_BISECT_SETS)]
          and rv_b.journal == [("device", SERVE_BISECT_SETS)] and rv_b.breaker.is_closed,
          "bisection verdicts")
    check(new_b == [(SERVE_BISECT_SETS // 2, True, False, False, False)],
          "the bisection's keys: the 16-set key built, no other")

    # -- (d) a silent lie through the 2-seat pod, caught by the canaries ------
    mesh = make_mesh(2, device="cuda:0")
    # the pod's marshal pads to N_SETS lanes, so each seat runs the mesh
    # phase's 2,048-set key and a canary probe on one seat the 4,096-set key:
    # no key is built for the pod's batches
    bk_pad = backend.TorchBackend(device="cuda", min_batch=N_SETS)
    rv_d = ResilientVerifier(device_verify=bk.verify_signature_sets, cpu_verify=oracle,
                             breaker=CircuitBreaker())
    inj = FA.FaultInjector()
    pod = POD.PodVerifier(rv_d, backend=bk, marshal=bk_pad.marshal_sets, devices=list(mesh.seats),
                          shard_timeout=POD_SHARD_TIMEOUT_S, backoff_base=0.0, injector=inj)
    guard_d = IntegrityGuard(pod, rv_d)
    guard_d.attach_pod(pod)
    lie = one_bad(single[8:8 + SERVE_LIE_SETS + 1], SERVE_LIE_BAD)[:SERVE_LIE_SETS]
    truth = [i != SERVE_LIE_BAD for i in range(SERVE_LIE_SETS)]
    keys0 = set(bk.builds)
    inj.arm("pod.gather", "silent-stuck-true")
    t0 = time.perf_counter()
    out_lie = guard_d.verify_batch(lie)
    lie_s = time.perf_counter() - t0
    unguarded = pod.verify_batch(lie).verdicts  # what the pod alone released
    inj.disarm()
    journal_lie = list(rv_d.journal)
    del rv_d.journal[:]
    t0 = time.perf_counter()
    out_clean = guard_d.verify_batch(single[8:8 + SERVE_LIE_SETS])
    clean_s = time.perf_counter() - t0
    emit({"phase": "serve", "step": "lie", "card": smi, "sets": SERVE_LIE_SETS,
          "bad_set": SERVE_LIE_BAD, "armed": "pod.gather=silent-stuck-true",
          "lie_s": lie_s, "released": out_lie.verdicts, "truth": truth,
          "pod_alone_released": unguarded, "journal_lie": journal_lie,
          "clean_s": clean_s, "clean_all_true": all(out_clean.verdicts),
          "journal_clean": list(rv_d.journal), "stats": guard_d.stats(),
          "strikes": {str(k): v for k, v in guard_d.trust.snapshot().items()},
          "breaker": rv_d.breaker.state.name, "keys_built": built(keys0, "lie")})
    check(out_lie.verdicts == truth and guard_d.distrusted >= 1
          and ("cpu", SERVE_LIE_SETS) in journal_lie and unguarded == [True] * SERVE_LIE_SETS,
          "the lie was not caught")
    check(all(out_clean.verdicts) and device_only(rv_d.journal) and rv_d.breaker.is_closed
          and guard_d.distrusted == 1, "clean traffic after the lie")

    # -- (e) the cross-arm audit: vpu15, then mxu13 (its key built here) ------
    rv_e = ResilientVerifier(device_verify=bk.verify_signature_sets, cpu_verify=oracle,
                             breaker=CircuitBreaker())
    auditor = CrossArmAuditor(oracle, backend=bk, arms=("vpu15", "mxu13"), fraction=1.0)
    guard_e = IntegrityGuard(rv_e, rv_e, k=0, auditor=auditor)  # the audit alone
    sets_e = single[:SERVE_AUDIT_SETS]
    keys0 = set(bk.builds)
    modes = ("vpu15", "mxu13", "cpu")
    audits0 = {m: M.INTEGRITY_AUDITS.value((m,)) for m in modes}
    rows = []
    for arm in ("vpu15", "mxu13"):
        t0 = time.perf_counter()
        out = guard_e.verify_batch(sets_e)
        rows.append({"arm": arm, "s": time.perf_counter() - t0, "all_true": all(out.verdicts)})
    new_e = built(keys0, "audit")
    audit_modes = {m: M.INTEGRITY_AUDITS.value((m,)) - audits0[m] for m in modes}
    mxu_key = (SERVE_AUDIT_SETS, True, True, False, False)
    emit({"phase": "serve", "step": "audit", "card": smi, "sets": SERVE_AUDIT_SETS,
          "rows": rows, "stats": guard_e.stats(), "modes": audit_modes, "keys_built": new_e,
          "mxu13_key_build_s": bk.builds.get(mxu_key, {}).get("build_s"),
          "journal": rv_e.journal, "gates_after": [c.F.chains_active(), c.F.wsm_fused_active(),
                                                   c.F.mxu_active()]})
    check(all(r["all_true"] for r in rows) and guard_e.audits == 2 and guard_e.sdc_events == 0
          and audit_modes == {"vpu15": 1, "mxu13": 1, "cpu": 0} and new_e == [mxu_key]
          and device_only(rv_e.journal) and not c.F.mxu_active(),
          "cross-arm audit")

    # -- (g) the child's round trip, on a thread beside (f): it is up by now -----
    child_sets = one_bad(single[:SERVE_CHILD_SETS + 1], SERVE_CHILD_BAD)[:SERVE_CHILD_SETS]
    child_verdicts = [i != SERVE_CHILD_BAD for i in range(SERVE_CHILD_SETS)]
    child_row = {}

    def child_round_trip():
        try:
            round_trip_body()
        except Exception as exc:  # a timeout, a refused connection, a malformed reply
            child_row["error"] = repr(exc)
            check(False, f"the child's round trip raised {exc!r}")

    def round_trip_body():
        t_up = time.perf_counter() + SERVE_CHILD_UP_S
        while time.perf_counter() < t_up and not child_lines and child.poll() is None:
            time.sleep(0.1)
        m = re.search(r"127\.0\.0\.1:(\d+)/", child_lines[0][1]) if child_lines else None
        if not check(m is not None, "the child did not come up"):
            return
        child_port = int(m.group(1))
        child_row["up_s"] = child_lines[0][0]
        child_row["up_seen_s"] = time.perf_counter() - t_child
        child_row["health"] = http(child_port, "/health")
        t0 = time.perf_counter()
        status, doc = http(child_port, "/eth/v1/verify/batch",
                           {"tenant": "smoke", "deadline_ms": 2000, "sets": wire(child_sets)})
        child_row["post_status"] = status
        child_rid = doc.get("data", {}).get("request_id") if status == 202 else None
        if not check(child_row["health"] == (200, {"status": "ok"}) and child_rid is not None,
                     "the child's health or post"):
            return
        doc = poll(child_port, child_rid, time.perf_counter() + SERVE_POLL_S)
        child_row["post_to_verdict_s"] = time.perf_counter() - t0
        child_row["verdicts"] = doc and doc["verdicts"]
        child_row["deadline_missed"] = doc and doc["deadline_missed"]
        check(doc is not None and doc["verdicts"] == child_verdicts, "the child's verdicts")

    round_trip = threading.Thread(target=child_round_trip, daemon=True)
    round_trip.start()

    # -- (f) the selfcheck over every verify key held ---------------------------
    keys0 = set(bk.builds)
    t0 = time.perf_counter()
    report = run_selfcheck(bk)
    emit({"phase": "serve", "step": "selfcheck", "card": smi, "ok": report.ok,
          "seconds": time.perf_counter() - t0, "checked": report.checked,
          "batch_sizes": report.batch_sizes, "keys": report.keys, "skipped": report.skipped,
          "mismatches": report.mismatches, "keys_built": len(set(bk.builds) - keys0)})
    check(report.ok and set(report.keys) == {k for k in bk._programs if isinstance(k[0], int)}
          and set(bk.builds) == keys0, "selfcheck")
    round_trip.join(SERVE_CHILD_UP_S + SERVE_POLL_S)
    # the thread's own checks may not have run: a round trip still going, or
    # one that ended early, fails here too
    check(not round_trip.is_alive(), "the child's round trip outlived its wait")
    check(child_row.get("verdicts") == child_verdicts, "the child's verdicts, after the wait")
    if child.poll() is None:
        child.send_signal(signal.SIGINT)  # it exits while (c) and (a) run

    # -- (c) the front door: the guarded stack behind its HTTP edge -------------
    stack = build_verify_stack()  # integrity auto: the guard at k = 2 over the ladder

    class Recorder:
        """The stack's verifier, each FIFO batch and its outcome kept."""

        def __init__(self, inner):
            self.inner, self.batches = inner, []

        def verify_batch(self, sets):
            out = self.inner.verify_batch(sets)
            self.batches.append((list(sets), list(out.verdicts)))
            return out

    rec = Recorder(stack.verifier)
    policy = TenantPolicy(rate=SERVE_HTTP_RATE, burst=2 * SERVE_HTTP_REQ)
    svc = VerifyService(rec, breaker=stack.breaker, compiled_sizes=SERVE_HTTP_SIZES,
                        flush_margin=0.05, default_deadline_s=5.0,
                        policies={"honest": policy, "greedy": policy}).start()
    server = ServeApiServer(svc, port=0).start()
    n_honest = SERVE_HTTP_REQS * SERVE_HTTP_REQ
    honest = one_bad([single[(4 + i) % len(single)] for i in range(n_honest + 1)],
                     SERVE_HTTP_BAD)[:n_honest]
    honest_wire = [wire(honest[i:i + SERVE_HTTP_REQ])
                   for i in range(0, len(honest), SERVE_HTTP_REQ)]
    greedy_wire = wire(single[:SERVE_HTTP_REQ])
    posted = {"honest": [], "greedy": []}  # (status, body) per post, list.append is atomic
    keys0 = set(bk.builds)
    keys_in_stack = set(bk.builds)

    def tenant(name, docs, period):
        t_next = time.perf_counter()
        for sets in docs:
            posted[name].append(http(server.port, "/eth/v1/verify/batch",
                                     {"tenant": name, "deadline_ms": 5000, "sets": sets}))
            t_next += period
            time.sleep(max(0.0, t_next - time.perf_counter()))

    t0 = time.perf_counter()
    g = SERVE_HTTP_GREEDY_THREADS  # together ten times the honest pace
    tenants = [threading.Thread(target=tenant, args=("honest", honest_wire, SERVE_HTTP_PERIOD_S))]
    tenants += [threading.Thread(target=tenant, args=(
        "greedy", [greedy_wire] * (10 * SERVE_HTTP_REQS // g), g * SERVE_HTTP_PERIOD_S / 10))
        for _ in range(g)]
    for t in tenants:
        t.start()
    for t in tenants:
        t.join(120)
    rids = [doc["data"]["request_id"] for status, doc in posted["honest"] if status == 202]
    until = time.perf_counter() + SERVE_POLL_S
    polled = [poll(server.port, rid, until) for rid in rids]
    http_s = time.perf_counter() - t0
    served = [v for doc in polled if doc for v in doc["verdicts"]]
    greedy_status = [status for status, _ in posted["greedy"]]
    _, stats_doc = http(server.port, "/eth/v1/verify/tenants")
    server.stop()
    svc.stop()
    bare = [(stack.resilient.verify_batch(sets).verdicts, got) for sets, got in rec.batches]
    emit({"phase": "serve", "step": "front_door", "card": smi, "seconds": http_s,
          "honest_requests": len(honest_wire), "honest_accepted": len(rids),
          "honest_status": sorted({status for status, _ in posted["honest"]}),
          "greedy_posted": len(greedy_status), "greedy_accepted": greedy_status.count(202),
          "greedy_shed_429": greedy_status.count(429),
          "greedy_other": [s for s in greedy_status if s not in (202, 429)],
          "tenants": stats_doc.get("data"), "batches": [len(s) for s, _ in rec.batches],
          "flushes": {"full": svc.batcher.flushes_full, "deadline": svc.batcher.flushes_deadline},
          "served_equals_truth": served == [i != SERVE_HTTP_BAD for i in range(len(honest))],
          "bare_equals_served": all(b == g for b, g in bare),
          "guard": stack.integrity.stats(), "deadline_misses": svc.deadline_misses,
          "journal_kinds": sorted({k for k, _ in stack.resilient.journal}),
          "keys_built": built(keys0, "front_door")})
    check(len(rids) == len(honest_wire) and all(p is not None for p in polled)
          and served == [i != SERVE_HTTP_BAD for i in range(len(honest))]
          and all(b == g for b, g in bare) and greedy_status.count(429) > 0
          and set(greedy_status) <= {202, 429} and stack.integrity.distrusted == 0
          and device_only(stack.resilient.journal) and stack.breaker.is_closed,
          "the front door over HTTP")

    # -- (c) 2,048-set batches through the service, k = 2 and k = 0, and bare --
    big = [single[i % len(single)] for i in range(SERVE_BIG)]
    rows = {}
    for name, verifier in (("k2", stack.verifier),
                           ("k0", IntegrityGuard(stack.resilient, stack.resilient, k=0)),
                           ("bare", None)):
        lat, j0 = [], len(stack.resilient.journal)
        t0 = time.perf_counter()
        if verifier is None:
            for _ in range(SERVE_BIG_REPS):
                t1 = time.perf_counter()
                ok = all(stack.resilient.verify_batch(big).verdicts)
                lat.append(time.perf_counter() - t1)
                check(ok, "bare 2,048-set verify")
        else:
            svc = VerifyService(verifier, breaker=stack.breaker, compiled_sizes=(SERVE_BIG,),
                                default_deadline_s=10.0,
                                default_policy=TenantPolicy(rate=1e9, burst=1e9,
                                                            max_queue=SERVE_BIG)).start()
            for _ in range(SERVE_BIG_REPS):
                res = svc.submit("bulk", big)
                doc = None
                until = time.perf_counter() + SERVE_POLL_S
                while time.perf_counter() < until:
                    doc = svc.result(res.request_id)
                    if doc["status"] == "done":
                        break
                    time.sleep(0.002)
                req = svc._requests[res.request_id]
                lat.append(req.done_at - req.submitted_at)
                check(doc["status"] == "done" and all(doc["verdicts"]),
                      f"2,048-set batch through the service ({name})")
            svc.stop()
        wall = time.perf_counter() - t0
        lat.sort()
        rows[name] = {"sets_per_s": SERVE_BIG * SERVE_BIG_REPS / wall, "wall_s": wall,
                      "p50_s": statistics.median(lat), "p99_s": lat[-1], "latencies_s": lat,
                      "journal": stack.resilient.journal[j0:]}
        check(device_only(stack.resilient.journal[j0:]), f"the {name} batches' rung")
    overhead = rows["k2"]["wall_s"] / rows["k0"]["wall_s"] - 1
    emit({"phase": "serve", "step": "throughput", "card": smi, "sets": SERVE_BIG,
          "reps": SERVE_BIG_REPS, **rows, "canary_overhead": overhead,
          "reference_bar_at_default_k": 0.02, "within_bar": overhead <= 0.02,
          "keys_built": built(keys_in_stack, "throughput")})

    # -- (a) the pipelined stream against the same batches in series ----------
    engine = IngestEngine(bk)
    rv_a = ResilientVerifier(device_verify=bk.verify_signature_sets, cpu_verify=oracle,
                             breaker=CircuitBreaker())
    valid = c.batches["valid"]
    stream = [valid[i * 7:] + valid[:i * 7] for i in range(SERVE_PIPE_BATCHES)]
    pv = PipelinedVerifier.for_backend(rv_a, bk, ingest=engine)
    engine.marshal_sets(stream[0])  # the engine's caches filled once, outside both timings
    gm0, gd0 = M.PIPELINE_MARSHAL_SECONDS.value(), M.PIPELINE_DEVICE_SECONDS.value()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = pv.verify_stream(stream)
    pipe_s = time.perf_counter() - t0
    pipe = {"wall_s": pipe_s, "marshal_busy_s": M.PIPELINE_MARSHAL_SECONDS.value() - gm0,
            "device_busy_s": M.PIPELINE_DEVICE_SECONDS.value() - gd0,
            "occupancy_pct": M.PIPELINE_OCCUPANCY.value(),
            "sets_per_s": N_SETS * SERVE_PIPE_BATCHES / pipe_s}
    serial = {"marshal_s": 0.0, "device_s": 0.0}
    serial_verdicts = []
    t0 = time.perf_counter()
    for sets in stream:
        t1 = time.perf_counter()
        mb = engine.marshal_sets(sets)
        t2 = time.perf_counter()
        serial_verdicts.append(bk.resolve(bk.dispatch(mb)))
        serial["device_s"] += time.perf_counter() - t2
        serial["marshal_s"] += t2 - t1
    serial["wall_s"] = time.perf_counter() - t0
    serial["sets_per_s"] = N_SETS * SERVE_PIPE_BATCHES / serial["wall_s"]
    engine.close()
    pipe_verdicts = [all(o.verdicts) and len(o.verdicts) == N_SETS for o in outs]
    emit({"phase": "serve", "step": "pipeline", "card": smi, "batches": SERVE_PIPE_BATCHES,
          "sets": N_SETS, "pipelined": pipe, "serial": serial,
          "pipelined_over_serial": serial["wall_s"] / pipe_s,
          "verdicts_pipelined": pipe_verdicts, "verdicts_serial": serial_verdicts,
          "journal": rv_a.journal})
    check(pipe_verdicts == serial_verdicts == [True] * SERVE_PIPE_BATCHES
          and rv_a.journal == [("device", N_SETS)] * SERVE_PIPE_BATCHES, "pipelined stream")

    # -- (g) the child's exit and its boot, from its datadir and its log ------
    try:
        child_row["exit"] = child.wait(60)
    except subprocess.TimeoutExpired:
        child.kill()
        child_row["exit"] = child.wait()
    reader.join(5)
    err_log.seek(0)
    child_err = err_log.read()
    err_log.close()
    os.unlink(err_log.name)
    # the boot row (prewarm's report, the nvcc processes it started) and the
    # selfcheck's line; a key built inside a request would have been captured
    # into the store
    rows = []
    with contextlib.suppress(OSError):
        with open(os.path.join(datadir, CLI.BOOT_HISTORY), encoding="utf-8") as f:
            rows = [json.loads(line) for line in f]
    boot_row = rows[-1] if rows else {}
    selfcheck = re.search(r"Integrity selfcheck done, ok: (\w+), checked: (\d+), "
                          r"kernel_batches: ([\d,-]+), wall_s: ([\d.]+)", child_err)
    child_row.update({
        "nvcc_runs": boot_row.get("nvcc_runs"), "prewarm_loaded": boot_row.get("loaded"),
        "prewarm_rejected": boot_row.get("rejected"), "prewarm_s": boot_row.get("wall_s"),
        "prewarm_builds": boot_row.get("builds"),
        "selfcheck": selfcheck and {"ok": selfcheck.group(1) == "True",
                                    "checked": int(selfcheck.group(2)),
                                    "kernel_batches": selfcheck.group(3),
                                    "wall_s": float(selfcheck.group(4))},
        "store_entries_after": sorted(m["cache_key"] for m in store.entries().values())})
    shutil.rmtree(datadir, ignore_errors=True)
    emit({"phase": "serve", "step": "entry_point", "card": smi, **child_row,
          "stdout": [line for _, line in child_lines[:3]],
          "stderr_tail": child_err[-1500:] if child_row.get("exit") else child_err[-300:]})
    check(child_row.get("exit") == 0, "the child's exit")
    check(child_row["nvcc_runs"] == 0 and child_row["prewarm_loaded"] == 1
          and child_row["prewarm_rejected"] == 0 and len(child_row["prewarm_builds"] or ()) == 1
          and (child_row["selfcheck"] or {}).get("ok") is True
          and child_row["selfcheck"]["kernel_batches"] == "8"
          and child_row["store_entries_after"] == child_entries,
          "the child's boot: nvcc, prewarm, selfcheck, or a key built inside its request")

    serve_counts = backend.launch_counts()  # read just after the serve path
    emit({"phase": "serve", "step": "cost", "card": smi,
          "seconds": time.perf_counter() - t_phase, "keys": len(bk.builds),
          "host_rss_gib_start": rss0 / 2**30, "host_rss_gib_end": PG._host_rss_bytes() / 2**30,
          "launches": serve_counts, "failures": failures})
    check(all(serve_counts[k] > 0 for k in ("mont_mul", "miller_step_dbl", "miller_step_add",
                                            "mont_mul_mxu", "miller_step_dbl_mxu",
                                            "miller_step_add_mxu")),
          "the serve path did not launch the default and mxu13 arms' kernels")
    if failures:
        emit({"phase": "serve", "error": "a serve check failed", "failures": failures})
        return None
    return serve_counts


def node_signed_block(spec, state, keypairs, api, slot=1):
    """A signed block whose sets are those of tests/test_block_signatures.py:
    the proposal, the randao reveal, an attestation signed by its committee,
    a voluntary exit and a proposer slashing's two headers (six sets).
    Returns the block, the epoch's committee cache and a pubkey getter."""
    from lighthouse_tpu_torch.consensus import committees as cm
    from lighthouse_tpu_torch.consensus import spec as S
    from lighthouse_tpu_torch.consensus.containers import (
        Attestation, AttestationData, BeaconBlockHeader, Checkpoint, ProposerSlashing,
        SignedBeaconBlockHeader, SignedVoluntaryExit, SigningData, VoluntaryExit, types_for)
    from lighthouse_tpu_torch.consensus.ssz import U64
    from lighthouse_tpu_torch.consensus.state_processing import signature_sets as SS
    from lighthouse_tpu_torch.consensus.testing import pubkey_getter

    preset = spec.preset
    T = types_for(preset)
    cache = cm.CommitteeCache(state, 0, preset)
    fork, gvr = state.fork, state.genesis_validators_root

    def sign(sk, obj, domain):
        return sk.sign(S.compute_signing_root(obj, domain)).to_bytes()

    committee = cache.committee(0, 0)
    data = AttestationData(slot=0, index=0, beacon_block_root=b"\x42" * 32,
                           source=Checkpoint(epoch=0, root=bytes(32)),
                           target=Checkpoint(epoch=0, root=b"\x10" * 32))
    root = S.compute_signing_root(data, SS.get_domain(fork, gvr, S.DOMAIN_BEACON_ATTESTER, 0))
    attestation = Attestation(
        aggregation_bits=[True] * len(committee), data=data,
        signature=api.AggregateSignature.aggregate(
            [keypairs[v][0].sign(root) for v in committee]).to_bytes())
    exit_msg = VoluntaryExit(epoch=0, validator_index=7)
    signed_exit = SignedVoluntaryExit(message=exit_msg, signature=sign(
        keypairs[7][0], exit_msg, SS.get_domain(fork, gvr, S.DOMAIN_VOLUNTARY_EXIT, 0)))
    prop_domain = SS.get_domain(fork, gvr, S.DOMAIN_BEACON_PROPOSER, 0)
    h1, h2 = (BeaconBlockHeader(slot=0, proposer_index=9, body_root=bytes([b]) * 32)
              for b in (1, 2))
    slashing = ProposerSlashing(
        signed_header_1=SignedBeaconBlockHeader(message=h1, signature=sign(keypairs[9][0], h1,
                                                                           prop_domain)),
        signed_header_2=SignedBeaconBlockHeader(message=h2, signature=sign(keypairs[9][0], h2,
                                                                           prop_domain)))
    proposer = cm.get_beacon_proposer_index(state, slot, preset)
    sk = keypairs[proposer][0]
    epoch = slot // preset.slots_per_epoch
    randao_root = SigningData(object_root=U64.hash_tree_root(epoch), domain=SS.get_domain(
        fork, gvr, S.DOMAIN_RANDAO, epoch)).root()
    body = T.BeaconBlockBody(randao_reveal=sk.sign(randao_root).to_bytes(),
                             attestations=[attestation], voluntary_exits=[signed_exit],
                             proposer_slashings=[slashing])
    block = T.BeaconBlock(slot=slot, proposer_index=proposer, parent_root=b"\x33" * 32,
                          body=body)
    signed = T.SignedBeaconBlock(message=block, signature=sign(
        sk, block, SS.get_domain(fork, gvr, S.DOMAIN_BEACON_PROPOSER, epoch)))
    return signed, cache, pubkey_getter(state)


def node_epoch_state(n: int, seed: int):
    """An altair state of ``n`` validators at the epoch-8 boundary of the
    minimal preset: the NODE_VALIDATORS interop validators (their keys made
    once, by the sync's chains) and active copies of them (each a synthetic
    pubkey: no epoch step reads a key), with random participation,
    inactivity scores, balances and slashings, as tests/test_epoch_device.py
    randomizes them (a finalizing chain)."""
    from lighthouse_tpu_torch.consensus import spec as S
    from lighthouse_tpu_torch.consensus.containers import Checkpoint, Validator
    from lighthouse_tpu_torch.consensus.testing import (
        FAR_FUTURE_EPOCH, interop_state, phase0_spec)

    spec = phase0_spec(S.MINIMAL)
    preset = spec.preset
    rng = random.Random(seed)
    state, _ = interop_state(NODE_VALIDATORS, spec, fork="altair")
    current = 8
    state.slot = current * preset.slots_per_epoch
    validators = list(state.validators)
    for i in range(len(validators), n):
        slashed = rng.random() < 0.2
        validators.append(Validator(
            pubkey=b"\xfb" + i.to_bytes(8, "little") + b"\x00" * 39,
            withdrawal_credentials=b"\x00" * 32, effective_balance=spec.max_effective_balance,
            slashed=slashed, activation_eligibility_epoch=0, activation_epoch=0,
            exit_epoch=FAR_FUTURE_EPOCH,
            withdrawable_epoch=(current + (preset.epochs_per_slashings_vector // 2
                                           if rng.random() < 0.5 else 5))
            if slashed else FAR_FUTURE_EPOCH).freeze())
    state.validators = validators
    state.previous_epoch_participation = [rng.choice((0, 1, 3, 7, 2)) for _ in range(n)]
    state.current_epoch_participation = [rng.choice((0, 7)) for _ in range(n)]
    state.inactivity_scores = [rng.choice((0, 1, 4, 100)) for _ in range(n)]
    state.balances = [rng.randrange(spec.ejection_balance, spec.max_effective_balance + 2 * 10**9)
                      for _ in range(n)]
    slashings = list(state.slashings)
    slashings[0] = 64 * 10**9
    state.slashings = slashings
    state.finalized_checkpoint = Checkpoint(epoch=current - 2, root=b"\x01" * 32)
    return state, spec


def node_prepare(api, out):
    """The node phase's host work, done ahead into the namespace ``out``
    (the boot phase runs it while it waits for its second boot's process):
    (a) the signed block and its randao-poisoned copy, with the oracle's
    verdict on each one's sets; (b) the honest peer's chain of
    NODE_SYNC_SLOTS slots, built over the oracle (the peer is not under
    test; the active engine is restored after), and the two syncing nodes at
    genesis; (c) the
    NODE_EPOCH_VALIDATORS state, an untouched copy for the card, and
    process_epoch_altair(device=False) on another copy (the host's result
    the card's is held against).  It launches no kernel.  Returns its
    seconds."""
    from lighthouse_tpu_torch.beacon.harness import BeaconChainHarness
    from lighthouse_tpu_torch.consensus import spec as S
    from lighthouse_tpu_torch.consensus.state_processing import per_epoch as PE
    from lighthouse_tpu_torch.consensus.state_processing.block_signature_verifier import (
        BlockSignatureVerifier)
    from lighthouse_tpu_torch.consensus.testing import interop_state, phase0_spec

    t_prep = time.perf_counter()
    # -- (a) the block and its poisoned copy, the oracle's verdicts -------------
    out.block_spec = phase0_spec(S.MINIMAL)
    out.block_state, keypairs = interop_state(32, out.block_spec)
    out.blocks = []  # (poisoned, signed block, committee cache, pubkey getter, oracle)
    for poison in (False, True):
        signed, cache, get_pk = node_signed_block(out.block_spec, out.block_state, keypairs, api)
        if poison:
            signed.message.body.randao_reveal = keypairs[0][0].sign(b"\xee" * 32).to_bytes()
        v = BlockSignatureVerifier(out.block_state, get_pk, out.block_spec)
        v.include_all(signed, lambda epoch, cache=cache: cache)
        out.blocks.append((poison, signed, cache, get_pk,
                           api.cpu_backend().verify_signature_sets(v.sets)))
    # -- (b) the honest peer's chain, its attestations on the oracle ------------
    active = api._ACTIVE[:]
    api.set_backend("python")
    try:
        t0 = time.perf_counter()
        out.ahead = BeaconChainHarness(n_validators=NODE_VALIDATORS)
        out.ahead.extend_chain(NODE_SYNC_SLOTS)
        out.peer_chain_s = time.perf_counter() - t0
        # the syncing nodes, at genesis: one for the honest peer, one for the forger
        out.fresh = {name: BeaconChainHarness(n_validators=NODE_VALIDATORS)
                     for name in ("honest", "forger")}
    finally:
        api._ACTIVE[:] = active
    # -- (c) the epoch state; the host's transition of a copy -------------------
    t0 = time.perf_counter()
    state, out.epoch_spec = node_epoch_state(NODE_EPOCH_VALIDATORS, NODE_SEED)
    out.epoch_state_s = time.perf_counter() - t0
    out.epoch_host, out.epoch_dev = state.copy(), state.copy()
    t0 = time.perf_counter()
    PE.process_epoch_altair(out.epoch_host, out.epoch_spec, device=False)
    out.epoch_host_s = time.perf_counter() - t0
    out.epoch_validators = len(state.validators)
    out.epoch_moved = sum(a != b for a, b in zip(out.epoch_host.balances, state.balances))
    out.seconds = time.perf_counter() - t_prep
    return out.seconds


def node_phase(c):
    """The node layers (the copies of beacon/, consensus/, network/) over the
    main backend, registered as "torch" with the serve phase's keys.  (a)
    on the default arm, a signed block's six sets (padded to the serve
    phase's 8-set key) through BlockSignatureVerifier: True, and False with
    the randao reveal poisoned, as the oracle says; (b) on NODE_SYNC_ARM,
    SyncManager syncs NODE_SYNC_SLOTS slots of an honest peer's chain (built
    over the oracle: the peer is not under test) as one batch, its bulk
    verify on the card (the arm's 64-set key, the one key the phase builds,
    whose warm-up and capture count the phase's launches): the head is the
    peer's; a peer serving the same blocks with one signature swapped is
    refused, greylisted, and the sync stalls; (c)
    process_epoch_altair with device=True (per_epoch_torch on the card)
    against device=False on a NODE_EPOCH_VALIDATORS-validator state:
    balances, inactivity scores, effective and exit epochs equal.  The
    blocks, the peer's chain, the syncing nodes at genesis, the epoch state
    and the host's transition come from node_prepare (``c.node_prep``), made ahead.  Returns the
    launch counts of the phase's run, or None on a failure."""
    from lighthouse_tpu_torch.beacon.sync import SyncManager, SyncPeer, serve_blocks_by_range
    from lighthouse_tpu_torch.consensus.state_processing import per_epoch as PE
    from lighthouse_tpu_torch.consensus.state_processing.block_signature_verifier import (
        BlockSignatureVerifier)
    from lighthouse_tpu_torch.network import rpc
    from lighthouse_tpu_torch.network.peer_manager import PeerManager
    from lighthouse_tpu_torch.utils import metrics as M

    torch, api, backend, bk, smi, PG = c.torch, c.api, c.backend, c.bk, c.smi, c.PG
    prep = c.node_prep
    t_phase = time.perf_counter()
    c.set_arm("default")
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
        return ok

    calls = []  # (sets, verdict) of each verify the copies hand the backend
    verify = bk.verify_signature_sets

    def counted(sets):
        ok = verify(sets)
        calls.append((len(sets), ok))
        return ok

    api.register_backend(bk)
    api.set_backend("torch")
    bk.verify_signature_sets = counted  # on the instance: the copies call it through the api
    keys0 = set(bk.builds)
    backend.reset_launch_counts()  # the counts just before the node path
    try:
        # -- (a) a signed block through BlockSignatureVerifier ----------------
        block_rows = []
        for poison, signed, cache, get_pk, oracle_verdict in prep.blocks:
            v = BlockSignatureVerifier(prep.block_state, get_pk, prep.block_spec)
            v.include_all(signed, lambda epoch, cache=cache: cache)
            t0 = time.perf_counter()
            got = v.verify()
            dev_s = time.perf_counter() - t0
            block_rows.append({"poisoned": poison, "sets": len(v.sets), "verdict": got,
                               "device_s": dev_s, "oracle": oracle_verdict})
        emit({"phase": "node", "step": "block", "card": smi, "rows": block_rows,
              "calls": calls[:], "prepared_s": prep.seconds})
        check([(r["sets"], r["verdict"], r["oracle"]) for r in block_rows]
              == [(6, True, True), (6, False, False)] and calls == [(6, True), (6, False)],
              "the block's verdicts")

        # -- (b) range sync of one epoch, its bulk verify on the card ---------
        ahead = prep.ahead
        c.set_arm(NODE_SYNC_ARM)
        serve = serve_blocks_by_range(ahead.chain, "altair")

        def request_blocks(start_slot, count):
            return [rpc.decode_response_chunk(x) for x in serve(start_slot, count)]

        sync_rows = {}
        for name in ("honest", "forger"):
            fresh = prep.fresh[name]
            pm = PeerManager()
            mgr = SyncManager(fresh.chain, peer_manager=pm, batch_slots=NODE_SYNC_SLOTS,
                              max_batch_attempts=1)
            serve_peer = request_blocks
            if name == "forger":
                chunks = request_blocks(1, NODE_SYNC_SLOTS)
                cls = ahead.chain.types.SignedBeaconBlock_BY_FORK["altair"]
                blocks = [cls.deserialize_value(ssz) for _, ssz in chunks]
                blocks[2].signature = bytes(blocks[1].signature)

                def serve_peer(start_slot, count, blocks=blocks):
                    return [(rpc.SUCCESS, b.encode()) for b in blocks]
            mgr.add_peer(SyncPeer(peer_id=name, head_slot=NODE_SYNC_SLOTS,
                                  request_blocks=serve_peer))
            n0, sets0 = len(calls), M.SYNC_SEGMENT_SETS_VERIFIED.value()
            t0 = time.perf_counter()
            got = mgr.tick()
            sync_rows[name] = {
                "state": got.name, "s": time.perf_counter() - t0, "imported": mgr.imported,
                "failed_batches": mgr.failed_batches, "calls": calls[n0:],
                "sets_verified": M.SYNC_SEGMENT_SETS_VERIFIED.value() - sets0,
                "head_is_peers": fresh.chain.head_root == ahead.chain.head_root,
                "greylisted": pm.greylisted(name)}
        c.set_arm("default")
        new_keys = sorted(set(bk.builds) - keys0, key=str)
        emit({"phase": "node", "step": "sync", "card": smi, "slots": NODE_SYNC_SLOTS,
              "validators": NODE_VALIDATORS, "arm": NODE_SYNC_ARM,
              "peer_chain_s": prep.peer_chain_s, **sync_rows,
              "keys_built": new_keys,
              "builds": {str(k): {f: bk.builds[k].get(f) for f in ("build_s", "warmup_s",
                                                                   "capture_s", "instantiate_s")}
                         for k in new_keys}})
        honest, forger = sync_rows["honest"], sync_rows["forger"]
        n_sets = honest["sets_verified"]
        check(honest["state"] == "SYNCED" and honest["head_is_peers"]
              and honest["imported"] == NODE_SYNC_SLOTS and honest["calls"] == [(n_sets, True)]
              and not honest["greylisted"], "the honest sync")
        check(forger["state"] == "STALLED" and forger["failed_batches"] == 1
              and forger["calls"] == [(n_sets, False)] and forger["greylisted"]
              and not forger["head_is_peers"], "the forger's batch")
        check(new_keys == [(bk._padded_size(n_sets), True, False, True, True)],
              "the node phase builds one key: the sync batch's, on its arm")
    finally:
        del bk.verify_signature_sets
        c.set_arm("default")
    node_counts = backend.launch_counts()  # read just after the node path

    # -- (c) the epoch transition, its balance step on the card ----------------
    host, dev = prep.epoch_host, prep.epoch_dev
    t0 = time.perf_counter()
    PE.process_epoch_altair(dev, prep.epoch_spec, device=True)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    same = {
        "balances": list(dev.balances) == list(host.balances),
        "inactivity_scores": list(dev.inactivity_scores) == list(host.inactivity_scores),
        "effective_balances": [v.effective_balance for v in dev.validators]
        == [v.effective_balance for v in host.validators],
        "exit_epochs": [v.exit_epoch for v in dev.validators]
        == [v.exit_epoch for v in host.validators]}
    n_epoch = prep.epoch_validators
    emit({"phase": "node", "step": "epoch", "card": smi, "validators": n_epoch,
          "state_s": prep.epoch_state_s, "host_s": prep.epoch_host_s, "device_s": device_s,
          "equal": same, "balances_moved": prep.epoch_moved})
    check(all(same.values()) and len(dev.validators) == n_epoch
          and prep.epoch_moved > n_epoch // 2, "the epoch on the card")
    emit({"phase": "node", "step": "cost", "card": smi,
          "seconds": time.perf_counter() - t_phase, "keys": len(bk.builds),
          "host_rss_gib": PG._host_rss_bytes() / 2**30, "launches": node_counts,
          "failures": failures})
    check(all(node_counts[k] > 0 for k in ("mont_mul", "miller_step_dbl", "miller_step_add",
                                            "fp_chain", "fp2_chain", "wsm_step_g1",
                                            "wsm_step_g2"))
          and not any(node_counts[k] for k in MXU_NAMES),
          "the node path did not launch the chain-and-WSM arm's kernels")
    if failures:
        emit({"phase": "node", "error": "a node check failed", "failures": failures})
        return None
    return node_counts


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
            _build, backend, chain_kernel as CK, codegen, fp as F, h2c, miller_kernel as ML,
            mont_kernel as MK, mxu_kernel as X, pairing as PR, points as P, program as PG,
            tower as T, wsm_kernel as W)
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--second-boot"]:
        return second_boot(*sys.argv[2:5])

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
    # the group forms of kernels 1, 2, 3, 2m, 3m, 4, 5, 7, 4m and 5m, kernel
    # 6's forms, the one-thread forms of kernels 1 and 7, and the device
    # functions the Miller and WSM steps and kernels 4m and 5m call (g_mul_mxu
    # once per staging depth: 2m's and 3m's; mul13, mont_group_mxu_core's one
    # copy per G)
    group_fns = {"mont": tuple(f"mont_mul_group_kernelILi{g}ELi{lanes}E"
                               for g, lanes in MK.FORMS if g > 1) + ("mont_mul_kernel",),
                 "miller_step": (f"miller_step_dbl_g{ML.DBL_GROUP}_kernel",
                                 f"miller_step_add_g{ML.ADD_GROUP}_kernel",
                                 "g_mul", "g_add", "g_sub"),
                 "miller_step_mxu": (f"miller_step_dbl_mxu_g{ML.DBL_MXU_GROUP}_kernel",
                                     f"miller_step_add_mxu_g{ML.ADD_MXU_GROUP}_kernel",
                                     *(f"g_mul_mxuILi{rows}E"
                                       for rows in sorted(set(codegen.MXU_GROUP_ROWS.values()))),
                                     "g_add", "g_sub"),
                 "chain": tuple(f"fp_chain_group_kernelILi{lanes}E" for _, lanes in CK.FP_FORMS)
                 + (f"fp2_chain_group_kernelILi{CK.FP2_FORM[1]}E",
                    f"fp_chain_mxu_group_kernelILi{CK.FP_MXU_FORM[0]}E",
                    f"fp2_chain_mxu_group_kernelILi{CK.FP2_MXU_FORM[0]}E")
                 + tuple(f"mul13ILi{g}E" for g in sorted({CK.FP_MXU_FORM[0],
                                                          CK.FP2_MXU_FORM[0]})),
                 "mxu": (f"mont_mul_mxu_group_kernelILi{X.MXU_FORM[0]}E",
                         "mont_mul_mxu_kernel"),
                 "wsm_step": (*(W.launcher(nc)[3:] + "_kernel" for nc in (1, 2)),
                              "g_mul", "g_add", "g_sub")}
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
    # every form of kernel 7 at widths around its group size and its block
    # (ragged tails) and the check width
    for form in X.FORMS:
        g, lanes = form
        widths = sorted({1, 2, max(g - 1, 1), g + 1, lanes - 1, lanes + 1, 31, 33, n})
        eqs = [hold("mont_mul_mxu", (x[:, :w].contiguous(), y[:, :w].contiguous()),
                    lambda x, y, form=form: [X.mont_mul_mxu(x, y, form=form)])[0]
               for w in widths for x, y in corpora.values()]
        emit({"phase": "kernel_check", "kernel": "mont_mul_mxu", "form": form,
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
                            ("miller_step_add", ML.ADD_GROUP, (f, tpt, q, xp, yp, bit)),
                            ("miller_step_add_mxu", ML.ADD_MXU_GROUP, (f, tpt, q, xp, yp, bit))):
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
    # the MXU chains' group forms at 1 lane and at a ragged block of 32
    eqs = [hold("fp_chain_mxu", (base[:, :w].contiguous(), F.P_INT - 2))[0]
           for w in (1, 33) for base in (a.limbs, lazy.limbs)]
    emit({"phase": "kernel_check", "kernel": "fp_chain_mxu", "form": CK.FP_MXU_FORM,
          "corpora": ["strict", "lazy_bound4"], "widths": [1, 33], "equal": all(eqs)})
    eqs = [hold("fp2_chain_mxu", (*cut(w, a.limbs, b.limbs), h2c.SQRT_EXP_BITS))[0]
           for w in (1, 33)]
    emit({"phase": "kernel_check", "kernel": "fp2_chain_mxu", "form": CK.FP2_MXU_FORM,
          "corpora": ["strict"], "widths": [1, 33], "equal": all(eqs)})

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
        # the curve's form at ragged widths: blocks of 8 (G1) or 32 (G2) lanes
        widths = [1, 17, 33, 257]
        eqs = [hold(name, cut(w, *args))[0] for w in widths]
        emit({"phase": "kernel_check", "kernel": name, "form": W.FORMS[int(name[-1])],
              "corpus": "live_points_flags", "widths": widths, "equal": all(eqs)})
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
    bad_at_0 = list(sets)
    bad_at_0[0] = api.SignatureSet(other.sign(b"another message"), [other.public_key()],
                                   sets[0].message)
    batches = {"valid": sets, "one_bad": bad, "bad_at_0": bad_at_0}
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

    def eager_dispatch(mb):
        """The eager device program (local_verify_fn) on a marshalled batch,
        under the arm in force: the graph's comparison."""
        args = backend._to_device(mb.args, dev)
        with torch.inference_mode():
            return bk.local_verify_fn()(*args)

    eager_counts, path_ops, path_widths, marshalled, eager_verdicts = {}, {}, {}, {}, {}
    for arm in ARMS:
        set_arm(arm)
        mbs = marshalled[arm] = {name: bk.marshal_sets(b) for name, b in batches.items()}
        backend.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")  # dispatch may only enqueue
        try:
            handle = eager_dispatch(mbs["valid"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        verdict = bk.resolve(handle)
        eager_counts[arm] = backend.launch_counts()
        backend.reset_launch_counts()
        bad_verdict, path_ops[arm], path_widths[arm] = capture_kernel_operands(
            entry_points, F.mxu_active, keep_steps,
            lambda: bk.resolve(eager_dispatch(mbs["one_bad"])))
        bad_counts = backend.launch_counts()
        bad0_verdict = bk.resolve(eager_dispatch(mbs["bad_at_0"]))
        eager_verdicts[arm] = {"valid": verdict, "one_bad": bad_verdict,
                               "bad_at_0": bad0_verdict}
        emit({"phase": "path", "arm": arm, "path": "eager", "verdict_valid": verdict,
              "verdict_one_bad": bad_verdict, "verdict_bad_at_0": bad0_verdict,
              "launches_per_verify": eager_counts[arm], "launches_one_bad": bad_counts,
              "launches_per_verify_total": sum(eager_counts[arm].values())})
        if not (verdict is True and bad_verdict is False and bad0_verdict is False):
            return 1
        if sum(eager_counts[arm].values()) != WRAPPER_LAUNCHES[arm]:
            emit({"phase": "path", "arm": arm, "error": "unexpected wrapper launches per verify",
                  "want": WRAPPER_LAUNCHES[arm]})
            return 1
        for c in (eager_counts[arm], bad_counts):
            prod = products[arm]
            if c[prod] <= 0 or any(c[k] != v for k, v in want_counts[arm].items() if k != prod):
                emit({"phase": "path", "arm": arm, "error": "unexpected launch counts",
                      "want": want_counts[arm]})
                return 1
    # the mxu arm runs the arm's path with every product on the 13-bit plane
    if eager_counts["mxu"]["mont_mul_mxu"] != eager_counts["arm"]["mont_mul"]:
        emit({"phase": "path", "error": "the mxu arm's 13-bit products differ in number from "
              "the arm's 15-bit products", "mxu": eager_counts["mxu"]["mont_mul_mxu"],
              "arm": eager_counts["arm"]["mont_mul"]})
        return 1

    # -- the main path: one captured graph per key, replayed ---------------
    # counts: the wrapper launches of the main path's program, counted while
    # warm_compile captures it (every replay runs each of them once)
    counts, keys = {}, {}
    for arm in ARMS:
        set_arm(arm)
        backend.reset_launch_counts()
        built = bk.warm_compile(N_SETS)
        total = sum(backend.launch_counts().values())  # the warm-up's and the capture's
        key = keys[arm] = (N_SETS, True, arm == "mxu", arm != "default", arm != "default")
        rec = bk.builds.get(key, {})
        counts[arm] = {name: rec.get("launches", {}).get(name, 0) for name in KERNEL_NAMES}
        emit({"phase": "program", "arm": arm, "key": key, "card": smi, "built": built,
              **{k: v for k, v in rec.items() if k != "launches"},
              "launches_at_capture": counts[arm],
              "launches_at_capture_total": sum(counts[arm].values()),
              "launches_warm_up_and_capture": total,
              "reserved_gib": torch.cuda.memory_reserved() / 2**30})
        if not (built and rec.get("nodes", {}).get("kernel") == DEVICE_KERNELS[arm]
                and counts[arm] == eager_counts[arm]
                and sum(counts[arm].values()) == WRAPPER_LAUNCHES[arm]
                and total == 2 * WRAPPER_LAUNCHES[arm]):
            emit({"phase": "program", "arm": arm, "error": "unexpected build",
                  "want_kernel_nodes": DEVICE_KERNELS[arm],
                  "want_launches": WRAPPER_LAUNCHES[arm]})
            return 1
    built_keys = {key: rec["capture_s"] for key, rec in bk.builds.items()}
    for arm in ARMS:
        set_arm(arm)
        order = ("valid", "one_bad", "valid", "bad_at_0")
        backend.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")  # dispatch may only enqueue
        try:
            handles = [bk.dispatch(marshalled[arm][name]) for name in order]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        verdicts = [bk.resolve(h) for h in handles]  # all four in flight before the first
        replay_counts = backend.launch_counts()
        eager = [eager_verdicts[arm][name] for name in order]
        rebuilt = {key: rec["capture_s"] for key, rec in bk.builds.items()} != built_keys
        emit({"phase": "graph_path", "arm": arm, "batches": order, "verdicts": verdicts,
              "eager_verdicts": eager, "launches_on_replay": sum(replay_counts.values()),
              "keys_built": len(bk.builds), "rebuilt": rebuilt})
        if (verdicts != [True, False, True, False] or verdicts != eager
                or any(replay_counts.values()) or rebuilt):
            return 1

    # -- warm boot: the arm plan, the store, a second boot in a fresh process --
    node_prep = types.SimpleNamespace()  # the node phase's host set-up, made beside it
    ctx = types.SimpleNamespace(
        torch=torch, api=api, backend=backend, bk=bk, dev=dev, smi=smi, F=F, PG=PG,
        entry_points=entry_points, keep_steps=keep_steps, eager_dispatch=eager_dispatch,
        hold=hold, beside_child=lambda: node_prepare(api, node_prep))
    # the marshal does not depend on the arm: the default arm's batches serve
    if boot_phase(ctx, marshalled["default"]) is None:
        return 1
    if {key: rec["capture_s"] for key, rec in bk.builds.items()} != built_keys:
        emit({"phase": "boot", "error": "the boot phase built a key of the main backend"})
        return 1
    mesh_batches = marshalled["default"]
    del marshalled

    # -- aggregate_verify and the epoch batch, through their programs --------
    ctx = types.SimpleNamespace(
        torch=torch, api=api, backend=backend, bk=bk, dev=dev, smi=smi, rng=rng,
        set_arm=set_arm, products=products, funcs=funcs, checked=checked,
        max_abs_err=max_abs_err, bound_ms=bound_ms, hash_to_g2=hash_to_g2, F=F, P=P, PG=PG,
        MK=MK, X=X, pool=pool, mesh_batches=mesh_batches, batches=batches, node_prep=node_prep)
    agg_counts = aggregate_phase(ctx)
    if agg_counts is None:
        return 1
    epoch = epoch_phase(ctx)
    if epoch is None:
        return 1
    ep_counts, epoch_widths = epoch
    # -- the ingest engine with the resident registry; the epoch balances -----
    if registry_phase(ctx) is None or epoch_balance_phase(ctx) is None:
        return 1
    # -- the mesh: two seats on the card --------------------------------------
    mesh_counts = mesh_phase(ctx)
    if mesh_counts is None:
        return 1
    del ctx.mesh_batches, ctx.registry
    # -- the front door: the ladder, the guard and the service -----------------
    serve_counts = serve_phase(ctx)
    if serve_counts is None:
        return 1
    # -- the node layers: block import, range sync, the epoch transition -------
    node_counts = node_phase(ctx)
    if node_counts is None:
        return 1
    built_keys = {key: rec["capture_s"] for key, rec in bk.builds.items()}  # with the new keys

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

        def form_key(form):
            return "x".join(map(str, form))

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
        # 2-lane call), with its heaviest widths beside
        n_mont = max(mont_widths, key=mont_widths.get)
        record("mont_mul", mont_ops[n_mont], "mont.cu",
               "pallas_fp.py:141", 3 * plane * n_mont, MK.IMAD_PER_LANE * n_mont, False,
               form=MK.form_for(n_mont),
               heaviest_widths=[{"n": w, "calls": mont_widths[w], "ms": sweep[w],
                                 "bound_ms": bound_ms(3 * plane * w, MK.IMAD_PER_LANE * w)[0],
                                 "form": MK.form_for(w)} for w in heavy])
        # mont_mul_mxu on the mxu arm, width by width, in every form: calls x
        # ms of form_for's form is its device time there; where another form
        # is faster, form_for's crossover is off
        mxu_widths = path_widths["mxu"]["mont_mul_mxu"]
        mxu_ops = path_ops["mxu"]["mont_mul_mxu"]

        def mxu_bound(w):
            return bound_ms(3 * plane * w, X.IMAD_PER_LANE * w, X.DMMA_FMA_PER_LANE * w)

        mxu_forms = {w: {form_key(f): time_ms(
            torch, lambda f=f, a=mxu_ops[w]: X.mont_mul_mxu(*a, form=f), KERNEL_LAUNCHES,
            queue_first=True, windows=SWEEP_WINDOWS) for f in X.FORMS} for w in sorted(mxu_widths)}
        mxu_sweep = {w: mxu_forms[w][form_key(X.form_for(w))] for w in mxu_widths}
        mxu_by_time = sorted(mxu_widths, key=lambda w: -mxu_widths[w] * mxu_sweep[w])
        emit({"phase": "mxu_widths", "arm": "mxu", "card": smi,
              "calls": sum(mxu_widths.values()), "widths": len(mxu_widths),
              "device_s": sum(c * mxu_sweep[w] for w, c in mxu_widths.items()) / 1e3,
              "device_s_by_form": {form_key(f): sum(c * mxu_forms[w][form_key(f)] for w, c in
                                                    mxu_widths.items()) / 1e3 for f in X.FORMS},
              "slower_than_another_form": [w for w in sorted(mxu_widths) if mxu_sweep[w] > min(
                  mxu_forms[w].values())],
              "top": [{"n": w, "calls": mxu_widths[w], "ms": mxu_sweep[w],
                       "device_s": mxu_widths[w] * mxu_sweep[w] / 1e3, "form": X.form_for(w),
                       "bound_ms": mxu_bound(w)[0]} for w in mxu_by_time[:20]],
              "ms_by_form": mxu_forms})
        # in the kernels line at mont_mul's width, with its heaviest widths
        n_mxu = n_mont if n_mont in mxu_ops else max(mxu_ops)
        record("mont_mul_mxu", mxu_ops[n_mxu], "mxu.cu", "pallas_mxu.py:161",
               3 * plane * n_mxu, X.IMAD_PER_LANE * n_mxu, False,
               dmma_fmas=X.DMMA_FMA_PER_LANE * n_mxu, group=X.form_for(n_mxu)[0],
               form=X.form_for(n_mxu),
               heaviest_widths=[{"n": w, "calls": mxu_widths[w], "ms": mxu_sweep[w],
                                 "bound_ms": mxu_bound(w)[0], "form": X.form_for(w)}
                                for w in mxu_by_time[:MONT_HEAVY]])
        # the 15-bit chains at every width the arm launches: the Fp chain in
        # every form, there and at CHAIN_SWEEP widths cut from the arm's
        # widest operands (where form_for's crossover is read); the Fp2
        # chain in its one form
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

                def form(w, field=field, sfx=sfx):
                    if sfx:
                        return CK.FP_MXU_FORM if field == "fp" else CK.FP2_MXU_FORM
                    return CK.form_for(w) if field == "fp" else CK.FP2_FORM

                if sfx:  # the MXU chains at every width their arm launches
                    chain_ms[name] = {w: {form_key(form(w)): time_ms(
                        torch, lambda a=ops[name][w], k=funcs[name][0]: k(*a), LONG_LAUNCHES,
                        queue_first=True)} for w in sorted(widths)}
                extra = {"group": form(n_ch)[0], "form": form(n_ch),
                         "ms": chain_ms[name][n_ch][form_key(form(n_ch))],
                         "by_width": [{"n": w, "calls": widths[w],
                                       "ms": chain_ms[name][w][form_key(form(w))],
                                       "bound_ms": bound_ms(*work(w))[0],
                                       "form": form(w)} for w in sorted(widths)]}
                nbytes, imads, fmas = work(n_ch)
                record(name, args, "chain.cu", f"pallas_fp.py:{line}", nbytes, imads, True,
                       dmma_fmas=fmas, digits=nd, **extra)
        # kernel 6 in each curve's form at the arm's width, and at WSM_WIDE
        # times it (the captured operands tiled)
        ops = path_ops["arm"]
        wsm_ms = {}
        for name, nc in (("wsm_step_g1", 1), ("wsm_step_g2", 2)):
            call = max(ops[name])
            args = ops[name][call]
            n_w = args[0].shape[-1]
            prog = W.program(nc)

            def wsm_work(w, nc=nc, prog=prog):
                """(bytes, 32-bit multiplies) of a w-lane step: acc and base
                read, acc written, three flag planes read and one written"""
                return (8 * nc * plane * w + 4 * 4 * w,
                        (prog.n_mul * MK.IMAD_PER_LANE + prog.n_sqr * MK.SQR_IMAD_PER_LANE) * w)

            wide = tuple(x.repeat(*([1] * (x.dim() - 1)), WSM_WIDE).contiguous() for x in args)
            wsm_ms[name] = {w: {"ms": time_ms(torch, lambda a=a: funcs[name][0](*a),
                                              KERNEL_LAUNCHES, queue_first=True),
                                "bound_ms": bound_ms(*wsm_work(w))[0]}
                            for w, a in ((n_w, args), (n_w * WSM_WIDE, wide))}
            del wide
            record(name, args, "wsm_step.cu", "pallas_wsm.py:172", *wsm_work(n_w), False,
                   ms=wsm_ms[name][n_w]["ms"], step=call, form=W.FORMS[nc])
        emit({"phase": "wsm_forms", "card": smi,
              "forms": {name: W.FORMS[int(name[-1])] for name in wsm_ms}, "ms": wsm_ms})
    del path_ops, ops, mxu_ops

    # -- path timing, the arms interleaved, eager and graph ----------------
    paths = {"eager": eager_dispatch, "graph": bk.dispatch}
    timings = {(arm, path): [] for arm in ARMS for path in paths}
    peak = {(arm, path): 0 for arm in ARMS for path in paths}
    for i, arm in enumerate(TIMING_ORDER):
        set_arm(arm)
        for path in (("eager", "graph") if 2 * i < len(TIMING_ORDER) else ("graph", "eager")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            mb = bk.marshal_sets(sets)
            t1 = time.perf_counter()
            handle = paths[path](mb)
            t2 = time.perf_counter()
            ok = bk.resolve(handle)
            t3 = time.perf_counter()
            if ok is not True:
                return 1
            timings[arm, path].append((t1 - t0, t2 - t1, t3 - t2))
            peak[arm, path] = max(peak[arm, path], torch.cuda.max_memory_allocated())
    if {key: rec["capture_s"] for key, rec in bk.builds.items()} != built_keys:
        emit({"phase": "path_timing", "error": "a dispatch built a key"})
        return 1
    for arm in ARMS:
        for path in paths:
            runs = timings[arm, path]
            med = [statistics.median(c) for c in zip(*runs)]
            extra = {}
            if path == "graph":
                rec = bk.builds[keys[arm]]
                extra = {"capture_s": rec["capture_s"], "instantiate_s": rec["instantiate_s"],
                         "capture_peak_gib": rec["capture_peak_bytes"] / 2**30,
                         "pool_gib": rec["pool_bytes"] / 2**30,
                         "instantiate_device_gib": rec["instantiate_device_bytes"] / 2**30}
            emit({"phase": "path_timing", "arm": arm, "path": path, "sets": N_SETS,
                  "order": TIMING_ORDER, "reps": len(runs), "marshal_s": med[0],
                  "dispatch_s": med[1], "resolve_s": med[2], "sets_per_s": N_SETS / sum(med),
                  "device_sets_per_s": N_SETS / (med[1] + med[2]),
                  "sets_per_s_each": [N_SETS / sum(r) for r in runs],
                  "dispatch_s_each": [r[1] for r in runs],
                  "launches_per_verify": sum(counts[arm].values()),
                  "card": smi, "peak_mem_gib": peak[arm, path] / 2**30, **extra})

    # -- profiles: eager and replayed, then the eager program by stage -------
    for arm in ARMS:
        set_arm(arm)
        for path in paths:
            # the profiler can lose records of the card's side (kernel_records
            # short of the kernels, the busy time with it), so such a verify is
            # profiled again, up to PROFILE_TRIES
            records_each = []
            for _ in range(PROFILE_TRIES):
                mb = bk.marshal_sets(sets)
                prof = profile_summary(*profile_trace(
                    torch, lambda: bk.resolve(paths[path](mb))))
                # a replay's kernels: the graph's, and any launched beside it
                want = prof["device_kernels"] + (
                    bk.builds[keys[arm]]["nodes"]["kernel"] if path == "graph" else 0)
                records_each.append(prof["kernel_records"])
                if prof["kernel_records"] == want:
                    break
            else:  # every try lost records: no busy time is printed as measured
                prof.update(device_busy_s=None, device_busy_share=None)
            emit({"phase": "profile", "arm": arm, "path": path, "sets": N_SETS, "card": smi,
                  **prof, "kernels_wanted": want, "kernel_records_each": records_each})
            if path == "eager" and prof["device_kernels"] != DEVICE_KERNELS[arm]:
                emit({"phase": "profile", "arm": arm, "error": "unexpected device kernels per "
                      "verify", "want": DEVICE_KERNELS[arm]})
                return 1
        if arm not in STAGE_ARMS:
            continue
        mb = bk.marshal_sets(sets)
        with stage_ranges(torch, {"h2c": h2c, "P": P, "W": W, "backend": backend, "PR": PR}):
            wall_s, events = profile_trace(torch, lambda: bk.resolve(eager_dispatch(mb)),
                                           cpu=True)
        stages = stage_summary(events)
        del events
        emit({"phase": "profile_stages", "arm": arm, "path": "eager", "sets": N_SETS,
              "card": smi, "wall_s": wall_s, "stages": stages})
        if sum(v["device_kernels"] for v in stages.values()) != DEVICE_KERNELS[arm]:
            emit({"phase": "profile_stages", "arm": arm, "error": "unexpected device kernels",
                  "want": DEVICE_KERNELS[arm]})
            return 1
    set_arm("default")

    # launches: the main path's, counted while its program was captured, on the
    # arm whose path the kernel is timed on
    home = {name: "mxu" if name in MXU_NAMES else "arm" for name in KERNEL_NAMES}
    out = []
    for name, rec in kernels.items():
        row = {"name": name, **rec, "launches": counts[home[name]][name],
               "launches_by_arm": {arm: counts[arm][name] for arm in ARMS},
               "launches_aggregate_by_arm": {arm: agg_counts[arm][name] for arm in ARMS},
               "launches_epoch_by_arm": {arm: ep_counts[arm][name] for arm in ARMS},
               "launches_mesh": mesh_counts[name], "launches_serve": serve_counts[name],
               "launches_node": node_counts[name]}
        if name in epoch_widths:  # the epoch tree's widest calls
            row["epoch_widths"] = [r for r in epoch_widths[name]["by_width"]
                                   if r["n"] in EPOCH_CHECK_WIDTHS]
        out.append(row)
    emit({"kernels": out})
    print(nvidia_smi("name,power.limit"), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
