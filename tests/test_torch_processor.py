"""The port's scheduler and verifier ladder (lighthouse_tpu_torch/beacon/
processor.py): twins of the 16 tests of tests/test_processor.py (priority
order, LIFO/FIFO semantics, shedding, batch assembly, deadline flush,
on-device bisection, the reprocess queue, the pipelined verify path),
asserted through the work journal, and differentials against the JAX
package's module: ``verify_with_bisection`` and the circuit breaker's
transitions on a seeded fault sequence, the ladder's journals and verdicts
on the same seeded device faults, and the queues' shed and drop accounting
on the same event stream."""

import itertools
import random

import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu_torch.beacon.processor import (
    BatchOutcome,
    BeaconProcessor,
    DeadlineBatcher,
    WorkEvent,
    WorkKind,
    verify_with_bisection,
)


def mk(kind, item):
    return WorkEvent(kind=kind, item=item)


def collector(sink):
    def handler(batch):
        sink.extend(ev.item for ev in batch)

    return handler


def test_priority_order():
    seen = []
    bp = BeaconProcessor(
        handlers={k: collector(seen) for k in WorkKind},
        batch_size_for=lambda k: 64,
    )
    bp.try_send(mk(WorkKind.GOSSIP_ATTESTATION, "att"))
    bp.try_send(mk(WorkKind.GOSSIP_BLOCK, "block"))
    bp.try_send(mk(WorkKind.CHAIN_SEGMENT, "segment"))
    bp.try_send(mk(WorkKind.API_REQUEST_P1, "api1"))
    bp.drain()
    assert seen == ["segment", "block", "att", "api1"]


def test_attestations_are_lifo_blocks_fifo():
    seen = []
    bp = BeaconProcessor(
        handlers={k: collector(seen) for k in WorkKind},
        batch_size_for=lambda k: 1,
    )
    for i in range(3):
        bp.try_send(mk(WorkKind.GOSSIP_ATTESTATION, f"att{i}"))
        bp.try_send(mk(WorkKind.GOSSIP_BLOCK, f"blk{i}"))
    bp.drain()
    blocks = [s for s in seen if s.startswith("blk")]
    atts = [s for s in seen if s.startswith("att")]
    assert blocks == ["blk0", "blk1", "blk2"]  # FIFO
    assert atts == ["att2", "att1", "att0"]  # LIFO: freshest first


def test_lifo_overflow_sheds_oldest_fifo_rejects_newest():
    bp = BeaconProcessor(
        handlers={},
        bounds={WorkKind.GOSSIP_ATTESTATION: 2, WorkKind.GOSSIP_BLOCK: 2},
    )
    for i in range(4):
        bp.try_send(mk(WorkKind.GOSSIP_ATTESTATION, i))
    q = bp.queues[WorkKind.GOSSIP_ATTESTATION]
    assert q.dropped == 2
    assert [q.pop().item, q.pop().item] == [3, 2]  # newest kept
    ok = [bp.try_send(mk(WorkKind.GOSSIP_BLOCK, i)) for i in range(4)]
    assert ok == [True, True, False, False]  # FIFO rejects at the door
    qb = bp.queues[WorkKind.GOSSIP_BLOCK]
    assert [qb.pop().item, qb.pop().item] == [0, 1]


def test_batch_assembly_4096_through_queue():
    """BASELINE.md config 3: 4,096 synthetic attestation work items flow
    through the bounded queue into device-sized batches."""
    batches = []
    bp = BeaconProcessor(
        handlers={WorkKind.GOSSIP_ATTESTATION: batches.append},
        batch_size_for=lambda k: 512,
    )
    for i in range(4096):
        assert bp.try_send(mk(WorkKind.GOSSIP_ATTESTATION, i))
    bp.drain()
    assert [len(b) for b in batches] == [512] * 8
    assert bp.journal.count(("GOSSIP_ATTESTATION", 512)) == 8
    # LIFO: the first assembled batch holds the freshest items
    assert batches[0][0].item == 4095


def test_bisection_single_poison():
    poisoned = {137}

    def verify(items):
        return not (set(items) & poisoned)

    out = verify_with_bisection(verify, list(range(512)))
    assert out.verdicts.count(False) == 1
    assert out.verdicts[137] is False
    # 2*log2(512)+1 = 19 batch calls, far below 512 singles
    assert out.device_calls <= 19


def test_bisection_all_good_one_call():
    out = verify_with_bisection(lambda items: True, list(range(512)))
    assert all(out.verdicts) and out.device_calls == 1


def test_bisection_multiple_poison():
    poisoned = {3, 200, 201}

    def verify(items):
        return not (set(items) & poisoned)

    out = verify_with_bisection(verify, list(range(256)))
    assert [i for i, v in enumerate(out.verdicts) if not v] == [3, 200, 201]


def test_deadline_batcher():
    clock = itertools.count()
    t = [0.0]

    def now():
        return t[0]

    b = DeadlineBatcher([8, 16], deadline_fn=lambda: 4.0, now=now)
    for i in range(15):
        full = b.offer(i)
        assert full is None  # cap is 16
    assert b.offer(15) == list(range(16))  # full flush at the cap
    b.offer(99)
    assert b.poll() is None  # deadline not reached
    t[0] = 5.0
    assert b.poll() == [99]  # deadline flush
    assert b.snap_size(3) == 8 and b.snap_size(9) == 16


def test_reprocess_queue_early_block_and_unknown_attestation():
    from lighthouse_tpu_torch.beacon.processor import ReprocessQueue

    t = [100.0]
    q = ReprocessQueue(now=lambda: t[0], attestation_ttl=12.0)
    early = mk(WorkKind.GOSSIP_BLOCK, "early-block")
    q.defer_until(early, ready_at=112.0)
    att = mk(WorkKind.GOSSIP_ATTESTATION, "att-unknown")
    q.defer_for_block(att, b"\xaa" * 32)
    assert len(q) == 2
    assert q.poll() == []  # nothing ready yet
    # the block arrives over sync: its waiter is released immediately
    released = q.block_imported(b"\xaa" * 32)
    assert [e.item for e in released] == ["att-unknown"]
    # slot arrives: early block released
    t[0] = 112.5
    assert [e.item for e in q.poll()] == ["early-block"]
    assert len(q) == 0


def test_reprocess_queue_expiry():
    from lighthouse_tpu_torch.beacon.processor import ReprocessQueue

    t = [0.0]
    q = ReprocessQueue(now=lambda: t[0], attestation_ttl=12.0)
    q.defer_for_block(mk(WorkKind.GOSSIP_ATTESTATION, "a"), b"\x01" * 32)
    t[0] = 30.0  # past ttl
    assert q.poll() == []
    assert q.expired == 1 and len(q) == 0
    # late-arriving block finds nothing
    assert q.block_imported(b"\x01" * 32) == []


# ---------------------------------------------------------------------------
# Pipelined verify path (marshal | dispatch | resolve overlap)
# ---------------------------------------------------------------------------


class _StubBatch:
    def __init__(self, invalid=False):
        self.invalid = invalid


def _mk_pipelined(marshal_s=0.0, device_s=0.0, device_ok=True,
                  marshal_raises=False, resolve_raises=False,
                  injector=None, **kw):
    """A PipelinedVerifier over sleep-based stub stages plus a real
    ResilientVerifier whose engines verify by set identity (a set is the
    string "bad" iff it is invalid)."""
    import time as _t

    from lighthouse_tpu_torch.beacon.processor import (
        PipelinedVerifier,
        ResilientVerifier,
    )
    from lighthouse_tpu_torch.utils.faults import FaultInjector

    if injector is None:
        injector = FaultInjector()
    oracle = lambda sets: all(s != "bad" for s in sets)  # noqa: E731
    rv = ResilientVerifier(
        device_verify=oracle, cpu_verify=oracle, injector=injector
    )

    def marshal(sets):
        if marshal_raises:
            raise RuntimeError("marshal blew up")
        _t.sleep(marshal_s)
        return _StubBatch()

    def dispatch(mb):
        return ("handle", device_ok)

    def resolve(handle):
        _t.sleep(device_s)
        if resolve_raises:
            raise RuntimeError("device fell over")
        return handle[1]

    pv = PipelinedVerifier(rv, marshal, dispatch, resolve,
                           injector=injector, **kw)
    return pv, rv


def test_pipelined_overlap_wall_is_max_not_sum():
    """The point of the pipeline: K batches at (marshal m, device d)
    finish in ~max(total_marshal / workers, total_device), not the
    serial sum K*(m+d)."""
    import time as _t

    m = d = 0.04
    k = 6
    pv, rv = _mk_pipelined(marshal_s=m, device_s=d, workers=2, depth=2)
    t0 = _t.perf_counter()
    outs = pv.verify_stream([["s"] * 3] * k)
    wall = _t.perf_counter() - t0
    assert [o.verdicts for o in outs] == [[True, True, True]] * k
    assert rv.journal == [("device", 3)] * k
    serial = k * (m + d)
    # overlap: generous epsilon for a loaded 1-core CI box, but far
    # below the no-overlap serial wall
    assert wall < serial * 0.75, (wall, serial)


def test_pipelined_false_verdict_takes_ladder_for_attribution():
    """A False device verdict is NOT a verdict on any single set: the
    raw sets re-enter the ladder so bisection names the bad one."""
    pv, rv = _mk_pipelined(device_ok=False)
    outs = pv.verify_stream([["a", "bad", "c"]])
    assert outs[0].verdicts == [True, False, True]


def test_pipelined_marshal_failure_never_drops_the_batch():
    pv, rv = _mk_pipelined(marshal_raises=True)
    outs = pv.verify_stream([["a", "b"]])
    assert outs[0].verdicts == [True, True]
    assert rv.journal  # the ladder, not the fast path, did the work


def test_pipelined_resolve_failure_feeds_breaker_and_falls_back():
    pv, rv = _mk_pipelined(resolve_raises=True)
    outs = pv.verify_stream([["a"], ["b"]])
    assert [o.verdicts for o in outs] == [[True], [True]]
    # every resolve failure took the ladder (which then succeeded and
    # reset the breaker — infra failures and recoveries both recorded)
    assert rv.journal == [("device", 1), ("device", 1)]


def test_pipelined_breaker_open_routes_to_cpu():
    pv, rv = _mk_pipelined()
    for _ in range(rv.breaker.failure_threshold):
        rv.breaker.record_failure()
    assert not rv.breaker.is_closed
    outs = pv.verify_stream([["a", "b"]])
    assert outs[0].verdicts == [True, True]
    assert ("cpu", 2) in rv.journal  # ladder went straight to the oracle


def test_pipelined_chaos_site_never_raises_never_drops():
    """Arm the shared processor.verify site: every pipelined dispatch
    AND every ladder device attempt errors — the CPU oracle still gives
    every set a verdict and verify_stream never raises."""
    from lighthouse_tpu_torch.utils.faults import FaultInjector

    inj = FaultInjector()
    pv, rv = _mk_pipelined(injector=inj)
    inj.arm("processor.verify", "error", times=200)
    outs = pv.verify_stream([["a", "bad"], ["c"], ["d"]])
    assert [o.verdicts for o in outs] == [[True, False], [True], [True]]
    assert all(kind == "cpu" for kind, _ in rv.journal)


# ---------------------------------------------------------------------------
# Differentials against the JAX package's beacon/processor.py
# ---------------------------------------------------------------------------


def _both():
    """(reference module, port module, reference faults, port faults)."""
    from lighthouse_tpu.beacon import processor as JP
    from lighthouse_tpu.utils import faults as JF
    from lighthouse_tpu_torch.beacon import processor as TP
    from lighthouse_tpu_torch.utils import faults as TF

    return JP, TP, JF, TF


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_bisection_matches_the_reference_on_seeded_poison(seed):
    JP, TP, _, _ = _both()
    rng = random.Random(seed)
    n = rng.choice([1, 7, 64, 100, 256])
    poisoned = set(rng.sample(range(n), rng.randint(0, min(n, 5))))
    calls = {"ref": [], "port": []}

    def verify(who):
        def v(items):
            calls[who].append(tuple(items))
            return not (set(items) & poisoned)
        return v

    ref = JP.verify_with_bisection(verify("ref"), list(range(n)))
    got = TP.verify_with_bisection(verify("port"), list(range(n)))
    assert got.verdicts == ref.verdicts == [i not in poisoned for i in range(n)]
    assert got.device_calls == ref.device_calls
    assert calls["port"] == calls["ref"]  # the same calls, in the same order


def test_breaker_transitions_match_the_reference_on_a_seeded_sequence():
    JP, TP, _, _ = _both()
    rng = random.Random(7)
    ops = [rng.choice(["ok", "fail", "fail", "allow", "tick"]) for _ in range(400)]

    def run(mod):
        clock = [0.0]
        b = mod.CircuitBreaker(failure_threshold=3, reset_timeout=1.0, max_backoff=8.0,
                               now=lambda: clock[0])
        trace = []
        for op in ops:
            if op == "ok":
                b.record_success()
            elif op == "fail":
                b.record_failure()
            elif op == "allow":
                trace.append(("allow", b.allow_device()))
            else:
                clock[0] += 0.75
            trace.append((b.state.name, b.consecutive_failures, b.trips, b._backoff))
        return trace

    ref, port = run(JP), run(TP)
    assert port == ref
    states = {t[0] for t in ref if len(t) == 4}
    assert states == {"CLOSED", "OPEN", "HALF_OPEN"}  # the sequence walks every state


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_ladder_matches_the_reference_under_seeded_device_faults(seed):
    """Both packages' ResilientVerifier over the same seeded injector arming
    (processor.verify errors at a probability) and the same set stream:
    identical verdicts, journals, breaker state and fired fault sequence."""
    JP, TP, JF, TF = _both()
    rng = random.Random(seed)
    batches = [[rng.random() > 0.1 for _ in range(rng.randint(1, 12))] for _ in range(20)]

    def run(mod, faults_mod):
        clock = [0.0]
        inj = faults_mod.FaultInjector(seed=seed)
        inj.arm("processor.verify", "error", probability=0.3)
        rv = mod.ResilientVerifier(
            device_verify=lambda s: all(s), cpu_verify=lambda s: all(s),
            breaker=mod.CircuitBreaker(now=lambda: clock[0]), now=lambda: clock[0],
            injector=inj)
        out = []
        for b in batches:
            out.append(rv.verify_batch(b).verdicts)
            clock[0] += 0.4
        return out, rv.journal, rv.breaker.state.name, inj.fired_sequence()

    ref, port = run(JP, JF), run(TP, TF)
    assert port == ref
    assert ref[0] == batches  # every verdict the truth, whatever rung gave it


def test_queues_shed_and_drop_like_the_reference():
    JP, TP, JF, TF = _both()
    rng = random.Random(5)
    kinds = [k.name for k in JP.WorkKind]
    stream = [(rng.choice(kinds), i) for i in range(600)]

    def run(mod, faults_mod):
        inj = faults_mod.FaultInjector(seed=5)
        inj.arm("processor.enqueue", "overflow", probability=0.05)
        breaker = mod.CircuitBreaker(failure_threshold=1)
        bp = mod.BeaconProcessor(handlers={}, batch_size_for=lambda k: 4,
                                 bounds={k: 16 for k in mod.WorkKind}, breaker=breaker,
                                 injector=inj)
        sent = []
        for n, (kind, item) in enumerate(stream):
            if n == 300:
                breaker.record_failure()  # degraded: shed-eligible kinds shed
            sent.append(bp.try_send(mod.WorkEvent(kind=mod.WorkKind[kind], item=item)))
            if n % 7 == 0:
                bp.dispatch_once()
        return (sent, bp.journal, bp.shed, {k.name: q.dropped for k, q in bp.queues.items()},
                bp.queue_lengths())

    assert run(TP, TF) == run(JP, JF)
