"""The port's verification front door (lighthouse_tpu_torch/serve): twins of
the 22 tests of tests/test_serve.py, and a differential against the JAX
package's service.

The twins pin the serve subsystem's contracts: the batcher's fill-or-flush policy
under a fake clock, per-tenant admission (token buckets, queue depth,
degraded-mode priority shedding), the Beacon-API-shaped HTTP edge on an
ephemeral port, chaos behavior at the ``serve.submit``/``serve.dispatch``
sites (malformed requests are shed, dispatch failures fail closed and
the service keeps serving), and the acceptance invariant that a stream
of tenant submissions polls back verdicts identical to handing the same
stream to the wrapped verifier directly.  The differential drives the
same submissions on an injected clock through the reference's
``VerifyService`` and the port's, over the same stub verifier: identical
verdicts, shed reasons, flush triggers and per-tenant tallies.  The
standalone service is built over the python oracle here
(``set_backend("python")``); on the card it is ``"torch"`` (chip_smoke.py's
``serve`` phase).
"""

import json
import random
import urllib.error
import urllib.request

import pytest
import torch

torch.set_num_threads(1)

from lighthouse_tpu_torch.beacon.processor import (
    BatchOutcome,
    CircuitBreaker,
    ResilientVerifier,
)
from lighthouse_tpu_torch.crypto.bls import api as tapi
from lighthouse_tpu_torch.serve import (
    AdmissionController,
    DeadlineAwareBatcher,
    ServeApiServer,
    TenantPolicy,
    VerifyService,
)
from lighthouse_tpu_torch.utils.faults import FaultInjector

pytestmark = pytest.mark.serve


@pytest.fixture(autouse=True)
def _python_backend_active(monkeypatch):
    """The port has no active engine until one is set: the standalone stack
    is built over the python oracle, and the registry is restored after."""
    monkeypatch.setattr(tapi, "_ACTIVE", [])
    tapi.set_backend("python")


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class StubVerifier:
    """verify_batch stand-in: verdict per set is the set's own first
    element (payload sets are ("good"|"bad", ...) tuples)."""

    def __init__(self):
        self.calls = []

    def verify_batch(self, sets):
        self.calls.append(list(sets))
        return BatchOutcome(
            verdicts=[s[0] == "good" for s in sets], device_calls=1,
        )


def good(i=0):
    return ("good", i)


def bad(i=0):
    return ("bad", i)


# -- batcher: fill vs flush under a fake clock ---------------------------


def test_batcher_fills_to_largest_compiled_size():
    clock = FakeClock()
    b = DeadlineAwareBatcher([8, 32], flush_margin=0.05, now=clock.now)
    for i in range(7):
        b.offer(f"r{i}", 4, clock.t + 10.0)
    assert b.due() is None  # 28 sets pooled, not yet full
    b.offer("r7", 4, clock.t + 10.0)
    assert b.due() == "full"
    items, trigger = b.poll()
    assert trigger == "full"
    assert items == [f"r{i}" for i in range(8)]  # FIFO, whole requests
    assert b.pending_sets == 0
    assert b.flushes_full == 1


def test_batcher_full_drain_leaves_remainder_pooled():
    clock = FakeClock()
    b = DeadlineAwareBatcher([32], flush_margin=0.05, now=clock.now)
    for i in range(5):
        b.offer(f"r{i}", 10, clock.t + 10.0)  # 50 sets pooled
    items, trigger = b.poll()
    assert trigger == "full"
    assert items == ["r0", "r1", "r2"]  # 30 <= 32; r3 would overflow
    assert b.pending_sets == 20


def test_batcher_oversized_request_is_its_own_batch():
    clock = FakeClock()
    b = DeadlineAwareBatcher([32], flush_margin=0.05, now=clock.now)
    b.offer("huge", 50, clock.t + 10.0)
    items, trigger = b.poll()
    assert trigger == "full"
    assert items == ["huge"]


def test_batcher_deadline_flushes_partial_batch():
    clock = FakeClock()
    b = DeadlineAwareBatcher([32], flush_margin=0.05, now=clock.now)
    b.offer("r0", 4, clock.t + 1.0)
    b.offer("r1", 4, clock.t + 5.0)
    assert b.due() is None
    assert b.poll() is None
    clock.advance(0.94)  # 0.01 short of (oldest deadline - margin)
    assert b.due() is None
    clock.advance(0.02)  # now past oldest - margin
    assert b.due() == "deadline"
    items, trigger = b.poll()
    assert trigger == "deadline"
    assert items == ["r0", "r1"]  # deadline drains everything pooled
    assert b.flushes_deadline == 1


def test_batcher_snap_size_rounds_to_compiled_shapes():
    b = DeadlineAwareBatcher([8, 32, 128], now=FakeClock().now)
    assert b.snap_size(3) == 8
    assert b.snap_size(8) == 8
    assert b.snap_size(9) == 32
    assert b.snap_size(1000) == 128  # beyond every program: the largest


# -- admission: token buckets, queue depth, degraded shedding ------------


def test_greedy_tenant_sheds_on_rate_limit_honest_unaffected():
    clock = FakeClock()
    adm = AdmissionController(
        policies={
            "greedy": TenantPolicy(rate=10.0, burst=10.0),
            "honest": TenantPolicy(rate=10.0, burst=10.0),
        },
        now=clock.now,
    )
    verdicts = [adm.admit("greedy", 1) for _ in range(100)]  # 10x its rate
    assert sum(ok for ok, _ in verdicts) == 10  # the burst allowance
    assert adm.shed["greedy"]["rate-limit"] == 90
    for _ in range(10):
        ok, reason = adm.admit("honest", 1)
        assert ok, reason
    assert "honest" not in adm.shed  # the offender's overage, nobody else's


def test_token_bucket_refills_on_the_injected_clock():
    clock = FakeClock()
    adm = AdmissionController(
        policies={"t": TenantPolicy(rate=10.0, burst=10.0)}, now=clock.now,
    )
    assert all(adm.admit("t", 1)[0] for _ in range(10))
    assert adm.admit("t", 1) == (False, "rate-limit")
    clock.advance(0.5)  # 5 tokens back
    assert sum(adm.admit("t", 1)[0] for _ in range(10)) == 5


def test_queue_depth_bound_and_release():
    adm = AdmissionController(
        policies={"t": TenantPolicy(rate=1e9, burst=1e9, max_queue=8)},
        now=FakeClock().now,
    )
    assert adm.admit("t", 8) == (True, "ok")
    assert adm.admit("t", 1) == (False, "queue-full")
    adm.release("t", 8)
    assert adm.admit("t", 1) == (True, "ok")


def test_degraded_mode_sheds_p1_keeps_p0():
    clock = FakeClock()
    breaker = CircuitBreaker(failure_threshold=1, now=clock.now)
    breaker.record_failure()  # OPEN: device down
    assert not breaker.is_closed
    adm = AdmissionController(
        policies={
            "bulk": TenantPolicy(rate=1e9, burst=1e9, priority="p1"),
            "critical": TenantPolicy(rate=1e9, burst=1e9, priority="p0"),
        },
        breaker=breaker,
        now=clock.now,
    )
    assert adm.admit("bulk", 1) == (False, "degraded")
    assert adm.admit("critical", 1) == (True, "ok")  # never shed


# -- service: fill-or-flush dispatch, per-request verdict slices ---------


def test_service_deadline_flush_and_verdict_slices():
    clock = FakeClock()
    stub = StubVerifier()
    svc = VerifyService(
        stub, compiled_sizes=(8,), flush_margin=0.05,
        default_deadline_s=0.5, now=clock.now,
        injector=FaultInjector(),
    )
    r1 = svc.submit("a", [good(0), bad(1)])
    r2 = svc.submit("b", [good(2)])
    assert r1.accepted and r2.accepted
    assert svc.tick() == 0  # neither full nor near deadline
    assert svc.result(r1.request_id)["status"] == "queued"
    clock.advance(0.46)  # inside the flush margin of the 0.5s deadline
    assert svc.tick() == 1
    d1 = svc.result(r1.request_id)
    d2 = svc.result(r2.request_id)
    assert d1["status"] == "done" and d1["verdicts"] == [True, False]
    assert d2["status"] == "done" and d2["verdicts"] == [True]
    assert len(stub.calls) == 1  # one coalesced device batch
    assert svc.batcher.flushes_deadline == 1


def test_service_full_flush_without_clock_advance():
    clock = FakeClock()
    svc = VerifyService(
        StubVerifier(), compiled_sizes=(4,), flush_margin=0.05,
        default_deadline_s=10.0, now=clock.now,
        injector=FaultInjector(),
    )
    for i in range(4):
        svc.submit("t", [good(i)])
    assert svc.tick() == 1  # fill, not deadline, triggered the flush
    assert svc.batcher.flushes_full == 1


def test_deadline_miss_is_flagged_and_tallied():
    clock = FakeClock()
    svc = VerifyService(
        StubVerifier(), compiled_sizes=(64,), flush_margin=0.01,
        now=clock.now, injector=FaultInjector(),
    )
    r = svc.submit("t", [good()], deadline_s=0.2)
    clock.advance(5.0)  # way past the deadline before anything flushes
    svc.tick()
    doc = svc.result(r.request_id)
    assert doc["status"] == "done" and doc["deadline_missed"] is True
    assert svc.deadline_misses["t"] == 1


# -- the acceptance invariant: service == direct verifier ----------------


def _device_verify(sets):
    return all(s[0] == "good" for s in sets)


def test_verdicts_identical_to_direct_resilient_verifier():
    """The same submission stream through the service and through the
    wrapped ResilientVerifier directly must produce identical per-set
    verdicts — batching/admission may never change a verdict."""
    stream = [
        [good(0), good(1)],
        [bad(2)],
        [good(3), bad(4), good(5)],
        [bad(6), bad(7)],
    ]
    clock = FakeClock()

    def make_rv():
        return ResilientVerifier(
            device_verify=_device_verify,
            cpu_verify=_device_verify,
            breaker=CircuitBreaker(now=clock.now),
            now=clock.now,
            injector=FaultInjector(),
        )

    direct = make_rv().verify_batch(
        [s for req in stream for s in req]
    ).verdicts

    svc = VerifyService(
        make_rv(), compiled_sizes=(64,), flush_margin=0.01,
        now=clock.now, injector=FaultInjector(),
    )
    ids = [svc.submit(f"vc-{i % 2}", req).request_id
           for i, req in enumerate(stream)]
    svc.flush()  # everything pooled -> ONE coalesced verify_batch call
    served = []
    for rid in ids:
        served.extend(svc.result(rid)["verdicts"])
    assert served == [bool(v) for v in direct]
    assert served == [True, True, False, True, False, True, False, False]


# -- chaos at the serve sites --------------------------------------------


def test_dispatch_fault_fails_batch_closed_and_service_keeps_serving():
    clock = FakeClock()
    inj = FaultInjector()
    svc = VerifyService(
        StubVerifier(), compiled_sizes=(4,), flush_margin=0.01,
        now=clock.now, injector=inj,
    )
    inj.arm("serve.dispatch", "error", times=1)
    r1 = svc.submit("t", [good(0), good(1)])
    assert svc.flush() == 1  # dispatch failed inside, flush still returns
    d1 = svc.result(r1.request_id)
    assert d1["status"] == "done"
    assert d1["verdicts"] == [False, False]  # fail closed, not an exception
    # the next batch goes through untouched: the service kept serving
    r2 = svc.submit("t", [good(2)])
    svc.flush()
    assert svc.result(r2.request_id)["verdicts"] == [True]


def test_malformed_request_chaos_is_shed_not_raised():
    inj = FaultInjector()
    inj.arm("serve.submit", "malformed-request", times=1)
    svc = VerifyService(
        StubVerifier(), now=FakeClock().now, injector=inj,
    )
    res = svc.submit("t", [good()])
    assert not res.accepted and res.reason == "malformed"
    assert inj.fired_sequence() == (("serve.submit", "malformed-request"),)
    assert svc.submit("t", [good()]).accepted  # arm was bounded to once


def test_slow_client_chaos_passes_payload_through():
    inj = FaultInjector()
    inj.arm("serve.submit", "slow-client", delay=0.0)
    svc = VerifyService(
        StubVerifier(), now=FakeClock().now, injector=inj,
    )
    assert svc.submit("t", [good()]).accepted
    assert ("serve.submit", "slow-client") in inj.fired_sequence()


def test_tick_never_raises_even_with_a_broken_batcher():
    svc = VerifyService(
        StubVerifier(), now=FakeClock().now, injector=FaultInjector(),
    )
    svc.batcher = None  # worst case: the pump's own state is gone
    assert svc.tick() == 0  # absorbed, counted, not raised


# -- the HTTP edge -------------------------------------------------------


def _post(port, doc, path="/eth/v1/verify/batch"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10
        ) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@pytest.fixture
def http_stack():
    """A service over a stub device rung (real BLS point decode at the
    edge, no pairings) behind a real ephemeral-port HTTP server."""
    rv = ResilientVerifier(
        device_verify=lambda sets: True,
        cpu_verify=lambda sets: True,
        breaker=CircuitBreaker(),
        injector=FaultInjector(),
    )
    svc = VerifyService(
        rv, compiled_sizes=(64,), flush_margin=0.01,
        default_deadline_s=0.25, injector=FaultInjector(),
    )
    server = ServeApiServer(svc, port=0).start()
    assert server.port != 0  # ephemeral port resolved
    yield svc, server
    server.stop()
    svc.stop()


def _wire_sets(n=2):
    from lighthouse_tpu_torch.crypto.bls.api import SecretKey

    out = []
    for i in range(n):
        sk = SecretKey(9000 + i)
        msg = bytes([i, 42]) * 16
        out.append({
            "signature": "0x" + sk.sign(msg).to_bytes().hex(),
            "pubkeys": ["0x" + sk.public_key().to_bytes().hex()],
            "message": "0x" + msg.hex(),
        })
    return out


def test_http_submit_poll_round_trip(http_stack):
    svc, server = http_stack
    status, doc = _post(server.port, {
        "tenant": "vc-7", "deadline_ms": 250, "sets": _wire_sets(2),
    })
    assert status == 202
    rid = doc["data"]["request_id"]
    assert doc["data"]["status"] == "queued"
    svc.flush()
    status, doc = _get(server.port, f"/eth/v1/verify/batch/{rid}")
    assert status == 200
    assert doc["data"]["status"] == "done"
    assert doc["data"]["verdicts"] == [True, True]
    status, stats = _get(server.port, "/eth/v1/verify/tenants")
    assert status == 200
    assert stats["data"]["vc-7"]["accepted"] == 1


def test_http_rejects_garbage_with_400_envelope(http_stack):
    _svc, server = http_stack
    status, doc = _post(server.port, {"tenant": "t", "sets": []})
    assert status == 400 and "sets" in doc["message"]
    status, doc = _post(server.port, {
        "tenant": "t",
        "sets": [{"signature": "0xzz", "pubkeys": ["0x00"],
                  "message": "0x00"}],
    })
    assert status == 400
    status, doc = _get(server.port, "/eth/v1/verify/batch/r99999999")
    assert status == 404


def test_http_rate_limit_maps_to_429(http_stack):
    svc, server = http_stack
    svc.admission.policies["limited"] = TenantPolicy(rate=1.0, burst=1.0)
    sets = _wire_sets(1)
    status, _ = _post(server.port, {"tenant": "limited", "sets": sets})
    assert status == 202
    status, doc = _post(server.port, {"tenant": "limited", "sets": sets})
    assert status == 429 and doc["message"] == "rate-limit"


def test_http_health_endpoint(http_stack):
    _svc, server = http_stack
    status, doc = _get(server.port, "/health")
    assert status == 200 and doc["status"] == "ok"


# -- the shared construction path ----------------------------------------


def test_standalone_service_builds_without_a_beacon_node():
    """VerifyService.standalone wires the same ladder the node embeds —
    breaker, resilient rung, injector — with no BeaconNode anywhere."""
    svc = VerifyService.standalone()
    assert svc.breaker is not None
    assert svc.admission.breaker is svc.breaker
    assert hasattr(svc._verifier, "verify_batch")
    svc.stop()


# -- differential against the JAX package's service ----------------------


def test_service_matches_the_reference_on_an_injected_clock():
    """The same seeded submission stream (two honest tenants, one greedy,
    a malformed payload, deadline and fill flushes) through the reference's
    VerifyService and the port's, over the same stub verifier and clock:
    identical admissions and shed reasons, verdicts, flush triggers and
    per-tenant tallies."""
    from lighthouse_tpu.serve import TenantPolicy as JPolicy
    from lighthouse_tpu.serve import VerifyService as JService
    from lighthouse_tpu.utils.faults import FaultInjector as JInjector

    rng = random.Random(31)
    plan = []
    for i in range(300):
        tenant = rng.choice(["honest-a", "honest-b", "greedy", "greedy", "greedy"])
        n = rng.randint(1, 6)
        sets = [good(i * 10 + j) if rng.random() > 0.15 else bad(i * 10 + j) for j in range(n)]
        plan.append((rng.random() * 0.03, tenant, sets, rng.choice([None, 0.05, 0.2, 1.0]),
                     rng.random() < 0.02))

    def run(service_cls, policy_cls, injector_cls):
        clock = FakeClock()
        inj = injector_cls(seed=3)
        svc = service_cls(
            StubVerifier(), compiled_sizes=(8, 32), flush_margin=0.02, default_deadline_s=0.25,
            now=clock.now, injector=inj,
            policies={"greedy": policy_cls(rate=40.0, burst=20.0, max_queue=24),
                      "honest-a": policy_cls(rate=400.0, burst=400.0),
                      "honest-b": policy_cls(rate=400.0, burst=400.0, priority="p0")})
        results, ids = [], []
        for dt, tenant, sets, deadline, malformed in plan:
            clock.advance(dt)
            if malformed:
                inj.arm("serve.submit", "malformed-request", times=1)
            r = svc.submit(tenant, list(sets), deadline_s=deadline)
            results.append((r.accepted, r.reason))
            if r.accepted:
                ids.append(r.request_id)
            svc.tick()
        clock.advance(5.0)
        svc.flush()
        polled = [svc.result(rid) for rid in ids]
        return (results, polled, svc.batcher.flushes_full, svc.batcher.flushes_deadline,
                svc.completed, svc.deadline_misses, svc.admission.stats(),
                [len(c) for c in svc._verifier.calls], inj.fired_sequence())

    ref = run(JService, JPolicy, JInjector)
    port = run(VerifyService, TenantPolicy, FaultInjector)
    assert port == ref
    accepted = [a for a, _ in ref[0]]
    assert any(accepted) and not all(accepted)
    assert {"rate-limit", "malformed"} <= {reason for ok, reason in ref[0] if not ok}
    assert ref[2] > 0 and ref[3] > 0  # both flush triggers fired
