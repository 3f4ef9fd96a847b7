"""Per-tenant admission control for the verification front door (the
port's copy of the JAX package's ``serve/admission.py``).

Three gates, in order, before a submission reaches the batcher:

1. **degraded-mode shedding** — the same posture as the work queues'
   ``DEGRADED_SHED_KINDS``: while the circuit breaker is open (device
   down, everything on the CPU fallback) the service sheds ingress whose
   work-queue kind is in that set.  Priority classes map onto the
   existing work-queue kinds — ``"p0"`` -> ``WorkKind.API_REQUEST_P0``
   (never shed: block-critical client work) and ``"p1"`` ->
   ``WorkKind.API_REQUEST_P1`` (sheddable: replaceable per-validator
   data) — so overload degrades exactly like the node's own queues
   instead of collapsing.
2. **per-tenant queue depth** — a tenant may not pool more than
   ``max_queue`` signature sets in the batcher; a greedy tenant fills
   its own bound, not the device.
3. **token bucket** — sustained ``rate`` sets/s with ``burst``
   headroom, refilled from the injectable clock so scenario runs are
   deterministic.

The controller never raises: every decision is an ``(admitted, reason)``
pair, and shed reasons are the label values of ``serve_shed_total``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..beacon.processor import DEGRADED_SHED_KINDS, PRIORITY_ORDER, WorkKind

#: priority class wire names -> work-queue kinds (PRIORITY_ORDER gives
#: them their place in the dispatch ladder; DEGRADED_SHED_KINDS decides
#: who is shed while the breaker is open)
PRIORITY_CLASSES = {
    "p0": WorkKind.API_REQUEST_P0,
    "p1": WorkKind.API_REQUEST_P1,
}

assert all(k in PRIORITY_ORDER for k in PRIORITY_CLASSES.values())


def _message_key(s) -> object:
    """The dedup identity of one signature set's message (best effort —
    the cost model must price ANY payload shape without raising)."""
    msg = getattr(s, "message", None)
    if msg is None and isinstance(s, (tuple, list)) and s:
        msg = s[0]
    if msg is None:
        msg = s
    try:
        return bytes(msg)
    except Exception:
        return repr(msg)


def estimated_verify_cost(sets) -> float:
    """Marginal batch-verify cost of a payload, in set-equivalents.

    A batch verifier amortizes *distinct* messages; near-duplicate
    aggregates over the same message (committee-overlap storms with
    bit-twiddled participation sets) defeat both dedup and aggregation,
    so each further copy of a message inside one payload prices
    superlinearly: the k-th set carrying the same message costs k.  A
    payload of n distinct messages still costs exactly n, so honest
    traffic is admitted at face value.
    """
    seen: dict = {}
    cost = 0.0
    for s in sets:
        key = _message_key(s)
        seen[key] = seen.get(key, 0) + 1
        cost += seen[key]
    return cost


@dataclass
class TenantPolicy:
    """One tenant's admission contract."""

    rate: float = 200.0        # sustained signature sets / second
    burst: float = 400.0       # bucket capacity (sets)
    max_queue: int = 1024      # sets the tenant may have pooled
    priority: str = "p1"       # "p0" | "p1" (PRIORITY_CLASSES)

    @property
    def kind(self) -> WorkKind:
        return PRIORITY_CLASSES[self.priority]


@dataclass
class _Bucket:
    tokens: float
    stamp: float
    policy: TenantPolicy = field(default_factory=TenantPolicy)

    def take(self, n: float, now: float) -> bool:
        self.tokens = min(
            self.policy.burst,
            self.tokens + (now - self.stamp) * self.policy.rate,
        )
        self.stamp = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class AdmissionController:
    """Thread-safe per-tenant gatekeeper in front of the batcher."""

    def __init__(self, policies: dict[str, TenantPolicy] | None = None,
                 default_policy: TenantPolicy | None = None,
                 breaker=None, now=time.monotonic, cost_model=None):
        self.policies = dict(policies or {})
        self.default_policy = default_policy or TenantPolicy()
        self.breaker = breaker
        #: optional ``sets -> float`` pricing a submission in
        #: set-equivalents for the token bucket (the queue-depth gate
        #: stays in raw sets).  :func:`estimated_verify_cost` makes
        #: near-duplicate aggregation storms pay their superlinear
        #: verify cost up front instead of being admitted by set count.
        self.cost_model = cost_model
        self._now = now
        self._lock = threading.Lock()
        self._buckets: dict[str, _Bucket] = {}
        #: sets currently pooled per tenant; the service decrements on
        #: dispatch via release()
        self.queued: dict[str, int] = {}
        self.accepted: dict[str, int] = {}
        self.shed: dict[str, dict[str, int]] = {}

    def policy_for(self, tenant: str) -> TenantPolicy:
        return self.policies.get(tenant, self.default_policy)

    @property
    def degraded(self) -> bool:
        """Device down: shed the sheddable (mirrors
        ``BeaconProcessor.degraded``)."""
        return self.breaker is not None and not self.breaker.is_closed

    def admit(self, tenant: str, n_sets: int,
              sets=None) -> tuple[bool, str]:
        """Decide one submission of ``n_sets`` sets: ``(True, "ok")`` or
        ``(False, reason)`` with reason in rate-limit / queue-full /
        degraded.  When a ``cost_model`` is configured and the caller
        passes the ``sets`` themselves, the token bucket is charged the
        model's estimate instead of the raw set count."""
        pol = self.policy_for(tenant)
        now = self._now()
        cost = float(n_sets)
        if self.cost_model is not None and sets is not None:
            try:
                cost = max(cost, float(self.cost_model(sets)))
            except Exception:  # the model must never turn into an outage
                cost = float(n_sets)
        with self._lock:
            if self.degraded and pol.kind in DEGRADED_SHED_KINDS:
                return self._shed(tenant, "degraded")
            if self.queued.get(tenant, 0) + n_sets > pol.max_queue:
                return self._shed(tenant, "queue-full")
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = _Bucket(
                    tokens=pol.burst, stamp=now, policy=pol,
                )
            if not b.take(cost, now):
                return self._shed(tenant, "rate-limit")
            self.queued[tenant] = self.queued.get(tenant, 0) + n_sets
            self.accepted[tenant] = self.accepted.get(tenant, 0) + 1
        return True, "ok"

    def _shed(self, tenant: str, reason: str) -> tuple[bool, str]:
        per = self.shed.setdefault(tenant, {})
        per[reason] = per.get(reason, 0) + 1
        return False, reason

    def release(self, tenant: str, n_sets: int) -> None:
        """Return ``n_sets`` of pooled depth after their batch left."""
        with self._lock:
            left = self.queued.get(tenant, 0) - n_sets
            self.queued[tenant] = max(0, left)

    def stats(self) -> dict:
        """Per-tenant accept/shed/queued snapshot (the HTTP stats
        endpoint's body)."""
        with self._lock:
            tenants = (
                set(self.accepted) | set(self.shed) | set(self.queued)
            )
            return {
                t: {
                    "accepted": self.accepted.get(t, 0),
                    "shed": dict(self.shed.get(t, {})),
                    "queued_sets": self.queued.get(t, 0),
                    "priority": self.policy_for(t).priority,
                }
                for t in sorted(tenants)
            }
