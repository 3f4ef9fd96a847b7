"""Peer manager: reputation with decay, per-topic gossip scores, ban expiry.

Twin of lighthouse_network/src/peer_manager/mod.rs (2,367 LoC) + peerdb.rs
(2,028) + service/gossipsub_scoring_parameters.rs, scaled to this stack's
needs but with the same load-bearing mechanics:

* **Score model** (gossipsub v1.1 shape): per-topic first-delivery reward
  (capped) and invalid-delivery penalty (squared — repeat offenders fall
  off a cliff), a global behaviour penalty (squared) for protocol abuse
  (oversized RPCs, IWANT floods), and a legacy manual delta channel.
* **Decay**: every component decays exponentially per decay tick, so
  reputation is earned and forgiven over time, not accumulated forever.
* **Ban policy with expiry**: crossing BAN_THRESHOLD bans for
  ``ban_duration`` seconds; the ban expires back to a greylist-level
  score rather than a clean slate.
* **PeerDB**: records persist across disconnects (bounded), so a
  reconnecting bad peer resumes its old reputation.

The mesh consumes scores through ``accept_graft`` / ``graft_candidates`` /
``mesh_prunable`` — scoring influences GRAFT/PRUNE, not just bans.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..utils.metrics import PEER_BANS, PEER_PENALTIES

GREYLIST_THRESHOLD = -16.0
BAN_THRESHOLD = -40.0

FIRST_DELIVERY_WEIGHT = 0.5
FIRST_DELIVERY_CAP = 10.0
INVALID_DELIVERY_WEIGHT = 4.0  # applied negatively, × count²
BEHAVIOUR_WEIGHT = 1.0  # applied negatively, × penalty²
DECAY_FACTOR = 0.95  # per decay tick
DECAY_INTERVAL = 1.0  # seconds between ticks (heartbeat-driven)
MAX_DB_SIZE = 1024


@dataclass
class TopicScore:
    first_message_deliveries: float = 0.0
    invalid_message_deliveries: float = 0.0

    def value(self) -> float:
        reward = (
            min(self.first_message_deliveries, FIRST_DELIVERY_CAP)
            * FIRST_DELIVERY_WEIGHT
        )
        penalty = INVALID_DELIVERY_WEIGHT * self.invalid_message_deliveries**2
        return reward - penalty

    def decay(self) -> None:
        self.first_message_deliveries *= DECAY_FACTOR
        self.invalid_message_deliveries *= DECAY_FACTOR


@dataclass
class PeerRecord:
    """peerdb.rs PeerInfo: identity, liveness, reputation components."""

    connected: bool = True
    banned_until: float | None = None
    manual_score: float = 0.0
    behaviour_penalty: float = 0.0
    topics: dict[str, TopicScore] = field(default_factory=dict)
    subscriptions: set[str] = field(default_factory=set)
    last_seen: float = field(default_factory=time.monotonic)
    goodbyes: int = 0

    def score(self) -> float:
        s = self.manual_score - BEHAVIOUR_WEIGHT * self.behaviour_penalty**2
        for ts in self.topics.values():
            s += ts.value()
        return s

    def decay(self) -> None:
        self.manual_score *= DECAY_FACTOR
        self.behaviour_penalty *= DECAY_FACTOR
        for ts in self.topics.values():
            ts.decay()

    # legacy alias used by older call sites
    @property
    def banned(self) -> bool:
        return self.banned_until is not None and (
            time.monotonic() < self.banned_until
        )


class PeerManager:
    """Score-driven peer lifecycle.  Backwards compatible with the round-3
    interface (connect/report/is_banned/greylisted/connected_peers) and
    extended with the gossipsub scoring surface."""

    def __init__(self, ban_duration: float = 60.0):
        self.peers: dict[str, PeerRecord] = {}
        self.ban_duration = ban_duration
        # Reentrant: the SyncManager tick thread, connection handler
        # threads, and the heartbeat decay all mutate the same records,
        # and public methods compose (_rec → _prune_db, report →
        # _maybe_ban) while holding it.
        self._lock = threading.RLock()
        self._last_decay = time.monotonic()

    # -- db ----------------------------------------------------------------

    def _rec(self, peer_id: str) -> PeerRecord:
        with self._lock:
            rec = self.peers.get(peer_id)
            if rec is None:
                if len(self.peers) > MAX_DB_SIZE:
                    self._prune_db()
                rec = PeerRecord()
                self.peers[peer_id] = rec
            return rec

    def _prune_db(self) -> None:
        """Drop the oldest disconnected, non-banned records (peerdb.rs
        prune: banned peers are retained so bans stick)."""
        with self._lock:
            removable = sorted(
                (
                    (rec.last_seen, pid)
                    for pid, rec in self.peers.items()
                    if not rec.connected and not rec.banned
                ),
            )
            for _, pid in removable[: max(len(self.peers) - MAX_DB_SIZE, 16)]:
                del self.peers[pid]

    # -- lifecycle ---------------------------------------------------------

    def connect(self, peer_id: str) -> None:
        with self._lock:
            rec = self._rec(peer_id)
            if self.is_banned(peer_id):
                raise PermissionError(f"peer {peer_id} is banned")
            rec.connected = True
            rec.last_seen = time.monotonic()

    def disconnect(self, peer_id: str) -> None:
        with self._lock:
            rec = self.peers.get(peer_id)
            if rec is not None:
                rec.connected = False
                rec.last_seen = time.monotonic()

    # -- reputation events -------------------------------------------------

    def report(self, peer_id: str, delta: float, reason: str = "") -> None:
        """Legacy manual channel (protocol errors etc.); decays like the
        rest."""
        with self._lock:
            rec = self._rec(peer_id)
            rec.manual_score += delta
            self._maybe_ban(peer_id, rec)

    def on_first_delivery(self, peer_id: str, topic: str) -> None:
        with self._lock:
            rec = self._rec(peer_id)
            ts = rec.topics.setdefault(topic, TopicScore())
            ts.first_message_deliveries += 1.0
            rec.last_seen = time.monotonic()

    def on_invalid_message(self, peer_id: str, topic: str) -> None:
        with self._lock:
            rec = self._rec(peer_id)
            ts = rec.topics.setdefault(topic, TopicScore())
            ts.invalid_message_deliveries += 1.0
            self._maybe_ban(peer_id, rec)

    def on_behaviour_penalty(
        self, peer_id: str, amount: float = 1.0, reason: str = ""
    ) -> None:
        with self._lock:
            rec = self._rec(peer_id)
            rec.behaviour_penalty += amount
            PEER_PENALTIES.inc(labels=(reason or "unspecified",))
            self._maybe_ban(peer_id, rec)

    def on_goodbye(self, peer_id: str) -> None:
        """Peer said goodbye: count it and mark the record disconnected
        (reputation persists — a goodbye is not a reset)."""
        with self._lock:
            rec = self._rec(peer_id)
            rec.goodbyes += 1
            rec.connected = False
            rec.last_seen = time.monotonic()

    def _maybe_ban(self, peer_id: str, rec: PeerRecord) -> None:
        with self._lock:
            if rec.score() <= BAN_THRESHOLD and not rec.banned:
                rec.banned_until = time.monotonic() + self.ban_duration
                rec.connected = False
                PEER_BANS.inc()

    # -- decay -------------------------------------------------------------

    def decay(self) -> None:
        """One decay tick over every record; expired bans lift back to a
        greylist-level manual score (reputation is forgiven, slowly)."""
        with self._lock:
            now = time.monotonic()
            for rec in self.peers.values():
                rec.decay()
                if rec.banned_until is not None and now >= rec.banned_until:
                    rec.banned_until = None
                    # resume at greylist, not zero: recently-banned stays cold
                    rec.manual_score = min(rec.manual_score,
                                           GREYLIST_THRESHOLD)
                    rec.behaviour_penalty = 0.0
                    for ts in rec.topics.values():
                        ts.invalid_message_deliveries = 0.0

    def maybe_decay(self) -> None:
        """Rate-limited decay for heartbeat call sites."""
        with self._lock:
            now = time.monotonic()
            if now - self._last_decay >= DECAY_INTERVAL:
                self._last_decay = now
                self.decay()

    # -- queries -----------------------------------------------------------

    def score(self, peer_id: str) -> float:
        with self._lock:
            rec = self.peers.get(peer_id)
            return rec.score() if rec is not None else 0.0

    def is_banned(self, peer_id: str) -> bool:
        with self._lock:
            rec = self.peers.get(peer_id)
            return rec is not None and rec.banned

    def greylisted(self, peer_id: str) -> bool:
        return self.score(peer_id) <= GREYLIST_THRESHOLD

    def connected_peers(self) -> list[str]:
        with self._lock:
            return [p for p, r in self.peers.items() if r.connected]

    # -- mesh integration (scoring → GRAFT/PRUNE) --------------------------

    def accept_graft(self, peer_id: str) -> bool:
        """A peer below zero score does not get into our mesh
        (gossipsub v1.1 graft score gate)."""
        return not self.is_banned(peer_id) and self.score(peer_id) >= 0.0

    def graft_candidates(self, peer_ids: list[str]) -> list[str]:
        """Eligible peers, best score first (mesh growth ordering)."""
        ok = [p for p in peer_ids if self.accept_graft(p)]
        return sorted(ok, key=self.score, reverse=True)

    def mesh_prunable(self, peer_ids: list[str]) -> list[str]:
        """Mesh members whose score fell below zero — pruned before any
        random over-subscription trimming."""
        return [p for p in peer_ids if self.score(p) < 0.0]
