"""Gossip layer: message IDs, peer scoring, and an in-process mesh router.

Twin of the vendored gossipsub fork + peer manager (SURVEY §2.4): spec
message-id derivation (sha256 over a domain + topic + payload, first 20
bytes), duplicate suppression cache (the mcache/seen-cache), per-peer
behavioral scoring with ban thresholds (peer_manager/peerdb.rs shape), and
a GossipRouter that floods to mesh peers — the transport for the in-process
multi-node simulator (testing/simulator analog), where libp2p's wire layer
is out of scope but the BEHAVIOR (dedup, scoring, topic fanout, validation
callbacks) is the part the consensus stack depends on.
"""

from __future__ import annotations

import time
from collections import OrderedDict, defaultdict
from typing import Callable

from ..ops import sha256
from . import snappy

MESSAGE_DOMAIN_VALID_SNAPPY = b"\x01\x00\x00\x00"
MESSAGE_DOMAIN_INVALID_SNAPPY = b"\x00\x00\x00\x00"


def message_id(topic: str, compressed_payload: bytes) -> bytes:
    """Spec compute_message_id (altair+ form: domain + topic len + topic +
    decompressed data, first 20 bytes of sha256)."""
    try:
        data = snappy.decompress_block(compressed_payload)
        domain = MESSAGE_DOMAIN_VALID_SNAPPY
    except snappy.SnappyError:
        data = compressed_payload
        domain = MESSAGE_DOMAIN_INVALID_SNAPPY
    t = topic.encode()
    return sha256(domain + len(t).to_bytes(8, "little") + t + data)[:20]


class SeenCache:
    """Bounded LRU of seen message ids (duplicate suppression)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._d: OrderedDict[bytes, float] = OrderedDict()

    def observe(self, mid: bytes) -> bool:
        """True if NEW."""
        if mid in self._d:
            self._d.move_to_end(mid)
            return False
        self._d[mid] = time.monotonic()
        if len(self._d) > self.capacity:
            self._d.popitem(last=False)
        return True

    def contains(self, mid: bytes) -> bool:
        """Non-mutating membership probe (IHAVE filtering)."""
        return mid in self._d


# peer scoring: the full decay/ban-expiry/per-topic model lives in
# peer_manager.py (peerdb.rs + gossipsub_scoring_parameters.rs twin);
# re-exported here for the in-process router + older call sites.
from .peer_manager import (  # noqa: E402,F401
    BAN_THRESHOLD,
    GREYLIST_THRESHOLD,
    PeerManager,
)


class GossipNode:
    """One node's gossip endpoint: subscribe with a validator callback,
    publish to the mesh.  Validation outcomes mirror the reference's
    MessageAcceptance {Accept, Ignore, Reject}: Reject penalizes the
    forwarding peer."""

    def __init__(self, node_id: str, router: "GossipRouter"):
        self.node_id = node_id
        self.router = router
        self.handlers: dict[str, Callable[[bytes, str], str]] = {}
        self.seen = SeenCache()
        self.peer_manager = PeerManager()
        self.received: list[tuple[str, bytes]] = []

    def subscribe(self, topic: str, handler: Callable[[bytes, str], str]) -> None:
        self.handlers[topic] = handler
        self.router.register(topic, self)

    def publish(self, topic: str, payload: bytes) -> bytes:
        compressed = snappy.compress_block(payload)
        mid = message_id(topic, compressed)
        self.seen.observe(mid)
        self.router.route(topic, compressed, origin=self.node_id)
        return mid

    def deliver(self, topic: str, compressed: bytes, from_peer: str) -> None:
        mid = message_id(topic, compressed)
        if not self.seen.observe(mid):
            return  # duplicate
        handler = self.handlers.get(topic)
        if handler is None:
            return
        try:
            payload = snappy.decompress_block(compressed)
        except snappy.SnappyError:
            # invalid-snappy gossip: reject + penalize (the reason the
            # MESSAGE_DOMAIN_INVALID_SNAPPY id domain exists)
            self.peer_manager.report(from_peer, -10.0, "invalid snappy")
            return
        outcome = handler(payload, from_peer)
        if outcome == "accept":
            self.received.append((topic, payload))
            # forward to the rest of the mesh (flood publish)
            self.router.route(topic, compressed, origin=self.node_id)
        elif outcome == "reject":
            self.peer_manager.report(from_peer, -10.0, "invalid gossip")


class GossipRouter:
    """In-process full-mesh router for the multi-node simulator.

    ``injector``: optional FaultInjector consulted once per *delivery* at
    the ``gossip.route`` site — a raising kind (``drop``) makes the
    message vanish on the wire to that one peer (lossy network), a
    mutating kind (``corrupt``) hands the peer flipped bytes (which then
    fail snappy/SSZ validation and penalize the forwarder, exactly as a
    bit-flipping relay would).  Unarmed, the hook is one attribute check.
    """

    def __init__(self, injector=None):
        self.subscriptions: dict[str, list[GossipNode]] = defaultdict(list)
        self.injector = injector
        self.dropped = 0  # deliveries lost to injected wire faults

    def register(self, topic: str, node: GossipNode) -> None:
        if node not in self.subscriptions[topic]:
            self.subscriptions[topic].append(node)

    def route(self, topic: str, compressed: bytes, origin: str) -> None:
        for node in self.subscriptions[topic]:
            if node.node_id == origin:
                continue
            payload = compressed
            if self.injector is not None:
                try:
                    payload = self.injector.fire("gossip.route", compressed)
                except Exception:
                    self.dropped += 1
                    continue  # lost on the wire to this one peer
            node.deliver(topic, payload, origin)
