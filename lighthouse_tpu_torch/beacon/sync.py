"""Sync: multi-peer range sync, backfill, and single-block lookups.

Twin of beacon_node/network/src/sync (SyncManager manager.rs:1-30, range
sync chain collection + epoch batches range_sync/, backfill after
checkpoint sync backfill_sync/mod.rs, block_lookups/).  The wire is the
req/resp codec (lighthouse_tpu.network.rpc BlocksByRange chunks); the peer
abstraction is anything serving encoded response chunks — in tests, another
in-process node's store.

Two sync drivers live here:

* :class:`RangeSync` — the original in-process driver (tests, tools):
  peers hand back encoded chunks directly.
* :class:`SyncManager` — the node's adversarial-input-tolerant driver.
  Every BlocksByRange response is VALIDATED before import (chunk-count cap,
  slots inside the requested range and strictly increasing, parent-root
  linkage within the batch and across the boundary to our head), then the
  whole segment's signatures are verified in ONE bulk pass
  (signature_verify_chain_segment, block_verification.rs:572) through the
  node's ResilientVerifier device path before sequential import.  Requests
  run under a per-request timeout with exception isolation — a hanging,
  raising, or garbage-serving peer can never wedge or crash the caller.
  Invalid/failed batches penalize the serving peer through the shared
  PeerManager, rotate to a different peer, and retry under a bounded
  budget; an exhausted batch parks the sync as STALLED (never silently
  dropped) and re-arms when a new viable peer arrives.

State machine per the reference: Idle -> Syncing(batches in flight) ->
Synced, plus Stalled when no viable peer can complete the front batch; a
failed batch re-queues against a rotated peer.  Backfill walks BACKWARD
from a checkpoint anchor verifying parent-root linkage (backfill_sync
semantics).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from enum import Enum

from ..network import rpc
from ..obs.tracer import TRACER
from ..utils import faults as faults_mod
from ..utils import metrics as M
from ..utils.logging import get_logger

log = get_logger("sync")


class SyncState(Enum):
    IDLE = "idle"
    SYNCING = "syncing"
    SYNCED = "synced"
    STALLED = "stalled"  # front batch exhausted its budget / no viable peer


EPOCHS_PER_BATCH = 2  # range_sync batch sizing (the reference's default)

# Peer-scoring amounts fed to PeerManager.on_behaviour_penalty (score drops
# by amount², BEHAVIOUR_WEIGHT=1): provably-byzantine content (bad
# signatures, broken linkage, garbage bytes on an authenticated stream —
# nothing a honest peer produces by accident) greylists on the first strike
# (-16) and bans on the second (-64 ≤ BAN_THRESHOLD); transport flakiness
# (timeouts, drops) degrades gradually — greylist around the third strike,
# ban only after ~5 in quick succession.
PENALTY_INVALID_BATCH = 4.0
PENALTY_FLAKY = 1.5


class BatchInvalid(Exception):
    """A response that is provably wrong — rejected before import."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


class GarbageResponse(Exception):
    """Response bytes that do not decode — raised by requester callables so
    the manager can tell byzantine content from transport failure."""


class PeerRequestError(Exception):
    """Transport-level request failure (timeout, drop, dead connection)."""


class EmptyBatch(PeerRequestError):
    """The peer served nothing for a range it claimed to have — retried
    against another peer, but without a penalty (slots CAN be empty)."""


@dataclass
class PeerSyncInfo:
    peer_id: str
    head_slot: int
    finalized_epoch: int
    # callable(start_slot, count) -> list of encoded response chunk bytes
    serve_blocks_by_range: object = None


@dataclass
class SyncPeer:
    """A remote peer as the SyncManager sees it after the Status handshake."""

    peer_id: str
    head_slot: int
    finalized_epoch: int = 0
    # callable(start_slot, count) -> list[(result_code, ssz_bytes)]; raises
    # GarbageResponse for undecodable bytes, anything else for transport
    request_blocks: object = None
    # callable(signed_block) -> bool (deneb availability recovery)
    fetch_blobs: object = None


@dataclass
class Batch:
    start_slot: int
    count: int
    peer_id: str | None = None
    attempts: int = 0


def _bulk_verify_sets(sig_sets, verifier) -> bool:
    """ONE bulk pass over a whole segment's signature sets: the node's
    ResilientVerifier ladder when wired (device → retry → CPU fallback,
    never raises), else the active backend's batch call."""
    if verifier is not None:
        return all(verifier.verify_batch(sig_sets).verdicts)
    from ..crypto.bls.api import get_backend

    return bool(get_backend().verify_signature_sets(sig_sets))


class RangeSync:
    """Forward sync toward the best peer's head (range_sync/) — the
    in-process driver.  ``peer_manager`` (optional) excludes banned and
    greylisted peers from selection; ``verifier`` routes the segment bulk
    pass through the ResilientVerifier ladder."""

    def __init__(self, chain, fork: str = "altair", max_batch_attempts: int = 3,
                 peer_manager=None, verifier=None):
        self.chain = chain
        self.fork = fork
        self.state = SyncState.IDLE
        self.peers: dict[str, PeerSyncInfo] = {}
        self.pending: list[Batch] = []
        self.failed_batches = 0
        self.max_batch_attempts = max_batch_attempts
        self.peer_manager = peer_manager
        self.verifier = verifier
        self.imported = 0
        self._batched_through = 0
        self._rr = 0  # deterministic rotation cursor

    # ------------------------------------------------------------- peers

    def add_peer(self, info: PeerSyncInfo) -> None:
        """Status handshake outcome (the reference decides relevance by
        comparing the peer's finalized/head against ours)."""
        self.peers[info.peer_id] = info
        if info.head_slot > int(self.chain.head_state().slot):
            self._start(info)

    def remove_peer(self, peer_id: str) -> None:
        self.peers.pop(peer_id, None)

    # -------------------------------------------------------------- sync

    def _start(self, target: PeerSyncInfo) -> None:
        our = int(self.chain.head_state().slot)
        if self.state != SyncState.SYNCING:
            self.state = SyncState.SYNCING
            self._batched_through = our
        # extend pending with the new tail: a higher head arriving while
        # already SYNCING used to be ignored, freezing the target at the
        # first peer's head
        per_batch = EPOCHS_PER_BATCH * self.chain.preset.slots_per_epoch
        slot = max(self._batched_through, our) + 1
        while slot <= target.head_slot:
            count = min(per_batch, target.head_slot - slot + 1)
            self.pending.append(Batch(start_slot=slot, count=count))
            slot += count
        self._batched_through = max(self._batched_through, target.head_slot)

    def tick(self) -> SyncState:
        """Drive batch request/import rounds until synced or stalled (the
        manager poll loop)."""
        while self.state == SyncState.SYNCING:
            if not self.pending:
                self.state = SyncState.SYNCED
                break
            batch = self.pending[0]
            peer = self._pick_peer(batch)
            if peer is None:
                self.state = SyncState.IDLE  # no peers: stall
                break
            batch.peer_id = peer.peer_id
            batch.attempts += 1
            chunks = peer.serve_blocks_by_range(batch.start_slot, batch.count)
            blocks = []
            ok = True
            for chunk in chunks:
                result, payload = rpc.decode_response_chunk(chunk)
                if result != rpc.SUCCESS:
                    ok = False
                    break
                cls = self.chain.types.SignedBeaconBlock_BY_FORK[self.fork]
                blocks.append(cls.deserialize_value(payload))
            if ok:
                ok = self._import_batch(blocks)
            if ok:
                self.pending.pop(0)
            else:
                self.failed_batches += 1
                if batch.attempts >= self.max_batch_attempts:
                    self.pending.pop(0)  # drop; peer penalty is upstream
        return self.state

    def _pick_peer(self, batch: Batch) -> PeerSyncInfo | None:
        """Deterministic rotation among eligible peers: banned/greylisted
        peers are excluded, the peer that just failed this batch is never
        re-picked while an alternative exists."""
        pm = self.peer_manager
        eligible = [
            p for p in sorted(self.peers.values(), key=lambda p: p.peer_id)
            if pm is None
            or not (pm.is_banned(p.peer_id) or pm.greylisted(p.peer_id))
        ]
        if not eligible:
            return None
        covering = [
            p for p in eligible
            if p.head_slot >= batch.start_slot + batch.count - 1
        ]
        pool = covering or eligible
        if len(pool) > 1 and batch.peer_id is not None:
            pool = [p for p in pool if p.peer_id != batch.peer_id] or pool
        pick = pool[(self._rr + batch.attempts) % len(pool)]
        self._rr += 1
        return pick

    def _import_batch(self, blocks) -> bool:
        """Chain-segment import: verify signatures for the whole batch in
        one bulk pass (signature_verify_chain_segment,
        block_verification.rs:572) then import sequentially."""
        from .chain import BlockError

        try:
            sig_sets = self.chain.collect_segment_signature_sets(blocks)
        except BlockError:
            return False
        if sig_sets:
            M.SYNC_SEGMENT_SETS_VERIFIED.inc(len(sig_sets))
            if not _bulk_verify_sets(sig_sets, self.verifier):
                return False
        for signed in blocks:
            try:
                self.chain.process_block(
                    signed, verify_signatures=False, from_rpc=True
                )
                self.imported += 1
            except BlockError as e:
                if "already known" not in str(e):
                    return False
        return True


class SyncManager:
    """Multi-peer, adversarial-input-tolerant range sync (the node core).

    Thread model: ``add_peer`` may be called from any connection thread;
    ``tick`` is reentrant-safe (one driver at a time, concurrent callers
    return immediately).  Chain access is serialized through
    ``chain_lock`` — the node passes its single-writer lock.
    """

    def __init__(self, chain, fork: str = "altair", peer_manager=None,
                 verifier=None, injector=None, chain_lock=None,
                 batch_slots: int | None = None, max_batch_attempts: int = 6,
                 request_timeout: float = 5.0):
        self.chain = chain
        self.fork = fork
        self.peer_manager = peer_manager
        self.verifier = verifier
        self.injector = injector if injector is not None else faults_mod.INJECTOR
        self._chain_lock = chain_lock if chain_lock is not None else threading.Lock()
        self.batch_slots = (
            batch_slots or EPOCHS_PER_BATCH * chain.preset.slots_per_epoch
        )
        self.max_batch_attempts = max_batch_attempts
        self.request_timeout = request_timeout
        self.state = SyncState.IDLE
        self.peers: dict[str, SyncPeer] = {}
        self.pending: list[Batch] = []
        self.imported = 0
        self.failed_batches = 0
        self._batched_through = 0
        self._rr = 0  # deterministic rotation cursor
        self._lock = threading.Lock()       # guards peers + pending
        self._tick_lock = threading.Lock()  # one tick driver at a time

    # ------------------------------------------------------------- peers

    def add_peer(self, peer: SyncPeer) -> None:
        """Register a status-handshaken peer; extend the batch queue up to
        its head and re-arm a STALLED sync when the peer is viable."""
        with self._lock:
            self.peers[peer.peer_id] = peer
            our = int(self.chain.head_state().slot)
            slot = max(self._batched_through, our) + 1
            while slot <= peer.head_slot:
                count = min(self.batch_slots, peer.head_slot - slot + 1)
                self.pending.append(Batch(start_slot=slot, count=count))
                slot += count
            self._batched_through = max(self._batched_through, peer.head_slot, our)
            if self.pending and (
                self.state != SyncState.STALLED or self._viable(peer.peer_id)
            ):
                if self.state == SyncState.STALLED:
                    # a fresh viable peer buys the parked batches a fresh
                    # attempt budget — stalling is a pause, never a drop
                    for b in self.pending:
                        b.attempts = 0
                self.state = SyncState.SYNCING

    def remove_peer(self, peer_id: str) -> None:
        with self._lock:
            self.peers.pop(peer_id, None)

    def _viable(self, peer_id: str) -> bool:
        return self.peer_manager is None or not self.peer_manager.is_banned(
            peer_id
        )

    # -------------------------------------------------------------- tick

    def tick(self) -> SyncState:
        """Drive request → validate → bulk-verify → import rounds until
        synced or stalled.  Never raises: every peer interaction is
        isolated, every failure is classified and fed back as score."""
        if not self._tick_lock.acquire(blocking=False):
            return self.state
        try:
            while self.state == SyncState.SYNCING:
                with self._lock:
                    if not self.pending:
                        self.state = SyncState.SYNCED
                        break
                    batch = self.pending[0]
                peer = self._pick_peer(batch)
                if peer is None:
                    self._stall("no viable peers")
                    break
                if batch.peer_id is not None and batch.peer_id != peer.peer_id:
                    M.SYNC_PEER_ROTATIONS.inc()
                batch.peer_id = peer.peer_id
                batch.attempts += 1
                if batch.attempts > 1:
                    M.SYNC_BATCH_RETRIES.inc()
                try:
                    # one span per batch attempt: request through import
                    # (failures carry an "error" field from the span exit)
                    with TRACER.span("sync.batch",
                                     start_slot=batch.start_slot,
                                     attempt=batch.attempts):
                        blocks = self._request(peer, batch)
                        self._validate(batch, blocks)
                        self._bulk_verify(blocks)
                        self._import(blocks, peer)
                except BatchInvalid as exc:
                    self.failed_batches += 1
                    M.SYNC_BATCHES_INVALID.inc(labels=(exc.reason,))
                    self._penalize(peer, PENALTY_INVALID_BATCH,
                                   f"sync:{exc.reason}")
                    log.warning("sync: invalid batch @%d from %s: %s",
                                batch.start_slot, peer.peer_id[:8], exc)
                    if batch.attempts >= self.max_batch_attempts:
                        self._stall(f"batch @{batch.start_slot} exhausted")
                        break
                    continue
                except EmptyBatch as exc:
                    self.failed_batches += 1
                    log.debug("sync: %s", exc)
                    if batch.attempts >= self.max_batch_attempts:
                        self._stall(f"batch @{batch.start_slot} unserved")
                        break
                    continue
                except Exception as exc:  # noqa: BLE001 — timeout/transport
                    self.failed_batches += 1
                    self._penalize(peer, PENALTY_FLAKY, "sync:rpc-failure")
                    log.debug("sync: rpc failure @%d from %s: %s",
                              batch.start_slot, peer.peer_id[:8], exc)
                    if batch.attempts >= self.max_batch_attempts:
                        self._stall(f"batch @{batch.start_slot} exhausted")
                        break
                    continue
                with self._lock:
                    if self.pending and self.pending[0] is batch:
                        self.pending.pop(0)
                M.SYNC_BATCHES_IMPORTED.inc()
        except Exception as exc:  # noqa: BLE001 — the never-raise backstop
            # Everything expected is classified above; this is the lexical
            # proof obligation for the "tick never raises" contract.
            log.error("sync: tick backstop caught %s: %s",
                      type(exc).__name__, exc)
        finally:
            self._tick_lock.release()
        return self.state

    # ---------------------------------------------------------- internals

    def _pick_peer(self, batch: Batch) -> SyncPeer | None:
        """Deterministic rotation: banned peers are out absolutely,
        greylisted peers are a last resort, peers whose head covers the
        batch are preferred, and the peer that just failed this batch is
        never re-picked while an alternative exists."""
        pm = self.peer_manager
        with self._lock:
            peers = sorted(self.peers.values(), key=lambda p: p.peer_id)
        if pm is not None:
            peers = [p for p in peers if not pm.is_banned(p.peer_id)]
            clean = [p for p in peers if not pm.greylisted(p.peer_id)]
            peers = clean or peers
        if not peers:
            return None
        covering = [
            p for p in peers
            if p.head_slot >= batch.start_slot + batch.count - 1
        ]
        pool = covering or peers
        if len(pool) > 1 and batch.peer_id is not None:
            pool = [p for p in pool if p.peer_id != batch.peer_id] or pool
        pick = pool[(self._rr + batch.attempts) % len(pool)]
        self._rr += 1
        return pick

    def _request(self, peer: SyncPeer, batch: Batch):
        """Issue one BlocksByRange request under a hard timeout; decode the
        chunks.  The worker runs on a daemon thread so a hanging peer costs
        one parked thread, never the sync loop."""
        M.SYNC_BATCHES_REQUESTED.inc()
        box: dict = {}

        def run():
            try:
                chunks = peer.request_blocks(batch.start_slot, batch.count)
                box["chunks"] = self.injector.fire("sync.request", chunks)
            except Exception as exc:  # noqa: BLE001 — isolated below
                box["error"] = exc

        t = threading.Thread(target=run, name="sync-request", daemon=True)
        t.start()
        t.join(self.request_timeout)
        if t.is_alive():
            raise PeerRequestError(
                f"request to {peer.peer_id[:8]} timed out "
                f"({self.request_timeout}s)"
            )
        err = box.get("error")
        if err is not None:
            if isinstance(err, GarbageResponse):
                # undecodable bytes on an authenticated stream: byzantine,
                # not weather
                raise BatchInvalid("garbage", str(err))
            raise PeerRequestError(f"{type(err).__name__}: {err}")
        blocks = []
        cls = self.chain.types.SignedBeaconBlock_BY_FORK[self.fork]
        for code, payload in box.get("chunks") or []:
            if code != rpc.SUCCESS:
                break  # peer signalled end-of-data / unavailability
            try:
                blocks.append(cls.deserialize_value(payload))
            except Exception as exc:  # noqa: BLE001
                raise BatchInvalid("undecodable", str(exc)) from None
        if not blocks:
            if int(self.chain.head_state().slot) >= (
                batch.start_slot + batch.count - 1
            ):
                return []  # gossip already covered this range
            raise EmptyBatch(f"empty response for batch @{batch.start_slot}")
        return blocks

    def _validate(self, batch: Batch, blocks) -> None:
        """Reject a response that is provably not the requested segment
        BEFORE any crypto or state work."""
        if len(blocks) > batch.count:
            raise BatchInvalid("over-count", f"{len(blocks)} > {batch.count}")
        prev_slot = None
        prev_root = None
        for signed in blocks:
            slot = int(signed.message.slot)
            if not (batch.start_slot <= slot < batch.start_slot + batch.count):
                raise BatchInvalid("slot-out-of-range", f"slot {slot}")
            if prev_slot is not None:
                if slot <= prev_slot:
                    raise BatchInvalid(
                        "non-increasing-slots", f"{prev_slot} -> {slot}"
                    )
                if bytes(signed.message.parent_root) != prev_root:
                    raise BatchInvalid("broken-linkage", f"slot {slot}")
            prev_slot = slot
            prev_root = signed.message.root()
        # boundary: the first block we don't already have must anchor to a
        # state we hold (linkage across the batch edge to our chain)
        for signed in blocks:
            if signed.message.root() in self.chain._observed_blocks:
                continue
            if self.chain.state_for_block(
                bytes(signed.message.parent_root)
            ) is None:
                raise BatchInvalid(
                    "unknown-anchor", f"slot {int(signed.message.slot)}"
                )
            break

    def _bulk_verify(self, blocks) -> None:
        """ONE bulk signature pass over the whole accepted batch through
        the BlockSignatureVerifier collection + ResilientVerifier ladder."""
        if not blocks:
            return
        try:
            with self._chain_lock:
                sig_sets = self.chain.collect_segment_signature_sets(blocks)
        except Exception as exc:  # noqa: BLE001 — anchor/transition reject
            raise BatchInvalid("segment-rejected", str(exc)) from None
        if not sig_sets:
            return
        M.SYNC_SEGMENT_SETS_VERIFIED.inc(len(sig_sets))
        if not _bulk_verify_sets(sig_sets, self.verifier):
            raise BatchInvalid("bad-signature", f"{len(sig_sets)} sets")

    def _import(self, blocks, peer: SyncPeer) -> None:
        """Sequential import of a validated, bulk-verified segment."""
        from .chain import AvailabilityPendingError, BlockError

        for signed in blocks:
            blobs_fetched = False
            while True:
                try:
                    with self._chain_lock:
                        self.chain.process_block(
                            signed, verify_signatures=False, from_rpc=True
                        )
                    self.imported += 1
                    M.SYNC_BLOCKS_IMPORTED.inc()
                    break
                except AvailabilityPendingError:
                    # deneb: pull the committed blobs from the same peer,
                    # then retry the import once
                    if blobs_fetched or not self._fetch_blobs(peer, signed):
                        raise BatchInvalid(
                            "availability", f"slot {int(signed.message.slot)}"
                        ) from None
                    blobs_fetched = True
                except BlockError as e:
                    if "already known" in str(e):
                        break  # gossip raced us; fine
                    raise BatchInvalid("import-rejected", str(e)) from None

    def _fetch_blobs(self, peer: SyncPeer, signed) -> bool:
        if peer.fetch_blobs is None:
            return False
        try:
            return bool(peer.fetch_blobs(signed))
        except Exception:  # noqa: BLE001
            return False

    def _penalize(self, peer: SyncPeer, amount: float, reason: str) -> None:
        if self.peer_manager is not None:
            self.peer_manager.on_behaviour_penalty(peer.peer_id, amount, reason)

    def _stall(self, why: str) -> None:
        # state/pending are _lock-guarded; _stall is called off the tick
        # thread while add_peer may be re-arming from a connection thread.
        with self._lock:
            self.state = SyncState.STALLED
            n_pending = len(self.pending)
        M.SYNC_STALLS.inc()
        log.warning("sync stalled: %s (pending=%d)", why, n_pending)


class BackfillSync:
    """Backward history fill from a checkpoint anchor (backfill_sync/):
    verifies parent-root linkage block-by-block going DOWN to genesis."""

    def __init__(self, anchor_block, store, fork_cls):
        self.expected_root = bytes(anchor_block.message.parent_root)
        self.earliest_slot = int(anchor_block.message.slot)
        self.store = store
        self.fork_cls = fork_cls
        self.complete = False

    def on_block(self, signed) -> bool:
        """Feed blocks newest-to-oldest; False = linkage violation."""
        root = signed.message.root()
        if root != self.expected_root:
            return False
        self.store.put_block(root, signed)
        self.earliest_slot = int(signed.message.slot)
        self.expected_root = bytes(signed.message.parent_root)
        if self.earliest_slot == 0 or self.expected_root == bytes(32):
            self.complete = True
        return True


def serve_blocks_by_range(chain, fork: str):
    """Build a BlocksByRange responder over a chain's store (the server
    half of rpc_methods.rs), emitting encoded response chunks."""

    def serve(start_slot: int, count: int) -> list[bytes]:
        out = []
        # walk the canonical chain via states (block roots by slot); on
        # empty slots block_roots repeats the previous root — the slot
        # equality guard keeps a block from being served twice
        head = chain.head_state()
        for slot in range(start_slot, start_slot + count):
            if slot > int(head.slot):
                break
            root = bytes(
                head.block_roots[slot % chain.preset.slots_per_historical_root]
            ) if slot < int(head.slot) else chain.head_root
            blk = chain.store.get_block(
                root, chain.types.SignedBeaconBlock_BY_FORK[fork]
            )
            if blk is not None and int(blk.message.slot) == slot:
                out.append(
                    rpc.encode_response_chunk(rpc.SUCCESS, blk.encode())
                )
        return out

    return serve
