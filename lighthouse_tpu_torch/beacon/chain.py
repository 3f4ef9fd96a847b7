"""BeaconChain: the chain engine wiring store, fork choice, transitions,
batching, and caches.

Twin of beacon_node/beacon_chain/src/beacon_chain.rs (`BeaconChain` struct
:363-486) with its verification pipelines condensed to the implemented
scope: `process_block` runs the gossip→signature→transition→import ladder
of block_verification.rs:20-44 in one call (each rung still distinct
internally), `process_attestation` the attestation_verification ladder,
`produce_block` the op-pool packing path.  Caches: committee shufflings
per epoch (shuffling_cache), decompressed validator pubkeys
(validator_pubkey_cache.rs:9-16 — the device marshaling input), recent
states (snapshot_cache), observed-gossip dedup sets.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..consensus import committees as cm
from ..consensus import spec as S
from ..consensus.containers import types_for
from ..consensus.fork_choice import ForkChoice
from ..consensus.fork_choice.proto_array import Block as FcBlock
from ..consensus.state_processing import signature_sets as sets
from ..consensus.state_processing.block_signature_verifier import (
    BlockSignatureVerifier,
)
from ..consensus.state_processing.per_block import (
    BlockProcessingError,
    process_block as st_process_block,
)
from ..consensus.state_processing.forks import state_fork_name
from ..consensus.state_processing.per_slot import process_slots
from ..crypto.bls import api as bls
from ..obs.tracer import TRACER
from ..store import HotColdDB
from ..utils import Counter, get_logger, log_with
from ..utils import metrics as M
from ..utils.metrics import BLOCK_IMPORT_LATENCY

BLOCKS_IMPORTED = Counter("beacon_blocks_imported_total", "Blocks imported")
ATTS_PROCESSED = Counter("beacon_attestations_processed_total", "Attestations")

import logging


class ChainError(Exception):
    pass


class BlockError(ChainError):
    pass


class AvailabilityPendingError(BlockError):
    """A deneb block whose committed blobs have not all arrived/verified —
    the caller parks it (reprocess queue) instead of rejecting it
    (data_availability_checker.rs Availability::MissingComponents)."""

    def __init__(self, block_root: bytes, missing: list[int]):
        super().__init__(
            f"block {block_root.hex()[:8]} awaiting blobs {missing}"
        )
        self.block_root = block_root
        self.missing = missing


@dataclass
class ChainConfig:
    state_cache_size: int = 8
    committee_cache_size: int = 4


@dataclass
class GossipVerifiedBlock:
    """Rung 1 of the type-state ladder (block_verification.rs:20-44):
    structurally valid, parent state advanced to the block's slot."""

    signed_block: object
    block_root: bytes
    state: object
    epoch: int
    cache: object
    proposal_verified: bool = False


@dataclass
class SignatureVerifiedBlock:
    """Rung 2: every signature of the block verified in one bulk batch."""

    gossip: GossipVerifiedBlock


class ValidatorPubkeyCache:
    """Index -> decompressed PublicKey (validator_pubkey_cache.rs:9-16).
    This is the marshaling table the device backend consumes; grows
    monotonically with the registry.

    Decompression is lazy: ``update`` records the raw compressed bytes
    (cheap), and the expensive BLS decompression happens on first ``get``
    of each index.  A registry padded with inactive synthetic validators
    (cheap-node scenarios) never pays for keys nobody looks up, and one
    cache instance can safely be shared across every node of an in-process
    simulation (the registry prefix is identical chain-wide)."""

    def __init__(self):
        self._raw: list[bytes] = []
        self._keys: dict[int, bls.PublicKey | None] = {}

    def update(self, state) -> None:
        vs = state.validators
        for i in range(len(self._raw), len(vs)):
            self._raw.append(bytes(vs[i].pubkey))

    def get(self, index: int) -> bls.PublicKey | None:
        if not 0 <= index < len(self._raw):
            return None
        if index in self._keys:
            return self._keys[index]
        try:
            key = bls.PublicKey.from_bytes(self._raw[index])
        except Exception:
            key = None
        self._keys[index] = key
        return key

    def __len__(self):
        return len(self._raw)


class BeaconChain:
    def __init__(self, spec: S.ChainSpec, genesis_state, store: HotColdDB | None,
                 slot_clock=None, fork: str = "base", execution=None,
                 committee_caches: dict | None = None,
                 pubkey_cache: ValidatorPubkeyCache | None = None):
        self.spec = spec
        self.preset = spec.preset
        self.types = types_for(spec.preset)
        self.fork_name = fork
        # execution-layer boundary (None = pre-merge chain / no EL wired);
        # anything with new_payload()/build_payload() — EngineApiClient or
        # MockExecutionEngine (execution.py)
        self.execution = execution
        # external builder (None = local-only production): a
        # BuilderHttpClient; produce_unsigned_block then runs the
        # builder-vs-local payload-source selection (builder.py,
        # execution_layer/src/lib.rs determine_and_fetch_payload)
        self.builder = None
        self.builder_boost_factor: int | None = None
        # eth1 ingestion service (None = no deposit/vote source wired):
        # an Eth1Service, normally fed by an Eth1PollingService over the
        # EL's eth_ namespace; production then packs its eth1-data vote
        self.eth1 = None
        # attestation simulator (attestation_simulator.rs; wired by the
        # node's slot timer — None = off)
        self.attestation_simulator = None
        # deneb data availability (beacon_chain.rs:486 data_availability_checker)
        from .blobs import DataAvailabilityChecker

        self.da_checker = DataAvailabilityChecker(
            setup=getattr(execution, "kzg_setup", None)
        )
        # sync-committee aggregation (the sync half of naive_aggregation_pool)
        from .sync_committee import SyncContributionPool

        self.sync_pool = SyncContributionPool(spec)
        # BN-side aggregation of gossip singles (naive_aggregation_pool.rs)
        from .naive_pool import NaiveAggregationPool

        self.naive_pool = NaiveAggregationPool()
        # observable chain milestones (events.rs SSE hub)
        from .events import EventBroadcaster

        self.events = EventBroadcaster()
        # per-validator performance + block latency attribution
        # (validator_monitor.rs, block_times_cache.rs)
        from .validator_monitor import BlockTimesCache, ValidatorMonitor

        self.validator_monitor = ValidatorMonitor()
        self.block_times = BlockTimesCache()
        self.store = store or HotColdDB(types_family=self.types)
        self.log = get_logger("beacon_chain")
        self.slot_clock = slot_clock
        from .op_pool import OperationPool

        self.op_pool = OperationPool()

        genesis_state = genesis_state.copy()
        genesis_state_root = genesis_state.root()
        # Anchor root: the latest header with its state_root filled — the
        # same value per-slot processing will fill in, and the canonical
        # "genesis block root" identity (header.root == block.root once
        # state_root is set).
        anchor_header = genesis_state.latest_block_header.copy()
        if bytes(anchor_header.state_root) == bytes(32):
            anchor_header.state_root = genesis_state_root
        genesis_root = anchor_header.root()
        self.genesis_block_root = genesis_root
        self.store.put_state(genesis_state_root, genesis_state)
        self.fork_choice = ForkChoice(
            spec,
            FcBlock(
                slot=int(genesis_state.slot),
                root=genesis_root,
                parent_root=None,
                state_root=genesis_state_root,
                justified_epoch=0,
                finalized_epoch=0,
            ),
        )
        self.head_root = genesis_root
        self._states: dict[bytes, object] = {genesis_root: genesis_state}
        # keyed by (state identity, epoch) — identical across every chain
        # following the same history, so the multi-node simulator passes
        # ONE shared dict to all its nodes (shuffling is the dominant
        # per-node setup cost; sharing makes dozens of nodes cheap)
        self._committee_caches: dict[tuple[bytes, int], cm.CommitteeCache] = (
            committee_caches if committee_caches is not None else {}
        )
        self.pubkey_cache = (
            pubkey_cache if pubkey_cache is not None else ValidatorPubkeyCache()
        )
        self.pubkey_cache.update(genesis_state)
        # observed-gossip dedup (observed_attesters / observed_block_producers)
        self._observed_blocks: set[bytes] = set()
        self._observed_attestations: set[bytes] = set()

    # -------------------------------------------------------------- helpers

    def head_state(self):
        return self._states[self.head_root]

    def state_for_block(self, block_root: bytes):
        return self._states.get(block_root)

    def attestation_data_for(self, slot: int, committee_index: int):
        """The canonical head/target/source attestation template for
        ``slot`` from this chain's current view — THE one derivation
        shared by the `/eth/v1/validator/attestation_data` endpoint and
        the attestation simulator (a drifted copy would turn the
        simulator's hit/miss metrics into false signals)."""
        from ..consensus.containers import AttestationData, Checkpoint

        state = self.head_state()
        preset = self.preset
        epoch = slot // preset.slots_per_epoch
        target_slot = epoch * preset.slots_per_epoch
        if int(state.slot) > target_slot:
            target_root = bytes(
                state.block_roots[
                    target_slot % preset.slots_per_historical_root
                ]
            )
        else:
            target_root = self.head_root
        return AttestationData(
            slot=slot,
            index=committee_index,
            beacon_block_root=self.head_root,
            source=state.current_justified_checkpoint,
            target=Checkpoint(epoch=epoch, root=target_root),
        )

    def committee_cache(self, state, epoch: int) -> cm.CommitteeCache:
        key = (bytes(state.genesis_validators_root), epoch)
        # seed depends only on (epoch, randao history): cache per epoch; a
        # reorg across the seed's mix slot invalidates via state identity
        ck = (state.root() if epoch > 1 else key[0], epoch)
        if ck not in self._committee_caches:
            self._committee_caches[ck] = cm.CommitteeCache(state, epoch, self.preset)
            if len(self._committee_caches) > 16:
                self._committee_caches.pop(next(iter(self._committee_caches)))
        return self._committee_caches[ck]

    def get_pubkey(self, index: int):
        return self.pubkey_cache.get(index)

    # -------------------------------------------------------- block import

    def process_block(self, signed_block, verify_signatures: bool = True,
                      from_rpc: bool = False) -> bytes:
        """The full ladder (block_verification.rs:20-44) as a composition
        of the STAGE methods below — SignedBeaconBlock →
        gossip_verify_block → signature_verify_block →
        import_verified_block — so the scheduler (beacon/processor.py) can
        also run the rungs as separate pipeline stages.  Returns the block
        root.  ``from_rpc``: sync/RPC imports skip the gossip-tier clock
        check (the reference's gossip vs rpc block entry distinction)."""
        with BLOCK_IMPORT_LATENCY.timer(), TRACER.span(
                "block.import", slot=int(signed_block.message.slot)):
            # proposal signature rides the bulk batch (one device call for
            # the whole block) rather than the gossip tier's single verify
            gvb = self.gossip_verify_block(
                signed_block, from_rpc=from_rpc, verify_proposal=False
            )
            if verify_signatures:
                svb = self.signature_verify_block(gvb, include_proposal=True)
            else:
                svb = SignatureVerifiedBlock(gossip=gvb)
            return self.import_verified_block(svb)

    # --- the type-state rungs (block_verification.rs:20-44) ---------------

    def gossip_verify_block(self, signed_block, from_rpc: bool = False,
                            verify_proposal: bool = True):
        """Rung 1 — GossipVerifiedBlock: dedup, parent known, clock bound,
        parent state advanced, and (in true gossip use) the proposer's
        signature over the block root."""
        block = signed_block.message
        block_root = block.root()
        self.block_times.observe(block_root, int(block.slot))
        if block_root in self._observed_blocks:
            raise BlockError("block already known")
        parent_state = self._states.get(bytes(block.parent_root))
        if parent_state is None:
            raise BlockError(f"unknown parent {bytes(block.parent_root).hex()}")
        if self.slot_clock is not None and not from_rpc:
            if block.slot > self.slot_clock.current_slot() + 1:
                raise BlockError("block from the future")
        state = parent_state.copy()
        state = process_slots(state, block.slot, self.spec)
        epoch = block.slot // self.preset.slots_per_epoch
        cache = self.committee_cache(state, epoch)
        if verify_proposal:
            self.pubkey_cache.update(state)
            try:
                s = sets.block_proposal_signature_set(
                    state, self.get_pubkey, signed_block, self.preset,
                    block_root=block_root,
                )
                ok = s.verify()
            except sets.SignatureSetError as e:
                raise BlockError(f"proposer signature undecodable: {e}") from None
            if not ok:
                raise BlockError("proposer signature invalid")
        return GossipVerifiedBlock(
            signed_block=signed_block,
            block_root=block_root,
            state=state,
            epoch=epoch,
            cache=cache,
            proposal_verified=verify_proposal,
        )

    def signature_verify_block(self, gvb: "GossipVerifiedBlock",
                               include_proposal: bool | None = None):
        """Rung 2 — SignatureVerifiedBlock: every remaining signature of
        the block in ONE bulk batch (block_signature_verifier.rs
        verify_entire_block; the TPU batch path)."""
        signed_block = gvb.signed_block
        block = signed_block.message
        state = gvb.state
        if include_proposal is None:
            include_proposal = not gvb.proposal_verified
        self.pubkey_cache.update(state)
        verifier = BlockSignatureVerifier(state, self.get_pubkey, self.spec)
        sync_parts = None
        prev_root = None
        if hasattr(block.body, "sync_aggregate"):
            from .sync_committee import sync_committee_indices

            idxs = sync_committee_indices(state)
            sync_parts = [
                vi
                for bit, vi in zip(
                    block.body.sync_aggregate.sync_committee_bits, idxs
                )
                if bit
            ]
            prev_root = bytes(
                state.block_roots[
                    (block.slot - 1) % self.preset.slots_per_historical_root
                ]
            )
        cache_for = (
            lambda e: gvb.cache if e == gvb.epoch
            else self.committee_cache(state, e)
        )
        if include_proposal:
            verifier.include_all(
                signed_block, cache_for,
                sync_participants=sync_parts, block_root_at_prev=prev_root,
            )
        else:
            verifier.include_randao_reveal(block)
            verifier.include_proposer_slashings(block)
            verifier.include_attester_slashings(block)
            verifier.include_attestations(block, cache_for)
            verifier.include_exits(block)
            if sync_parts is not None:
                verifier.include_sync_aggregate(
                    block, sync_parts, prev_root or bytes(32)
                )
            verifier.include_bls_to_execution_changes(block)
        if not verifier.verify():
            raise BlockError("block signature verification failed")
        return SignatureVerifiedBlock(gossip=gvb)

    def collect_segment_signature_sets(self, blocks) -> list:
        """The collection half of signature_verify_chain_segment
        (block_verification.rs:572): walk a parent-linked run of blocks
        from its anchor state, advancing a throwaway copy block by block,
        and gather EVERY signature set of every block into one list — the
        caller verifies them in a single bulk device pass and only then
        imports the segment.

        Blocks already imported are skipped (gossip may race an RPC
        batch).  Raises :class:`BlockError` when the segment does not
        anchor to a state we hold or a block fails the (signature-free)
        state transition — either way the segment is not importable.
        """
        blocks = [
            b for b in blocks if b.message.root() not in self._observed_blocks
        ]
        if not blocks:
            return []
        parent_state = self._states.get(bytes(blocks[0].message.parent_root))
        if parent_state is None:
            raise BlockError(
                "segment anchor unknown: parent "
                f"{bytes(blocks[0].message.parent_root).hex()}"
            )
        state = parent_state.copy()
        all_sets: list = []
        for signed in blocks:
            block = signed.message
            state = process_slots(state, block.slot, self.spec)
            epoch = int(block.slot) // self.preset.slots_per_epoch
            cache = self.committee_cache(state, epoch)
            self.pubkey_cache.update(state)
            verifier = BlockSignatureVerifier(state, self.get_pubkey, self.spec)
            sync_parts = None
            prev_root = None
            if hasattr(block.body, "sync_aggregate"):
                from .sync_committee import sync_committee_indices

                idxs = sync_committee_indices(state)
                sync_parts = [
                    vi
                    for bit, vi in zip(
                        block.body.sync_aggregate.sync_committee_bits, idxs
                    )
                    if bit
                ]
                prev_root = bytes(
                    state.block_roots[
                        (block.slot - 1) % self.preset.slots_per_historical_root
                    ]
                )
            cache_for = (
                lambda e, _c=cache, _e=epoch, _s=state: _c if e == _e
                else self.committee_cache(_s, e)
            )
            try:
                verifier.include_all(
                    signed, cache_for,
                    sync_participants=sync_parts, block_root_at_prev=prev_root,
                )
            except sets.SignatureSetError as e:
                raise BlockError(f"segment signatures undecodable: {e}") from None
            all_sets.extend(verifier.sets)
            try:
                st_process_block(
                    state, signed, self.spec, committee_cache=cache,
                    verify_signatures=False, get_pubkey=self.get_pubkey,
                )
            except BlockProcessingError as e:
                raise BlockError(
                    f"state transition rejected segment block: {e}"
                ) from None
        return all_sets

    def import_verified_block(self, svb: "SignatureVerifiedBlock") -> bytes:
        """Rung 3+4 — ExecutionPending → import: state transition, EL
        verdict, data availability, fork choice, store, caches, events."""
        gvb = svb.gossip
        signed_block = gvb.signed_block
        block = signed_block.message
        block_root = gvb.block_root
        state = gvb.state
        cache = gvb.cache
        try:
            st_process_block(
                state,
                signed_block,
                self.spec,
                committee_cache=cache,
                verify_signatures=False,
                get_pubkey=self.get_pubkey,
            )
        except BlockProcessingError as e:
            raise BlockError(f"state transition rejected block: {e}") from None
        # --- execution-layer gate (ExecutionPendingBlock rung) -------------
        payload = getattr(block.body, "execution_payload", None)
        if payload is not None and self.execution is not None:
            from ..consensus.state_processing.per_block import _default_root
            from .execution import PayloadStatus, notify_new_payload

            if payload.root() != _default_root(type(payload)):
                status = notify_new_payload(self.execution, payload)
                if status == PayloadStatus.INVALID:
                    raise BlockError("execution engine rejected payload")
                # SYNCING/ACCEPTED: optimistic import, same as the
                # reference's optimistic-sync path
        # --- data availability gate (deneb) --------------------------------
        commitments = list(getattr(block.body, "blob_kzg_commitments", []))
        if commitments:
            missing = self.da_checker.missing_indices(block_root, commitments)
            if missing:
                raise AvailabilityPendingError(block_root, missing)
            if not self.da_checker.verify_batch(block_root, commitments):
                raise BlockError("blob kzg batch verification failed")
            for sc in self.da_checker.get(block_root):
                self.store.put_blob(block_root, int(sc.index), sc)
        # --- import: fork choice + store + caches --------------------------
        jc = state.current_justified_checkpoint
        fc = state.finalized_checkpoint
        is_timely = True
        if self.slot_clock is not None:
            into = self.slot_clock.seconds_into_slot()
            is_timely = (
                self.slot_clock.current_slot() == block.slot
                and into < self.spec.seconds_per_slot / 3
            )
        finalized_before = self.fork_choice.finalized_checkpoint
        self.fork_choice.on_block(
            FcBlock(
                slot=int(block.slot),
                root=block_root,
                parent_root=bytes(block.parent_root),
                state_root=bytes(block.state_root),
                justified_epoch=int(jc.epoch),
                finalized_epoch=int(fc.epoch),
            ),
            justified_checkpoint=(int(jc.epoch), bytes(jc.root)),
            finalized_checkpoint=(int(fc.epoch), bytes(fc.root)),
            is_timely_proposal=is_timely,
        )
        self.store.put_block(block_root, signed_block)
        self.store.put_state(state.root(), state)
        # durability point: a block counts as imported only once its
        # records are fsync'd — a SIGKILL after this line cannot lose the
        # head (MemoryStore flush is a no-op, SlabStore is a real fsync)
        self.store.flush()
        self._states[block_root] = state
        self._observed_blocks.add(block_root)
        self.pubkey_cache.update(state)
        BLOCKS_IMPORTED.inc()
        self.block_times.imported(block_root, int(block.slot))
        if self.validator_monitor.validators or self.validator_monitor.auto_register:
            self.validator_monitor.process_block(
                block,
                lambda e: self.committee_cache(state, e),
                self.preset,
            )
            if hasattr(block.body, "sync_aggregate"):
                from .sync_committee import sync_committee_indices

                self.validator_monitor.process_sync_aggregate(
                    block.body.sync_aggregate, sync_committee_indices(state)
                )
        if self.attestation_simulator is not None:
            self.attestation_simulator.on_block(block)
        self.events.emit(
            "block",
            {
                "slot": str(int(block.slot)),
                "block": "0x" + block_root.hex(),
                "execution_optimistic": False,
            },
        )
        finalized_now = self.fork_choice.finalized_checkpoint
        if finalized_now != finalized_before and finalized_now[0] > 0:
            self.events.emit(
                "finalized_checkpoint",
                {
                    "epoch": str(int(finalized_now[0])),
                    "block": "0x" + bytes(finalized_now[1]).hex(),
                    "state": "0x" + state.root().hex(),
                },
            )
        log_with(
            self.log, logging.DEBUG, "Block imported",
            slot=int(block.slot), root=block_root.hex()[:8],
        )
        self.recompute_head()
        return block_root

    # ------------------------------------------------------- attestations

    def process_attestation(self, attestation, current_slot: int | None = None):
        """Gossip attestation ladder (attestation_verification.rs ladder +
        fork_choice.on_attestation)."""
        data = attestation.data
        att_key = data.root() + bytes(
            bytearray(
                b"".join(
                    bytes([b])
                    for b in np.packbits(
                        np.array(attestation.aggregation_bits, dtype=bool)
                    )
                )
            )
        )
        if att_key in self._observed_attestations:
            return  # dedup (observed_attesters)
        target_root = bytes(data.beacon_block_root)
        if not self.fork_choice.contains_block(target_root):
            raise ChainError("attestation references unknown block")
        state = self._states.get(target_root) or self.head_state()
        cache = self.committee_cache(
            state, int(data.slot) // self.preset.slots_per_epoch
        )
        committee = cache.committee(int(data.slot), int(data.index))
        indexed = cm.get_indexed_attestation(committee, attestation)
        s = sets.indexed_attestation_signature_set(
            state, self.get_pubkey, indexed, self.preset
        )
        if not s.verify():
            raise ChainError("attestation signature invalid")
        cur = (
            current_slot
            if current_slot is not None
            else (self.slot_clock.current_slot() if self.slot_clock else None)
        )
        for vi in indexed.attesting_indices:
            self.fork_choice.process_attestation(
                int(vi), target_root, int(data.target.epoch), cur
            )
        self._observed_attestations.add(att_key)
        self.op_pool.insert_attestation(attestation)
        if self.validator_monitor.validators or self.validator_monitor.auto_register:
            self.validator_monitor.register_gossip_attestation(
                indexed, int(data.target.epoch)
            )
        ATTS_PROCESSED.inc()
        self.events.emit(
            "attestation",
            {
                "slot": str(int(data.slot)),
                "index": str(int(data.index)),
                "beacon_block_root": "0x" + bytes(data.beacon_block_root).hex(),
            },
        )

    # ------------------------------------------------------------- blobs

    def process_blob_sidecar(self, sidecar) -> bytes:
        """Gossip blob ladder (blob_verification.rs GossipVerifiedBlob):
        verify then record in the availability checker.  Returns the block
        root the sidecar belongs to."""
        from .blobs import verify_blob_sidecar_for_gossip

        state = self.head_state()
        verify_blob_sidecar_for_gossip(
            sidecar,
            self.spec,
            self.get_pubkey,
            state.fork,
            bytes(state.genesis_validators_root),
            setup=self.da_checker.setup,
        )
        return self.da_checker.put_sidecar(sidecar)

    def process_unaggregated_attestation(
        self, attestation, subnet_id: int | None = None,
        current_slot: int | None = None,
    ):
        """Gossip single-attestation ladder (attestation_verification.rs
        unaggregated path): exactly one bit, correct subnet, committee
        membership, signature — then fork choice + the naive pool so the
        node can pack its OWN aggregates at production."""
        data = attestation.data
        bits = [bool(b) for b in attestation.aggregation_bits]
        if sum(bits) != 1:
            raise ChainError("unaggregated attestation must set exactly one bit")
        target_root = bytes(data.beacon_block_root)
        if not self.fork_choice.contains_block(target_root):
            raise ChainError("attestation references unknown block")
        state = self._states.get(target_root) or self.head_state()
        cache = self.committee_cache(
            state, int(data.slot) // self.preset.slots_per_epoch
        )
        if subnet_id is not None:
            from ..network.topics import compute_subnet_for_attestation

            expected = compute_subnet_for_attestation(
                self.spec, int(data.slot), int(data.index),
                cache.committees_per_slot,
            )
            if expected != subnet_id:
                raise ChainError(
                    f"attestation on subnet {subnet_id}, expected {expected}"
                )
        committee = cache.committee(int(data.slot), int(data.index))
        indexed = cm.get_indexed_attestation(committee, attestation)
        s = sets.indexed_attestation_signature_set(
            state, self.get_pubkey, indexed, self.preset
        )
        if not s.verify():
            raise ChainError("attestation signature invalid")
        cur = (
            current_slot
            if current_slot is not None
            else (self.slot_clock.current_slot() if self.slot_clock else None)
        )
        for vi in indexed.attesting_indices:
            self.fork_choice.process_attestation(
                int(vi), target_root, int(data.target.epoch), cur
            )
        self.naive_pool.insert(attestation)
        if self.validator_monitor.validators or self.validator_monitor.auto_register:
            self.validator_monitor.register_gossip_attestation(
                indexed, int(data.target.epoch)
            )
        ATTS_PROCESSED.inc()

    # ----------------------------------------------------- sync committee

    def process_sync_committee_message(self, msg, subnet_id: int) -> None:
        """Gossip sync message ladder (sync_committee_verification.rs:290)
        then into the aggregation pool."""
        from .sync_committee import verify_sync_committee_message

        verify_sync_committee_message(self, msg, subnet_id)
        self.sync_pool.insert_message(msg, self.head_state())

    def process_sync_contribution(self, signed) -> None:
        """Gossip contribution ladder (:617 — the 3-set batch) then pool."""
        from .sync_committee import verify_sync_contribution

        verify_sync_contribution(self, signed)
        self.sync_pool.insert_contribution(signed.message.contribution)

    def blobs_bundle_for(self, block_hash: bytes):
        """(commitments, proofs, blobs) the EL bundled with a produced
        payload (engine_getPayload's BlobsBundle), or None."""
        if self.execution is None:
            return None
        getter = getattr(self.execution, "get_blobs_bundle", None)
        return getter(block_hash) if getter is not None else None

    # --------------------------------------------------------------- head

    def recompute_head(self) -> bytes:
        """canonical_head.rs:477 recompute_head: fork choice get_head over
        the registry's effective balances."""
        state = self._states.get(self.head_root) or self.head_state()
        balances = np.fromiter(
            (v.effective_balance for v in state.validators),
            np.int64,
            len(state.validators),
        )
        old = self.head_root
        self.head_root = self.fork_choice.get_head(
            balances,
            self.slot_clock.current_slot() if self.slot_clock else None,
        )
        if self.head_root != old:
            self.block_times.set_head(self.head_root)
            head_state = self._states.get(self.head_root)
            self.events.emit(
                "head",
                {
                    "slot": str(int(head_state.slot)) if head_state else "0",
                    "block": "0x" + bytes(self.head_root).hex(),
                    "state": "0x" + (head_state.root().hex() if head_state else "00" * 32),
                    "epoch_transition": False,
                },
            )
        return self.head_root

    # ------------------------------------------------------- production

    def _advance_for_production(self, slot: int):
        """Copy the head state and run slot processing up to ``slot`` —
        the (expensive) shared prologue of both production entrypoints."""
        state = self.head_state().copy()
        return process_slots(state, slot, self.spec)

    def produce_unsigned_block(
        self, slot: int, randao_reveal: bytes, graffiti: bytes = b"",
        advanced_state=None,
    ):
        """Server-side half of block production (produce_block.rs:1 — the
        BN packs the block; the VC supplies only the randao reveal and
        signs the result).  This is the body behind the
        `/eth/v3/validator/blocks/{slot}` endpoint: advance head state,
        max-cover-pack the op pool, attach sync aggregate / payload /
        blobs, and fill state_root by running the transition.  Returns
        (unsigned block, fork_name).  ``advanced_state`` lets a caller
        that already paid the slot advance (produce_block) hand it in."""
        parent_root = self.head_root
        state = (
            advanced_state
            if advanced_state is not None
            else self._advance_for_production(slot)
        )
        # dynamic fork: the post-advance state is the fork witness, so a
        # proposal straddling a fork boundary uses the NEW fork's containers
        fork_now = state_fork_name(state)
        proposer = cm.get_beacon_proposer_index(state, slot, self.preset)
        # drain the naive pool: aggregates the node built from gossip
        # singles compete in max-cover packing alongside delivered ones
        for agg in self.naive_pool.get_aggregates():
            self.op_pool.insert_attestation(agg)
        atts = self.op_pool.get_attestations_for_block(state, self.preset)
        ps, asl, exits = self.op_pool.get_slashings_and_exits(
            state, self.preset, spec=self.spec
        )
        body_cls = self.types.BeaconBlockBody_BY_FORK[fork_now]
        body_kwargs = dict(
            randao_reveal=randao_reveal,
            graffiti=graffiti.ljust(32, b"\x00")[:32],
            attestations=atts,
            proposer_slashings=ps,
            attester_slashings=asl,
            voluntary_exits=exits,
        )
        if self.eth1 is not None:
            vote = self.eth1.eth1_data_for_vote(state)
            body_kwargs["eth1_data"] = vote
            # once the voting period adopts a vote advancing deposit_count,
            # every block MUST carry the pending deposits (per_block.py
            # expected_deposits check) — and process_eth1_data may adopt
            # THIS block's own vote before that check runs, so compute the
            # post-vote eth1_data exactly as the transition will
            period_slots = (
                self.preset.epochs_per_eth1_voting_period
                * self.preset.slots_per_epoch
            )
            n_votes = sum(
                1 for v in state.eth1_data_votes if v == vote
            ) + 1  # + this block's
            effective = (
                vote if n_votes * 2 > period_slots else state.eth1_data
            )
            backlog = int(effective.deposit_count) - int(
                state.eth1_deposit_index
            )
            M.DEPOSIT_QUEUE_DEPTH.set(max(0, backlog))
            need = min(self.preset.max_deposits, backlog)
            if need > 0:
                body_kwargs["deposits"] = (
                    self.eth1.deposit_cache.deposits_for_block(
                        int(state.eth1_deposit_index),
                        need,
                        deposit_count=int(effective.deposit_count),
                    )
                )
        if "sync_aggregate" in body_cls._fields:
            # pack the pool's contributions for the parent root (participants
            # signed the PREVIOUS slot's head — altair/sync_committee.rs)
            body_kwargs["sync_aggregate"] = self.sync_pool.get_sync_aggregate(
                slot - 1, bytes(parent_root), self.types
            )
        if "execution_payload" in body_cls._fields and self.execution is not None:
            payload_cls = body_cls._fields["execution_payload"].cls
            payload = self._select_execution_payload(
                state, slot, proposer, fork_now, payload_cls
            )
            body_kwargs["execution_payload"] = payload
            if "blob_kzg_commitments" in body_cls._fields:
                bundle = self.blobs_bundle_for(bytes(payload.block_hash))
                if bundle is not None:
                    body_kwargs["blob_kzg_commitments"] = list(bundle[0])
        body = body_cls(**body_kwargs)
        block_cls = self.types.BeaconBlock_BY_FORK[fork_now]
        block = block_cls(
            slot=slot,
            proposer_index=proposer,
            parent_root=parent_root,
            state_root=bytes(32),
            body=body,
        )
        # fill state_root by running the transition (produce_block.rs does
        # the same complete-state dance)
        trial = self.types.SignedBeaconBlock_BY_FORK[fork_now](
            message=block, signature=b"\x00" * 96
        )
        st_process_block(
            state, trial, self.spec, verify_signatures=False,
            get_pubkey=self.get_pubkey,
        )
        block.state_root = state.root()
        return block, fork_now

    def _select_execution_payload(
        self, state, slot: int, proposer: int, fork_now: str, payload_cls
    ):
        """Payload-source selection for production (builder.py /
        execution_layer/src/lib.rs determine_and_fetch_payload): builder
        bid vs local EL by profit, with bid verification and local
        fallback on every builder failure mode.  No builder wired =
        local-only (the common path)."""
        local_holder: dict = {}

        def local_fn():
            if hasattr(self.execution, "build_payload_with_value"):
                out = self.execution.build_payload_with_value(
                    state, self.spec, payload_cls
                )
            else:
                out = (
                    self.execution.build_payload(
                        state, self.spec, payload_cls
                    ),
                    0,
                )
            local_holder["payload"] = out[0]
            return out

        if self.builder is None:
            payload, _ = local_fn()
            return payload
        from . import builder as B

        parent_hash = bytes(state.latest_execution_payload_header.block_hash)
        proposer_pk = self.get_pubkey(proposer)
        bid_holder: dict = {}

        def relay_fn():
            out = self.builder.get_header(
                slot, parent_hash, proposer_pk.to_bytes()
            )
            if out is None:
                return None
            bid_fork, bid_json = out
            bid_holder["fork"] = bid_fork
            bid_holder["json"] = bid_json
            value = int(bid_json["message"]["value"])

            def reveal():
                from ..network.api import from_json

                header = from_json(
                    self.types.ExecutionPayloadHeader_BY_FORK[bid_fork],
                    bid_json["message"]["header"],
                )
                resp = self.builder.submit(
                    slot, header.root(), b"\x00" * 96
                )
                return from_json(payload_cls, resp["data"])

            return value, reveal

        def verify_fn():
            return B.verify_builder_bid(
                bid_holder["json"],
                bid_holder["fork"],
                self.types,
                self.spec,
                parent_hash,
                getattr(self.builder, "expected_pubkey", None),
                None,
            )

        source, result, value = B.select_payload_source(
            local_fn,
            relay_fn,
            chain_healthy=True,
            boost_factor=self.builder_boost_factor,
            verify_fn=verify_fn,
        )
        if source == "builder":
            try:
                payload = result()  # reveal: relay returns the full payload
            except Exception as exc:  # noqa: BLE001
                # reveal happens pre-signature here (module docstring), so
                # falling back to the already-built local payload is sound
                # — unlike the reference's post-signature blinded flow,
                # where a withheld payload means a missed slot
                if "payload" in local_holder:
                    self.log.warning(
                        "builder reveal failed (%s); using local payload",
                        exc,
                    )
                    return local_holder["payload"]
                raise
            self.log.info(
                "proposing with BUILDER payload (bid %d wei) at slot %d",
                value, slot,
            )
            return payload
        return result

    def produce_block(self, slot: int, keypairs, graffiti: bytes = b""):
        """produce_block.rs condensed for in-process harnesses: sign the
        randao reveal and the packed block with the proposer's key (the
        real VC signs remotely via `/eth/v3/validator/blocks/{slot}`)."""
        state = self._advance_for_production(slot)
        proposer = cm.get_beacon_proposer_index(state, slot, self.preset)
        sk = keypairs[proposer][0]
        epoch = slot // self.preset.slots_per_epoch
        fork, gvr = state.fork, state.genesis_validators_root

        from ..consensus.containers import SigningData
        from ..consensus.ssz import U64

        randao_domain = sets.get_domain(fork, gvr, S.DOMAIN_RANDAO, epoch)
        randao_root = SigningData(
            object_root=U64.hash_tree_root(epoch), domain=randao_domain
        ).root()
        block, fork_now = self.produce_unsigned_block(
            slot, sk.sign(randao_root).to_bytes(), graffiti,
            advanced_state=state,
        )
        block_domain = sets.get_domain(fork, gvr, S.DOMAIN_BEACON_PROPOSER, epoch)
        sig = sk.sign(S.compute_signing_root(block, block_domain))
        return self.types.SignedBeaconBlock_BY_FORK[fork_now](
            message=block, signature=sig.to_bytes()
        )

    # ------------------------------------------------------- maintenance

    def prune(self) -> None:
        """Finalization housekeeping: migrate store to cold + prune pools."""
        fc = self.fork_choice.finalized_checkpoint
        state = self.head_state()
        self.op_pool.prune(state, self.preset)
        if fc[0] > 0:
            fin_slot = fc[0] * self.preset.slots_per_epoch
            self.store.migrate_to_cold(fin_slot, fc[1])
