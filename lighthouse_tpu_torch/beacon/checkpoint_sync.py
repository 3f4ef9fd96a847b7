"""Checkpoint (weak-subjectivity) sync: boot a node from a trusted anchor.

Twin of the reference's ClientGenesis::{WeakSubjSszBytes, CheckpointSyncUrl}
path (beacon_node/client/src/config.rs:21-43 + builder.rs genesis decision):
fetch/accept an anchor (state, block) pair, verify their correspondence,
start the chain from it, and hand history to BackfillSync.
"""

from __future__ import annotations

from .chain import BeaconChain
from .sync import BackfillSync


class CheckpointSyncError(Exception):
    pass


def verify_anchor(anchor_state, anchor_block) -> None:
    """The anchor block must commit to the anchor state (the check the
    reference performs on weak-subjectivity payloads before trusting
    them)."""
    if bytes(anchor_block.message.state_root) != anchor_state.root():
        raise CheckpointSyncError("anchor block state_root != state root")
    if int(anchor_block.message.slot) != int(anchor_state.slot):
        raise CheckpointSyncError("anchor block slot != state slot")


def chain_from_anchor(
    spec, anchor_state, anchor_block, store=None, slot_clock=None,
    fork: str = "altair",
):
    """Build a BeaconChain anchored at a finalized checkpoint instead of
    genesis; returns (chain, backfill) where backfill fills history
    backward (network/src/sync/backfill_sync semantics)."""
    verify_anchor(anchor_state, anchor_block)
    chain = BeaconChain(
        spec, anchor_state, store=store, slot_clock=slot_clock, fork=fork
    )
    # the anchor's own block is known: store it so backfill links below it
    root = anchor_block.message.root()
    chain.store.put_block(root, anchor_block)
    backfill = BackfillSync(
        anchor_block,
        chain.store,
        chain.types.SignedBeaconBlock_BY_FORK[fork],
    )
    return chain, backfill


def fetch_anchor_via_api(client, fork_cls, state_cls):
    """Checkpoint-sync over the Beacon-API (CheckpointSyncUrl): pull the
    FINALIZED block (JSON) and its full state (SSZ over the debug states
    endpoint) — finalized, not head, so the anchor cannot be reorged."""
    from ..network.api import from_json

    blk_json = client.get_block_json("finalized")
    signed = from_json(fork_cls, blk_json["data"])
    raw_state = client.get_state_ssz("finalized")
    state = state_cls.deserialize_value(raw_state)
    try:
        verify_anchor(state, signed)
    except CheckpointSyncError:
        # finalization advanced between the two requests: retryable
        raise CheckpointSyncError("anchor moved mid-fetch; retry") from None
    return state, signed
