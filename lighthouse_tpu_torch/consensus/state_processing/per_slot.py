"""Per-slot processing + the state-transition driver.

Twin of consensus/state_processing/src/{per_slot_processing.rs,lib.rs}:
cache roots into the history vectors each slot, run per-epoch at epoch
boundaries, and `state_transition` = process_slots + verify + process_block.
"""

from __future__ import annotations

from ..spec import ChainSpec
from .per_block import BlockProcessingError, process_block
from .per_epoch import process_epoch


def process_slot(state, spec: ChainSpec) -> None:
    """Cache state/block roots for the CURRENT slot before advancing."""
    preset = spec.preset
    state_root = state.root()
    sr = list(state.state_roots)
    sr[state.slot % preset.slots_per_historical_root] = state_root
    state.state_roots = sr
    if bytes(state.latest_block_header.state_root) == bytes(32):
        state.latest_block_header.state_root = state_root
    br = list(state.block_roots)
    br[state.slot % preset.slots_per_historical_root] = (
        state.latest_block_header.root()
    )
    state.block_roots = br


def process_slots(state, target_slot: int, spec: ChainSpec):
    """per_slot_processing: advance to target_slot, epoch work on
    boundaries, fork upgrades at scheduled epochs.  Returns the state —
    a fork upgrade swaps the container class, so callers must re-bind
    (`state = process_slots(state, ...)`)."""
    from .upgrades import upgrade_state_at_epoch

    if target_slot < state.slot:
        raise BlockProcessingError(
            f"cannot rewind: state at {state.slot}, target {target_slot}"
        )
    preset = spec.preset
    while state.slot < target_slot:
        process_slot(state, spec)
        if (state.slot + 1) % preset.slots_per_epoch == 0:
            process_epoch(state, spec)
        state.slot += 1
        if state.slot % preset.slots_per_epoch == 0:
            state = upgrade_state_at_epoch(
                state, state.slot // preset.slots_per_epoch, spec
            )
    return state


def state_transition(
    state,
    signed_block,
    spec: ChainSpec,
    verify_signatures: bool = True,
    verify_state_root: bool = True,
):
    """The spec's state_transition: slots -> block -> state-root check.
    Returns the post-state (re-bound across fork upgrades)."""
    block = signed_block.message
    state = process_slots(state, block.slot, spec)
    process_block(
        state, signed_block, spec, verify_signatures=verify_signatures
    )
    if verify_state_root and bytes(block.state_root) != state.root():
        raise BlockProcessingError("post-state root mismatch")
    return state
