"""Fork detection + fork-dependent transition parameters.

The reference dispatches fork behavior through superstruct enum variants
(consensus/types/src/beacon_state.rs) and per-fork constant sets
(consensus/types/src/chain_spec.rs: MIN_SLASHING_PENALTY_QUOTIENT_{ALTAIR,
BELLATRIX}, PROPORTIONAL_SLASHING_MULTIPLIER_*, INACTIVITY_PENALTY_QUOTIENT_*).
Here the fork of a state is recovered structurally from the container ladder
(containers.py BY_FORK classes differ in fields), which keeps detection
independent of the runtime fork schedule — a state object is its own fork
witness, exactly like a superstruct variant.
"""

from __future__ import annotations

FORK_ORDER = ("base", "altair", "bellatrix", "capella", "deneb")
_FORK_INDEX = {name: i for i, name in enumerate(FORK_ORDER)}


def state_fork_name(state) -> str:
    """Structural fork detection over the container ladder."""
    if hasattr(state, "previous_epoch_attestations"):
        return "base"
    if not hasattr(state, "latest_execution_payload_header"):
        return "altair"
    if not hasattr(state, "next_withdrawal_index"):
        return "bellatrix"
    if hasattr(state.latest_execution_payload_header, "blob_gas_used"):
        return "deneb"
    return "capella"


def fork_at_least(fork: str, other: str) -> bool:
    return _FORK_INDEX[fork] >= _FORK_INDEX[other]


def min_slashing_penalty_quotient(fork: str, preset) -> int:
    """chain_spec.rs min_slashing_penalty_quotient{,_altair,_bellatrix}:
    128 → 64 → 32 (the penalty doubles at each of the first two forks)."""
    base = preset.min_slashing_penalty_quotient  # phase0 value (128)
    if fork == "base":
        return base
    if fork == "altair":
        return base // 2
    return base // 4  # bellatrix and later


def proportional_slashing_multiplier(fork: str, preset) -> int:
    """chain_spec.rs proportional_slashing_multiplier{,_altair,_bellatrix}:
    1 → 2 → 3."""
    base = preset.proportional_slashing_multiplier  # phase0 value (1)
    if fork == "base":
        return base
    if fork == "altair":
        return base * 2
    return base * 3


def inactivity_penalty_quotient(fork: str, preset) -> int:
    """chain_spec.rs inactivity_penalty_quotient{,_altair,_bellatrix}:
    2^26 → 3·2^24 → 2^24."""
    if fork == "base":
        return preset.inactivity_penalty_quotient  # phase0 value (2^26)
    if fork == "altair":
        return 3 * 2**24
    return 2**24
