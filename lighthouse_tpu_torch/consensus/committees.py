"""Committee computation — the CommitteeCache analog, dense-array first.

Twin of the reference's committee machinery (consensus/types/src/
beacon_state/committee_cache.rs, consumed by get_beacon_committee): one
epoch's full committee assignment is computed in a single vectorized pass
(shuffle the active-validator array once, slice per (slot, index)) and
cached.  The dense layout — one int64 array of shuffled validator indices
plus offset bookkeeping — is deliberately the layout a device kernel
ingests: committee lookup is a gather, aggregation-bit application is a
masked gather, both TPU-native.
"""

from __future__ import annotations

import numpy as np

from ..ops import sha256
from .shuffle import shuffle_list
from .spec import DOMAIN_BEACON_ATTESTER, Preset
from .ssz import CACHE_BUDGET

DOMAIN_BEACON_PROPOSER_SEED = bytes([0, 0, 0, 0])


def is_active_validator(v, epoch: int) -> bool:
    return v.activation_epoch <= epoch < v.exit_epoch


# Active-set scans over frozen registries (the cheap-node path, where every
# mutation rebinds the list so identity implies content).  Level 1 is hit
# by repeated scans of one state; level 2 keys on the shared element
# identities, so every node in a mesh reuses one scan of the same content.
# Callers treat the returned array as read-only (shuffles gather-copy).
_ACTIVE_BY_ID: dict = {}
_ACTIVE_BY_ELEMS: dict = {}


def get_active_validator_indices(state, epoch: int) -> np.ndarray:
    vs = state.validators
    cacheable = (
        len(vs) >= 4096 and vs and vs[0].__dict__.get("_frozen", False)
    )
    if not cacheable:
        return np.array(
            [i for i, v in enumerate(vs) if is_active_validator(v, epoch)],
            dtype=np.int64,
        )
    key = (id(vs), epoch)
    hit = _ACTIVE_BY_ID.get(key)
    if hit is not None and hit[1] is vs:
        return hit[0]
    ekey = (epoch, tuple(map(id, vs)))
    hit2 = _ACTIVE_BY_ELEMS.get(ekey)
    if hit2 is not None:
        arr = hit2[0]
    else:
        arr = np.array(
            [i for i, v in enumerate(vs) if is_active_validator(v, epoch)],
            dtype=np.int64,
        )
        # identity-keyed sharing is only sound if every element is frozen
        # (an unfrozen element could mutate under the same id)
        if all(v.__dict__.get("_frozen") for v in vs):
            CACHE_BUDGET.charge(len(vs) * 16 + arr.nbytes + 96)
            _ACTIVE_BY_ELEMS[ekey] = (arr, list(vs))
            CACHE_BUDGET.trim(
                _ACTIVE_BY_ELEMS,
                lambda k, v: len(k[1]) * 16 + v[0].nbytes + 96,
                4,
            )
        else:
            return arr
    CACHE_BUDGET.charge(len(vs) * 8 + arr.nbytes + 96)
    _ACTIVE_BY_ID[key] = (arr, vs)
    CACHE_BUDGET.trim(
        _ACTIVE_BY_ID, lambda k, v: len(v[1]) * 8 + v[0].nbytes + 96, 8
    )
    return arr


def get_seed(state, epoch: int, domain_type: bytes, preset: Preset) -> bytes:
    """Spec get_seed: randao mix from (epoch + len - lookahead - 1)."""
    mix = state.randao_mixes[
        (epoch + preset.epochs_per_historical_vector - preset.min_seed_lookahead - 1)
        % preset.epochs_per_historical_vector
    ]
    return sha256(domain_type + epoch.to_bytes(8, "little") + bytes(mix))


def committees_per_slot(n_active: int, preset: Preset) -> int:
    return max(
        1,
        min(
            preset.max_committees_per_slot,
            n_active // preset.slots_per_epoch // preset.target_committee_size,
        ),
    )


class CommitteeCache:
    """One epoch's committees: a single shuffled index array + slicing.

    committee_cache.rs computes exactly this shape (shuffling + offsets);
    `committee(slot, index)` is a zero-copy numpy slice of the shuffle.
    """

    def __init__(self, state, epoch: int, preset: Preset):
        self.epoch = epoch
        self.preset = preset
        active = get_active_validator_indices(state, epoch)
        if len(active) == 0:
            raise ValueError(f"no active validators at epoch {epoch}")
        seed = get_seed(state, epoch, DOMAIN_BEACON_ATTESTER, preset)
        self.seed = seed
        self.shuffling = shuffle_list(active, seed, preset.shuffle_round_count)
        self.committees_per_slot = committees_per_slot(len(active), preset)
        self._n = len(active)

    def committee(self, slot: int, index: int) -> np.ndarray:
        """Validator indices of committee ``index`` at ``slot`` (spec
        compute_committee slicing)."""
        cps = self.committees_per_slot
        if index >= cps:
            raise IndexError(f"committee index {index} >= {cps}")
        count = cps * self.preset.slots_per_epoch
        ci = (slot % self.preset.slots_per_epoch) * cps + index
        start = (self._n * ci) // count
        end = (self._n * (ci + 1)) // count
        return self.shuffling[start:end]

    def committees_at_slot(self, slot: int) -> list[np.ndarray]:
        return [self.committee(slot, i) for i in range(self.committees_per_slot)]


def iter_epoch_committees(cache: "CommitteeCache", epoch: int, preset: Preset):
    """Yield (slot, committee_index, committee) for every committee in the
    epoch — the one enumeration both duty computation (validator duties
    service) and the duties API endpoints walk."""
    for slot in range(
        epoch * preset.slots_per_epoch, (epoch + 1) * preset.slots_per_epoch
    ):
        for index in range(cache.committees_per_slot):
            yield slot, index, cache.committee(slot, index)


def get_committee_count_per_slot(state, epoch: int, preset: Preset) -> int:
    return committees_per_slot(len(get_active_validator_indices(state, epoch)), preset)


def get_indexed_attestation(committee: np.ndarray, attestation):
    """Spec get_indexed_attestation: committee members selected by the
    aggregation bits, sorted ascending (types/src/indexed_attestation.rs)."""
    from .containers import IndexedAttestation

    bits = attestation.aggregation_bits
    if len(bits) != len(committee):
        raise ValueError(
            f"aggregation bits {len(bits)} != committee size {len(committee)}"
        )
    indices = sorted(int(committee[i]) for i, b in enumerate(bits) if b)
    return IndexedAttestation(
        attesting_indices=indices,
        data=attestation.data,
        signature=attestation.signature,
    )


def get_beacon_proposer_index(state, slot: int, preset: Preset) -> int:
    """Spec get_beacon_proposer_index: effective-balance-weighted sampling
    over the epoch's active set, seeded per slot."""
    epoch = slot // preset.slots_per_epoch
    seed = sha256(
        get_seed(state, epoch, DOMAIN_BEACON_PROPOSER_SEED, preset)
        + slot.to_bytes(8, "little")
    )
    indices = get_active_validator_indices(state, epoch)
    return compute_proposer_index(state, indices, seed, preset)


def compute_proposer_index(
    state, indices: np.ndarray, seed: bytes, preset: Preset
) -> int:
    from .shuffle import compute_shuffled_index

    MAX_RANDOM_BYTE = 2**8 - 1
    max_eb = 32_000_000_000
    i = 0
    total = len(indices)
    while True:
        shuffled = compute_shuffled_index(
            i % total, total, seed, preset.shuffle_round_count
        )
        candidate = int(indices[shuffled])
        random_byte = sha256(seed + (i // 32).to_bytes(8, "little"))[i % 32]
        eb = state.validators[candidate].effective_balance
        if eb * MAX_RANDOM_BYTE >= max_eb * random_byte:
            return candidate
        i += 1
