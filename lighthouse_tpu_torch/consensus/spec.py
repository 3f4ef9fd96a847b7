"""Preset (static) + chain (runtime) configuration — the two-level split.

Twin of the reference's `EthSpec` trait (compile-time type-level sizes,
consensus/types/src/eth_spec.rs:52 — Mainnet :292, Minimal :342, Gnosis
:395) and `ChainSpec` (runtime scalars, consensus/types/src/chain_spec.rs).

The split matters more here than in Rust: every `Preset` integer becomes an
XLA-static array shape (committee tensors, state lists, device batch sizes),
so a preset pins a family of compiled programs exactly the way `MainnetEthSpec`
pins a family of monomorphized functions. `ChainSpec` values (fork versions,
domains, time params) are runtime data and never shape a compiled graph.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class Preset:
    """Static-shape constants (the EthSpec analog). Frozen: hashable, so it
    can key caches of per-preset container families and compiled kernels."""

    name: str
    # misc
    max_committees_per_slot: int
    target_committee_size: int
    max_validators_per_committee: int
    shuffle_round_count: int
    # time
    slots_per_epoch: int
    min_seed_lookahead: int = 1
    max_seed_lookahead: int = 4
    epochs_per_eth1_voting_period: int = 64
    slots_per_historical_root: int = 8192
    min_epochs_to_inactivity_penalty: int = 4
    # state list lengths
    epochs_per_historical_vector: int = 65536
    epochs_per_slashings_vector: int = 8192
    historical_roots_limit: int = 16777216
    validator_registry_limit: int = 2**40
    # rewards & penalties
    base_reward_factor: int = 64
    whistleblower_reward_quotient: int = 512
    proposer_reward_quotient: int = 8
    inactivity_penalty_quotient: int = 2**26
    min_slashing_penalty_quotient: int = 128
    proportional_slashing_multiplier: int = 1
    # max operations per block
    max_proposer_slashings: int = 16
    max_attester_slashings: int = 2
    max_attestations: int = 128
    max_deposits: int = 16
    max_voluntary_exits: int = 16
    # altair
    sync_committee_size: int = 512
    epochs_per_sync_committee_period: int = 256
    inactivity_score_bias: int = 4
    inactivity_score_recovery_rate: int = 16
    # bellatrix (execution payloads)
    max_bytes_per_transaction: int = 2**30
    max_transactions_per_payload: int = 2**20
    bytes_per_logs_bloom: int = 256
    max_extra_data_bytes: int = 32
    # capella
    max_bls_to_execution_changes: int = 16
    max_withdrawals_per_payload: int = 16
    max_validators_per_withdrawals_sweep: int = 16384
    # deneb
    max_blobs_per_block: int = 6
    max_blob_commitments_per_block: int = 4096
    field_elements_per_blob: int = 4096
    kzg_commitment_inclusion_proof_depth: int = 17

    @property
    def pending_attestations_limit(self) -> int:
        return self.max_attestations * self.slots_per_epoch


# consensus/types/src/eth_spec.rs:292 (MainnetEthSpec)
MAINNET = Preset(
    name="mainnet",
    max_committees_per_slot=64,
    target_committee_size=128,
    max_validators_per_committee=2048,
    shuffle_round_count=90,
    slots_per_epoch=32,
)

# consensus/types/src/eth_spec.rs:342 (MinimalEthSpec): smaller shapes for
# tests/simulators; everything not overridden matches mainnet.
MINIMAL = Preset(
    name="minimal",
    max_committees_per_slot=4,
    target_committee_size=4,
    max_validators_per_committee=2048,
    shuffle_round_count=10,
    slots_per_epoch=8,
    epochs_per_eth1_voting_period=4,
    slots_per_historical_root=64,
    epochs_per_historical_vector=64,
    epochs_per_slashings_vector=64,
    sync_committee_size=32,
    epochs_per_sync_committee_period=8,
    max_withdrawals_per_payload=4,
    max_validators_per_withdrawals_sweep=16,
)

# consensus/types/src/eth_spec.rs:395 (GnosisEthSpec)
GNOSIS = replace(MAINNET, name="gnosis", slots_per_epoch=16)

PRESETS = {p.name: p for p in (MAINNET, MINIMAL, GNOSIS)}


# ---------------------------------------------------------------------------
# Runtime chain configuration (the ChainSpec analog)
# ---------------------------------------------------------------------------

# Domain types: consensus/types/src/chain_spec.rs `Domain` enum /
# per_block_processing/signature_sets.rs usage.
DOMAIN_BEACON_PROPOSER = (0).to_bytes(4, "little")
DOMAIN_BEACON_ATTESTER = (1).to_bytes(4, "little")
DOMAIN_RANDAO = (2).to_bytes(4, "little")
DOMAIN_DEPOSIT = (3).to_bytes(4, "little")
DOMAIN_VOLUNTARY_EXIT = (4).to_bytes(4, "little")
DOMAIN_SELECTION_PROOF = (5).to_bytes(4, "little")
DOMAIN_AGGREGATE_AND_PROOF = (6).to_bytes(4, "little")
DOMAIN_SYNC_COMMITTEE = (7).to_bytes(4, "little")
DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF = (8).to_bytes(4, "little")
DOMAIN_CONTRIBUTION_AND_PROOF = (9).to_bytes(4, "little")
DOMAIN_BLS_TO_EXECUTION_CHANGE = (10).to_bytes(4, "little")
DOMAIN_APPLICATION_MASK = (1).to_bytes(4, "big")  # 0x00000001


@dataclass(frozen=True)
class ChainSpec:
    """Runtime scalars: fork schedule, time parameters, deposit config.

    Mirrors consensus/types/src/chain_spec.rs (1,863 LoC there; the fields
    here are the subset the implemented layers consume — extended as layers
    land, never speculatively).
    """

    preset: Preset = MAINNET
    config_name: str = "mainnet"
    # genesis
    min_genesis_active_validator_count: int = 16384
    min_genesis_time: int = 1606824000
    genesis_fork_version: bytes = bytes(4)
    genesis_delay: int = 604800
    # forks (epoch = FAR_FUTURE means not scheduled)
    altair_fork_version: bytes = bytes.fromhex("01000000")
    altair_fork_epoch: int | None = 74240
    bellatrix_fork_version: bytes = bytes.fromhex("02000000")
    bellatrix_fork_epoch: int | None = 144896
    capella_fork_version: bytes = bytes.fromhex("03000000")
    capella_fork_epoch: int | None = 194048
    deneb_fork_version: bytes = bytes.fromhex("04000000")
    deneb_fork_epoch: int | None = 269568
    # time
    seconds_per_slot: int = 12
    seconds_per_eth1_block: int = 14
    min_attestation_inclusion_delay: int = 1
    min_validator_withdrawability_delay: int = 256
    shard_committee_period: int = 256
    eth1_follow_distance: int = 2048
    # validator cycle
    min_per_epoch_churn_limit: int = 4
    churn_limit_quotient: int = 65536
    max_per_epoch_activation_churn_limit: int = 8
    ejection_balance: int = 16_000_000_000
    # gwei values
    min_deposit_amount: int = 1_000_000_000
    max_effective_balance: int = 32_000_000_000
    effective_balance_increment: int = 1_000_000_000
    # deposit contract
    deposit_chain_id: int = 1
    deposit_network_id: int = 1
    deposit_contract_address: bytes = bytes(20)
    deposit_contract_tree_depth: int = 32
    # fork choice
    proposer_score_boost: int = 40
    # networking / sync committees
    attestation_subnet_count: int = 64
    sync_committee_subnet_count: int = 4

    # the ONE fork schedule every derivation below reads (chain_spec.rs);
    # adding a fork means adding exactly one row here
    _FORK_ORDER = ("altair", "bellatrix", "capella", "deneb")

    def fork_schedule(self) -> list:
        """Scheduled forks as ascending [(epoch, name, version)], genesis
        included (None-epoch forks are not scheduled)."""
        sched = [(0, "base", self.genesis_fork_version)]
        for name in self._FORK_ORDER:
            e = getattr(self, f"{name}_fork_epoch")
            if e is not None:
                sched.append((e, name, getattr(self, f"{name}_fork_version")))
        sched.sort(key=lambda t: t[0])
        return sched

    def fork_at_epoch(self, epoch: int) -> tuple:
        """(previous_version, current_version, current_fork_epoch) active
        at ``epoch`` — exactly the Fork container a post-upgrade state
        carries, derivable without any state (the stateless VC's need)."""
        sched = self.fork_schedule()
        current = previous = sched[0]
        for boundary in sched:
            if boundary[0] <= epoch:
                previous, current = current, boundary
            else:
                break
        return previous[2], current[2], current[0]

    def fork_version_at_epoch(self, epoch: int) -> bytes:
        """Active fork version for an epoch (chain_spec.rs fork schedule)."""
        return self.fork_at_epoch(epoch)[1]

    def fork_name_at_epoch(self, epoch: int) -> str:
        for fork_epoch, name, _ in reversed(self.fork_schedule()):
            if epoch >= fork_epoch:
                return name
        return "base"


def mainnet_spec() -> ChainSpec:
    return ChainSpec()


def minimal_spec() -> ChainSpec:
    """Minimal-preset spec with all forks at genesis (the common test shape,
    cf. the reference harness defaulting spec forks to epoch 0 in tests)."""
    return ChainSpec(
        preset=MINIMAL,
        config_name="minimal",
        min_genesis_active_validator_count=64,
        churn_limit_quotient=32,
        eth1_follow_distance=16,
        altair_fork_epoch=0,
        bellatrix_fork_epoch=0,
        capella_fork_epoch=0,
        deneb_fork_epoch=0,
    )


# ---------------------------------------------------------------------------
# Domain / signing-root helpers (spec helpers compute_domain & co)
# ---------------------------------------------------------------------------


def compute_fork_data_root(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    from . import containers as C

    fd = C.ForkData(
        current_version=current_version,
        genesis_validators_root=genesis_validators_root,
    )
    return fd.root()


def compute_fork_digest(current_version: bytes, genesis_validators_root: bytes) -> bytes:
    return compute_fork_data_root(current_version, genesis_validators_root)[:4]


def compute_domain(
    domain_type: bytes,
    fork_version: bytes | None = None,
    genesis_validators_root: bytes | None = None,
) -> bytes:
    if fork_version is None:
        fork_version = bytes(4)
    if genesis_validators_root is None:
        genesis_validators_root = bytes(32)
    fork_data_root = compute_fork_data_root(fork_version, genesis_validators_root)
    return domain_type + fork_data_root[:28]


def compute_signing_root(obj, domain: bytes) -> bytes:
    from . import containers as C

    sd = C.SigningData(object_root=obj.root(), domain=domain)
    return sd.root()
