"""Consensus containers — the `consensus/types` twin.

Fresh SSZ container definitions from the consensus specs, shaped like the
reference's type layer (consensus/types/src/: beacon_block.rs:8-55 fork
variants, beacon_state.rs, attestation.rs, validator.rs, ...) but organized
Python/TPU-first:

* Fork-versioning: the reference uses the `superstruct` macro to generate
  Base/Altair/Bellatrix/Capella/Deneb variants of a container; here each
  variant is a plain class and ``<NAME>_BY_FORK`` dicts map fork name ->
  class (the match statement analog of superstruct's enum dispatch).
* Preset-parametric shapes (sync committee size, state list limits) live in
  a per-`Preset` family built once by :func:`types_for` and cached — the
  Python analog of monomorphizing `BeaconState<MainnetEthSpec>`.

Scalar fields use plain ints (Slot/Epoch newtype safety is provided by the
SSZ descriptors at the boundary, not wrapper classes — wrappers would break
numpy/JAX interop for the dense state-transition arrays).
"""

from __future__ import annotations

from functools import lru_cache

from .spec import Preset
from .ssz import (
    BOOLEAN,
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    F,
    SSZList,
    U8,
    U64,
    U256,
    Vector,
)

Root = ByteVector(32)
Bytes32 = ByteVector(32)
Bytes20 = ByteVector(20)
Bytes4 = ByteVector(4)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)
BLSPubkey = Bytes48
BLSSignature = Bytes96
KZGCommitment = Bytes48
KZGProof = Bytes48

# Limits that are preset-invariant across mainnet/minimal (eth_spec.rs keeps
# these equal in both presets).
MAX_VALIDATORS_PER_COMMITTEE = 2048
DEPOSIT_CONTRACT_TREE_DEPTH = 32


class Fork(Container):
    fields = {
        "previous_version": Bytes4,
        "current_version": Bytes4,
        "epoch": U64,
    }


class ForkData(Container):
    fields = {
        "current_version": Bytes4,
        "genesis_validators_root": Root,
    }


class SigningData(Container):
    fields = {
        "object_root": Root,
        "domain": Bytes32,
    }


class Checkpoint(Container):
    fields = {
        "epoch": U64,
        "root": Root,
    }


class Validator(Container):
    """Registry entry.  Supports an opt-in freeze/copy-on-write protocol for
    registry-scale scenarios: a frozen validator is immutable (``__setattr__``
    raises; mutators must go through :meth:`thawed`), shares itself across
    state copies (``__deepcopy__``/``copy_value`` return ``self``), and memoizes
    its hash tree root — so a 100k-entry registry of mostly-inert validators
    costs O(active) per state copy/root instead of O(registry)."""

    fields = {
        "pubkey": BLSPubkey,
        "withdrawal_credentials": Bytes32,
        "effective_balance": U64,
        "slashed": BOOLEAN,
        "activation_eligibility_epoch": U64,
        "activation_epoch": U64,
        "exit_epoch": U64,
        "withdrawable_epoch": U64,
    }

    _freezable = True

    def freeze(self) -> "Validator":
        """Mark immutable (idempotent).  Returns self for chaining."""
        self.__dict__["_frozen"] = True
        return self

    @property
    def frozen(self) -> bool:
        return self.__dict__.get("_frozen", False)

    def thawed(self, **changes) -> "Validator":
        """Replace-on-write: a fresh *mutable* validator with ``changes``
        applied.  The canonical mutation path for frozen registries — callers
        rebind the registry slot to the thawed copy."""
        new = type(self).__new__(type(self))
        d = new.__dict__
        src = self.__dict__
        for fname in self._fields:
            d[fname] = src[fname]
        for fname, v in changes.items():
            if fname not in self._fields:
                raise TypeError(f"unknown field: {fname}")
            d[fname] = v
        return new

    def __setattr__(self, name, value):
        if self.__dict__.get("_frozen"):
            raise AttributeError(
                f"frozen Validator is immutable; use thawed({name}=...) and "
                "rebind the registry slot"
            )
        if name in self._fields:
            self.__dict__.pop("_root_memo", None)
            self.__dict__.pop("_ser_memo", None)
        object.__setattr__(self, name, value)

    def __deepcopy__(self, memo):
        if self.__dict__.get("_frozen"):
            return self
        new = self.thawed()
        memo[id(self)] = new
        return new

    def root(self) -> bytes:
        memo = self.__dict__.get("_root_memo")
        if memo is None:
            memo = type(self).hash_tree_root_value(self)
            self.__dict__["_root_memo"] = memo
        return memo

    @classmethod
    def bulk_roots(cls, validators) -> None:
        """Prefill ``_root_memo`` for many validators in wide numpy-batched
        SHA-256 passes (one tree level per pass across ALL validators),
        instead of one per-validator Merkleization each.  Registry-scale
        genesis builds go from seconds to tens of milliseconds; ``root()``
        and the SSZ sequence-root path consume the memos transparently."""
        import numpy as np

        from ..ops import sha256_many

        todo = [v for v in validators if "_root_memo" not in v.__dict__]
        if not todo:
            return
        n = len(todo)
        # chunk 0: pubkey root = sha256(48 bytes || 16 zero bytes)
        pk = np.zeros((n, 64), dtype=np.uint8)
        pk[:, :48] = np.frombuffer(
            b"".join(bytes(v.pubkey) for v in todo), dtype=np.uint8
        ).reshape(n, 48)
        chunks = np.zeros((n, 8, 32), dtype=np.uint8)
        chunks[:, 0] = sha256_many(pk)
        chunks[:, 1] = np.frombuffer(
            b"".join(bytes(v.withdrawal_credentials) for v in todo),
            dtype=np.uint8,
        ).reshape(n, 32)
        u64_fields = (
            (2, "effective_balance"),
            (4, "activation_eligibility_epoch"),
            (5, "activation_epoch"),
            (6, "exit_epoch"),
            (7, "withdrawable_epoch"),
        )
        for ci, fname in u64_fields:
            col = np.fromiter(
                (getattr(v, fname) for v in todo), dtype="<u8", count=n
            )
            chunks[:, ci, :8] = col.view(np.uint8).reshape(n, 8)
        chunks[:, 3, 0] = np.fromiter(
            (1 if v.slashed else 0 for v in todo), dtype=np.uint8, count=n
        )
        lvl = chunks.reshape(n * 4, 64)
        lvl = sha256_many(lvl).reshape(n * 2, 64)
        lvl = sha256_many(lvl).reshape(n, 64)
        roots = sha256_many(lvl)
        for v, r in zip(todo, roots):
            v.__dict__["_root_memo"] = r.tobytes()
        frozen = sum(1 for v in todo if v.__dict__.get("_frozen"))
        if frozen:
            from .ssz import CACHE_BUDGET

            CACHE_BUDGET.charge_memo(96 * frozen)


class AttestationData(Container):
    fields = {
        "slot": U64,
        "index": U64,
        "beacon_block_root": Root,
        "source": F(Checkpoint),
        "target": F(Checkpoint),
    }


class IndexedAttestation(Container):
    fields = {
        "attesting_indices": SSZList(U64, MAX_VALIDATORS_PER_COMMITTEE),
        "data": F(AttestationData),
        "signature": BLSSignature,
    }


class PendingAttestation(Container):
    fields = {
        "aggregation_bits": Bitlist(MAX_VALIDATORS_PER_COMMITTEE),
        "data": F(AttestationData),
        "inclusion_delay": U64,
        "proposer_index": U64,
    }


class Attestation(Container):
    fields = {
        "aggregation_bits": Bitlist(MAX_VALIDATORS_PER_COMMITTEE),
        "data": F(AttestationData),
        "signature": BLSSignature,
    }


class AggregateAndProof(Container):
    fields = {
        "aggregator_index": U64,
        "aggregate": F(Attestation),
        "selection_proof": BLSSignature,
    }


class SignedAggregateAndProof(Container):
    fields = {
        "message": F(AggregateAndProof),
        "signature": BLSSignature,
    }


class SyncAggregatorSelectionData(Container):
    """altair sync aggregator selection (sync_selection_proof.rs)."""

    fields = {
        "slot": U64,
        "subcommittee_index": U64,
    }


class Eth1Data(Container):
    fields = {
        "deposit_root": Root,
        "deposit_count": U64,
        "block_hash": Bytes32,
    }


class DepositMessage(Container):
    fields = {
        "pubkey": BLSPubkey,
        "withdrawal_credentials": Bytes32,
        "amount": U64,
    }


class DepositData(Container):
    fields = {
        "pubkey": BLSPubkey,
        "withdrawal_credentials": Bytes32,
        "amount": U64,
        "signature": BLSSignature,
    }


class Deposit(Container):
    fields = {
        "proof": Vector(Bytes32, DEPOSIT_CONTRACT_TREE_DEPTH + 1),
        "data": F(DepositData),
    }


class BeaconBlockHeader(Container):
    fields = {
        "slot": U64,
        "proposer_index": U64,
        "parent_root": Root,
        "state_root": Root,
        "body_root": Root,
    }


class SignedBeaconBlockHeader(Container):
    fields = {
        "message": F(BeaconBlockHeader),
        "signature": BLSSignature,
    }


class ProposerSlashing(Container):
    fields = {
        "signed_header_1": F(SignedBeaconBlockHeader),
        "signed_header_2": F(SignedBeaconBlockHeader),
    }


class AttesterSlashing(Container):
    fields = {
        "attestation_1": F(IndexedAttestation),
        "attestation_2": F(IndexedAttestation),
    }


class VoluntaryExit(Container):
    fields = {
        "epoch": U64,
        "validator_index": U64,
    }


class SignedVoluntaryExit(Container):
    fields = {
        "message": F(VoluntaryExit),
        "signature": BLSSignature,
    }


class BLSToExecutionChange(Container):
    fields = {
        "validator_index": U64,
        "from_bls_pubkey": BLSPubkey,
        "to_execution_address": Bytes20,
    }


class SignedBLSToExecutionChange(Container):
    fields = {
        "message": F(BLSToExecutionChange),
        "signature": BLSSignature,
    }


class Withdrawal(Container):
    fields = {
        "index": U64,
        "validator_index": U64,
        "address": Bytes20,
        "amount": U64,
    }


class DepositRequest(Container):
    fields = {
        "pubkey": BLSPubkey,
        "withdrawal_credentials": Bytes32,
        "amount": U64,
        "signature": BLSSignature,
        "index": U64,
    }


# ---------------------------------------------------------------------------
# Preset-parametric family
# ---------------------------------------------------------------------------

FORKS = ("base", "altair", "bellatrix", "capella", "deneb")


class TypesFamily:
    """All preset-shaped containers for one `Preset`, built once.

    Access fork-versioned containers via the ``*_BY_FORK`` dicts, e.g.
    ``types_for(MAINNET).BeaconBlockBody_BY_FORK["capella"]``; bare names
    (``.BeaconBlock``) are the base-fork variants for phase0-only callers.
    """

    def __init__(self, preset: Preset):
        self.preset = preset
        P = preset

        class SyncCommittee(Container):
            fields = {
                "pubkeys": Vector(BLSPubkey, P.sync_committee_size),
                "aggregate_pubkey": BLSPubkey,
            }

        class SyncAggregate(Container):
            fields = {
                "sync_committee_bits": Bitvector(P.sync_committee_size),
                "sync_committee_signature": BLSSignature,
            }

        class SyncCommitteeMessage(Container):
            fields = {
                "slot": U64,
                "beacon_block_root": Root,
                "validator_index": U64,
                "signature": BLSSignature,
            }

        class SyncCommitteeContribution(Container):
            fields = {
                "slot": U64,
                "beacon_block_root": Root,
                "subcommittee_index": U64,
                "aggregation_bits": Bitvector(
                    max(P.sync_committee_size // 4, 1)
                ),
                "signature": BLSSignature,
            }

        class ContributionAndProof(Container):
            fields = {
                "aggregator_index": U64,
                "contribution": F(SyncCommitteeContribution),
                "selection_proof": BLSSignature,
            }

        class SignedContributionAndProof(Container):
            fields = {
                "message": F(ContributionAndProof),
                "signature": BLSSignature,
            }

        class HistoricalBatch(Container):
            fields = {
                "block_roots": Vector(Root, P.slots_per_historical_root),
                "state_roots": Vector(Root, P.slots_per_historical_root),
            }

        class HistoricalSummary(Container):
            fields = {
                "block_summary_root": Root,
                "state_summary_root": Root,
            }

        class ExecutionPayloadHeader(Container):
            fields = {
                "parent_hash": Bytes32,
                "fee_recipient": Bytes20,
                "state_root": Bytes32,
                "receipts_root": Bytes32,
                "logs_bloom": ByteVector(P.bytes_per_logs_bloom),
                "prev_randao": Bytes32,
                "block_number": U64,
                "gas_limit": U64,
                "gas_used": U64,
                "timestamp": U64,
                "extra_data": ByteList(P.max_extra_data_bytes),
                "base_fee_per_gas": U256,
                "block_hash": Bytes32,
                "transactions_root": Root,
            }

        class ExecutionPayloadHeaderCapella(ExecutionPayloadHeader):
            fields = {
                **ExecutionPayloadHeader.fields,
                "withdrawals_root": Root,
            }

        class ExecutionPayloadHeaderDeneb(ExecutionPayloadHeaderCapella):
            fields = {
                **ExecutionPayloadHeaderCapella.fields,
                "blob_gas_used": U64,
                "excess_blob_gas": U64,
            }

        _txs = SSZList(
            ByteList(P.max_bytes_per_transaction), P.max_transactions_per_payload
        )

        class ExecutionPayload(Container):
            fields = {
                "parent_hash": Bytes32,
                "fee_recipient": Bytes20,
                "state_root": Bytes32,
                "receipts_root": Bytes32,
                "logs_bloom": ByteVector(P.bytes_per_logs_bloom),
                "prev_randao": Bytes32,
                "block_number": U64,
                "gas_limit": U64,
                "gas_used": U64,
                "timestamp": U64,
                "extra_data": ByteList(P.max_extra_data_bytes),
                "base_fee_per_gas": U256,
                "block_hash": Bytes32,
                "transactions": _txs,
            }

        class ExecutionPayloadCapella(ExecutionPayload):
            fields = {
                **ExecutionPayload.fields,
                "withdrawals": SSZList(F(Withdrawal), P.max_withdrawals_per_payload),
            }

        class ExecutionPayloadDeneb(ExecutionPayloadCapella):
            fields = {
                **ExecutionPayloadCapella.fields,
                "blob_gas_used": U64,
                "excess_blob_gas": U64,
            }

        # ---- block bodies, fork ladder (beacon_block_body.rs) -------------
        _body_base_fields = {
            "randao_reveal": BLSSignature,
            "eth1_data": F(Eth1Data),
            "graffiti": Bytes32,
            "proposer_slashings": SSZList(
                F(ProposerSlashing), P.max_proposer_slashings
            ),
            "attester_slashings": SSZList(
                F(AttesterSlashing), P.max_attester_slashings
            ),
            "attestations": SSZList(F(Attestation), P.max_attestations),
            "deposits": SSZList(F(Deposit), P.max_deposits),
            "voluntary_exits": SSZList(
                F(SignedVoluntaryExit), P.max_voluntary_exits
            ),
        }

        class BeaconBlockBody(Container):
            fields = dict(_body_base_fields)

        class BeaconBlockBodyAltair(Container):
            fields = {
                **_body_base_fields,
                "sync_aggregate": F(SyncAggregate),
            }

        class BeaconBlockBodyBellatrix(Container):
            fields = {
                **BeaconBlockBodyAltair.fields,
                "execution_payload": F(ExecutionPayload),
            }

        class BeaconBlockBodyCapella(Container):
            fields = {
                **BeaconBlockBodyAltair.fields,
                "execution_payload": F(ExecutionPayloadCapella),
                "bls_to_execution_changes": SSZList(
                    F(SignedBLSToExecutionChange), P.max_bls_to_execution_changes
                ),
            }

        class BeaconBlockBodyDeneb(Container):
            fields = {
                **BeaconBlockBodyAltair.fields,
                "execution_payload": F(ExecutionPayloadDeneb),
                "bls_to_execution_changes": SSZList(
                    F(SignedBLSToExecutionChange), P.max_bls_to_execution_changes
                ),
                "blob_kzg_commitments": SSZList(
                    KZGCommitment, P.max_blob_commitments_per_block
                ),
            }

        self.BeaconBlockBody_BY_FORK = {
            "base": BeaconBlockBody,
            "altair": BeaconBlockBodyAltair,
            "bellatrix": BeaconBlockBodyBellatrix,
            "capella": BeaconBlockBodyCapella,
            "deneb": BeaconBlockBodyDeneb,
        }

        def _block_cls(body_cls, suffix):
            class BeaconBlock(Container):
                fields = {
                    "slot": U64,
                    "proposer_index": U64,
                    "parent_root": Root,
                    "state_root": Root,
                    "body": F(body_cls),
                }

            class SignedBeaconBlock(Container):
                fields = {
                    "message": F(BeaconBlock),
                    "signature": BLSSignature,
                }

            BeaconBlock.__name__ = f"BeaconBlock{suffix}"
            SignedBeaconBlock.__name__ = f"SignedBeaconBlock{suffix}"
            return BeaconBlock, SignedBeaconBlock

        self.BeaconBlock_BY_FORK = {}
        self.SignedBeaconBlock_BY_FORK = {}
        for fork, body_cls in self.BeaconBlockBody_BY_FORK.items():
            blk, sblk = _block_cls(body_cls, fork.capitalize())
            self.BeaconBlock_BY_FORK[fork] = blk
            self.SignedBeaconBlock_BY_FORK[fork] = sblk

        # ---- states, fork ladder (beacon_state.rs) ------------------------
        _state_base_fields = {
            "genesis_time": U64,
            "genesis_validators_root": Root,
            "slot": U64,
            "fork": F(Fork),
            "latest_block_header": F(BeaconBlockHeader),
            "block_roots": Vector(Root, P.slots_per_historical_root),
            "state_roots": Vector(Root, P.slots_per_historical_root),
            "historical_roots": SSZList(Root, P.historical_roots_limit),
            "eth1_data": F(Eth1Data),
            "eth1_data_votes": SSZList(
                F(Eth1Data),
                P.epochs_per_eth1_voting_period * P.slots_per_epoch,
            ),
            "eth1_deposit_index": U64,
            "validators": SSZList(F(Validator), P.validator_registry_limit),
            "balances": SSZList(U64, P.validator_registry_limit),
            "randao_mixes": Vector(Bytes32, P.epochs_per_historical_vector),
            "slashings": Vector(U64, P.epochs_per_slashings_vector),
        }
        _state_tail_fields = {
            "justification_bits": Bitvector(4),
            "previous_justified_checkpoint": F(Checkpoint),
            "current_justified_checkpoint": F(Checkpoint),
            "finalized_checkpoint": F(Checkpoint),
        }

        class _FastCopyState(Container):
            """States are copied on every import/proposal path; the
            type-driven field-wise copy replaces deepcopy's memo walk and
            lets frozen registry validators be shared instead of cloned —
            the difference between O(registry) and O(active) per copy."""

            def copy(self):
                return type(self).copy_value_of(self)

        class BeaconState(_FastCopyState):
            fields = {
                **_state_base_fields,
                "previous_epoch_attestations": SSZList(
                    F(PendingAttestation), P.pending_attestations_limit
                ),
                "current_epoch_attestations": SSZList(
                    F(PendingAttestation), P.pending_attestations_limit
                ),
                **_state_tail_fields,
            }

        _altair_participation = {
            "previous_epoch_participation": SSZList(
                U8, P.validator_registry_limit
            ),
            "current_epoch_participation": SSZList(U8, P.validator_registry_limit),
        }
        _altair_tail = {
            "inactivity_scores": SSZList(U64, P.validator_registry_limit),
            "current_sync_committee": F(SyncCommittee),
            "next_sync_committee": F(SyncCommittee),
        }

        class BeaconStateAltair(_FastCopyState):
            fields = {
                **_state_base_fields,
                **_altair_participation,
                **_state_tail_fields,
                **_altair_tail,
            }

        class BeaconStateBellatrix(_FastCopyState):
            fields = {
                **BeaconStateAltair.fields,
                "latest_execution_payload_header": F(ExecutionPayloadHeader),
            }

        class BeaconStateCapella(_FastCopyState):
            fields = {
                **BeaconStateAltair.fields,
                "latest_execution_payload_header": F(ExecutionPayloadHeaderCapella),
                "next_withdrawal_index": U64,
                "next_withdrawal_validator_index": U64,
                "historical_summaries": SSZList(
                    F(HistoricalSummary), P.historical_roots_limit
                ),
            }

        class BeaconStateDeneb(_FastCopyState):
            fields = {
                **BeaconStateAltair.fields,
                "latest_execution_payload_header": F(ExecutionPayloadHeaderDeneb),
                "next_withdrawal_index": U64,
                "next_withdrawal_validator_index": U64,
                "historical_summaries": SSZList(
                    F(HistoricalSummary), P.historical_roots_limit
                ),
            }

        self.BeaconState_BY_FORK = {
            "base": BeaconState,
            "altair": BeaconStateAltair,
            "bellatrix": BeaconStateBellatrix,
            "capella": BeaconStateCapella,
            "deneb": BeaconStateDeneb,
        }

        class BlobSidecar(Container):
            fields = {
                "index": U64,
                "blob": ByteVector(32 * P.field_elements_per_blob),
                "kzg_commitment": KZGCommitment,
                "kzg_proof": KZGProof,
                "signed_block_header": F(SignedBeaconBlockHeader),
                "kzg_commitment_inclusion_proof": Vector(
                    Bytes32, P.kzg_commitment_inclusion_proof_depth
                ),
            }

        # ---- builder API containers (consensus/types/src/builder_bid.rs:
        # BuilderBid/SignedBuilderBid per post-merge fork; deneb adds the
        # blob commitments the relay promises to reveal) ------------------
        self.ExecutionPayloadHeader_BY_FORK = {
            "bellatrix": ExecutionPayloadHeader,
            "capella": ExecutionPayloadHeaderCapella,
            "deneb": ExecutionPayloadHeaderDeneb,
        }
        self.ExecutionPayload_BY_FORK = {
            "bellatrix": ExecutionPayload,
            "capella": ExecutionPayloadCapella,
            "deneb": ExecutionPayloadDeneb,
        }
        self.BuilderBid_BY_FORK = {}
        self.SignedBuilderBid_BY_FORK = {}
        for _fork, _hdr_cls in self.ExecutionPayloadHeader_BY_FORK.items():
            _bid_fields = {"header": F(_hdr_cls)}
            if _fork == "deneb":
                _bid_fields["blob_kzg_commitments"] = SSZList(
                    KZGCommitment, P.max_blob_commitments_per_block
                )
            _bid_fields["value"] = U256
            _bid_fields["pubkey"] = BLSPubkey
            _bid = type(
                f"BuilderBid_{_fork}", (Container,), {"fields": _bid_fields}
            )
            _sbid = type(
                f"SignedBuilderBid_{_fork}",
                (Container,),
                {"fields": {"message": F(_bid), "signature": BLSSignature}},
            )
            self.BuilderBid_BY_FORK[_fork] = _bid
            self.SignedBuilderBid_BY_FORK[_fork] = _sbid

        # bare names = base-fork variants + altair extras
        self.SyncCommittee = SyncCommittee
        self.SyncAggregate = SyncAggregate
        self.SyncCommitteeMessage = SyncCommitteeMessage
        self.SyncCommitteeContribution = SyncCommitteeContribution
        self.ContributionAndProof = ContributionAndProof
        self.SignedContributionAndProof = SignedContributionAndProof
        self.HistoricalBatch = HistoricalBatch
        self.HistoricalSummary = HistoricalSummary
        self.ExecutionPayload = ExecutionPayload
        self.ExecutionPayloadCapella = ExecutionPayloadCapella
        self.ExecutionPayloadDeneb = ExecutionPayloadDeneb
        self.ExecutionPayloadHeader = ExecutionPayloadHeader
        self.ExecutionPayloadHeaderCapella = ExecutionPayloadHeaderCapella
        self.ExecutionPayloadHeaderDeneb = ExecutionPayloadHeaderDeneb
        self.BeaconBlockBody = BeaconBlockBody
        self.BeaconBlock = self.BeaconBlock_BY_FORK["base"]
        self.SignedBeaconBlock = self.SignedBeaconBlock_BY_FORK["base"]
        self.BeaconState = BeaconState
        self.BlobSidecar = BlobSidecar


@lru_cache(maxsize=8)
def types_for(preset: Preset) -> TypesFamily:
    """The cached per-preset container family (EthSpec monomorphization)."""
    return TypesFamily(preset)
