"""Spec fork choice over the proto-array — on_block / on_attestation /
get_head.

Twin of consensus/fork_choice/src/fork_choice.rs (`ForkChoice` :320,
`get_head` :483, `on_block` :653, `on_attestation` :1090, queued
attestations :249) plus the vote bookkeeping of proto_array's
`proto_array_fork_choice.rs` (`VoteTracker`, `compute_deltas`).

Votes are dense numpy arrays indexed by validator: current root-index, next
root-index, effective balance.  `compute_deltas` is one vectorized
scatter-add instead of the reference's per-validator loop — the same
transform the TPU epoch-processing kernels use.
"""

from __future__ import annotations

import numpy as np

from ..spec import ChainSpec
from .proto_array import NONE, Block, ProtoArray


class ForkChoiceError(Exception):
    pass


class ForkChoice:
    def __init__(
        self,
        spec: ChainSpec,
        genesis_block: Block,
        justified_epoch: int = 0,
        finalized_epoch: int = 0,
    ):
        self.spec = spec
        self.proto = ProtoArray(justified_epoch, finalized_epoch)
        self.proto.on_block(genesis_block)
        self.justified_checkpoint = (justified_epoch, genesis_block.root)
        self.finalized_checkpoint = (finalized_epoch, genesis_block.root)
        # dense vote state (grown on demand)
        self._votes_current = np.full(0, NONE, dtype=np.int64)  # root index
        self._votes_next = np.full(0, NONE, dtype=np.int64)
        self._balances = np.zeros(0, dtype=np.int64)  # applied balances
        # attestations from future slots wait a slot (fork_choice.rs:249)
        self._queued: list[tuple[int, bytes, int]] = []
        self.proposer_boost_root: bytes | None = None

    # ----------------------------------------------------------------- votes

    def _ensure_validators(self, n: int):
        cur = len(self._votes_current)
        if n > cur:
            pad = n - cur
            self._votes_current = np.append(
                self._votes_current, np.full(pad, NONE, dtype=np.int64)
            )
            self._votes_next = np.append(
                self._votes_next, np.full(pad, NONE, dtype=np.int64)
            )
            self._balances = np.append(self._balances, np.zeros(pad, dtype=np.int64))

    def process_attestation(
        self, validator_index: int, block_root: bytes, target_epoch: int,
        current_slot: int | None = None,
    ) -> None:
        """fork_choice.rs:1090 on_attestation (queued if from the future)."""
        if block_root not in self.proto.index:
            raise ForkChoiceError(f"attestation for unknown block {block_root.hex()}")
        if current_slot is not None:
            att_slot = target_epoch * self.spec.preset.slots_per_epoch
            if att_slot > current_slot:
                self._queued.append((validator_index, block_root, target_epoch))
                return
        self._ensure_validators(validator_index + 1)
        self._votes_next[validator_index] = self.proto.index[block_root]

    def process_queued(self, current_slot: int) -> None:
        still = []
        for vi, root, epoch in self._queued:
            if epoch * self.spec.preset.slots_per_epoch <= current_slot:
                self.process_attestation(vi, root, epoch)
            else:
                still.append((vi, root, epoch))
        self._queued = still

    def _compute_deltas(self, new_balances: np.ndarray) -> np.ndarray:
        """proto_array_fork_choice.rs compute_deltas — vectorized: remove
        old weight at the old vote, add new weight at the new vote."""
        n_nodes = len(self.proto)
        deltas = np.zeros(n_nodes, dtype=np.int64)
        nv = len(self._votes_next)
        self._ensure_validators(len(new_balances))
        bal_new = np.zeros(len(self._votes_next), dtype=np.int64)
        bal_new[: len(new_balances)] = new_balances
        cur, nxt = self._votes_current, self._votes_next
        has_cur = cur != NONE
        has_nxt = nxt != NONE
        np.subtract.at(deltas, cur[has_cur], self._balances[has_cur])
        np.add.at(deltas, nxt[has_nxt], bal_new[has_nxt])
        self._votes_current = nxt.copy()
        self._balances = bal_new
        return deltas

    # ----------------------------------------------------------------- blocks

    def on_block(
        self,
        block: Block,
        current_slot: int | None = None,
        justified_checkpoint: tuple[int, bytes] | None = None,
        finalized_checkpoint: tuple[int, bytes] | None = None,
        is_timely_proposal: bool = False,
    ) -> None:
        """fork_choice.rs:653 (condensed): insert + checkpoint advance +
        proposer boost for timely proposals."""
        if block.parent_root is not None and block.parent_root not in self.proto.index:
            raise ForkChoiceError(f"unknown parent {block.parent_root.hex()}")
        self.proto.on_block(block)
        if justified_checkpoint and justified_checkpoint[0] > self.justified_checkpoint[0]:
            self.justified_checkpoint = justified_checkpoint
        if finalized_checkpoint and finalized_checkpoint[0] > self.finalized_checkpoint[0]:
            self.finalized_checkpoint = finalized_checkpoint
            remap = self.proto.prune(finalized_checkpoint[1])
            if remap is not None:
                # votes hold node indices: follow the prune's reindexing
                # (votes into pruned subtrees become NONE and stop counting)
                for arr in (self._votes_current, self._votes_next):
                    live = arr != NONE
                    arr[live] = remap[arr[live]]
        if is_timely_proposal:
            self.proposer_boost_root = block.root

    # ------------------------------------------------------------------ head

    def get_head(self, balances: np.ndarray, current_slot: int | None = None) -> bytes:
        """fork_choice.rs:483: apply pending votes then find_head, with the
        proposer boost computed from the committee-weight fraction."""
        if current_slot is not None:
            self.process_queued(current_slot)
        boost_amount = 0
        if self.proposer_boost_root is not None:
            total = int(np.sum(balances))
            per_slot = total // self.spec.preset.slots_per_epoch
            boost_amount = per_slot * self.spec.proposer_score_boost // 100
        deltas = self._compute_deltas(np.asarray(balances, dtype=np.int64))
        self.proto.apply_score_changes(
            deltas,
            self.justified_checkpoint[0],
            self.finalized_checkpoint[0],
            self.proposer_boost_root,
            boost_amount,
        )
        return self.proto.find_head(self.justified_checkpoint[1])

    def on_slot_boundary(self):
        """Proposer boost expires at the next slot (fork_choice.rs)."""
        self.proposer_boost_root = None

    def contains_block(self, root: bytes) -> bool:
        return root in self.proto.index
