"""Proto-array: the array-backed LMD-GHOST fork-choice DAG.

Twin of consensus/proto_array/src/proto_array.rs (`ProtoNode` :77,
`apply_score_changes` :212, `find_head` :689, pruning :754, execution-status
invalidation :436-560).  The proto-array design is already "array-thinking"
— nodes append in insertion order, every parent precedes its children, and
score propagation is one backward sweep — so the idiomatic port keeps
parallel numpy columns (weight/parent/epochs) instead of a node-struct list,
and computes the vote-delta vector with a single vectorized pass over the
validator vote arrays (`compute_deltas` twin, proto_array_fork_choice.rs).

Viability (node_is_viable_for_head, proto_array.rs:874): a head candidate
must agree with the store's justified+finalized checkpoints; invalid
execution status excludes a subtree.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

NONE = -1

# execution status codes (proto_array.rs ExecutionStatus)
EXEC_VALID = 0
EXEC_OPTIMISTIC = 1  # not yet verified by the EL
EXEC_INVALID = 2
EXEC_IRRELEVANT = 3  # pre-merge blocks


@dataclass
class Block:
    """The insertion payload (proto_array.rs `Block`)."""

    slot: int
    root: bytes
    parent_root: bytes | None
    state_root: bytes
    justified_epoch: int
    finalized_epoch: int
    execution_block_hash: bytes | None = None
    execution_status: int = EXEC_IRRELEVANT


class ProtoArray:
    def __init__(self, justified_epoch: int, finalized_epoch: int):
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        self.roots: list[bytes] = []
        self.index: dict[bytes, int] = {}
        self.blocks: list[Block] = []
        # numpy columns
        self.parent = np.empty(0, dtype=np.int64)
        self.weight = np.empty(0, dtype=np.int64)
        self.best_child = np.empty(0, dtype=np.int64)
        self.best_descendant = np.empty(0, dtype=np.int64)
        self.just_epoch = np.empty(0, dtype=np.int64)
        self.fin_epoch = np.empty(0, dtype=np.int64)
        self.exec_status = np.empty(0, dtype=np.int8)
        self.slot_arr = np.empty(0, dtype=np.int64)
        # proposer boost (fork_choice.rs proposer-boost)
        self.previous_proposer_boost_root: bytes | None = None

    def __len__(self) -> int:
        return len(self.blocks)

    def _grow(self, **cols):
        self.parent = np.append(self.parent, cols["parent"])
        self.weight = np.append(self.weight, 0)
        self.best_child = np.append(self.best_child, NONE)
        self.best_descendant = np.append(self.best_descendant, NONE)
        self.just_epoch = np.append(self.just_epoch, cols["just"])
        self.fin_epoch = np.append(self.fin_epoch, cols["fin"])
        self.exec_status = np.append(self.exec_status, cols["exec"])
        self.slot_arr = np.append(self.slot_arr, cols["slot"])

    # ------------------------------------------------------------------ API

    def on_block(self, block: Block) -> None:
        """proto_array.rs:on_block (insert + back-propagate best pointers)."""
        if block.root in self.index:
            return
        parent_idx = (
            self.index.get(block.parent_root, NONE)
            if block.parent_root is not None
            else NONE
        )
        idx = len(self.blocks)
        self.index[block.root] = idx
        self.roots.append(block.root)
        self.blocks.append(block)
        self._grow(
            parent=parent_idx,
            just=block.justified_epoch,
            fin=block.finalized_epoch,
            exec=block.execution_status,
            slot=block.slot,
        )
        if parent_idx != NONE:
            self._maybe_update_best_child_and_descendant(parent_idx, idx)

    def apply_score_changes(
        self,
        deltas: np.ndarray,
        justified_epoch: int,
        finalized_epoch: int,
        proposer_boost_root: bytes | None = None,
        proposer_boost_amount: int = 0,
    ) -> None:
        """proto_array.rs:212 — add deltas (+ proposer boost differential),
        back-propagate child weights into parents, then refresh best-child/
        best-descendant pointers in the same backward sweep."""
        n = len(self.blocks)
        if len(deltas) != n:
            raise ValueError("deltas length mismatch")
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        deltas = deltas.astype(np.int64, copy=True)
        # proposer boost differential (proto_array.rs:240-260)
        if self.previous_proposer_boost_root is not None:
            prev = self.index.get(self.previous_proposer_boost_root, NONE)
            if prev != NONE:
                deltas[prev] -= self._prev_boost_amount
        if proposer_boost_root is not None:
            cur = self.index.get(proposer_boost_root, NONE)
            if cur != NONE:
                deltas[cur] += proposer_boost_amount
        self.previous_proposer_boost_root = proposer_boost_root
        self._prev_boost_amount = proposer_boost_amount

        # backward sweep: node -> parent accumulation must be sequential in
        # the worst case (a chain), but appending order guarantees children
        # come after parents, so one reverse pass settles everything.
        for i in range(n - 1, -1, -1):
            self.weight[i] += deltas[i]
            p = self.parent[i]
            if p != NONE:
                deltas[p] += deltas[i]
        if (self.weight < 0).any():
            raise ValueError("negative weight after score changes")
        for i in range(n - 1, -1, -1):
            p = self.parent[i]
            if p != NONE:
                self._maybe_update_best_child_and_descendant(p, i)

    def find_head(self, justified_root: bytes) -> bytes:
        """proto_array.rs:689: justified root's best descendant, verified
        viable."""
        ji = self.index.get(justified_root)
        if ji is None:
            raise KeyError(f"justified root unknown: {justified_root.hex()}")
        best = self.best_descendant[ji]
        if best == NONE:
            best = ji
        if not self._node_is_viable_for_head(best):
            raise ValueError(
                "best descendant is not viable for head (justified/finalized "
                "mismatch or invalid execution status)"
            )
        return self.roots[best]

    def prune(self, finalized_root: bytes) -> np.ndarray | None:
        """proto_array.rs:754: drop everything not descending from the new
        finalized root and reindex the columns.  Returns the old->new index
        remap (NONE for pruned nodes) so vote trackers can follow, or None
        if nothing changed."""
        fi = self.index.get(finalized_root)
        if fi is None:
            raise KeyError("finalized root unknown")
        if fi == 0:
            return None
        n = len(self.blocks)
        keep = np.zeros(n, dtype=bool)
        keep[fi] = True
        for i in range(fi + 1, n):
            p = self.parent[i]
            if p != NONE and keep[p]:
                keep[i] = True
        remap = np.full(n, NONE, dtype=np.int64)
        remap[keep] = np.arange(int(keep.sum()))

        def remap_ptr(col):
            out = col[keep].copy()
            mask = out != NONE
            out[mask] = remap[out[mask]]
            return out

        self.parent = remap_ptr(self.parent)
        self.parent[0] = NONE
        self.best_child = remap_ptr(self.best_child)
        self.best_descendant = remap_ptr(self.best_descendant)
        self.weight = self.weight[keep]
        self.just_epoch = self.just_epoch[keep]
        self.fin_epoch = self.fin_epoch[keep]
        self.exec_status = self.exec_status[keep]
        self.slot_arr = self.slot_arr[keep]
        kept = [i for i in range(n) if keep[i]]
        self.blocks = [self.blocks[i] for i in kept]
        self.roots = [self.roots[i] for i in kept]
        self.index = {r: j for j, r in enumerate(self.roots)}
        return remap

    def propagate_execution_invalidation(self, root: bytes) -> None:
        """proto_array.rs:436-560 (condensed): mark a payload invalid and
        invalidate its whole descendant subtree; ancestors that were only
        optimistic stay optimistic."""
        start = self.index.get(root)
        if start is None:
            raise KeyError("unknown root")
        n = len(self.blocks)
        bad = np.zeros(n, dtype=bool)
        bad[start] = True
        for i in range(start + 1, n):
            p = self.parent[i]
            if p != NONE and bad[p]:
                bad[i] = True
        self.exec_status[bad] = EXEC_INVALID
        self.weight[bad] = 0
        # recompute best pointers from scratch (invalidation is rare)
        self.best_child[:] = NONE
        self.best_descendant[:] = NONE
        for i in range(n - 1, -1, -1):
            p = self.parent[i]
            if p != NONE:
                self._maybe_update_best_child_and_descendant(p, i)

    # ------------------------------------------------------------ internals

    def _node_leads_to_viable_head(self, i: int) -> bool:
        bd = self.best_descendant[i]
        if bd != NONE:
            return self._node_is_viable_for_head(bd)
        return self._node_is_viable_for_head(i)

    def _node_is_viable_for_head(self, i: int) -> bool:
        if self.exec_status[i] == EXEC_INVALID:
            return False
        ok_j = (
            self.just_epoch[i] == self.justified_epoch
            or self.justified_epoch == 0
        )
        ok_f = (
            self.fin_epoch[i] == self.finalized_epoch
            or self.finalized_epoch == 0
        )
        return bool(ok_j and ok_f)

    def _maybe_update_best_child_and_descendant(self, parent: int, child: int):
        """proto_array.rs:794 (three-way decision table)."""
        child_leads = self._node_leads_to_viable_head(child)
        best = self.best_child[parent]
        if best == child:
            if not child_leads:
                self.best_child[parent] = NONE
                self.best_descendant[parent] = NONE
            else:
                self._set_best(parent, child)
            return
        if not child_leads:
            return
        if best == NONE:
            self._set_best(parent, child)
            return
        best_leads = self._node_leads_to_viable_head(best)
        if not best_leads:
            self._set_best(parent, child)
            return
        cw, bw = self.weight[child], self.weight[best]
        if cw > bw or (
            cw == bw and self.roots[child] >= self.roots[best]
        ):  # tie-break on root bytes (proto_array.rs tie_breaker)
            self._set_best(parent, child)

    def _set_best(self, parent: int, child: int):
        self.best_child[parent] = child
        bd = self.best_descendant[child]
        self.best_descendant[parent] = bd if bd != NONE else child

    _prev_boost_amount: int = 0
