"""Merkle proofs + incremental deposit tree.

Twin of consensus/merkle_proof (`MerkleTree`, verify_merkle_proof) — used by
deposit processing (proofs against eth1_data.deposit_root) and light-client
style branch checks (generalized indices).
"""

from __future__ import annotations

from ..ops import sha256

ZERO_HASHES: list[bytes] = [bytes(32)]
while len(ZERO_HASHES) < 64:
    ZERO_HASHES.append(sha256(ZERO_HASHES[-1] + ZERO_HASHES[-1]))


def merkle_root_from_branch(
    leaf: bytes, branch: list[bytes], depth: int, index: int
) -> bytes:
    """Fold a proof branch upward from a leaf at ``index``."""
    node = leaf
    for i in range(depth):
        if (index >> i) & 1:
            node = sha256(branch[i] + node)
        else:
            node = sha256(node + branch[i])
    return node


def verify_merkle_proof(
    leaf: bytes, branch: list[bytes], depth: int, index: int, root: bytes
) -> bool:
    return merkle_root_from_branch(leaf, branch, depth, index) == root


class DepositTree:
    """Incremental sparse Merkle tree of deposit-data roots (depth 32) with
    the eth1 deposit-count mix-in — produces the proofs process_deposit
    checks.  The sparse 'filled subtrees' trick keeps pushes O(depth)."""

    DEPTH = 32

    def __init__(self):
        self.filled: list[bytes | None] = [None] * self.DEPTH
        self.count = 0
        self._leaves: list[bytes] = []  # retained for proof generation

    def push(self, leaf: bytes) -> None:
        self._leaves.append(leaf)
        self.count += 1
        node = leaf
        size = self.count
        for level in range(self.DEPTH):
            if size % 2 == 1:
                self.filled[level] = node
                break
            node = sha256(self.filled[level] + node)
            size //= 2

    def root(self) -> bytes:
        """Tree root with the deposit count mixed in (deposit contract
        semantics: sha256(root ++ count_le ++ zeros))."""
        node = bytes(32)
        size = self.count
        for level in range(self.DEPTH):
            if size % 2 == 1:
                node = sha256(self.filled[level] + node)
            else:
                node = sha256(node + ZERO_HASHES[level])
            size //= 2
        return sha256(node + self.count.to_bytes(8, "little") + bytes(24))

    def proof(self, index: int, count: int | None = None) -> list[bytes]:
        """Branch for leaf ``index`` (+ the count chunk as the final
        element, matching the Deposit.proof DEPTH+1 layout).

        ``count`` selects a HISTORICAL snapshot of the tree (the first
        ``count`` leaves): under deposit-queue saturation the contract
        tree keeps growing while blocks drain against the *voted*
        ``eth1_data`` snapshot, so proofs must verify against that
        snapshot's root, not the live tip."""
        count = self.count if count is None else count
        assert 0 < count <= self.count and index < count
        # rebuild the level nodes (O(n); fine for test/genesis scale)
        level_nodes = list(self._leaves[:count])
        branch: list[bytes] = []
        idx = index
        for level in range(self.DEPTH):
            sibling = idx ^ 1
            if sibling < len(level_nodes):
                branch.append(level_nodes[sibling])
            else:
                branch.append(ZERO_HASHES[level])
            nxt = []
            for i in range(0, len(level_nodes), 2):
                a = level_nodes[i]
                b = (
                    level_nodes[i + 1]
                    if i + 1 < len(level_nodes)
                    else ZERO_HASHES[level]
                )
                nxt.append(sha256(a + b))
            level_nodes = nxt
            idx //= 2
        branch.append(count.to_bytes(8, "little") + bytes(24))
        return branch
