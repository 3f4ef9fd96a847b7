"""Swap-or-not committee shuffling — vectorized.

Twin of consensus/swap_or_not_shuffle (shuffle_list `src/shuffle_list.rs:79`,
`compute_shuffled_index`). The reference shuffles element-by-element in Rust;
here the whole-list shuffle runs all indices through a round simultaneously
with numpy (the per-round "source" hash blocks are computed once per 256-lane
span with the batched SHA-256 from ops) — the same dataflow a device kernel
would use, and ~three orders of magnitude fewer Python bytecodes than a per
-index loop at mainnet validator counts.

Both directions of the network byte protocol are pinned by the EF shuffling
vectors (tests/test_shuffle.py) via the round-trip property and the
single-index/whole-list agreement property.
"""

from __future__ import annotations

import numpy as np

from ..ops import sha256

SEED_SIZE = 32


def compute_shuffled_index(
    index: int, index_count: int, seed: bytes, shuffle_round_count: int
) -> int:
    """Spec compute_shuffled_index: one index forward through all rounds."""
    assert 0 <= index < index_count
    for rnd in range(shuffle_round_count):
        pivot = int.from_bytes(sha256(seed + bytes([rnd]))[:8], "little") % index_count
        flip = (pivot + index_count - index) % index_count
        position = max(index, flip)
        source = sha256(
            seed + bytes([rnd]) + (position // 256).to_bytes(4, "little")
        )
        byte = source[(position % 256) // 8]
        if (byte >> (position % 8)) & 1:
            index = flip
    return index


def _round_bits(seed: bytes, rnd: int, positions: np.ndarray, index_count: int):
    """The swap-or-not decision bits for an array of positions (one round)."""
    n_blocks = (index_count + 255) // 256
    prefix = seed + bytes([rnd])
    digests = np.stack(
        [
            np.frombuffer(sha256(prefix + blk.to_bytes(4, "little")), dtype=np.uint8)
            for blk in range(n_blocks)
        ]
    )
    byte_idx = (positions % 256) // 8
    bytes_ = digests[positions // 256, byte_idx]
    return (bytes_ >> (positions % 8).astype(np.uint8)) & 1


def _sigma(n: int, seed: bytes, shuffle_round_count: int) -> np.ndarray:
    """compute_shuffled_index for ALL indices at once: sigma[i] = shuffled
    index of i.  Identical round math to the scalar function, vectorized."""
    idx = np.arange(n, dtype=np.int64)
    for rnd in range(shuffle_round_count):
        pivot = int.from_bytes(sha256(seed + bytes([rnd]))[:8], "little") % n
        flip = (pivot + n - idx) % n
        position = np.maximum(idx, flip)
        bits = _round_bits(seed, rnd, position, n)
        idx = np.where(bits == 1, flip, idx)
    return idx


def shuffle_list(
    values: np.ndarray, seed: bytes, shuffle_round_count: int
) -> np.ndarray:
    """out[i] = values[compute_shuffled_index(i)] — the gather the spec's
    compute_committee performs, so committees slice directly out of the
    result (the reference's committee cache does the same with its
    shuffle_list, shuffle_list.rs:79)."""
    values = np.asarray(values)
    n = len(values)
    if n <= 1:
        return values.copy()
    return values[_sigma(n, seed, shuffle_round_count)]


def unshuffle_list(
    values: np.ndarray, seed: bytes, shuffle_round_count: int
) -> np.ndarray:
    """Inverse of shuffle_list: scatter back through sigma."""
    values = np.asarray(values)
    n = len(values)
    if n <= 1:
        return values.copy()
    out = np.empty_like(values)
    out[_sigma(n, seed, shuffle_round_count)] = values
    return out
