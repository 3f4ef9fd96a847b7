"""Batch SHA-256 — the hashing workhorse under Merkleization and shuffling.

The reference leans on `ethereum_hashing` (SHA-256 with CPU intrinsics,
Cargo.toml:66) for tree-hash and swap-or-not shuffling. Here the equivalent
is a *lane-parallel* SHA-256: k independent 64-byte messages are compressed
simultaneously with numpy uint32 vector ops (one message per lane), which is
exactly the layout a TPU tree-hash kernel wants (the compression function is
64 rounds of elementwise uint32 arithmetic — VPU-shaped, no MXU needed).

Two paths:
* default: loop over hashlib (OpenSSL with SHA-NI — measured ~700k
  hashes/s/core, ~10x faster than the numpy compressor, which pays heavy
  memory traffic for its 64 rounds of temporaries).
* `sha256_many_vec`: the lane-parallel compressor — kept as the correctness
  reference and the blueprint for the jax/Pallas device tree-hash kernel
  (identical dataflow, jnp.uint32 for np.uint32).
"""

from __future__ import annotations

import hashlib

import numpy as np

_K = np.array(
    [
        0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5,
        0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
        0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
        0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
        0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC,
        0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
        0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7,
        0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
        0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
        0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
        0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3,
        0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
        0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5,
        0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
        0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
        0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
    ],
    dtype=np.uint32,
)

_H0 = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)

# The second (final) block of a 64-byte message: 0x80 delimiter, zero pad,
# 512-bit length — constant across all lanes.
_PAD_BLOCK_WORDS = np.zeros(16, dtype=np.uint32)
_PAD_BLOCK_WORDS[0] = 0x80000000
_PAD_BLOCK_WORDS[15] = 512


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _compress(state: np.ndarray, words: np.ndarray) -> np.ndarray:
    """One compression round batch: state (k, 8), words (k, 16) -> (k, 8)."""
    w = [words[:, i].copy() for i in range(16)]
    a, b, c, d, e, f, g, h = (state[:, i].copy() for i in range(8))
    for t in range(64):
        if t < 16:
            wt = w[t]
        else:
            w15, w2 = w[(t - 15) % 16], w[(t - 2) % 16]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> np.uint32(3))
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> np.uint32(10))
            wt = w[t % 16] + s0 + w[(t - 7) % 16] + s1
            w[t % 16] = wt
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + _K[t] + wt
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = S0 + maj
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
    out = np.empty_like(state)
    for i, v in enumerate((a, b, c, d, e, f, g, h)):
        out[:, i] = state[:, i] + v
    return out


def sha256_many(data: np.ndarray) -> np.ndarray:
    """SHA-256 of k 64-byte messages: (k, 64) uint8 -> (k, 32) uint8."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    k = data.shape[0]
    assert data.shape == (k, 64), data.shape
    out = np.empty((k, 32), dtype=np.uint8)
    for i in range(k):
        out[i] = np.frombuffer(
            hashlib.sha256(data[i].tobytes()).digest(), dtype=np.uint8
        )
    return out


def sha256_many_vec(data: np.ndarray) -> np.ndarray:
    """Lane-parallel SHA-256 (numpy compressor): (k, 64) -> (k, 32)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    k = data.shape[0]
    assert data.shape == (k, 64), data.shape
    if k == 0:
        return np.empty((0, 32), dtype=np.uint8)
    # big-endian word view of the message block
    words = data.reshape(k, 16, 4).astype(np.uint32)
    words = (
        (words[:, :, 0] << np.uint32(24))
        | (words[:, :, 1] << np.uint32(16))
        | (words[:, :, 2] << np.uint32(8))
        | words[:, :, 3]
    )
    with np.errstate(over="ignore"):
        state = np.broadcast_to(_H0, (k, 8)).copy()
        state = _compress(state, words)
        pad = np.broadcast_to(_PAD_BLOCK_WORDS, (k, 16))
        state = _compress(state, pad)
    # back to big-endian bytes
    out = np.empty((k, 32), dtype=np.uint8)
    for i in range(8):
        out[:, 4 * i] = (state[:, i] >> np.uint32(24)).astype(np.uint8)
        out[:, 4 * i + 1] = (state[:, i] >> np.uint32(16)).astype(np.uint8)
        out[:, 4 * i + 2] = (state[:, i] >> np.uint32(8)).astype(np.uint8)
        out[:, 4 * i + 3] = state[:, i].astype(np.uint8)
    return out


def sha256(data: bytes) -> bytes:
    """Plain single-message SHA-256 (hashlib passthrough)."""
    return hashlib.sha256(data).digest()
